"""The exactness checks of chip_smoke.py phase 4, rerun on an NVIDIA GPU.

They skip where JAX finds no GPU.  On a machine with one:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -q -m gpu
"""

import pytest

import chip_smoke
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """The first GPU, as JAX's default device for the test."""
    import jax

    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu)")
    with jax.default_device(dev):
        yield dev


def test_golden_stream_hash_gpu(gpu):
    assert chip_smoke.golden_stream_sha256() == chip_smoke.GOLDEN_SHA256


@pytest.mark.parametrize("mode,k,j", [(VideoMode.DHGR, 32, 10),
                                      (VideoMode.HGR, 16, 4)])
def test_host_vs_scan_differential_gpu(gpu, mode, k, j):
    assert chip_smoke.oracle_mismatches(mode, k, j) == 0


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_window_store_cost_matches_shipped_gpu(gpu, mode):
    assert chip_smoke.store_cost_vs_shipped(mode, Palette.NTSC,
                                            "window") == 0.0
