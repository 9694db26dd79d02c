"""Edit-distance generation tests.

Validates the diagonal DP reduction against a full weighted
Damerau-Levenshtein oracle, the XLA tile path against the scalar DP, and the
table invariants from reference transcoder/make_data_tables_test.py:18-95.
"""

import numpy as np
import pytest

from iivision_tpu.ops import editdist
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode


@pytest.fixture(scope="module")
def sub():
    return editdist.substitute_matrix(Palette.NTSC)


def test_diagonal_reduction_matches_full_dl(sub):
    rng = np.random.RandomState(42)
    for L in (3, 10, 18):
        for _ in range(200):
            a = rng.randint(0, 16, size=L)
            b = rng.randint(0, 16, size=L)
            full = editdist.dam_lev_scalar(a, b, sub)
            diag = editdist.diagonal_dp_scalar(a, b, sub)
            assert full == diag, (a, b, full, diag)


def test_diagonal_reduction_transposition_cases(sub):
    # swapping two adjacent distinct colours costs exactly 1
    a = np.array([3, 7, 7, 7])
    b = np.array([7, 3, 7, 7])
    assert editdist.diagonal_dp_scalar(a, b, sub) == 1.0
    assert editdist.dam_lev_scalar(a, b, sub) == 1.0
    # identical strings cost 0
    assert editdist.diagonal_dp_scalar(a, a, sub) == 0.0
    # double transposition
    a2 = np.array([1, 2, 3, 4])
    b2 = np.array([2, 1, 4, 3])
    assert editdist.dam_lev_scalar(a2, b2, sub) == 2.0
    assert editdist.diagonal_dp_scalar(a2, b2, sub) == 2.0


def test_lane_pixel_codes_shapes():
    dhgr = editdist.lane_pixel_codes(VideoMode.DHGR, 0)
    assert dhgr.shape == (2 ** 13, 10)
    assert dhgr.max() < 16
    hgr = editdist.lane_pixel_codes(VideoMode.HGR, 1)
    assert hgr.shape == (2 ** 14, 18)
    assert hgr.max() < 16
    # lanes differ by phase: same masked value yields rotated codes
    d0 = editdist.lane_pixel_codes(VideoMode.DHGR, 0)
    d1 = editdist.lane_pixel_codes(VideoMode.DHGR, 1)
    assert not np.array_equal(d0, d1)


def test_dp_tile_matches_scalar(sub):
    import jax.numpy as jnp
    codes = editdist.lane_pixel_codes(VideoMode.DHGR, 2).astype(np.int32)
    rng = np.random.RandomState(7)
    ia = rng.randint(0, len(codes), size=24)
    ib = rng.randint(0, len(codes), size=24)
    tile = editdist.dp_distance_tile(
        jnp.asarray(codes[ia]), jnp.asarray(codes[ib]),
        jnp.asarray(sub.astype(np.float32)))
    tile = np.asarray(tile)
    for x in range(len(ia)):
        for y in range(len(ib)):
            want = editdist.dam_lev_scalar(codes[ia[x]], codes[ib[y]], sub)
            assert tile[x, y] == want


def test_dp_tile_hgr_lane(sub):
    import jax.numpy as jnp
    codes = editdist.lane_pixel_codes(VideoMode.HGR, 0).astype(np.int32)
    rng = np.random.RandomState(8)
    ia = rng.randint(0, len(codes), size=12)
    tile = np.asarray(editdist.dp_distance_tile(
        jnp.asarray(codes[ia]), jnp.asarray(codes[ia]),
        jnp.asarray(sub.astype(np.float32))))
    # symmetry, zero diagonal, uint16 range
    assert np.array_equal(tile, tile.T)
    assert np.all(np.diag(tile) == 0)
    assert tile.max() < 2 ** 16
    for x in range(len(ia)):
        want = editdist.dam_lev_scalar(codes[ia[x]], codes[ia[0]], sub)
        assert tile[x, 0] == want


def test_save_load_roundtrip(tmp_path, sub):
    import jax.numpy as jnp
    # tiny synthetic "table" exercising triangle storage + symmetrised load
    n = 1 << 13
    rng = np.random.RandomState(3)
    # build a symmetric matrix with zero diagonal in the top-left corner only
    small = rng.randint(0, 3000, size=(16, 16))
    small = np.triu(small, 1) + np.triu(small, 1).T
    full = np.zeros((4, n, n), dtype=np.uint16)
    full[:, :16, :16] = small
    tables = jnp.asarray(full.reshape(4, n * n))
    path = editdist.save_tables(tables, VideoMode.DHGR, Palette.IIGS,
                                data_dir=str(tmp_path))
    assert path.endswith("DHGR_palette_0_edit_distance.npz")
    loaded = editdist.load_tables(VideoMode.DHGR, Palette.IIGS,
                                  data_dir=str(tmp_path))
    assert loaded.shape == (4, n * n)
    assert np.all(loaded.reshape(4, n, n)[:, :16, :16] == small)
    assert loaded.reshape(4, n, n)[:, 16:, :].max() == 0

