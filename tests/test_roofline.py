"""Sanity checks for the encode-scan FLOP/HBM cost model (roofline.py)."""

import numpy as np
import pytest

from iivision_tpu import encoder, roofline
from iivision_tpu.video_mode import VideoMode


def _padded(plan):
    (sf, _, sr, _), _ = encoder.pad_plan_steps(plan)

    class _P:
        pass

    p = _P()
    p.k, p.j, p.chunk_steps = plan.k, plan.j, plan.chunk_steps
    p.step_frame, p.step_recompute = sf, sr
    return p


def _plan(mode, k=16, j=4):
    plan, _ = encoder.plan_movie(
        n_frames=60, n_audio_ticks=29400, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=2, mode=mode,
        k=k, j=j)
    return plan


def test_cost_model_basics():
    for mode in (VideoMode.DHGR, VideoMode.HGR):
        plan = _plan(mode)
        c = roofline.encode_cost(_padded(plan), mode, batch=8)
        assert c.flops > 0 and c.hbm_bytes_min > 0
        if plan.chunk_steps < encoder.BODY_CAP:
            # per-body slab rebuild: nothing carried, no copy ambiguity
            assert c.hbm_bytes_max == c.hbm_bytes_min
        else:
            # carried pair: the XLA copy-per-body band is real
            assert c.hbm_bytes_max > c.hbm_bytes_min
        assert 0.0 < c.flops_recompute < c.flops
        assert c.n_chunks == int(np.asarray(
            _padded(plan).step_recompute).sum())
        # batch scales every total linearly
        c1 = roofline.encode_cost(_padded(plan), mode, batch=1)
        assert abs(c.flops - 8 * c1.flops) < 1e-6 * c.flops


class _H100:
    device_kind = "NVIDIA H100 80GB HBM3"


def test_report_line_and_fields():
    plan = _plan(VideoMode.DHGR)
    rec = roofline.report(_padded(plan), VideoMode.DHGR, batch=32,
                          seconds=1.0, device=_H100())
    for key in ("model_tflop", "achieved_tflops", "mfu_pct", "hbm_gbps",
                "bound", "line", "recompute_tflop"):
        assert key in rec, key
    assert 0 < rec["mfu_pct"] < 100
    assert rec["hbm_gbps"][0] <= rec["hbm_gbps"][1]
    assert "roofline[B=32 DHGR" in rec["line"]
    assert rec["peak"]["device_kind"] == _H100.device_kind
    # far from both peaks at these shapes -> latency-bound classification
    assert rec["bound"].startswith("latency")


def test_device_peaks_fallback():
    """There is no fallback: a device missing from the table is an error,
    and so is no device at all."""
    class Unknown:
        device_kind = "unlisted accelerator"

    for dev in (None, Unknown()):
        with pytest.raises(ValueError, match="no published peaks"):
            roofline.device_peaks(dev)
    with pytest.raises(ValueError):
        roofline.report(_padded(_plan(VideoMode.DHGR)), VideoMode.DHGR,
                        batch=1, seconds=1.0, device=Unknown())


def test_device_peaks_h100_by_device_kind():
    peaks = roofline.device_peaks(_H100())
    assert peaks == (989.0, 67.0, 3350.0)
    assert (peaks.bf16_tflops, peaks.f32_tflops, peaks.hbm_gbps) == peaks
