"""NTSC-composite (YIQ) colour model tests: calibration quality, LUT
invariants, and full host-vs-device-scan differential under the new basis."""

import functools

import numpy as np

from iivision_tpu import encoder, encoder_host, palettes
from iivision_tpu.ops import distance, yiq
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode


import pytest


@functools.lru_cache(None)
def get_dist(mode):
    return distance.ComputedDistance(mode, Palette.NTSC, model="yiq")


def test_calibration_reproduces_palette():
    """Solid 4-dot patterns decode to within a small CIEDE2000 of the 16
    reference NTSC palette colours."""
    pal = Palette.NTSC
    rgb_pal = palettes.palette_rgb_array(pal).astype(np.float64)
    errs = []
    for code in range(16):
        w = sum(((code >> ((k - 3) % 4)) & 1) << k for k in range(7))
        dec = yiq.decode_windows(np.array([w]), 0, pal)[0]
        errs.append(float(palettes.delta_e_cie2000(
            palettes.srgb_to_lab(dec[None]),
            palettes.srgb_to_lab(rgb_pal[code][None]))[0]))
    assert np.mean(errs) < 4.0, errs
    assert np.max(errs) < 8.0, errs


def test_pair_lut_invariants():
    lut = yiq.pair_lut(Palette.NTSC)
    assert lut.shape == (4, 128, 128)
    assert (lut >= 0).all() and lut.max() < 4096
    assert np.array_equal(lut, lut.transpose(0, 2, 1))
    for p in range(4):
        assert np.diag(lut[p]).max() == 0


def test_zero_self_distance_and_blend_smoothness():
    """D(x, x) = 0; and the composite model blends: a single flipped dot
    spreads over the full 7-dot chroma support with per-pixel costs well
    below a solid colour swap (the nominal model snaps 4 pixels to entirely
    different palette entries)."""
    pal = Palette.NTSC
    sub = distance.sub_for(VideoMode.DHGR, pal, "yiq").astype(np.float64)
    v = np.arange(512)
    for lane in range(4):
        d = np.asarray(distance.dist_lane_pairs(
            v, v, VideoMode.DHGR, lane, sub))
        assert (d == 0).all()

    # single-dot flip in the middle of a solid field
    a = np.array([0])
    b = np.array([1 << 6])  # centre content dot of the 13-dot window
    wa = yiq.lane_windows(a, VideoMode.DHGR, 0)[0]
    wb = yiq.lane_windows(b, VideoMode.DHGR, 0)[0]
    per_pix = np.asarray([
        float(sub[0, j, wa[j], wb[j]]) for j in range(len(wa))])
    affected = np.flatnonzero(per_pix)
    assert affected.size == 7, per_pix  # full 7-dot support reacts
    # each blended pixel costs a fraction of a hard black<->white swap
    lut = yiq.pair_lut(pal)
    full_swap = lut[0, 0, 127]
    assert per_pix.max() < 0.8 * full_swap, (per_pix, full_swap)


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_host_vs_scan_differential_yiq(mode):
    """The scalar host oracle and the XLA scan agree bit-for-bit under the
    YIQ basis (zero nonces), including final screen state."""
    dist = get_dist(mode)
    rng = np.random.RandomState(21)
    hi = 0x80 if mode == VideoMode.DHGR else 0x100
    fmain = rng.randint(0, hi, size=(2, 32, 256)).astype(np.uint8)
    faux = (rng.randint(0, hi, size=(2, 32, 256)).astype(np.uint8)
            if mode == VideoMode.DHGR else None)
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=2100.0 / 700 * 2,
        ticks_per_second=2100.0 * 2 / 700 * 350,
        every_n_video_frames=1, mode=mode, k=8)
    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    ops_dev, fin_main, fin_aux = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=None)
    dev_ops = encoder.flatten_ops(np.asarray(ops_dev), plan)
    host_ops = encoder_host.encode_movie_host(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=None)
    assert np.array_equal(dev_ops, host_ops)


def test_yiq_stream_valid_and_converges():
    """A constant target encodes to a VM-valid stream that converges to
    zero YIQ replay error."""
    from iivision_tpu import quality
    from iivision_tpu.sim import PlayerVM
    from iivision_tpu.stream.emit_fast import emit_stream_fast

    mode = VideoMode.DHGR
    dist = get_dist(mode)
    rng = np.random.RandomState(4)
    fmain = np.zeros((1, 32, 256), np.uint8)
    faux = np.zeros((1, 32, 256), np.uint8)
    fmain[0, 10:13] = rng.randint(0, 0x80, size=(3, 256)).astype(np.uint8)
    faux[0, 10:13] = rng.randint(0, 0x80, size=(3, 256)).astype(np.uint8)
    from iivision_tpu import screen
    fmain[0][screen.SCREEN_HOLES] = 0  # holes can never be stored
    faux[0][screen.SCREEN_HOLES] = 0
    plan, _ = encoder.plan_movie(
        n_frames=1, n_audio_ticks=6000, input_frame_rate=1.0,
        ticks_per_second=6001.0, every_n_video_frames=1, mode=mode, k=8)
    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    ops, _, _ = encoder.encode_movie(dist, lanes_tgt, bytes_tgt, plan,
                                     mode, seed=0)
    flat = encoder.flatten_ops(np.asarray(ops), plan)
    rep = quality.replay_frame_errors(flat, plan, lanes_tgt, mode, dist)
    assert rep.final_error == 0.0
    data = emit_stream_fast(flat, np.zeros(plan.n_ops, np.int32), mode)
    res = PlayerVM().decode(data)
    assert res.ok, (res.error, res.error_pos)
