"""Encoder tests: movie planning, and differential host-oracle vs device-scan
equivalence using the real distance model."""

import functools

import numpy as np
import pytest

from iivision_tpu import encoder, encoder_host, screen
from iivision_tpu.ops import distance
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode


@functools.lru_cache(None)
def get_dist(mode, palette=Palette.NTSC):
    return distance.ComputedDistance(mode, palette)


def random_frames(mode, n_frames, seed=0):
    rng = np.random.RandomState(seed)
    hi = 0x80 if mode == VideoMode.DHGR else 0x100
    main = rng.randint(0, hi, size=(n_frames, 32, 256)).astype(np.uint8)
    aux = rng.randint(0, hi, size=(n_frames, 32, 256)).astype(np.uint8)
    return main, (aux if mode == VideoMode.DHGR else None)


# --- planning ------------------------------------------------------------------

def test_plan_movie_basic():
    plan, n_enc = encoder.plan_movie(
        n_frames=4, n_audio_ticks=10 ** 6, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=2,
        mode=VideoMode.DHGR, k=8)
    # the movie ends when the 5th frame pull raises StopIteration at the
    # first tick >= 490*4 = 1960 (reference video.py:67, frame_number
    # starting at 0); that tick emits no opcode
    assert plan.n_ops == 1959
    assert n_enc == 2
    assert plan.step_nvalid.sum() == plan.n_ops
    assert plan.step_recompute[0]
    assert plan.step_bank[0] == 0
    assert plan.step_frame[0] == 0
    # banks alternate across 2KB segments
    assert plan.step_bank.max() == 1
    # every chunk start is a recompute; frame changes are new_frame
    changes = np.flatnonzero(np.diff(plan.step_frame) != 0) + 1
    assert plan.step_recompute[changes].all()
    # bank flips within a frame recompute priorities
    bankflips = np.flatnonzero(
        (np.diff(plan.step_bank) != 0)
        & (np.diff(plan.step_frame) == 0)) + 1
    assert plan.step_recompute[bankflips].all()


def test_plan_movie_memoized():
    args = dict(n_frames=4, n_audio_ticks=10 ** 6, input_frame_rate=30.0,
                ticks_per_second=14700.0, every_n_video_frames=2,
                mode=VideoMode.DHGR, k=8)
    p1, n1 = encoder.plan_movie(**args)
    p2, n2 = encoder.plan_movie(**args)
    assert p1 is p2 and n1 == n2  # cache hit on identical scalar args
    # the shared arrays must be immutable so one caller can't corrupt
    # another's plan
    with pytest.raises(ValueError):
        p1.step_nvalid[0] = 99
    # distinct args miss the cache
    p3, _ = encoder.plan_movie(**{**args, "k": 16})
    assert p3 is not p1 and p3.k == 16


def test_plan_movie_hgr_no_bank_flips():
    plan, n_enc = encoder.plan_movie(
        n_frames=3, n_audio_ticks=1200, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=1,
        mode=VideoMode.HGR, k=4)
    assert plan.step_bank.max() == 0
    assert n_enc == 3
    rec = plan.step_recompute
    fr = plan.step_frame
    assert rec[0]
    changes = np.flatnonzero(np.diff(fr) != 0) + 1
    assert rec[changes].all()
    assert rec.sum() == len(changes) + 1


def test_plan_audio_limits_length():
    plan, _ = encoder.plan_movie(
        n_frames=100, n_audio_ticks=700, input_frame_rate=30.0,
        ticks_per_second=14700.0, every_n_video_frames=1,
        mode=VideoMode.DHGR, k=8)
    assert plan.n_ops == 700


# --- differential: host oracle vs XLA scan --------------------------------------

@pytest.mark.parametrize("mode,k,j", [
    (VideoMode.DHGR, 1, 1),
    (VideoMode.DHGR, 8, 1),
    (VideoMode.DHGR, 4, 2),  # multi-op-per-page mode
    (VideoMode.DHGR, 32, 8),  # the solo-latency frontier config
    (VideoMode.HGR, 4, 1),
    (VideoMode.HGR, 4, 3),
])
def test_host_vs_scan_differential(mode, k, j):
    dist = get_dist(mode)
    fmain, faux = random_frames(mode, n_frames=2, seed=3)
    plan, n_enc = encoder.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=2100.0 / 700 * 2,
        ticks_per_second=2100.0 * 2 / 700 * 350,  # => 350 ticks per frame
        every_n_video_frames=1, mode=mode, k=k, j=j)
    assert n_enc == 2

    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    ops_dev, fin_main, fin_aux = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=None)
    dev_ops = encoder.flatten_ops(np.asarray(ops_dev), plan)

    host_ops = encoder_host.encode_movie_host(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=None)

    assert dev_ops.shape == host_ops.shape == (plan.n_ops, 6)
    mismatch = np.nonzero((dev_ops != host_ops).any(axis=1))[0]
    assert mismatch.size == 0, (
        "first mismatch at op %d: device=%s host=%s" % (
            mismatch[0] if mismatch.size else -1,
            dev_ops[mismatch[:3]], host_ops[mismatch[:3]]))

    # final screen state matches the host too
    henc = encoder_host.HostEncoder(mode, dist, k=k, seed=None, j=j)
    lanes_np, bytes_np = np.asarray(lanes_tgt), np.asarray(bytes_tgt)
    for s in range(len(plan.step_frame)):
        f = int(plan.step_frame[s])
        b = int(plan.step_bank[s])
        if plan.step_recompute[s]:
            henc.recompute(lanes_np[f], b)
        henc.step(bytes_np[f, b], f, b, int(plan.step_nvalid[s]))
    assert np.array_equal(np.asarray(fin_main), henc.banks[0])
    if mode == VideoMode.DHGR:
        assert np.array_equal(np.asarray(fin_aux), henc.banks[1])


def test_scan_converges_on_constant_frame():
    """With a single constant target, enough opcodes, and a palette with no
    duplicate colours (IIGS), the encoder must converge: late opcodes become
    padding and the screen equals the target outside screen holes.

    (NTSC has two identical greys, so zero distance does not imply byte
    equality there - the reference documents the same caveat,
    reference video.py:192-207.)
    """
    mode = VideoMode.DHGR
    dist = get_dist(mode, Palette.IIGS)
    rng = np.random.RandomState(0)
    # sparse target: a few pages of content, rest zero
    fmain = np.zeros((1, 32, 256), dtype=np.uint8)
    faux = np.zeros((1, 32, 256), dtype=np.uint8)
    fmain[0, 4:7] = rng.randint(0, 0x80, size=(3, 256)).astype(np.uint8)
    faux[0, 4:7] = rng.randint(0, 0x80, size=(3, 256)).astype(np.uint8)
    fmain[0][screen.SCREEN_HOLES] = 0
    faux[0][screen.SCREEN_HOLES] = 0

    plan, _ = encoder.plan_movie(
        n_frames=1, n_audio_ticks=6000, input_frame_rate=1.0,
        ticks_per_second=6001.0, every_n_video_frames=1, mode=mode, k=8)
    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    ops_dev, fin_main, fin_aux = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=0)
    live = ~screen.SCREEN_HOLES
    assert np.array_equal(np.asarray(fin_main)[live],
                          fmain[0].astype(np.int32)[live])
    assert np.array_equal(np.asarray(fin_aux)[live],
                          faux[0].astype(np.int32)[live])
    # late ops are padding (page 32, offsets 0)
    flat = encoder.flatten_ops(np.asarray(ops_dev), plan)
    tail = flat[-50:]
    assert np.all(tail[:, 0] == 32)
    assert np.all(tail[:, 2:] == 0)


@pytest.mark.parametrize("raw_msb", [False, True])
def test_slab_body_matches_carried_pair(raw_msb):
    """The per-body active-bank slab rebuild (encoder.py slab_body, used
    when every chunk fits one scan body) is bit-identical to the carried
    both-bank pair it replaced - including on raw .BIN-style DHGR bytes
    with the palette MSB set, where the cost row index masks the unused
    bit (reference video.py:135-137)."""
    import jax

    mode = VideoMode.DHGR
    dist = get_dist(mode)
    rng = np.random.RandomState(5)
    n_frames = 4
    hi = 0x100 if raw_msb else 0x80
    fmain = rng.randint(0, hi, size=(n_frames, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, hi, size=(n_frames, 32, 256)).astype(np.uint8)
    plan, n_enc = encoder.plan_movie(
        n_frames=n_frames, n_audio_ticks=2000, input_frame_rate=29.4,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode,
        k=16, j=4)
    assert plan.chunk_steps < encoder.BODY_CAP  # body mode engages
    (sf, sb, sr, sn), _ = encoder.pad_plan_steps(plan)
    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    import jax.numpy as jnp
    args = (jnp.asarray(dist.store_cost), jnp.asarray(dist.sub),
            lanes_tgt, bytes_tgt, jnp.asarray(sf), jnp.asarray(sb),
            jnp.asarray(sr), jnp.asarray(sn), jax.random.PRNGKey(9))
    outs = {}
    for diag in ("", "carryslab"):
        scan = encoder._build_encode_scan(mode, plan.k, False, plan.j,
                                          plan.chunk_steps, diag=diag)
        outs[diag] = [np.asarray(o) for o in jax.jit(scan)(*args)]
    for got, want in zip(outs[""], outs["carryslab"]):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mode,seed,chunk,j", [
    (VideoMode.DHGR, None, 2, 1),
    (VideoMode.DHGR, 7, 3, 1),
    (VideoMode.DHGR, 7, 2, 4),  # multi-op mode through the chunked path
    (VideoMode.HGR, 7, 2, 1),
])
def test_chunked_matches_unchunked(mode, seed, chunk, j):
    """Single-pass chunked encode is bit-identical to the unchunked scan:
    nonces fold absolute step indices and each segment's first frame ranks
    candidates against the previous segment's last target."""
    dist = get_dist(mode)
    n_frames = 6
    fmain, faux = random_frames(mode, n_frames=n_frames, seed=11)
    plan, n_enc = encoder.plan_movie(
        n_frames=n_frames, n_audio_ticks=2400, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8,
        j=j)
    assert n_enc == n_frames

    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    ops_ref, main_ref, aux_ref = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=seed)
    flat_ref = encoder.flatten_ops(np.asarray(ops_ref), plan)

    ops_c, main_c, aux_c = encoder.encode_movie_chunked(
        dist, fmain, faux, plan, mode, seed=seed, chunk_frames=chunk)
    flat_c = encoder.flatten_ops(ops_c, plan)

    assert np.array_equal(flat_c, flat_ref)
    assert np.array_equal(main_c, np.asarray(main_ref))
    assert np.array_equal(aux_c, np.asarray(aux_ref))


def test_encode_stream_quality_and_vm():
    """Encode a short movie, check replay quality is finite and the emitted
    stream decodes cleanly on the player VM."""
    from iivision_tpu import quality
    from iivision_tpu.sim import PlayerVM
    from iivision_tpu.stream.emit_fast import emit_stream_fast

    mode = VideoMode.DHGR
    dist = get_dist(mode)
    fmain, faux = random_frames(mode, n_frames=2, seed=9)
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=1200, input_frame_rate=12.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)

    ops_dev, fin_m, fin_a = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=3)
    flat = encoder.flatten_ops(np.asarray(ops_dev), plan)
    assert flat.shape == (plan.n_ops, 6)

    rep = quality.replay_frame_errors(flat, plan, lanes_tgt, mode, dist)
    assert np.isfinite(rep.mean_error)
    data = emit_stream_fast(flat, np.zeros(plan.n_ops, np.int32), mode)
    res = PlayerVM().decode(data)
    assert res.ok, (res.error, res.error_pos)


def test_streaming_encode_bit_identical_and_buffering():
    """encode_movie_streaming must equal encode_movie bit-for-bit across
    segment boundaries, regardless of how the target stream is batched."""
    mode = VideoMode.DHGR
    dist = get_dist(mode)
    F = 11
    main, aux = random_frames(mode, F, seed=3)
    plan, n_enc = encoder.plan_movie(
        n_frames=F, n_audio_ticks=4500, input_frame_rate=36.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode,
        k=4, j=2)
    assert n_enc == F
    lanes_tgt, bytes_tgt = encoder.prepare_targets(main, aux, mode)
    ops_ref, m_ref, a_ref = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=5)
    flat_ref = encoder.flatten_ops(np.asarray(ops_ref), plan)

    for batch_sizes in [(3, 3, 3, 2), (1,) * 11, (11,), (5, 6)]:
        def gen():
            pos = 0
            for b in batch_sizes:
                yield main[pos:pos + b], aux[pos:pos + b]
                pos += b
        ops_s, m_s, a_s, tm, ta = encoder.encode_movie_streaming(
            dist, gen(), plan, mode, seed=5, chunk_frames=4)
        flat_s = encoder.flatten_ops(np.asarray(ops_s), plan)
        assert np.array_equal(flat_s, flat_ref), batch_sizes
        assert np.array_equal(m_s, np.asarray(m_ref))
        assert np.array_equal(a_s, np.asarray(a_ref))
        assert np.array_equal(tm, main) and np.array_equal(ta, aux)

    # a stream that ends short must raise, not truncate silently
    def short():
        yield main[:4], aux[:4]
    with pytest.raises(ValueError, match="short"):
        encoder.encode_movie_streaming(dist, short(), plan, mode,
                                       seed=5, chunk_frames=4)


# --- joint content optimization ---------------------------------------------------

@pytest.mark.parametrize("mode,k,j", [
    (VideoMode.DHGR, 8, 1),
    (VideoMode.DHGR, 4, 2),
    (VideoMode.HGR, 4, 1),
])
def test_joint_content_host_vs_scan_differential(mode, k, j):
    """--joint_content (the reference's 'Global optimization' future
    improvement): device scan and host oracle must stay bit-equal, and each
    op's modelled gain must be >= the default content rule's (the default
    choice is in the joint candidate set)."""
    dist = get_dist(mode)
    fmain, faux = random_frames(mode, n_frames=2, seed=5)
    plan, n_enc = encoder.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=2100.0 / 700 * 2,
        ticks_per_second=2100.0 * 2 / 700 * 350,
        every_n_video_frames=1, mode=mode, k=k, j=j)
    assert n_enc == 2

    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    ops_dev, fin_main, fin_aux = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=None, joint=True)
    dev_ops = encoder.flatten_ops(np.asarray(ops_dev), plan)

    host_ops = encoder_host.encode_movie_host(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=None, joint=True)

    mismatch = np.nonzero((dev_ops != host_ops).any(axis=1))[0]
    assert mismatch.size == 0, (
        "first mismatch at op %d: device=%s host=%s" % (
            mismatch[0] if mismatch.size else -1,
            dev_ops[mismatch[:3]], host_ops[mismatch[:3]]))

    # joint must actually diverge from the default rule somewhere (it is
    # allowed to emit non-target content bytes)
    dflt = encoder_host.encode_movie_host(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=None, joint=False)
    assert (dev_ops != dflt).any()
