"""Full benchmark suite: the five BASELINE.json configs + a K quality sweep.

Runs in one process on an NVIDIA GPU and prints one JSON line per config
to stdout, each naming the device (bench.py remains the single-headline
benchmark).  With no GPU, or when any stage raises, it exits non-zero.

Configs (from /root/repo/BASELINE.json):
  1. HGR NTSC, 10s clip, video-only (silent stream)
  2. HGR + 14.7kHz 5-bit audio
  3. DHGR NTSC with MAIN/AUX interleaving
  4. DHGR IIGS palette at --audio_bitrate 22500 (//gs 2.8MHz profile)
  5. batch of 10 movies + full edit-distance LUT regeneration
"""

import json
import os
import sys
import tempfile
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")  # see bench.py

import numpy as np

from bench import require_gpu, synth_clip

BASELINE_REALTIME_X = 0.2
DEVICE = {}  # filled by main(): the device record of every line
WORK = None  # main()'s scratch directory for streams and inputs


def emit(rec):
    print(json.dumps({**rec, "device": DEVICE}), flush=True)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def tone(seconds, bitrate):
    n = int(seconds * bitrate)
    return (np.sin(2 * np.pi * 440 * np.arange(n) / bitrate)
            * 16000).astype(np.float32)


def run_config(name, mode, palette, bitrate, silent, dists, k=16,
               seconds=10.0, colour_model="window", replay_bases=None):
    """One Movie config: warm-up compile, measured transcode, VM
    validation, replay scoring.

    colour_model selects the distance basis the ENCODER optimises;
    replay_bases maps metric-name suffixes to distance models the stream
    is SCORED under (default: {"": the encoding basis}; a None value
    means "the encoding basis" - avoids building it twice).
    """
    from iivision_tpu import audio as audio_mod, encoder, quality
    from iivision_tpu.movie import Movie, get_distance
    from iivision_tpu.sim import PlayerVM

    if colour_model == "window":
        dist = dists[(mode, palette)]
    else:
        dist = get_distance(mode, palette, colour_model)
        dist.store_cost.block_until_ready()
    if replay_bases is None:
        replay_bases = {"": dist}
    replay_bases = {sfx: (dist if d is None else d)
                    for sfx, d in replay_bases.items()}

    rgb = synth_clip(seconds=seconds)
    if silent:
        aud = audio_mod.Audio(data=np.zeros(int(seconds * bitrate) + 1,
                                            np.float32),
                              rate=bitrate, bitrate=bitrate,
                              normalization=1.0)
    else:
        aud = audio_mod.Audio(data=tone(seconds, bitrate), rate=bitrate,
                              bitrate=bitrate)

    def build():
        return Movie(frames_source=rgb, audio_source=aud,
                     every_n_video_frames=2, video_mode=mode,
                     palette=palette, k=k, j=4, colour_model=colour_model,
                     dist=dist)

    def replay(m, flat, lanes_tgt):
        return {sfx: quality.replay_frame_errors(
            flat, m.plan, lanes_tgt, mode, d)
            for sfx, d in replay_bases.items()}

    path = os.path.join(WORK, "cfg.a2m")
    m = build()
    m.transcode(path)  # compile
    t0 = time.time()
    m = build()
    stats = m.transcode(path)
    wall = time.time() - t0
    rt = stats["movie_seconds"] / wall

    data = open(path, "rb").read()
    res = PlayerVM().decode(data)
    assert res.ok, (name, res.error, res.error_pos)
    assert res.n_ops == stats["n_ops"]

    flat, _ = m.encode_ops()
    lanes_tgt, _ = encoder.prepare_targets(
        m.frames.targets_main, m.frames.targets_aux, mode)
    reps = replay(m, flat, lanes_tgt)

    out = {
        "config": name,
        "realtime_x": round(rt, 2),
        "vs_baseline": round(rt / BASELINE_REALTIME_X, 1),
        "n_ops": stats["n_ops"],
        "stream_bytes": len(data),
        "playback_s": round(res.playback_seconds, 2),
    }
    for sfx, rep in reps.items():
        out["mean_error" + sfx] = round(rep.mean_error, 2)
        out["final_error" + sfx] = round(rep.final_error, 2)
    emit(out)
    return out


def run_yiq_config(dists):
    """DHGR NTSC with the NTSC-composite YIQ distance basis (the repo's
    flagship beyond-reference feature), scored under BOTH metric bases."""
    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode

    mode, palette = VideoMode.DHGR, Palette.NTSC
    return run_config(
        "dhgr_ntsc_yiq", mode, palette, 14700, False, dists,
        colour_model="yiq",
        replay_bases={"_yiq": None,  # = the encoding (yiq) basis
                      "_window": dists[(mode, palette)]})


def cli_batch_soak(n_inputs=16):
    """Production entry point at realistic scale: 16 mixed-length .npz
    frame files -> one CLI batch invocation with per-movie --stats_json ->
    every output validated by the player VM."""
    import glob

    from iivision_tpu import cli
    from iivision_tpu.sim import PlayerVM

    workdir = os.path.join(WORK, "cli_batch")
    os.makedirs(workdir)
    paths = [os.path.join(workdir, "in_%02d.npz" % i)
             for i in range(n_inputs)]
    rng = np.random.RandomState(0)
    base = synth_clip(seconds=10.0)
    for i, path in enumerate(paths):
        # mixed lengths 4..10s, distinct content per movie
        f = int((4.0 + 6.0 * (i / max(n_inputs - 1, 1))) * 30)
        roll = int(rng.randint(0, 280))
        frames = np.stack([np.roll(base[t % len(base)], roll + 3 * t,
                                   axis=1) for t in range(f)])
        np.savez(path, frames=frames, frame_rate=30.0)
    t0 = time.time()
    cli.main(paths + ["--output", workdir, "--video_mode", "DHGR",
                      "--palette", "NTSC", "--k", "16", "--j", "4",
                      "--stats_json", os.path.join(workdir, "stats.json")])
    wall = time.time() - t0
    outs = sorted(glob.glob(os.path.join(workdir, "*.a2m")))
    assert len(outs) == n_inputs, outs
    vm = PlayerVM()
    total_secs = 0.0
    for p in outs:
        res = vm.decode(open(p, "rb").read())
        assert res.ok, (p, res.error, res.error_pos)
        total_secs += res.playback_seconds
    stats_path = os.path.join(workdir, "stats.json")
    n_stats = 0
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            n_stats = len(json.load(f))
    emit({
        "config": "cli_batch16",
        "n_inputs": n_inputs,
        "movie_seconds_total": round(total_secs, 1),
        "wall_s": round(wall, 2),
        "batch_realtime_x": round(total_secs / wall, 2),
        "per_movie_stats": n_stats,
        "all_vm_valid": True,
    })


def k_sweep(dists):
    from iivision_tpu import audio as audio_mod, encoder, quality
    from iivision_tpu.movie import Movie
    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode

    rgb = synth_clip(seconds=5.0)
    aud = audio_mod.Audio(data=tone(5.0, 14700), rate=14700, bitrate=14700)
    for k, j in ((1, 1), (8, 1), (32, 1), (16, 4), (16, 8), (32, 4),
                 (32, 8)):
        m = Movie(frames_source=rgb, audio_source=aud,
                  every_n_video_frames=2, video_mode=VideoMode.DHGR,
                  palette=Palette.NTSC, k=k, j=j,
                  dist=dists[(VideoMode.DHGR, Palette.NTSC)])
        m.encode_ops()  # compile
        t0 = time.time()
        m2 = Movie(frames_source=rgb, audio_source=aud,
                   every_n_video_frames=2, video_mode=VideoMode.DHGR,
                   palette=Palette.NTSC, k=k, j=j,
                   dist=dists[(VideoMode.DHGR, Palette.NTSC)])
        flat, _ = m2.encode_ops()
        enc_wall = time.time() - t0
        lanes_tgt, _ = encoder.prepare_targets(
            m2.frames.targets_main, m2.frames.targets_aux, VideoMode.DHGR)
        rep = quality.replay_frame_errors(flat, m2.plan, lanes_tgt,
                                          VideoMode.DHGR, m2.dist)
        emit({
            "config": "k_sweep", "k": k, "j": j,
            "encode_realtime_x": round(5.0 / enc_wall, 2),
            "mean_error": round(rep.mean_error, 2),
            "final_error": round(rep.final_error, 2),
        })


def main():
    global WORK
    DEVICE.update(require_gpu())
    WORK = tempfile.mkdtemp(prefix="iivision_bench_configs_")

    import jax

    from iivision_tpu.movie import get_distance
    from iivision_tpu.ops import editdist
    from iivision_tpu.palettes import Palette
    from iivision_tpu.parallel import mesh as pmesh
    from iivision_tpu.stream.emit_fast import emit_stream_fast
    from iivision_tpu.video_mode import VideoMode
    import jax.numpy as jnp
    from iivision_tpu import audio as audio_mod, encoder

    log("device:", DEVICE)
    dists = {}
    for mode, pal in [(VideoMode.HGR, Palette.NTSC),
                      (VideoMode.DHGR, Palette.NTSC),
                      (VideoMode.DHGR, Palette.IIGS)]:
        t0 = time.time()
        dists[(mode, pal)] = get_distance(mode, pal)
        dists[(mode, pal)].store_cost.block_until_ready()
        log("distance model %s/%s: %.1fs" % (mode.name, pal.name,
                                             time.time() - t0))

    run_config("hgr_ntsc_video_only", VideoMode.HGR, Palette.NTSC,
               14700, True, dists)
    run_config("hgr_ntsc_audio", VideoMode.HGR, Palette.NTSC,
               14700, False, dists)
    run_config("dhgr_ntsc_audio", VideoMode.DHGR, Palette.NTSC,
               14700, False, dists)
    run_config("dhgr_iigs_22500", VideoMode.DHGR, Palette.IIGS,
               22500, False, dists)
    run_yiq_config(dists)
    cli_batch_soak()

    # 5. batch of 10 movies + LUT regeneration
    t0 = time.time()
    tables = editdist.build_tables(VideoMode.DHGR, Palette.NTSC)
    tables.block_until_ready()
    t_tables = time.time() - t0
    del tables

    # HGR LUT artifact gen at full scale: 2 lanes x 2^14 x 2^14 pairs,
    # 1 GiB raw uint16 (reference screen.py:617) - the case the reference's
    # 90-minute run struggles with most
    t0 = time.time()
    tables_hgr = editdist.build_tables(VideoMode.HGR, Palette.NTSC)
    tables_hgr.block_until_ready()
    t_tables_hgr = time.time() - t0
    del tables_hgr
    emit({
        "config": "hgr_tablegen",
        "tablegen_s": round(t_tables_hgr, 1),
        "raw_bytes": 2 * (1 << 28),
        "tablegen_vs_baseline_min": round(90 * 60 / t_tables_hgr, 1),
    })

    rgb = synth_clip(seconds=10.0)
    aud = audio_mod.Audio(data=tone(10.0, 14700), rate=14700, bitrate=14700)
    from iivision_tpu.movie import Movie
    m = Movie(frames_source=rgb, audio_source=aud, every_n_video_frames=2,
              video_mode=VideoMode.DHGR, palette=Palette.NTSC, k=16, j=4,
              dist=dists[(VideoMode.DHGR, Palette.NTSC)])
    m.encode_ops()  # compile + plan
    B = 10
    lanes_tgt, bytes_tgt = encoder.prepare_targets(
        m.frames.targets_main, m.frames.targets_aux, VideoMode.DHGR)
    lanes_b = jnp.broadcast_to(lanes_tgt, (B,) + lanes_tgt.shape)
    bytes_b = jnp.broadcast_to(bytes_tgt, (B,) + bytes_tgt.shape)
    levels = np.asarray(m.audio.levels())[:m.plan.n_ops]
    d = dists[(VideoMode.DHGR, Palette.NTSC)]
    r = pmesh.encode_movies_batch(d, lanes_b, bytes_b, m.plan,
                                  VideoMode.DHGR, np.arange(B))
    jax.tree.map(lambda x: x.block_until_ready(), r)  # compile
    t0 = time.time()
    ops_b, _, _ = pmesh.encode_movies_batch(d, lanes_b, bytes_b,
                                            m.plan, VideoMode.DHGR,
                                            np.arange(1, B + 1))
    ops_np = pmesh.fetch_ops(ops_b, m.plan)
    streams = [emit_stream_fast(encoder.flatten_ops(ops_np[i], m.plan),
                                levels, VideoMode.DHGR)
               for i in range(B)]
    wall = time.time() - t0
    emit({
        "config": "batch10_plus_tablegen",
        "batch_realtime_x": round(B * 10.0 / wall, 2),
        "tablegen_s": round(t_tables, 1),
        "tablegen_vs_baseline_min": round(90 * 60 / t_tables, 1),
    })

    # HGR batched transcode at scale (same B=10 shape as the DHGR row)
    mh = Movie(frames_source=rgb, audio_source=aud, every_n_video_frames=2,
               video_mode=VideoMode.HGR, palette=Palette.NTSC, k=16, j=4,
               dist=dists[(VideoMode.HGR, Palette.NTSC)])
    mh.encode_ops()  # compile + plan
    lanes_h, bytes_h = encoder.prepare_targets(
        mh.frames.targets_main, None, VideoMode.HGR)
    lanes_hb = jnp.broadcast_to(lanes_h, (B,) + lanes_h.shape)
    bytes_hb = jnp.broadcast_to(bytes_h, (B,) + bytes_h.shape)
    dh = dists[(VideoMode.HGR, Palette.NTSC)]
    r = pmesh.encode_movies_batch(dh, lanes_hb, bytes_hb, mh.plan,
                                  VideoMode.HGR, np.arange(B))
    jax.tree.map(lambda x: x.block_until_ready(), r)  # compile
    levels_h = np.asarray(mh.audio.levels())[:mh.plan.n_ops]
    t0 = time.time()
    ops_b, _, _ = pmesh.encode_movies_batch(dh, lanes_hb, bytes_hb,
                                            mh.plan, VideoMode.HGR,
                                            np.arange(1, B + 1))
    ops_np = pmesh.fetch_ops(ops_b, mh.plan)
    streams = [emit_stream_fast(encoder.flatten_ops(ops_np[i], mh.plan),
                                levels_h, VideoMode.HGR)
               for i in range(B)]
    wall = time.time() - t0
    from iivision_tpu.sim import PlayerVM
    res_h = PlayerVM().decode(streams[-1])
    assert res_h.ok, res_h.error
    emit({
        "config": "hgr_batch10",
        "batch_realtime_x": round(B * 10.0 / wall, 2),
    })

    k_sweep(dists)


if __name__ == "__main__":
    main()
