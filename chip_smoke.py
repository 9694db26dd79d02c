"""Smoke test of the transcoder on NVIDIA GPUs, through the entry points
users call.

    python chip_smoke.py [--seed N]               # phases 1-5 on one GPU
    python chip_smoke.py --four-cards [--seed N]  # phase 6 alone, 4 GPUs

Phases, at full size:
  1. solo: ``Movie(...).transcode()`` on a 30 s, 30 fps, 640x480 clip with
     a 14.7 kHz tone, DHGR/NTSC, every 2nd frame, k=32, j=10.  The stream
     must pass the player VM with the plan's opcode count.
  2. cli: ``iivision_tpu.cli.main`` on eight 10 s .npz clips with
     ``--output DIR --mesh auto``.  Every .a2m must pass the player VM.
  3. batch: ``parallel.mesh.ingest_movies_batch`` + ``encode_movies_batch``
     on 32 movies of 10 s at 280x192, k=16, j=4.  The last stream must pass
     the player VM, and the device audio levels may differ from the host
     path in fewer than 1e-3 of samples.
  4. exactness: the golden stream hash of tests/test_stream.py, the encoder
     against the host oracle (encoder_host) on a DHGR and an HGR movie, the
     live window store-cost tables against the shipped artifacts bit for
     bit, and the live yiq tables within YIQ_RTOL.
  5. tablegen: ``editdist.build_tables(DHGR, NTSC)``, sampled cells against
     the scalar Damerau-Levenshtein oracle; cold and warm seconds.
  6. four cards: sharded == unsharded for the batch encode, the
     mixed-length encode, device ingest and tablegen
     (``mesh_equivalence_checks``, which the CPU dry run in
     __graft_entry__.py shares).

Every phase prints its compile time (cold minus warm wall), its warm wall
time, the process's peak device memory so far and the realtime factor it
saw, beside the card's name and power limit.  Inputs are made from
``--seed``.  The last line of stdout is one JSON object naming the device.
With no GPU, or when a phase fails, the script exits non-zero and prints
no such line: there is no CPU fallback.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Tuple

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")  # see iivision_tpu

import numpy as np

GOLDEN_SHA256 = (
    "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc")
# The yiq store-cost values are fractional sums of products, computed at
# HIGHEST precision; XLA may order those sums differently per backend, so
# they agree to float32 rounding, not bit for bit.
YIQ_RTOL = 1e-3
TICKS = 14700  # the player's default audio rate (ops per second)


@dataclasses.dataclass(frozen=True)
class MeshSizes:
    """Shapes of the four sharded == unsharded checks."""
    movies: int  # batch size; a multiple of the device count
    k: int
    j: int
    batch_plan: dict  # plan_movie arguments of the equal-length batch
    mixed: Tuple[Tuple[int, int], ...]  # (input frames, ticks) per movie
    mixed_rates: Tuple[float, float]  # (input frame rate, ticks per second)
    ingest_frames: int
    ingest_hw: Tuple[int, int]
    tablegen_rows: Optional[int]  # rows per lane (None: the full table)

    @classmethod
    def full(cls, n_devices: int):
        return cls(
            movies=2 * n_devices, k=16, j=4,
            batch_plan=dict(n_frames=300, n_audio_ticks=10 * TICKS,
                            input_frame_rate=30.0,
                            ticks_per_second=float(TICKS),
                            every_n_video_frames=2),
            mixed=((300, 10 * TICKS), (150, 5 * TICKS), (240, 8 * TICKS),
                   (90, 3 * TICKS)) * (n_devices // 2),
            mixed_rates=(30.0, float(TICKS)),
            ingest_frames=60, ingest_hw=(192, 280), tablegen_rows=None)

    @classmethod
    def tiny(cls, n_devices: int):
        shapes = ((2, 700), (1, 400), (2, 500), (1, 650)) * (
            n_devices // 4 + 1)
        return cls(
            movies=n_devices, k=2, j=1,
            batch_plan=dict(n_frames=2, n_audio_ticks=64,
                            input_frame_rate=30.0,
                            ticks_per_second=30.0 * 33,
                            every_n_video_frames=1),
            mixed=shapes[:max(n_devices, 4)],
            mixed_rates=(TICKS / 350, float(TICKS)),
            ingest_frames=2, ingest_hw=(64, 80), tablegen_rows=16 * n_devices)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Phase sizes; the defaults are the full sizes users run."""
    solo_seconds: float = 30.0
    solo_hw: Tuple[int, int] = (480, 640)
    cli_clips: int = 8
    cli_seconds: float = 10.0
    cli_hw: Tuple[int, int] = (240, 320)
    batch_movies: int = 32
    batch_seconds: float = 10.0
    batch_hw: Tuple[int, int] = (192, 280)
    yiq_tables: bool = True
    tablegen_rows: Optional[int] = None  # None: the full table
    tablegen_samples: int = 64
    four_cards: MeshSizes = dataclasses.field(
        default_factory=lambda: MeshSizes.full(4))


class SmokeFailure(RuntimeError):
    """A phase's output was wrong."""


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# --- inputs from the seed ----------------------------------------------------

def synth_clip(seed: int, seconds: float, hw, fps: int = 30) -> np.ndarray:
    """(F, H, W, 3) uint8 clip: moving sinusoids over a seeded texture."""
    rng = np.random.default_rng(seed)
    h, w = hw
    n = int(seconds * fps)
    freq = rng.uniform(2.0, 9.0, 3).astype(np.float32)
    phase = rng.uniform(0.0, 2 * np.pi, 3).astype(np.float32)
    texture = rng.integers(-24, 25, (h, w, 3)).astype(np.float32)
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    out = np.empty((n, h, w, 3), np.uint8)
    for f in range(n):
        t = np.float32(f / fps)
        chans = [np.sin(freq[0] * (xx + 0.3 * t) + phase[0]),
                 np.sin(freq[1] * (yy + 0.2 * t) + phase[1]),
                 np.cos(freq[2] * (xx + yy + 0.1 * t) + phase[2])]
        img = 127.5 + 110.0 * np.stack(np.broadcast_arrays(*chans), -1) \
            + texture
        out[f] = np.clip(img, 0, 255)
    return out


def tone(seconds: float, rate: int = TICKS) -> np.ndarray:
    n = int(seconds * rate)
    return (np.sin(2 * np.pi * 440 * np.arange(n) / rate)
            * 16000).astype(np.float32)


# --- measurement helpers -----------------------------------------------------

def peak_bytes_in_use() -> Optional[int]:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _vm_check(data: bytes, n_ops: Optional[int], what: str):
    from iivision_tpu.sim import PlayerVM

    res = PlayerVM().decode(data)
    _check(res.ok, "%s: player VM rejected the stream: %s at %s"
           % (what, res.error, res.error_pos))
    if n_ops is not None:
        _check(res.n_ops == n_ops, "%s: VM saw %d ops, plan has %d"
               % (what, res.n_ops, n_ops))
    return res


# --- phase 1: solo movie -----------------------------------------------------

def phase_solo(sizes: Sizes, seed: int) -> dict:
    from iivision_tpu import audio as audio_mod
    from iivision_tpu.movie import Movie
    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode

    rgb = synth_clip(seed, sizes.solo_seconds, sizes.solo_hw)
    audio = tone(sizes.solo_seconds)
    walls = []
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "solo.a2m")
        for _ in range(2):  # cold (compiles), then warm
            t0 = time.perf_counter()
            stats = Movie(
                frames_source=rgb, frame_rate=30.0,
                audio_source=audio_mod.Audio(data=audio, rate=TICKS,
                                             bitrate=TICKS),
                every_n_video_frames=2, video_mode=VideoMode.DHGR,
                palette=Palette.NTSC, k=32, j=10).transcode(out)
            walls.append(time.perf_counter() - t0)
            with open(out, "rb") as f:
                _vm_check(f.read(), stats["n_ops"], "solo")
    return dict(cold_s=walls[0], warm_s=walls[1],
                movie_s=stats["movie_seconds"], n_ops=stats["n_ops"],
                encode_s=stats["encode_s"])


# --- phase 2: CLI batch ------------------------------------------------------

def phase_cli(sizes: Sizes, seed: int) -> dict:
    from iivision_tpu import cli

    walls, movie_s = [], 0.0
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(sizes.cli_clips):
            path = os.path.join(d, "clip%02d.npz" % i)
            np.savez(path, frames=synth_clip(seed + 1 + i, sizes.cli_seconds,
                                             sizes.cli_hw),
                     frame_rate=30.0)
            paths.append(path)
        out = os.path.join(d, "out")
        for _ in range(2):
            for name in os.listdir(d):  # decode + quantize again, not cached
                if ".iiv_" in name:
                    os.remove(os.path.join(d, name))
            t0 = time.perf_counter()
            cli.main(paths + ["--output", out, "--mesh", "auto"])
            walls.append(time.perf_counter() - t0)
        outs = sorted(os.listdir(out))
        _check(len(outs) == len(paths), "cli wrote %s" % outs)
        for name in outs:
            with open(os.path.join(out, name), "rb") as f:
                movie_s += _vm_check(f.read(), None,
                                     "cli " + name).playback_seconds
    return dict(cold_s=walls[0], warm_s=walls[1], movie_s=movie_s,
                n_streams=len(outs))


# --- phase 3: device batch ---------------------------------------------------

def phase_batch(sizes: Sizes, seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from iivision_tpu import audio as audio_mod, encoder
    from iivision_tpu.movie import get_distance
    from iivision_tpu.palettes import Palette
    from iivision_tpu.parallel import mesh as pmesh
    from iivision_tpu.stream.emit_fast import emit_stream_fast
    from iivision_tpu.video_mode import VideoMode

    mode, B = VideoMode.DHGR, sizes.batch_movies
    base = synth_clip(seed + 100, sizes.batch_seconds, sizes.batch_hw)
    # distinct content per movie: each is the base clip scrolled sideways;
    # every 2nd input frame is encoded
    rgb_b = np.stack([np.roll(base[::2], 7 * i, axis=2) for i in range(B)])
    wave = tone(sizes.batch_seconds)
    audio = audio_mod.Audio(data=wave, rate=TICKS, bitrate=TICKS)
    levels_host = np.asarray(audio.levels())
    plan, _ = encoder.plan_movie(
        n_frames=len(base), n_audio_ticks=len(levels_host),
        input_frame_rate=30.0, ticks_per_second=float(TICKS),
        every_n_video_frames=2, mode=mode, k=16, j=4)
    dist = get_distance(mode, Palette.NTSC)

    @jax.jit
    def audio_levels_device(x, norm):
        lv = jnp.trunc(x / 16384.0 * norm * 16).astype(jnp.int32)
        return jnp.clip(lv, -15, 16)

    def run():
        src = jax.device_put(rgb_b)
        lanes_b, bytes_b = pmesh.ingest_movies_batch(src, mode, Palette.NTSC)
        levels = np.asarray(audio_levels_device(jnp.asarray(wave),
                                                audio.normalization))
        ops_b, _, _ = pmesh.encode_movies_batch(
            dist, lanes_b, bytes_b, plan, mode, seeds=np.arange(B))
        flat = pmesh.fetch_ops_compact(ops_b, plan)
        levels = levels[:plan.n_ops]
        streams = [emit_stream_fast(flat[i], levels, mode) for i in range(B)]
        return streams, levels, (lanes_b, bytes_b)

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        streams, levels, targets = run()
        walls.append(time.perf_counter() - t0)
    mismatch = float((levels != levels_host[:plan.n_ops]).mean())
    _check(mismatch < 1e-3, "device audio levels differ from the host "
           "path in %.2e of samples" % mismatch)
    _vm_check(streams[-1], plan.n_ops, "batch")

    fn = pmesh._jitted_batch_encode(mode, plan.k, False, plan.j,
                                    plan.chunk_steps, False)
    (sf, sb, sr, sn), _ = encoder.pad_plan_steps(plan)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))
    mem = fn.lower(jnp.asarray(dist.store_cost), jnp.asarray(dist.sub),
                   *targets, sf, sb, sr, sn, keys).compile().memory_analysis()
    return dict(cold_s=walls[0], warm_s=walls[1],
                movie_s=B * plan.n_ops / TICKS, level_mismatch=mismatch,
                encode_memory=str(mem))


# --- phase 4: exactness ------------------------------------------------------

def golden_stream_sha256() -> str:
    """sha256 of the pinned movie's stream (tests/test_stream.py)."""
    from iivision_tpu import encoder
    from iivision_tpu.ops import distance
    from iivision_tpu.palettes import Palette
    from iivision_tpu.stream.emit_fast import emit_stream_fast
    from iivision_tpu.video_mode import VideoMode

    mode = VideoMode.DHGR
    dist = distance.ComputedDistance(mode, Palette.NTSC)
    rng = np.random.RandomState(123)
    fmain = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=1200, input_frame_rate=12.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
    lanes, bytes_ = encoder.prepare_targets(fmain, faux, mode)
    ops, _, _ = encoder.encode_movie(dist, lanes, bytes_, plan, mode,
                                     seed=None)
    flat = encoder.flatten_ops(np.asarray(ops), plan)
    levels = ((np.arange(plan.n_ops) % 32) - 15).astype(np.int32)
    return hashlib.sha256(emit_stream_fast(flat, levels, mode)).hexdigest()


def oracle_mismatches(mode, k: int, j: int) -> int:
    """Ops where the device encoder and the host oracle differ (seed=None)
    on the two-frame movie of tests/test_encoder.py, plus 1 if the final
    screens differ."""
    from iivision_tpu import encoder, encoder_host
    from iivision_tpu.ops import distance
    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode

    dist = distance.ComputedDistance(mode, Palette.NTSC)
    rng = np.random.RandomState(3)
    hi = 0x80 if mode == VideoMode.DHGR else 0x100
    fmain = rng.randint(0, hi, size=(2, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, hi, size=(2, 32, 256)).astype(np.uint8)
    faux = faux if mode == VideoMode.DHGR else None
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=6.0,
        ticks_per_second=2100.0, every_n_video_frames=1, mode=mode, k=k,
        j=j)
    lanes, bytes_ = encoder.prepare_targets(fmain, faux, mode)
    ops, fin_main, _ = encoder.encode_movie(dist, lanes, bytes_, plan,
                                            mode, seed=None)
    dev_ops = encoder.flatten_ops(np.asarray(ops), plan)
    henc = encoder_host.HostEncoder(mode, dist, k=k, seed=None, j=j)
    lanes_np, bytes_np = np.asarray(lanes), np.asarray(bytes_)
    host_ops = []
    for s in range(len(plan.step_frame)):
        f, b = int(plan.step_frame[s]), int(plan.step_bank[s])
        if plan.step_recompute[s]:
            henc.recompute(lanes_np[f], b)
        host_ops.extend(henc.step(bytes_np[f, b], f, b,
                                  int(plan.step_nvalid[s])))
    host_ops = np.asarray(host_ops, np.int32)
    _check(dev_ops.shape == host_ops.shape == (plan.n_ops, 6),
           "op shapes %s vs %s" % (dev_ops.shape, host_ops.shape))
    bad = int((dev_ops != host_ops).any(axis=1).sum())
    return bad + int(not np.array_equal(np.asarray(fin_main), henc.banks[0]))


def store_cost_vs_shipped(mode, palette, model: str) -> float:
    """Largest |live - shipped| / max(1, |shipped|) of a store-cost table
    built on the default device against its shipped artifact."""
    from iivision_tpu.ops import distance

    shipped = np.load(distance.store_cost_path(mode, palette, model))["cost"]
    live = np.asarray(distance._build_store_cost(mode, palette, model))
    _check(live.shape == shipped.shape, "%s table shape %s != %s"
           % (model, live.shape, shipped.shape))
    shipped = shipped.astype(np.float64)
    return float((np.abs(live - shipped) / np.maximum(1.0, np.abs(shipped)))
                 .max())


def phase_exactness(sizes: Sizes, seed: int) -> dict:
    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode

    t0 = time.perf_counter()
    got = golden_stream_sha256()
    _check(got == GOLDEN_SHA256, "golden stream hash %s" % got)
    for mode, k, j in ((VideoMode.DHGR, 32, 10), (VideoMode.HGR, 16, 4)):
        bad = oracle_mismatches(mode, k, j)
        _check(bad == 0, "%s k=%d j=%d: %d ops differ from the host oracle"
               % (mode.name, k, j, bad))
    out = {}
    tables = [(m, p, "window") for m in (VideoMode.DHGR, VideoMode.HGR)
              for p in (Palette.NTSC, Palette.IIGS)]
    if sizes.yiq_tables:
        tables += [(m, Palette.NTSC, "yiq")
                   for m in (VideoMode.DHGR, VideoMode.HGR)]
    for mode, pal, model in tables:
        err = store_cost_vs_shipped(mode, pal, model)
        tol = YIQ_RTOL if model == "yiq" else 0.0
        _check(err <= tol, "%s/%s/%s store cost off by %.3g (limit %g)"
               % (mode.name, pal.name, model, err, tol))
        out["%s_%s_%s_rel_err" % (mode.name, pal.name, model)] = err
    return dict(cold_s=time.perf_counter() - t0, **out)


# --- phase 5: tablegen -------------------------------------------------------

def phase_tablegen(sizes: Sizes, seed: int) -> dict:
    from iivision_tpu.ops import editdist
    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode

    mode, pal = VideoMode.DHGR, Palette.NTSC
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        tables = editdist.build_tables(mode, pal, n_rows=sizes.tablegen_rows)
        tables.block_until_ready()
        walls.append(time.perf_counter() - t0)
    n_lanes, cells = tables.shape
    n = len(editdist.lane_pixel_codes(mode, 0))
    rng = np.random.default_rng(seed)
    lane = rng.integers(0, n_lanes, sizes.tablegen_samples)
    cell = rng.integers(0, cells, sizes.tablegen_samples)
    got = np.asarray(tables[lane, cell])
    sub = editdist.substitute_matrix(pal)
    for ln, c, g in zip(lane, cell, got):
        codes = editdist.lane_pixel_codes(mode, int(ln))
        want = editdist.dam_lev_scalar(codes[c // n], codes[c % n], sub)
        _check(g == want, "table[%d, %d] = %d, oracle %s" % (ln, c, g, want))
    return dict(cold_s=walls[0], warm_s=walls[1],
                pairs_per_s=n_lanes * cells / walls[1])


# --- phase 6: four cards -----------------------------------------------------

def _random_targets(rng, mode, n_frames):
    from iivision_tpu.video_mode import VideoMode

    hi = 0x80 if mode == VideoMode.DHGR else 0x100
    return (rng.randint(0, hi, size=(n_frames, 32, 256)).astype(np.uint8),
            rng.randint(0, hi, size=(n_frames, 32, 256)).astype(np.uint8))


def mesh_equivalence_checks(n_devices: int, sizes: MeshSizes,
                            seed: int = 7) -> dict:
    """Sharded == unsharded on an n-device mesh: tablegen, equal-length
    batch encode, mixed-length batch encode (against a padded solo
    encode) and device ingest.  Raises SmokeFailure on a mismatch."""
    from iivision_tpu import encoder
    from iivision_tpu.ops import distance, editdist
    from iivision_tpu.palettes import Palette
    from iivision_tpu.parallel import mesh as pmesh
    from iivision_tpu.video_mode import VideoMode

    mode, pal = VideoMode.DHGR, Palette.NTSC
    mesh = pmesh.make_mesh(n_devices)
    rng = np.random.RandomState(seed)
    dist = distance.ComputedDistance(mode, pal)

    # 1. tablegen, row-sharded over the mesh
    rows = sizes.tablegen_rows
    sharded = np.asarray(pmesh.build_tables_sharded(mode, pal, mesh,
                                                    n_rows=rows))
    _check(np.array_equal(sharded, np.asarray(editdist.build_tables(
        mode, pal, n_rows=rows))), "sharded tablegen != unsharded")

    # 2. equal-length batch encode, movies sharded over the mesh
    plan, n_enc = encoder.plan_movie(mode=mode, k=sizes.k, j=sizes.j,
                                     **sizes.batch_plan)
    fmain, faux = _random_targets(rng, mode, n_enc)
    lanes, bytes_ = encoder.prepare_targets(fmain, faux, mode)
    B = sizes.movies
    lanes_b = np.broadcast_to(np.asarray(lanes), (B,) + lanes.shape).copy()
    bytes_b = np.broadcast_to(np.asarray(bytes_), (B,) + bytes_.shape).copy()
    ops_sh, _, _ = pmesh.encode_movies_batch(
        dist, lanes_b, bytes_b, plan, mode, seeds=np.arange(B), mesh=mesh)
    ops_un, _, _ = pmesh.encode_movies_batch(
        dist, lanes_b, bytes_b, plan, mode, seeds=np.arange(B), mesh=None)
    _check(np.array_equal(np.asarray(ops_sh), np.asarray(ops_un)),
           "mesh-sharded encode != single-device encode")

    # 3. mixed-length batch on the mesh == padded solo encode of movie 1
    fps, tps = sizes.mixed_rates
    every_n = sizes.batch_plan["every_n_video_frames"]
    movies = []
    for nf, nt in sizes.mixed:
        n_enc_i = encoder.plan_movie(
            n_frames=nf, n_audio_ticks=nt, input_frame_rate=fps,
            ticks_per_second=tps, every_n_video_frames=every_n, mode=mode,
            k=sizes.k, j=sizes.j)[1]
        movies.append(_random_targets(rng, mode, n_enc_i) + (nf, nt))
    flats, _, n_ops = pmesh.encode_movies_mixed(
        dist, movies, mode, input_frame_rate=fps, ticks_per_second=tps,
        every_n_video_frames=every_n, k=sizes.k, j=sizes.j, mesh=mesh)
    _check([len(f) for f in flats] == n_ops, "mixed-length op counts")
    flats_solo, _, _ = pmesh.encode_movies_mixed(
        dist, [movies[1], movies[0]], mode, input_frame_rate=fps,
        ticks_per_second=tps, every_n_video_frames=every_n, k=sizes.k,
        j=sizes.j, seeds=np.asarray([1, 0]), mesh=None)
    _check(np.array_equal(flats[1], flats_solo[0]),
           "mixed-length sharded stream != solo padded encode")

    # 4. device ingest (resize, dither, packing, lanes), batch-sharded
    h, w = sizes.ingest_hw
    rgb_b = rng.randint(0, 256, size=(B, sizes.ingest_frames, h, w, 3)
                        ).astype(np.uint8)
    got = pmesh.ingest_movies_batch(rgb_b, mode, pal, mesh=mesh)
    want = pmesh.ingest_movies_batch(rgb_b, mode, pal, mesh=None)
    for g, x, what in zip(got, want, ("lanes", "bytes")):
        _check(np.array_equal(np.asarray(g), np.asarray(x)),
               "mesh-sharded ingest %s != single-device ingest" % what)
    return dict(mesh=str(mesh.shape), movies=B, mixed_n_ops=n_ops,
                tablegen_rows=rows, ingest_batch=rgb_b.shape)


def phase_four_cards(sizes: Sizes, seed: int) -> dict:
    t0 = time.perf_counter()
    out = mesh_equivalence_checks(4, sizes.four_cards, seed)
    return dict(cold_s=time.perf_counter() - t0, **out)


# --- main ------------------------------------------------------------------

PHASES = (("solo", phase_solo), ("cli", phase_cli), ("batch", phase_batch),
          ("exactness", phase_exactness), ("tablegen", phase_tablegen))
FOUR_CARDS = (("four_cards", phase_four_cards),)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of every card, one per
    line (a child that stays off JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def report(name: str, card: str, rec: dict) -> str:
    """One phase's line: compile and warm time, peak memory, realtime."""
    cold, warm = rec.pop("cold_s"), rec.pop("warm_s", None)
    movie_s = rec.pop("movie_s", None)
    fields = {
        "phase": name, "card": card,
        "compile_s": None if warm is None else round(cold - warm, 3),
        "cold_s": round(cold, 3),
        "warm_s": None if warm is None else round(warm, 3),
        "peak_bytes_in_use": peak_bytes_in_use(),
        "realtime_x": (None if movie_s is None or warm is None
                       else round(movie_s / warm, 2)),
    }
    fields.update(rec)
    return json.dumps(fields, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded == unsharded phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print("chip_smoke: needs an NVIDIA GPU; JAX found %r devices"
              % devices[0].platform, file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print("chip_smoke: needs %d GPUs, JAX found %d"
              % (want, len(devices)), file=sys.stderr)
        return 2
    cards = card_line()
    print("gpu:", cards.replace("\n", " | "), flush=True)
    card = cards.splitlines()[0]
    for name, fn in FOUR_CARDS if args.four_cards else PHASES:
        print(report(name, card, fn(Sizes(), args.seed)), flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
