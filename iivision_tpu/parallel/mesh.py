"""Device-mesh scale-out for batch transcoding.

The reference's only parallelism is a single frame-conversion worker thread
(reference transcoder/frame_grabber.py:66-130); transcode itself is strictly
sequential Python.  Here the whole-movie encode scan (encoder.py) is batched
with `vmap` and sharded over a `jax.sharding.Mesh` - movies are independent,
so data parallelism over the batch axis scales linearly across chips with
zero collectives on the hot path; the small distance tables (store-cost +
CIE2000 matrix) are replicated.

Edit-distance LUT *artifact generation* (ops/editdist.py) also shards: the
pair-matrix row blocks are independent (build_tables_sharded).
"""

import functools
from typing import Optional

import numpy as np

from iivision_tpu import encoder, screen
from iivision_tpu.video_mode import VideoMode


def make_mesh(n_devices: Optional[int] = None, axis: str = "movies"):
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.asarray(devices[:n]), (axis,))


def shard_batch(x, mesh, axis: str = "movies"):
    """Place a batch-leading array sharded over the mesh axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(x, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(x, NamedSharding(mesh, P()))


INGEST_CHUNK = 256  # frames per fully-parallel ingest step


@functools.lru_cache(None)
def _jitted_batch_ingest(mode: VideoMode, palette):
    """Jitted (B, F, H, W, 3) uint8 RGB -> (lanes_b, bytes_b) targets.

    Fuses the whole ingestion stage on device: Lanczos resize (two
    matmuls, ops/resize.py), ordered-dither quantization, screen-memory
    packing and masked-lane derivation.  Movies are flattened to one frame
    axis and processed in fully-parallel chunks of INGEST_CHUNK frames
    (lax.map over chunks), which bounds the per-pixel palette-score
    buffers (~450MB/chunk) without serializing per movie (a map over the
    movie axis makes each step too small to fill the device).
    """
    import jax
    import jax.numpy as jnp

    from iivision_tpu import frames as frames_mod
    from iivision_tpu.ops import dither as dither_mod
    from iivision_tpu.ops import resize as resize_mod

    def one_chunk(rgb):  # (C, H, W, 3) uint8
        if rgb.shape[1:3] != (frames_mod.TARGET_H, frames_mod.TARGET_W):
            rgb = resize_mod.resize_batch(
                rgb, frames_mod.TARGET_H, frames_mod.TARGET_W)
        if mode == VideoMode.DHGR:
            codes = dither_mod.quantize_ordered(rgb, palette)
            main, aux = dither_mod.dhgr_codes_to_memory(codes)
        else:
            main, aux = dither_mod.quantize_hgr(rgb, palette), None
        return encoder.prepare_targets(main, aux, mode)

    def f(rgb_b):  # (B, F, H, W, 3) uint8
        B, F = rgb_b.shape[:2]
        n = B * F
        flat = rgb_b.reshape((n,) + rgb_b.shape[2:])
        pad = (-n) % INGEST_CHUNK
        if pad:  # zero-pad to a whole chunk; padded outputs sliced away
            flat = jnp.pad(flat, ((0, pad),) + ((0, 0),) * (flat.ndim - 1))
        chunks = flat.reshape((-1, INGEST_CHUNK) + flat.shape[1:])
        lanes_c, bytes_c = jax.lax.map(one_chunk, chunks)
        lanes = lanes_c.reshape((-1,) + lanes_c.shape[2:])[:n]
        bytes_ = bytes_c.reshape((-1,) + bytes_c.shape[2:])[:n]
        return (lanes.reshape((B, F) + lanes.shape[1:]),
                bytes_.reshape((B, F) + bytes_.shape[1:]))

    return jax.jit(f)


def ingest_movies_batch(rgb_b, mode: VideoMode, palette, mesh=None):
    """Device-side batched ingestion for equal-length movies.

    rgb_b: (B, F, H, W, 3) uint8 source frames (device-resident or host).
    Returns (lanes_b (B,F,32,128,L), bytes_b (B,F,2,32,256)) device arrays,
    sharded over the mesh batch axis when a mesh is given.
    """
    if mesh is not None:
        rgb_b = shard_batch(rgb_b, mesh)
    return _jitted_batch_ingest(mode, palette)(rgb_b)


@functools.lru_cache(None)
def _jitted_batch_encode(mode: VideoMode, k: int, deterministic: bool,
                         j: int = 1, chunk_steps: int = 1,
                         joint: bool = False):
    import jax

    scan = encoder._build_encode_scan(mode, k, deterministic, j,
                                      chunk_steps, joint=joint)
    batched = jax.vmap(
        scan, in_axes=(None, None, 0, 0, None, None, None, None, 0))

    def batched_flat(*args):
        # flatten ops inside the compiled program: the dense 1-D layout
        # needs no extra device program at fetch time
        ops, main, aux = batched(*args)
        return ops.reshape(ops.shape[0], -1), main, aux

    return jax.jit(batched_flat)


def encode_movies_batch(dist, lanes_tgt_b, bytes_tgt_b,
                        plan: encoder.MoviePlan, mode: VideoMode,
                        seeds, mesh=None, joint: bool = False):
    """Encode a batch of equal-schedule movies, sharded over the mesh.

    lanes_tgt_b: (B, F, 32, 128, L); bytes_tgt_b: (B, F, 2, 32, 256);
    seeds: (B,) ints.  All movies share `plan` (same tick count and frame
    schedule - e.g. fixed-length clips); use encode_movies_mixed for
    mixed-length batches.
    Returns (ops (B, S*K*6) flat uint8 - see fetch_ops -, final main
    (B,32,256), final aux).
    """
    import jax
    import jax.numpy as jnp

    fn = _jitted_batch_encode(mode, plan.k, False, plan.j,
                              plan.chunk_steps, joint)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    store_cost = jnp.asarray(dist.store_cost)
    sub = jnp.asarray(dist.sub)
    # step-bucket padding: arbitrary clip lengths share compiled programs
    # (padded steps are nvalid=0 no-ops; fetch_ops_compact's static index
    # and flatten_ops both drop them)
    (sf, sb, sr, sn), _ = encoder.pad_plan_steps(plan)

    if mesh is not None:
        lanes_tgt_b = shard_batch(lanes_tgt_b, mesh)
        bytes_tgt_b = shard_batch(bytes_tgt_b, mesh)
        keys = shard_batch(keys, mesh)
        store_cost = replicate(store_cost, mesh)
        sub = replicate(sub, mesh)

    return fn(store_cost, sub, lanes_tgt_b, bytes_tgt_b,
              jnp.asarray(sf), jnp.asarray(sb),
              jnp.asarray(sr), jnp.asarray(sn), keys)


def encode_movies_mixed(dist, movies, mode: VideoMode,
                        input_frame_rate: float, ticks_per_second: float,
                        every_n_video_frames: int = 1, k: int = 8,
                        j: int = 1, seeds=None, mesh=None,
                        joint: bool = False):
    """Encode a batch of DIFFERENT-length movies in one vmapped scan.

    movies: list of (targets_main (F_i,32,256) u8, targets_aux or None,
    n_input_frames_i, n_audio_ticks_i) sharing the frame rate, tick rate,
    every_n and k.  Such movies have identical opcode schedules up to
    length, so all encode under one shared plan built from (max frames,
    max ticks) - dominating every movie in both ops and encoded frames -
    with video targets padded by repeating each movie's last frame; movie
    i's opcode stream is the first n_ops_i flattened ops (the scan is
    causal, so the padded tail cannot affect them).  Semantically movie i
    encodes exactly as if its audio were extended to the shared schedule's
    length while its video holds the last frame - bit-identical to that
    padded solo encode.

    Returns (flat_ops: list of (n_ops_i, 6) arrays, plan_max: MoviePlan,
    n_ops: list of int).
    """
    plans = [encoder.plan_movie(
        n_frames=nf, n_audio_ticks=nt, input_frame_rate=input_frame_rate,
        ticks_per_second=ticks_per_second,
        every_n_video_frames=every_n_video_frames, mode=mode, k=k, j=j)
        for _, _, nf, nt in movies]
    n_ops = [p.n_ops for p, _ in plans]
    # the shared plan must dominate every movie in BOTH ops and frames: the
    # max-ops movie can have fewer encoded frames than another movie (long
    # audio, short video), which would truncate that movie's real frames
    plan_max, n_enc_max = encoder.plan_movie(
        n_frames=max(nf for _, _, nf, _ in movies),
        n_audio_ticks=max(nt for _, _, _, nt in movies),
        input_frame_rate=input_frame_rate,
        ticks_per_second=ticks_per_second,
        every_n_video_frames=every_n_video_frames, mode=mode, k=k, j=j)
    assert plan_max.n_ops >= max(n_ops)
    assert all(n_enc_max >= ne for _, ne in plans)

    def pad_targets(t):
        t = np.asarray(t)
        if len(t) >= n_enc_max:
            return t[:n_enc_max]
        reps = np.repeat(t[-1:], n_enc_max - len(t), axis=0)
        return np.concatenate([t, reps], axis=0)

    has_aux = mode == VideoMode.DHGR
    mains = np.stack([pad_targets(m[0]) for m in movies])
    auxes = (np.stack([pad_targets(m[1]) for m in movies])
             if has_aux else None)
    B, F = mains.shape[:2]
    lanes, bytes_ = encoder.prepare_targets(
        mains.reshape(B * F, 32, 256),
        None if auxes is None else auxes.reshape(B * F, 32, 256), mode)
    lanes_b = lanes.reshape((B, F) + lanes.shape[1:])
    bytes_b = bytes_.reshape((B, F) + bytes_.shape[1:])

    if seeds is None:
        seeds = np.arange(B)
    ops_b, _, _ = encode_movies_batch(
        dist, lanes_b, bytes_b, plan_max, mode, seeds=seeds, mesh=mesh,
        joint=joint)
    ops_np = fetch_ops(ops_b, plan_max)
    flats = [encoder.flatten_ops(ops_np[i], plan_max)[:n_ops[i]]
             for i in range(B)]
    return flats, plan_max, n_ops


def fetch_ops(ops_dev, plan: encoder.MoviePlan) -> np.ndarray:
    """Transfer encoder ops to host and view as (..., S, K, 6).

    Accepts the flat (B, S*K*6) output of encode_movies_batch (preferred:
    the flatten already happened inside the compiled scan) or an unflattened
    (..., S, K, 6) tensor, which is flattened on device first (a dense
    layout for the device-to-host copy).
    """
    if ops_dev.ndim >= 3 and ops_dev.shape[-1] == encoder.OP_FIELDS:
        shape = ops_dev.shape
        flat = np.asarray(_jitted_flatten()(ops_dev))
        return flat.reshape(shape)
    flat = np.asarray(ops_dev)  # (B, S*K*J*6) from encode_movies_batch
    kj = plan.k * plan.j
    s = flat.shape[-1] // (kj * encoder.OP_FIELDS)
    return flat.reshape(flat.shape[:-1] + (s, kj, encoder.OP_FIELDS))


@functools.lru_cache(None)
def _jitted_flatten():
    import jax

    return jax.jit(lambda o: o.reshape(-1))


@functools.lru_cache(None)
def _jitted_compact(idx_bytes: bytes, n: int):
    import jax
    import jax.numpy as jnp

    idx = jnp.asarray(np.frombuffer(idx_bytes, np.int32))

    @jax.jit
    def f(ops_flat):  # (B, S*K*J*6) uint8
        o = ops_flat.reshape(ops_flat.shape[0], -1, encoder.OP_FIELDS)
        return jnp.take(o, idx, axis=1)  # static indices: one fused gather

    return f


def fetch_ops_compact(ops_dev, plan: encoder.MoviePlan) -> np.ndarray:
    """Transfer only the VALID ops to host: (B, n_ops, 6) uint8.

    The padding mask is static per plan (step_nvalid), so dropping the
    ~10-15% padding slots happens on device as one static-index gather
    before the transfer - the flatten_ops step on host becomes a no-op.
    """
    kj = plan.k * plan.j
    valid = (np.arange(kj)[None, :]
             < plan.step_nvalid[:, None]).reshape(-1)
    idx = np.flatnonzero(valid).astype(np.int32)
    assert len(idx) == plan.n_ops
    fn = _jitted_compact(idx.tobytes(), len(idx))
    return np.asarray(fn(ops_dev))


_FETCH_POOL = None
_FETCH_DRIVER = None


def _fetch_pool():
    global _FETCH_POOL
    if _FETCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _FETCH_POOL = ThreadPoolExecutor(4, thread_name_prefix="iiv-fetch")
    return _FETCH_POOL


def io_pool():
    """Shared 4-thread pool for host<->device transfers.

    device_put / np.asarray release the GIL while they copy, so a small
    thread pool overlaps transfers with host work in both directions
    (used by fetch_ops_parallel and the solo-movie upload overlap in
    movie.Movie.encode_ops)."""
    return _fetch_pool()


def fetch_ops_parallel(ops_dev, plan: encoder.MoviePlan,
                       compact: bool = True, streams: int = 4) -> np.ndarray:
    """Fetch batched ops over multiple concurrent host streams.

    The batch is sliced device-side along the movie axis and pulled by a
    small thread pool (the blocking transfer releases the GIL).  With
    compact=True the static valid-op gather runs on device first, so
    only n_ops x 6 bytes per movie are copied.  Returns (B, n_ops, 6)
    uint8 (compact) or the padded (B, S, K*J, 6) view (compact=False).
    """
    import jax

    if compact:
        kj = plan.k * plan.j
        valid = (np.arange(kj)[None, :]
                 < plan.step_nvalid[:, None]).reshape(-1)
        idx = np.flatnonzero(valid).astype(np.int32)
        dev = _jitted_compact(idx.tobytes(), len(idx))(ops_dev)
    else:
        dev = ops_dev
    B = dev.shape[0]
    streams = max(1, min(streams, B))
    bounds = np.linspace(0, B, streams + 1).astype(int)
    parts = [dev[b0:b1] for b0, b1 in zip(bounds[:-1], bounds[1:])
             if b1 > b0]
    jax.block_until_ready(parts)
    outs = list(_fetch_pool().map(np.asarray, parts))
    out = np.concatenate(outs, axis=0)
    if not compact:
        return fetch_ops(out, plan) if out.ndim == 2 else out
    return out


def fetch_ops_parallel_future(ops_dev, plan: encoder.MoviePlan,
                              compact: bool = True, streams: int = 4):
    """fetch_ops_parallel in a background thread; returns a Future.

    Start this BEFORE dispatching the next batch's programs, so the fetch
    owns its own thread (its blocking copy releases the GIL) while the
    main thread drives the next batch's compute.
    """
    global _FETCH_DRIVER
    if _FETCH_DRIVER is None:
        from concurrent.futures import ThreadPoolExecutor

        _FETCH_DRIVER = ThreadPoolExecutor(
            1, thread_name_prefix="iiv-fetch-drv")
    return _FETCH_DRIVER.submit(
        fetch_ops_parallel, ops_dev, plan, compact, streams)


def build_tables_sharded(mode: VideoMode, palette, mesh,
                         axis: str = "movies", n_rows: Optional[int] = None):
    """Edit-distance LUT generation sharded over the mesh (row blocks of the
    pair matrix are independent; no communication until output gather).

    n_rows limits the computation to the first n_rows source values per
    lane (testing/dry runs); None computes the full LUT.  Output matches
    the corresponding rows of editdist.build_tables exactly (same
    dp_distance_tile numerics, row-sharded over the mesh).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from iivision_tpu.ops import editdist

    spec = screen.spec_for_mode(mode)
    sub = jnp.asarray(editdist.substitute_matrix(palette).astype(np.float32))
    mats = []
    for lane in range(int(spec.N_LANES)):
        codes = jnp.asarray(
            editdist.lane_pixel_codes(mode, lane).astype(np.int32))
        src = codes if n_rows is None else codes[:n_rows]
        rows = jax.device_put(src, NamedSharding(mesh, P(axis, None)))
        cols = jax.device_put(codes, NamedSharding(mesh, P()))

        @jax.jit
        def one(rows, cols):
            return editdist.dp_distance_tile(rows, cols, sub).astype(
                jnp.uint16)

        mats.append(one(rows, cols).reshape(-1))
    return jnp.stack(mats)
