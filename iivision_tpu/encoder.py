"""Movie encoder: the whole transcoder inner loop as one XLA scan.

The reference encodes each frame with a Python heapq greedy loop that pops one
(page, offset) at a time and mutates a packed screen model per store
(reference transcoder/video.py:95-251) - inherently sequential and the reason
transcode runs 5-10x slower than realtime on CPU (reference README.md:131).

Accelerator redesign, three layers:

1. Page parallelism.  Screen pages are independent - a packed column never
   spans pages (reference screen.py:207-226 zeroes halos at page
   boundaries) - so up to 32 opcodes (one per page) are selected and applied
   per scan step with results identical to running the same per-page greedy
   choices sequentially.  A whole movie - every frame and 2KB bank flip - is
   ONE XLA program; batches of movies vmap over it and shard over meshes.

2. Gather-free hot path.  Random gathers from large tables are the slow
   access pattern on an accelerator, so neither the reference's 512MB
   edit-distance LUT nor any per-step table lookup survives here.
   Page/offset selection and all state updates are one-hot contractions
   and dense masked writes.

3. Amortised distance work.  Store costs depend only on (target lane
   window, content): a small store-cost table (ops/distance.py).  Each
   scan body gathers the active bank's full cost slab
   sc[page, offset, content] (contiguous-row gathers from the small
   table; when chunks span several bodies a both-bank pair is carried in
   state instead); every step then ranks companion offsets for its (page,
   content) pairs against the LIVE diff with two one-hot contractions
   + three masked argmaxes - the same per-op companion semantics as the
   reference's compute_delta_page (reference video.py:275-301,
   screen.py:525-547), with zero random gathers.  The per-chunk diff
   recompute runs the Damerau-Levenshtein diagonal DP on the fly.

Scheduling semantics mirrored from the reference encode loop (reference
transcoder/movie.py:56-111):
  - one opcode per audio tick; frame f is pulled at the first tick
    >= ticks_per_frame * f; every_n-th pulled frame becomes the new target;
  - diff weights + update priorities are recomputed at every encoded-frame
    start and (DHGR) at every 2KB bank flip (reference movie.py:94-102);
  - when a page has no work the opcode is the reference's padding op: store
    target[0,0] at offset 0 of page 32, NOT applied to the encoder's screen
    model (reference video.py:248-251 yields padding without apply);
  - priorities accumulate across frames and are cleared where a new frame's
    diff is zero (reference video.py:113-117).

Documented divergences from the reference greedy (shared with the host
oracle in encoder_host.py): priorities are arrays (argmax always sees
current values, unlike the stale-able heap); tie-breaks are seeded (pages
and primary offsets) or lowest-index (companions); the bank's diff
weights refresh at chunk starts rather than per op; and all 3 companion
slots carry real offsets (the reference stops at 2 companions and pads
the 4th slot with the primary offset, video.py:180-185 — a duplicate
store that wastes a quarter of the opcode's video bandwidth).

Parallel-selection knobs: each scan step selects K pages by priority and
emits J sequential sub-ops per page (K*J opcodes/step).  K=1, J=1 is the
strict greedy order; K=16/J=4 both encodes faster AND scores lower
replay error than K=32/J=1 (concentrating ops on the
busiest pages approximates the greedy order more closely).
"""

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from iivision_tpu import screen
from iivision_tpu.ops import distance
from iivision_tpu.stream import opcodes as ops_mod
from iivision_tpu.video_mode import VideoMode

OP_FIELDS = 6  # per-op record: [page, content, o0, o1, o2, o3]
import os as _os
_SCAN_UNROLL = int(_os.environ.get("IIVISION_SCAN_UNROLL", "1"))
BODY_CAP = 8  # max plan steps unrolled per scan body: bodies tile chunks
# (a chunk shorter than the cap gets exactly one body), bounding compile
# time for small-K configs whose chunks span tens of steps


# --- host-side movie planning -------------------------------------------------

@dataclass
class MoviePlan:
    """Static per-step schedule driving the encoder scan (all numpy).

    Steps are laid out chunk-major: every (frame, bank) chunk spans exactly
    `chunk_steps` consecutive steps (tail steps padded with nvalid=0), and
    step_recompute is True exactly on each chunk's first step."""
    n_ops: int
    k: int  # pages per step
    j: int  # ops per page per step (ops/step = k*j)
    chunk_steps: int  # scan steps per (frame, bank) chunk (uniform)
    step_frame: np.ndarray  # (S,) int32: index into the stacked targets
    step_bank: np.ndarray  # (S,) int32: 0=main, 1=aux
    step_recompute: np.ndarray  # (S,) bool: recompute diff+priority
    step_nvalid: np.ndarray  # (S,) int32: number of real ops in this step
    op_tick_index: np.ndarray  # (n_ops,) int32: audio tick of each opcode


def plan_movie(
        n_frames: int,
        n_audio_ticks: int,
        input_frame_rate: float,
        ticks_per_second: float,
        every_n_video_frames: int,
        mode: VideoMode,
        k: int = 8,
        j: int = 1,
) -> Tuple[MoviePlan, int]:
    """Plan the opcode schedule for a movie (host, pure numpy).

    Derives, for every emitted opcode, which encoded frame is the target and
    which memory bank it stores to, then chunks runs of (frame, bank) into
    scan steps of K opcodes with a recompute flag on each chunk's first step.

    Pure in its scalar arguments, so results are memoized (the chunk-major
    layout loop costs ~15ms for a 10s movie - real money on the solo
    latency path); the returned arrays are marked read-only.
    """
    return _plan_movie_cached(n_frames, n_audio_ticks,
                              float(input_frame_rate),
                              float(ticks_per_second),
                              every_n_video_frames, mode, k, j)


@functools.lru_cache(maxsize=256)
def _plan_movie_cached(
        n_frames: int,
        n_audio_ticks: int,
        input_frame_rate: float,
        ticks_per_second: float,
        every_n_video_frames: int,
        mode: VideoMode,
        k: int,
        j: int,
) -> Tuple[MoviePlan, int]:
    tpf = ticks_per_second / input_frame_rate
    # The movie ends when the (n_frames+1)-th frame pull raises StopIteration.
    # Reference semantics (video.py:67 with frame_number starting at 0): pull
    # f happens at the first tick >= tpf*(f-1), so the terminating pull is at
    # ceil(tpf*n_frames) and that tick emits no opcode.
    end_tick = int(np.ceil(tpf * n_frames))
    n_ops = int(min(n_audio_ticks, end_tick - 1))
    if n_ops <= 0:
        raise ValueError("Empty movie: no opcodes to emit")

    ticks = np.arange(1, n_ops + 1)
    pulled = np.minimum(np.floor(ticks / tpf).astype(np.int64) + 1, n_frames)
    encoded = (pulled - 1) // every_n_video_frames
    n_encoded = int(encoded.max()) + 1

    op_idx = np.arange(n_ops)
    seg = np.where(op_idx < ops_mod.OPS_FIRST_FRAME, 0,
                   1 + (op_idx - ops_mod.OPS_FIRST_FRAME)
                   // ops_mod.OPS_PER_FRAME)
    bank = (seg % 2).astype(np.int32) if mode == VideoMode.DHGR else \
        np.zeros(n_ops, dtype=np.int32)

    change = np.zeros(n_ops, dtype=bool)
    change[0] = True
    change[1:] = (np.diff(encoded) != 0) | (np.diff(bank) != 0)
    chunk_starts = np.flatnonzero(change)
    chunk_ends = np.append(chunk_starts[1:], n_ops)

    ops_per_step = k * j
    # chunk-major padded layout: every (frame, bank) chunk occupies exactly
    # `chunk_steps` scan steps (the max any chunk needs), tail steps padded
    # with nvalid=0 no-ops.  This lets the encode scan run one chunk per
    # loop body with the chunk-start recompute hoisted OUT of the per-step
    # code - crucial under vmap, where a per-step lax.cond lowers to a
    # select that would execute the expensive recompute branch (diff DP +
    # slab build) on every step for every movie in the batch.
    lengths = chunk_ends - chunk_starts
    n_steps_per_chunk = -(-lengths // ops_per_step)
    body_steps = min(int(n_steps_per_chunk.max()), BODY_CAP)
    sf, sb, sr, sn = [], [], [], []
    for cs, ce in zip(chunk_starts, chunk_ends):
        length = ce - cs
        n_chunk = -(-length // ops_per_step)
        n_steps = -(-n_chunk // body_steps) * body_steps
        for st in range(n_steps):
            sf.append(encoded[cs])
            sb.append(bank[cs])
            sr.append(st == 0)
            sn.append(int(np.clip(length - st * ops_per_step,
                                  0, ops_per_step)))

    plan = MoviePlan(
        n_ops=n_ops,
        k=k,
        j=j,
        chunk_steps=body_steps,
        step_frame=np.asarray(sf, dtype=np.int32),
        step_bank=np.asarray(sb, dtype=np.int32),
        step_recompute=np.asarray(sr, dtype=bool),
        step_nvalid=np.asarray(sn, dtype=np.int32),
        op_tick_index=op_idx.astype(np.int32),
    )
    for a in (plan.step_frame, plan.step_bank, plan.step_recompute,
              plan.step_nvalid, plan.op_tick_index):
        a.setflags(write=False)  # memoized: shared across callers
    return plan, n_encoded


# --- target preparation ---------------------------------------------------------

@functools.lru_cache(None)
def _jitted_prepare(mode: VideoMode):
    import jax

    def f(main, aux):
        return prepare_targets(main, aux if mode == VideoMode.DHGR
                               else None, mode)
    return jax.jit(f)


def prepare_targets_jit(frames_main, frames_aux, mode: VideoMode):
    """prepare_targets as ONE compiled program (one dispatch instead of
    the eager form's tens of small device ops).

    The frame count is padded (last frame repeated) to a multiple of 16
    so arbitrary movie lengths share compiled programs - the encode scan
    never reads past the plan's last frame, so padded rows are inert.
    Returned arrays have the PADDED leading dimension.
    """
    import jax.numpy as jnp

    main = np.asarray(frames_main)
    aux = None if frames_aux is None else np.asarray(frames_aux)
    F = len(main)
    pad = (-F) % 16
    if pad:
        main = np.concatenate([main, np.repeat(main[-1:], pad, 0)])
        if aux is not None:
            aux = np.concatenate([aux, np.repeat(aux[-1:], pad, 0)])
    main = jnp.asarray(main)
    aux = main if aux is None else jnp.asarray(aux)
    return _jitted_prepare(mode)(main, aux)


def prepare_targets(frames_main: np.ndarray,
                    frames_aux: Optional[np.ndarray],
                    mode: VideoMode):
    """Stack per-frame targets into encoder inputs.

    Returns (lanes_tgt (F,32,128,L) int32, bytes_tgt (F,2,32,256) int32).
    """
    import jax.numpy as jnp

    main = jnp.asarray(frames_main)
    if mode == VideoMode.DHGR:
        aux = jnp.asarray(frames_aux)
        lanes = screen.dhgr_masked_lanes(main, aux)
        bytes_tgt = jnp.stack(
            [main.astype(jnp.int32), aux.astype(jnp.int32)], axis=1)
    else:
        lanes = screen.hgr_masked_lanes(main)
        z = main.astype(jnp.int32)
        bytes_tgt = jnp.stack([z, z], axis=1)
    return lanes, bytes_tgt


# --- the scan -------------------------------------------------------------------

def _build_encode_scan(mode: VideoMode, k: int, deterministic: bool = False,
                       j: int = 1, chunk_steps: int = 1, diag: str = "",
                       joint: bool = False):
    """Construct the whole-movie encode function for (mode, K, J).

    joint=True selects each op's CONTENT byte jointly over all C content
    codes (the reference's "Global optimization" future improvement,
    reference README.md:212-215: "the best value to store to minimize the
    total error of 4 offsets may not even be any one of those target
    content bytes").  The priority-driven primary offset and all state
    update rules are unchanged - only the content rule differs: instead of
    the target byte at the primary offset, pick argmax over c of
    [improvement at the primary offset + the 3 best positive companion
    improvements] from the page's full (C, 256) cost-slab block.  The
    default rule's choice is in the candidate set, so each op's modelled
    gain can only match or exceed greedy's.  Costs ~C more slab reads per
    sub-op - opt-in (--joint_content); its replay error is pinned in
    tests/data/quality_baseline.json.

    diag: comma-separated perf-diagnostic knobs.  Ablations whose outputs
    are WRONG: "nodp" zeroes the chunk-start diff DP, "noslab" skips the
    slab build (zeros / keeps the carried slab), "cheapslab" writes a
    same-shape slab without the table gather, "nolanes" diffs the target
    against itself (skips the current-screen lane derivation),
    "norowgather" replaces the per-sub-op slab row gather with a
    same-shape stand-in (attributes the gather's share of the sub-op
    latency floor).  BIT-EXACT strategy knobs (like "carryslab"):
    "takex" extracts page rows with jnp.take instead of the one-hot
    HIGHEST matmul, "scatterwb" writes them back with .at[pages].set -
    the matmul forms are the default.
    "carryslab" is different: it forces the carried-pair slab strategy
    even for single-body chunks and is BIT-EXACT (the per-body rebuild
    produces identical values - tests/test_encoder.py pins it).
    bench_recompute.py times these to attribute the recompute cost;
    production callers never pass diag.

    k = pages selected per step; j = ops emitted per selected page per
    step (sequential sub-ops on the extracted page rows - each sees the
    previous sub-ops' updates exactly as consecutive steps would).
    deterministic=True replaces random tie-break nonces with zeros (ties
    resolve to lowest index) - for differential testing vs the host oracle.

    The scan iterates `chunk_steps` plan steps per loop body; the plan
    pads every (frame, bank) chunk to a multiple of that length, so chunk
    starts always fall on body boundaries.  The chunk-start recompute
    (diff DP + store-cost slab) runs at most once per BODY and the active
    bank's state rows are extracted/written back once per body - under
    vmap a per-step cond would lower to a select executing the recompute
    on EVERY step of every movie, which dominated the batched encode
    cost.  Long chunks (small K*J) span several bodies; continuation
    bodies reuse the slab carried in scan state.
    """
    import jax
    import jax.numpy as jnp

    spec = screen.spec_for_mode(mode)
    n_lanes = int(spec.N_LANES)
    n_banks = 2 if mode == VideoMode.DHGR else 1
    C = distance.n_contents(mode)
    holes_i = jnp.asarray((~screen.SCREEN_HOLES).astype(np.int32))
    # chunk_steps < BODY_CAP means every (frame, bank) chunk fits exactly
    # one scan body, so the active bank's slab is a pure function of the
    # body's plan scalars and can be rebuilt per body instead of carried:
    # no lax.cond pass-through and no 4MB pair in the while-loop carry
    # (XLA may insert a full-slab copy there every body).  Long chunks
    # (chunk_steps == BODY_CAP, e.g. small K*J or HGR's 1000-op frame
    # chunks) keep the carried pair.
    slab_body = chunk_steps < BODY_CAP and "carryslab" not in diag

    def lanes_of(banks):
        if mode == VideoMode.DHGR:
            return screen.dhgr_masked_lanes(banks[0], banks[1])
        return screen.hgr_masked_lanes(banks[0])

    def bank_lane_pair(bank_idx: int) -> Tuple[int, int]:
        if mode == VideoMode.DHGR:
            return spec.bank_lanes(bank_idx == 1)
        return spec.bank_lanes(False)

    def diff_bank(cur_lanes, tgt_lanes, bank, sub):
        """On-the-fly DP diff of the active bank, (32, 256) int32.

        The per-lane pixel/window extraction is cheap bit-twiddling; the
        alignment DP / cost contraction behind it is the expensive half of
        the chunk-start recompute.  So extract all lanes, SELECT the
        active bank's pair, and run the expensive part on two lanes
        instead of four (computing all four and where-ing the results
        doubles the recompute).  Selection is by-value, so results are
        bit-identical.
        """
        if mode != VideoMode.DHGR:
            ds = [distance.dist_lane_pairs(
                cur_lanes[..., l], tgt_lanes[..., l], mode, l, sub)
                for l in range(n_lanes)]
            return screen.interleave_bank_lanes(
                ds[0], ds[1]).astype(jnp.int32)
        is_aux = bank == 1
        (ae, ao), (me, mo) = bank_lane_pair(1), bank_lane_pair(0)
        # both lanes run through ONE batched distance call (stacked on a
        # leading axis): the einsum/DP math is elementwise over leading
        # dims, so results are bit-identical and the recompute cond's op
        # chain halves
        if getattr(sub, "ndim", 2) == 4:  # NTSC-composite YIQ basis
            from iivision_tpu.ops import yiq

            wc = [yiq.lane_windows(cur_lanes[..., l], mode, l)
                  for l in range(4)]
            wt = [yiq.lane_windows(tgt_lanes[..., l], mode, l)
                  for l in range(4)]
            wa = jnp.stack([jnp.where(is_aux, wc[ae], wc[me]),
                            jnp.where(is_aux, wc[ao], wc[mo])])
            wb = jnp.stack([jnp.where(is_aux, wt[ae], wt[me]),
                            jnp.where(is_aux, wt[ao], wt[mo])])
            sub2 = jnp.stack([jnp.where(is_aux, sub[ae], sub[me]),
                              jnp.where(is_aux, sub[ao], sub[mo])])
            d2 = distance.dist_window_sums_sub2(wa, wb, sub2)
        else:
            pc = [distance.lane_pixels(cur_lanes[..., l], mode, l)
                  for l in range(4)]
            pt = [distance.lane_pixels(tgt_lanes[..., l], mode, l)
                  for l in range(4)]
            pa = jnp.stack([jnp.where(is_aux, pc[ae], pc[me]),
                            jnp.where(is_aux, pc[ao], pc[mo])])
            pb = jnp.stack([jnp.where(is_aux, pt[ae], pt[me]),
                            jnp.where(is_aux, pt[ao], pt[mo])])
            d2 = distance.dist_pixel_pairs(pa, pb, sub)
        return screen.interleave_bank_lanes(d2[0], d2[1]).astype(jnp.int32)

    def build_sc_bank(tgt_lanes, store_cost16, bank_idx: int):
        """One bank's cost slab (32*C rows, 256 offsets) int16, row-gathered.

        sc row p*C + c = costs of storing content c over page p's 256
        offsets relative to the target frame.  Contiguous-row gathers from
        the small int16 store-cost table outperform one-hot matmul selection
        here.  bank_idx is STATIC: both banks' slabs are built at frame
        starts (the slab depends only on (target, bank), so the 2-4 bank
        flips inside a frame reuse the carried pair).
        """
        R = store_cost16.shape[1]
        le, lo = bank_lane_pair(bank_idx)
        return _sc_slab(store_cost16,
                        le * R + tgt_lanes[..., le],
                        lo * R + tgt_lanes[..., lo])

    def _sc_slab(store_cost16, rows_e, rows_o):
        """(32*C, 256) slab from flat per-position table row indices -
        the one place that knows the even/odd offset interleave layout."""
        flat = store_cost16.reshape(-1, C)
        se = jnp.take(flat, rows_e.reshape(-1),
                      axis=0).reshape(32, 128, C)
        so = jnp.take(flat, rows_o.reshape(-1),
                      axis=0).reshape(32, 128, C)
        return (jnp.stack([se, so], axis=2).reshape(32, 256, C)
                .transpose(0, 2, 1).reshape(32 * C, 256))

    def build_sc_bank_dyn(tgt_lanes, store_cost16, bank):
        """The ACTIVE bank's cost slab with the bank chosen by VALUE.

        Same values as build_sc_bank(tgt_lanes, ., bank) bit-for-bit: the
        lane selects are on the tiny (32,128) index arrays and the lane id
        becomes a row-base into the flattened per-lane tables, so the two
        gathers themselves read identical rows.  Used by the per-body slab
        rebuild, where `bank` is a traced plan scalar."""
        if n_banks == 1:
            return build_sc_bank(tgt_lanes, store_cost16, 0)
        (ae, ao), (me, mo) = bank_lane_pair(1), bank_lane_pair(0)
        is_aux = bank == 1
        R = store_cost16.shape[1]
        ve = jnp.where(is_aux, ae * R + tgt_lanes[..., ae],
                       me * R + tgt_lanes[..., me])
        vo = jnp.where(is_aux, ao * R + tgt_lanes[..., ao],
                       mo * R + tgt_lanes[..., mo])
        return _sc_slab(store_cost16, ve, vo)

    def encode_scan(store_cost, sub, lanes_tgt, bytes_tgt,
                    step_frame, step_bank, step_recompute,
                    step_nvalid, key,
                    step_index=None, init_state=None, return_state=False):
        store_cost16 = store_cost.astype(jnp.int16)  # costs < 2^12
        S = step_frame.shape[0]
        Sc = chunk_steps
        if S % Sc != 0:
            raise ValueError("plan steps (%d) not a multiple of the "
                             "chunk length (%d)" % (S, Sc))
        zero = jnp.zeros((n_banks, 32, 256), jnp.int32)
        if init_state is None:
            state0 = dict(banks=zero, up=zero, dw=zero)
            if not slab_body:
                state0["sc"] = jnp.zeros((n_banks, 32 * C, 256), jnp.int16)
        else:
            state0 = dict(init_state)
            if slab_body:
                state0.pop("sc", None)
        # carry mode: the cost-slab pair is rebuilt only where the chunk's
        # FRAME differs from the previous step's (plus step 0 - fresh or
        # carried segment state): a bank flip reuses the carried pair.
        # Derived from the plan arrays, which are UNBATCHED under vmap
        # (in_axes None), so the rebuild cond stays a real cond - a batched
        # predicate would lower to a select running the gather every body.
        if not slab_body:
            step_slab = jnp.concatenate([
                jnp.ones((1,), bool),
                step_recompute[1:] & (step_frame[1:] != step_frame[:-1])])
        iota_k32 = jax.lax.broadcasted_iota(jnp.int32, (k, 32), 1)
        iota_256 = jax.lax.broadcasted_iota(jnp.int32, (1, 256), 1)
        iota_k = jax.lax.broadcasted_iota(jnp.int32, (k, 1), 0)[:, 0]
        iota_c = jax.lax.broadcasted_iota(jnp.int32, (C,), 0)

        def chunk_body(state, xs):
            # each (Sc,)
            (step_is, frames_x, banks_x, recs_x, nvalids_x), slabs_x = \
                xs[:5], xs[5:]
            frame = frames_x[0]
            bank = banks_x[0]
            recompute = recs_x[0]
            tl = lanes_tgt[frame]  # (32, 128, n_lanes)
            tb = bytes_tgt[frame, bank]  # (32, 256) int32
            bank_c = jnp.clip(bank, 0, n_banks - 1)

            up_b = jax.lax.dynamic_index_in_dim(
                state["up"], bank_c, 0, keepdims=False)
            dw_b = jax.lax.dynamic_index_in_dim(
                state["dw"], bank_c, 0, keepdims=False)
            by_b = jax.lax.dynamic_index_in_dim(
                state["banks"], bank_c, 0, keepdims=False)

            if slab_body:
                # -- per-body ACTIVE-bank slab rebuild (no carry, no cond):
                # a pure function of this body's (frame, bank), values
                # bit-identical to the carried pair's active rows
                if "noslab" in diag:
                    slab = jnp.zeros((32 * C, 256), jnp.int16)
                elif "cheapslab" in diag:
                    # same-shape slab write WITHOUT the table gather:
                    # isolates gather cost vs slab write cost
                    slab = (jnp.broadcast_to(
                        tl[:, :1, 0].astype(jnp.int16),
                        (32, C)).reshape(-1)[:, None]
                        + jnp.arange(256, dtype=jnp.int16))
                else:
                    slab = build_sc_bank_dyn(tl, store_cost16, bank_c)
                slab_base = 0
            else:
                # -- frame-start slab rebuild (both banks) ------------------
                def do_slab(_):
                    if "noslab" in diag:
                        return state["sc"]
                    if "cheapslab" in diag:
                        # same-shape slab write WITHOUT the table gather:
                        # isolates gather cost vs carried-slab write cost
                        return (jnp.broadcast_to(
                            tl[:, :1, 0].astype(jnp.int16),
                            (32, 32 * C // 32)).reshape(-1)[None, :, None]
                            + jnp.arange(256, dtype=jnp.int16)
                        ) + jnp.zeros((n_banks, 1, 1), jnp.int16)
                    return jnp.stack([build_sc_bank(tl, store_cost16, b)
                                      for b in range(n_banks)])

                sc_pair = jax.lax.cond(slabs_x[0][0], do_slab,
                                       lambda _: state["sc"], 0)
                # index the active bank's rows by a base offset instead of
                # materialising a 2MB dynamic slice of the pair every body
                slab = sc_pair.reshape(n_banks * 32 * C, 256)
                slab_base = bank_c * (32 * C)

            # -- chunk-start recompute: on-the-fly DP diff -------------------
            def do_recompute(up, dw):
                cur = tl if "nolanes" in diag else lanes_of(state["banks"])
                if "nodp" in diag:
                    d = jnp.zeros((32, 256), jnp.int32)
                else:
                    d = diff_bank(cur, tl, bank, sub) * holes_i
                return jnp.where(d == 0, 0, up) + d, d

            def no_recompute(up, dw):
                # continuation body of a long chunk (or a padded no-op
                # chunk)
                return up, dw

            up_bf, dw_bf = jax.lax.cond(
                recompute, do_recompute, no_recompute, up_b, dw_b)
            up_b = up_bf.astype(jnp.float32)
            dw_b = dw_bf.astype(jnp.float32)
            by_b = by_b.astype(jnp.float32)
            tb_f = tb.astype(jnp.float32)

            pad_content = tb[0, 0]

            # inner scans over the body's steps and each step's j sub-ops:
            # the program contains ONE sub-op selection block instead of
            # Sc*j unrolled copies, which bounds compile time
            def sub_op(carry, jj):
                up_p, dw_p, by_p, tb_p, pages, sc_all, nvalid, skey = carry
                has_work = jnp.max(up_p, axis=1) > 0.0
                real = has_work & (jj * k + iota_k < nvalid)
                realf = real.astype(jnp.float32)[:, None]

                if deterministic:
                    nonce_o = jnp.zeros((k, 256), jnp.float32)
                else:
                    nonce_o = jax.random.uniform(
                        jax.random.fold_in(skey, 1 + jj), (k, 256),
                        jnp.float32)
                off_score = up_p * 256.0 + nonce_o * 255.0
                offset0 = jnp.argmax(off_score, axis=1)  # (K,)
                off0_oh = (offset0[:, None] == iota_256).astype(
                    jnp.float32)
                if joint:
                    # joint content: score ALL C content codes of each
                    # selected page by (gain at the fixed primary offset)
                    # + (3 best positive companion gains), pick the best.
                    # The slab block per page is contiguous rows
                    # [base+p*C, base+(p+1)*C); all values are integers
                    # < 2^18, exact in f32, so host/device stay bit-equal.
                    rows_all = ((slab_base + pages * C)[:, None]
                                + iota_c[None, :])  # (K, C)
                    blocks = jnp.take(
                        sc_all, rows_all.reshape(-1),
                        axis=0).astype(jnp.float32).reshape(k, C, 256)
                    score_all = dw_p[:, None, :] - blocks
                    prim = jnp.sum(score_all * off0_oh[:, None, :],
                                   axis=2)  # (K, C)
                    eligj = ((up_p > 0.0)
                             & (iota_256 != offset0[:, None]))[:, None, :]
                    slj = jnp.where(eligj & (score_all > 0.0),
                                    score_all, 0.0)
                    comp = jnp.zeros((k, C), jnp.float32)
                    for _ in range(3):
                        o = jnp.argmax(slj, axis=2)  # (K, C)
                        ohj = o[..., None] == iota_256[0][None, None, :]
                        comp = comp + jnp.sum(
                            jnp.where(ohj, slj, 0.0), axis=2)
                        slj = jnp.where(ohj, 0.0, slj)
                    content = jnp.argmax(prim + comp, axis=1).astype(
                        jnp.int32)
                else:
                    content = jnp.sum(tb_p * off0_oh, axis=1).astype(
                        jnp.int32)

                # companions: rank ALL offsets against the LIVE diff.
                # sc rows for each slot's (page, content):
                # contiguous-row gathers from the bank's cost slab -
                # the same semantics as the reference's per-op
                # compute_delta_page (video.py:275-301)
                # DHGR content is 7-bit for COST purposes (palette bit
                # unused, reference video.py:135-137): mask the slab row
                # index so a raw .BIN byte with the MSB set can't index
                # out of the active bank's rows (the emitted byte stays
                # raw, as the reference stores it)
                rows = slab_base + pages * C + (content & (C - 1))  # (K,)
                if "norowgather" in diag:
                    # diag ONLY (wrong outputs): same-shape stand-in to
                    # attribute the dynamic row gather's share of the
                    # sub-op latency floor
                    sc_row = by_p * 0.5 + rows[:, None].astype(
                        jnp.float32)
                else:
                    sc_row = jnp.take(sc_all, rows, axis=0).astype(
                        jnp.float32)  # (K, 256)
                # eligible: still-pending offset (up>0 also excludes
                # screen holes, which never take priority) that the
                # store improves
                score = dw_p - sc_row
                elig = (up_p > 0.0) & (score > 0.0) \
                    & (iota_256 != offset0[:, None])
                sl = jnp.where(elig, score, -1.0)
                oh_sel, off_sel, resid_sel = [], [], []
                for _ in range(3):  # best three, ties to lowest offset
                    o = jnp.argmax(sl, axis=1)
                    oh = (o[:, None] == iota_256).astype(jnp.float32)
                    hit = jnp.sum(sl * oh, axis=1) > 0.0
                    hitf = hit.astype(jnp.float32)[:, None]
                    off_sel.append(jnp.where(hit, o, offset0))
                    oh_sel.append(oh * hitf)
                    resid_sel.append(jnp.sum(sc_row * oh, axis=1)
                                     * hit.astype(jnp.float32))
                    sl = jnp.where(oh > 0, -1.0, sl)
                acc_rows = oh_sel[0] + oh_sel[1] + oh_sel[2]
                resid_rows = (oh_sel[0] * resid_sel[0][:, None]
                              + oh_sel[1] * resid_sel[1][:, None]
                              + oh_sel[2] * resid_sel[2][:, None])
                off3_eff = jnp.stack(off_sel, axis=1)  # (K, 3)

                # local page-row updates (gated so padding sub-ops
                # are no-ops): primary clears up+dw, companions take
                # residuals, stored cells take the content byte
                umask = (off0_oh + acc_rows) * realf  # 0/1, disjoint
                if joint:
                    # joint may store a non-target byte at the primary
                    # offset: credit its residual error back into the
                    # priority/diff state (exactly the companion rule)
                    # instead of declaring the offset done - without
                    # this, imperfect primaries are never repaired until
                    # the next frame and final error regresses
                    prim_resid = jnp.sum(sc_row * off0_oh, axis=1)
                    resid_rows = (resid_rows
                                  + off0_oh * prim_resid[:, None])
                    up_p = up_p * (1.0 - umask) + resid_rows * realf
                    dw_p = (dw_p * (1.0 - off0_oh * realf)
                            + off0_oh * prim_resid[:, None] * realf)
                else:
                    up_p = up_p * (1.0 - umask) + resid_rows * realf
                    dw_p = dw_p * (1.0 - off0_oh * realf)
                by_p = by_p * (1.0 - umask) \
                    + umask * content[:, None].astype(jnp.float32)

                all_off = jnp.concatenate(
                    [offset0[:, None], off3_eff], axis=1)
                rec = jnp.concatenate(
                    [jnp.where(real, pages, 0)[:, None] + 32,
                     jnp.where(real, content, pad_content)[:, None],
                     jnp.where(real[:, None], all_off, 0)], axis=1)
                return (up_p, dw_p, by_p, tb_p, pages, sc_all, nvalid,
                        skey), rec

            def step_body(carry, xs_u):
                up_b, dw_b, by_b = carry
                step_i, nvalid = xs_u
                skey = jax.random.fold_in(key, step_i)

                # -- page selection ------------------------------------
                page_max = jnp.max(up_b, axis=1)  # (32,)
                if deterministic:
                    nonce_p = jnp.zeros((32,), jnp.float32)
                else:
                    nonce_p = jax.random.uniform(
                        jax.random.fold_in(skey, 0), (32,), jnp.float32)
                page_score = page_max * 256.0 + nonce_p * 255.0
                _, pages = jax.lax.top_k(page_score, k)  # (K,) distinct
                P = (pages[:, None] == iota_k32).astype(jnp.float32)

                # one fused page-row extraction for up/dw/target/screen
                # bytes.  HIGHEST precision: a default-precision f32 dot
                # may run in bf16/TF32 on an accelerator and round the
                # extracted VALUES (priorities exceed TF32's exact integer
                # range), silently changing selections vs the host oracle;
                # with HIGHEST, CPU and GPU streams are bit-identical.
                stacked = jnp.concatenate(
                    [up_b, dw_b, tb_f, by_b], axis=1)  # (32, 1024)
                if "takex" in diag:
                    # bit-exact alternative: row gather instead of the
                    # one-hot matmul (both are permutations)
                    proj = jnp.take(stacked, pages, axis=0)
                else:
                    proj = jnp.dot(P, stacked,
                                   precision=jax.lax.Precision.HIGHEST,
                                   preferred_element_type=jnp.float32)
                up_p, dw_p = proj[:, :256], proj[:, 256:512]
                tb_p, by_p = proj[:, 512:768], proj[:, 768:]

                # -- j sequential op selections on the extracted rows ---
                # each sub-op sees the previous sub-ops' local updates,
                # exactly as consecutive scan steps would on the same
                # pages
                (up_p, dw_p, by_p, _, _, _, _, _), op_recs = jax.lax.scan(
                    sub_op, (up_p, dw_p, by_p, tb_p, pages, slab, nvalid,
                             skey),
                    jnp.arange(j, dtype=jnp.int32))

                # -- whole-row write-back of the selected pages ---------
                if "scatterwb" in diag:
                    # bit-exact alternative: scatter rows (pages are
                    # distinct by top_k) instead of the one-hot matmul
                    up_b = up_b.at[pages].set(up_p)
                    dw_b = dw_b.at[pages].set(dw_p)
                    by_b = by_b.at[pages].set(by_p)
                else:
                    keep = 1.0 - jnp.sum(P, axis=0)[:, None]  # (32, 1)
                    back = jnp.concatenate([up_p, dw_p, by_p], axis=1)
                    wr = jnp.dot(P.T, back,
                                 precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32)
                    up_b = up_b * keep + wr[:, :256]
                    dw_b = dw_b * keep + wr[:, 256:512]
                    by_b = by_b * keep + wr[:, 512:]

                # emit order is sub-op-major: all pages' first ops, then
                # their second ops, ... (matches the plan's nvalid)
                return (up_b, dw_b, by_b), op_recs.reshape(
                    k * j, OP_FIELDS).astype(jnp.uint8)

            (up_b, dw_b, by_b), recs_out = jax.lax.scan(
                step_body, (up_b, dw_b, by_b), (step_is, nvalids_x))

            new_state = dict(
                banks=jax.lax.dynamic_update_index_in_dim(
                    state["banks"], by_b.astype(jnp.int32), bank_c, 0),
                up=jax.lax.dynamic_update_index_in_dim(
                    state["up"], up_b.astype(jnp.int32), bank_c, 0),
                dw=jax.lax.dynamic_update_index_in_dim(
                    state["dw"], dw_b.astype(jnp.int32), bank_c, 0),
            )
            if not slab_body:
                new_state["sc"] = sc_pair
            return new_state, recs_out  # (Sc, K*j, 6)

        if step_index is None:
            step_index = jnp.arange(S, dtype=jnp.int32)
        xs = (step_index, step_frame, step_bank,
              step_recompute, step_nvalid)
        if not slab_body:
            xs = xs + (step_slab,)
        xs = jax.tree.map(
            lambda a: a.reshape((-1, Sc) + a.shape[1:]), xs)
        final, ops = jax.lax.scan(chunk_body, state0, xs,
                                  unroll=_SCAN_UNROLL)
        ops = ops.reshape((-1,) + ops.shape[2:])  # (S, K*j, 6)
        if return_state:
            return ops, final
        main = final["banks"][0]
        aux = final["banks"][n_banks - 1] if n_banks == 2 else \
            final["banks"][0]
        return ops, main, aux

    def full(store_cost, sub, lanes_tgt, bytes_tgt, step_frame, step_bank,
             step_recompute, step_nvalid, key):
        return encode_scan(store_cost, sub, lanes_tgt, bytes_tgt,
                           step_frame, step_bank, step_recompute,
                           step_nvalid, key)

    def full_frames(store_cost, sub, frames_main_u8, frames_aux_u8,
                    step_frame, step_bank, step_recompute, step_nvalid,
                    key):
        """Lane preparation + the whole-movie scan in ONE dispatch (the
        solo fast path): raw uint8 screen banks in, ops out.  Ops are
        returned as FETCH_SPLITS equal FLAT parts (separate outputs of
        the same program, so splitting costs no extra dispatch) that the
        host fetches concurrently."""
        lanes_tgt, bytes_tgt = prepare_targets(
            frames_main_u8,
            frames_aux_u8 if mode == VideoMode.DHGR else None, mode)
        ops, main, aux = encode_scan(
            store_cost, sub, lanes_tgt, bytes_tgt, step_frame,
            step_bank, step_recompute, step_nvalid, key)
        S = ops.shape[0]
        bounds = [(i * S) // FETCH_SPLITS for i in range(1, FETCH_SPLITS)]
        parts = tuple(p.reshape(-1) for p in jnp.split(ops, bounds))
        return parts + (main, aux)

    full.full_frames = full_frames

    def chunk(store_cost, sub, frames_main_u8, frames_aux_u8,
              step_frame, step_bank, step_recompute, step_nvalid,
              step_index, banks0, up0, dw0, sc0, key):
        """One segment of a chunked movie: carries (banks, up, dw, sc)
        state in and out so arbitrarily long movies encode in bounded
        memory.  Targets arrive as raw uint8 screen banks; lane derivation
        happens INSIDE this program (one dispatch + a small h2d per
        segment).

        Output matches the unchunked encoder bit-for-bit: nonces fold the
        ABSOLUTE step index and every segment's first step is a frame start
        (recompute=True rebuilds the diff and cost slab from carried state).
        """
        lanes_tgt, bytes_tgt = prepare_targets(
            frames_main_u8,
            frames_aux_u8 if mode == VideoMode.DHGR else None, mode)
        init = dict(banks=banks0, up=up0, dw=dw0, sc=sc0)
        ops, fin = encode_scan(
            store_cost, sub, lanes_tgt, bytes_tgt, step_frame,
            step_bank, step_recompute, step_nvalid, key,
            step_index=step_index, init_state=init, return_state=True)
        # per-body slab rebuild carries no sc: pass the caller's through
        # (every segment's first body rebuilds it anyway)
        return ops, fin["banks"], fin["up"], fin["dw"], fin.get("sc", sc0)

    full.chunk = chunk
    return full


@functools.lru_cache(None)
def _jitted_encode(mode: VideoMode, k: int, deterministic: bool, j: int = 1,
                   chunk_steps: int = 1, joint: bool = False):
    import jax
    return jax.jit(_build_encode_scan(mode, k, deterministic, j,
                                      chunk_steps, joint=joint))


FETCH_SPLITS = 4  # flat ops parts of the solo encode, fetched concurrently


@functools.lru_cache(None)
def _jitted_frames_encode(mode: VideoMode, k: int, deterministic: bool,
                          j: int = 1, chunk_steps: int = 1,
                          joint: bool = False):
    import jax
    return jax.jit(_build_encode_scan(mode, k, deterministic, j,
                                      chunk_steps, joint=joint).full_frames)


@functools.lru_cache(None)
def _jitted_chunk(mode: VideoMode, k: int, deterministic: bool, j: int = 1,
                  chunk_steps: int = 1, joint: bool = False):
    import jax
    return jax.jit(_build_encode_scan(mode, k, deterministic, j, chunk_steps,
                                      joint=joint).chunk)


def _bucket_steps(n: int, chunk_steps: int) -> int:
    """Pad a step count to a shared bucket (multiple of chunk_steps).

    Every distinct step count is a distinct XLA program; bucketing
    collapses arbitrary movie lengths onto a bounded program family (each
    fresh program is a fresh compile).
    Buckets are 1/32-octave: padding waste is <=~6% of the scan, and at
    most 32 programs exist per power of two of movie length.  Trailing
    steps are nvalid=0 no-ops: ops output and final screen state are
    bit-identical (same mechanism as the chunked path's padding)."""
    p2 = 64
    while p2 < n:
        p2 *= 2
    q = max(64, p2 // 32)
    n = -(-n // q) * q
    return -(-n // chunk_steps) * chunk_steps


def pad_plan_steps(plan: MoviePlan):
    """(step_frame, step_bank, step_recompute, step_nvalid) padded to the
    step bucket; returns (arrays tuple, S_real)."""
    sf, sb = plan.step_frame, plan.step_bank
    sr, sn = plan.step_recompute, plan.step_nvalid
    S_real = len(sf)
    pad = _bucket_steps(S_real, plan.chunk_steps) - S_real
    if pad:
        sf = np.concatenate([sf, np.full(pad, sf[-1], sf.dtype)])
        sb = np.concatenate([sb, np.full(pad, sb[-1], sb.dtype)])
        sr = np.concatenate([sr, np.zeros(pad, sr.dtype)])
        sn = np.concatenate([sn, np.zeros(pad, sn.dtype)])
    return (sf, sb, sr, sn), S_real


def encode_movie(dist, lanes_tgt, bytes_tgt, plan: MoviePlan,
                 mode: VideoMode, seed: Optional[int] = 0,
                 joint: bool = False):
    """Encode a planned movie on the accelerator.

    dist: a distance.ComputedDistance for (mode, palette).
    seed=None disables random tie-breaks (deterministic; for testing).
    Returns (ops (S, K*J, 6) uint8, final main (32,256), final aux).
    """
    import jax
    import jax.numpy as jnp

    fn = _jitted_encode(mode, plan.k, seed is None, plan.j,
                        plan.chunk_steps, joint)
    key = jax.random.PRNGKey(0 if seed is None else seed)
    (sf, sb, sr, sn), S_real = pad_plan_steps(plan)
    ops, main, aux = fn(
        jnp.asarray(dist.store_cost), jnp.asarray(dist.sub),
        lanes_tgt, bytes_tgt,
        jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(sr),
        jnp.asarray(sn), key)
    if len(sf) != S_real:
        ops = ops[:S_real]
    return ops, main, aux


def encode_movie_from_frames(dist, frames_main_dev, frames_aux_dev,
                             plan: MoviePlan, mode: VideoMode,
                             seed: Optional[int] = 0,
                             joint: bool = False):
    """Solo fast path: encode from DEVICE-RESIDENT raw uint8 targets.

    Fuses lane preparation into the encode program (one dispatch instead
    of prepare + encode) and returns the ops as FETCH_SPLITS flat uint8
    device arrays for concurrent host fetch, plus the final screen banks
    still on device.  Callers reassemble with `ops_from_parts`.
    Bit-identical to prepare_targets_jit + encode_movie (differential
    test: tests/test_pipeline.py stream-vs-ingest).
    """
    import jax
    import jax.numpy as jnp

    fn = _jitted_frames_encode(mode, plan.k, seed is None, plan.j,
                               plan.chunk_steps, joint)
    key = jax.random.PRNGKey(0 if seed is None else seed)
    (sf, sb, sr, sn), S_real = pad_plan_steps(plan)
    out = fn(
        jnp.asarray(dist.store_cost), jnp.asarray(dist.sub),
        frames_main_dev,
        frames_main_dev if frames_aux_dev is None else frames_aux_dev,
        jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(sr),
        jnp.asarray(sn), key)
    return out[:FETCH_SPLITS], out[FETCH_SPLITS], out[FETCH_SPLITS + 1]


def ops_from_parts(parts, plan: MoviePlan) -> np.ndarray:
    """Host-side reassembly of encode_movie_from_frames's fetched ops
    parts -> the padded (S, K*J, 6) array flatten_ops accepts."""
    kj = plan.k * plan.j
    flat = np.concatenate([np.asarray(p) for p in parts])
    return flat.reshape(-1, kj, OP_FIELDS)


def encode_movie_chunked(dist, frames_main, frames_aux, plan: MoviePlan,
                         mode: VideoMode, seed: Optional[int] = 0,
                         chunk_frames: int = 512, joint: bool = False):
    """Encode an arbitrarily long planned movie in bounded device memory.

    Splits the plan at encoded-frame boundaries into segments of at most
    `chunk_frames` frames, transfers each segment's uint8 target banks to the
    device on demand (lanes are derived on-device), and carries the encoder
    state (screen banks, update priorities, live diffs, cost slab) across
    segments.  All segments pad to one (S, F) shape: one compile total.

    Chunked output is bit-identical to `encode_movie` (same seed): nonces
    fold absolute step indices and every segment starts with a recompute
    step that rebuilds diff + cost slab from the carried screen state.

    frames_main/frames_aux: (F, 32, 256) uint8 target banks (aux None for
    HGR).  Returns (ops (S_total, K*J, 6) uint8 numpy, final main, final
aux).
    """
    import jax
    import jax.numpy as jnp

    if chunk_frames <= 0:
        raise ValueError("chunk_frames must be positive, got %r"
                         % (chunk_frames,))
    from iivision_tpu.ops import distance as dist_mod
    frames_main = np.asarray(frames_main)
    n_banks = 2 if mode == VideoMode.DHGR else 1
    sf = plan.step_frame
    f_max = int(sf.max())
    bounds = list(range(0, f_max + 1, chunk_frames)) + [f_max + 1]
    ranges = [(f0, f1, int(np.searchsorted(sf, f0)),
               int(np.searchsorted(sf, f1)))
              for f0, f1 in zip(bounds[:-1], bounds[1:])]
    S_pad = max(s1 - s0 for _, _, s0, s1 in ranges)
    F_pad = min(chunk_frames, f_max + 1)

    fn = _jitted_chunk(mode, plan.k, seed is None, plan.j,
                       plan.chunk_steps, joint)
    key = jax.random.PRNGKey(0 if seed is None else seed)
    store_cost = jnp.asarray(dist.store_cost)
    sub = jnp.asarray(dist.sub)
    zero = jnp.zeros((n_banks, 32, 256), jnp.int32)
    banks, up, dw = zero, zero, zero
    sc = jnp.zeros((n_banks, 32 * dist_mod.n_contents(mode), 256),
                   jnp.int16)
    ops_all = []

    def pad_frames(a, F):
        if a is None:
            return None
        out = np.zeros((F_pad,) + a.shape[1:], a.dtype)
        out[:F] = a
        return out

    for f0, f1, s0, s1 in ranges:
        F, S = f1 - f0, s1 - s0
        main_c = pad_frames(frames_main[f0:f1], F)
        aux_c = pad_frames(main_c if frames_aux is None
                           else np.asarray(frames_aux)[f0:f1], F)

        def pad_steps(a, fill):
            out = np.full(S_pad, fill, a.dtype)
            out[:S] = a[s0:s1]
            return jnp.asarray(out)

        # pad steps repeat the last real (frame, bank) with nvalid=0 and no
        # recompute: pure no-op chunks
        ops_c, banks, up, dw, sc = fn(
            store_cost, sub, main_c, aux_c,
            pad_steps(sf - f0, int(sf[s1 - 1]) - f0),
            pad_steps(plan.step_bank, int(plan.step_bank[s1 - 1])),
            pad_steps(plan.step_recompute, False),
            pad_steps(plan.step_nvalid, 0),
            pad_steps(np.arange(len(sf), dtype=np.int32), 0),
            banks, up, dw, sc, key)
        ops_all.append(np.asarray(ops_c[:S]))

    main = np.asarray(banks[0])
    aux = np.asarray(banks[n_banks - 1])
    return np.concatenate(ops_all, axis=0), main, aux


def encode_movie_streaming(dist, batches, plan: MoviePlan, mode: VideoMode,
                           seed: Optional[int] = 0,
                           chunk_frames: int = 64, joint: bool = False):
    """Encode while targets stream in: device scans overlap host ingestion.

    batches: iterator of (main (B,32,256) uint8, aux|None) target batches
    (any sizes; concatenation must cover the plan's frames).  The plan is
    split at `chunk_frames` encoded-frame boundaries exactly like
    encode_movie_chunked; segment i's scan runs on device while the host
    quantizes segment i+1's frames and fetches segment i-1's ops - the
    pipelining that takes single-movie transcode latency off the sum of
    its stages.  Output is bit-identical to encode_movie (same seed):
    same chunk machinery, same absolute step indices.

    Returns a 5-tuple (ops, main, aux, targets_main, targets_aux): the
    segments' step-major padded op arrays concatenated into one, the
    final main/aux screen banks, and the accumulated quantized-target
    host arrays (targets_aux is None for HGR).
    """
    import jax.numpy as jnp

    from iivision_tpu.ops import distance as dist_mod

    if chunk_frames <= 0:
        raise ValueError("chunk_frames must be positive")
    n_banks = 2 if mode == VideoMode.DHGR else 1
    sf = plan.step_frame
    f_max = int(sf.max())
    bounds = list(range(0, f_max + 1, chunk_frames)) + [f_max + 1]
    ranges = [(f0, f1, int(np.searchsorted(sf, f0)),
               int(np.searchsorted(sf, f1)))
              for f0, f1 in zip(bounds[:-1], bounds[1:])]
    S_pad = max(s1 - s0 for _, _, s0, s1 in ranges)
    F_pad = min(chunk_frames, f_max + 1)
    assert S_pad % plan.chunk_steps == 0, (S_pad, plan.chunk_steps)

    fn = _jitted_chunk(mode, plan.k, seed is None, plan.j,
                       plan.chunk_steps, joint)
    import jax
    key = jax.random.PRNGKey(0 if seed is None else seed)
    store_cost = jnp.asarray(dist.store_cost)
    sub = jnp.asarray(dist.sub)
    zero = jnp.zeros((n_banks, 32, 256), jnp.int32)
    banks, up, dw = zero, zero, zero
    sc = jnp.zeros((n_banks, 32 * dist_mod.n_contents(mode), 256),
                   jnp.int16)

    acc_main, acc_aux = [], []  # all pulled batches (host copies)
    buf_main, buf_aux = [], []  # not-yet-consumed frames
    buffered = 0
    batches = iter(batches)

    def pull_frames(need):
        nonlocal buffered
        while buffered < need:
            try:
                bm, ba = next(batches)
            except StopIteration:
                raise ValueError(
                    "target stream ended %d frames short" % (need - buffered))
            bm = np.asarray(bm, np.uint8)
            acc_main.append(bm)
            buf_main.append(bm)
            if ba is not None:
                ba = np.asarray(ba, np.uint8)
                acc_aux.append(ba)
                buf_aux.append(ba)
            buffered += len(bm)
        out_m = np.concatenate(buf_main) if len(buf_main) > 1 else buf_main[0]
        out_a = None
        if buf_aux:
            out_a = (np.concatenate(buf_aux) if len(buf_aux) > 1
                     else buf_aux[0])
        take_m, rest_m = out_m[:need], out_m[need:]
        buf_main[:] = [rest_m] if len(rest_m) else []
        if out_a is not None:
            buf_aux[:] = [out_a[need:]] if len(out_a) > need else []
            out_a = out_a[:need]
        buffered -= need
        return take_m, out_a

    def pad_frames(a):
        if a is None:
            return None
        out = np.zeros((F_pad,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return out

    ops_out = []
    pending = None  # (device ops handle, real step count)
    for f0, f1, s0, s1 in ranges:
        S = s1 - s0
        fm, fa = pull_frames(f1 - f0)
        main_c = pad_frames(fm)
        aux_c = main_c if fa is None else pad_frames(fa)

        def pad_steps(a, fill):
            out = np.full(S_pad, fill, a.dtype)
            out[:S] = a[s0:s1]
            return jnp.asarray(out)

        ops_c, banks, up, dw, sc = fn(
            store_cost, sub, main_c, aux_c,
            pad_steps(sf - f0, int(sf[s1 - 1]) - f0),
            pad_steps(plan.step_bank, int(plan.step_bank[s1 - 1])),
            pad_steps(plan.step_recompute, False),
            pad_steps(plan.step_nvalid, 0),
            pad_steps(np.arange(len(sf), dtype=np.int32), 0),
            banks, up, dw, sc, key)
        if pending is not None:
            # fetch the previous segment's ops while this one runs
            ops_out.append(np.asarray(pending[0])[:pending[1]])
        pending = (ops_c, S)
    ops_out.append(np.asarray(pending[0])[:pending[1]])

    tgt_main = np.concatenate(acc_main) if len(acc_main) > 1 else acc_main[0]
    tgt_aux = (np.concatenate(acc_aux) if len(acc_aux) > 1 else
               acc_aux[0]) if acc_aux else None
    main = np.asarray(banks[0])
    aux = np.asarray(banks[n_banks - 1])
    return (np.concatenate(ops_out, axis=0), main, aux,
            tgt_main, tgt_aux)


def flatten_ops(ops: np.ndarray, plan: MoviePlan) -> np.ndarray:
    """(S, K*J, 6) step-major ops -> (n_ops, 6) stream-ordered, valid only.

    Accepts step-bucket-padded ops (S >= len(plan.step_frame)); padded
    trailing steps are all-invalid by construction and are dropped."""
    S_real = len(plan.step_nvalid)
    ops = np.asarray(ops)[:S_real]
    k = ops.shape[1]
    valid = np.arange(k)[None, :] < plan.step_nvalid[:, None]
    flat = ops.reshape(S_real * k, OP_FIELDS)
    return flat[valid.reshape(-1)]


def ops_to_ticks(flat_ops: np.ndarray, audio_levels: np.ndarray):
    """Merge encoder ops with audio levels into Tick opcodes (host)."""
    from iivision_tpu.stream.opcodes import Tick, audio_level_to_tick
    n = len(flat_ops)
    assert len(audio_levels) >= n
    for i in range(n):
        page, content, o0, o1, o2, o3 = (int(x) for x in flat_ops[i])
        yield Tick(audio_level_to_tick(int(audio_levels[i])), page,
                   content, (o0, o1, o2, o3))
