"""Analytical FLOP/HBM cost model of the encode scan: MFU + roofline.

The headline bench reports realtime_x; this module turns a measured encode
wall time into *achieved fraction of peak* so perf work is steered by
numbers instead of adjectives ("recompute-bound" becomes a flops/bytes
split).  The model mirrors encoder._build_encode_scan term by term:

- per-chunk recompute (once per (frame, bank) chunk): the on-the-fly
  Damerau-Levenshtein diff (ops/distance.dist_pixel_pairs - one-hot
  einsums over L pixel positions + the L-step DP) and the store-cost slab
  rebuild (contiguous-row gathers, (32, 256, C) int16 write);
- per-step selection math: the two one-hot page extraction/write-back
  matmuls (k x 32 x 1024 and 32 x k x 768, f32 HIGHEST) and j sub-op
  iterations of (K, 256) masked argmax rounds + one slab row-gather each;
- scan-carry traffic: the (banks, up, dw) state each body touches, plus
  the carried cost slab.  Whether XLA aliases the slab across bodies is
  not observable from here, so HBM totals come in a [min, max] band:
  min = slab touched only at recomputes, max = slab copied every body.

Peak numbers come from one table keyed by ``device_kind``; a device that is
not in it is an error.  All counts are per the BATCH (B movies vmapped over
one scan).
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from iivision_tpu import screen
from iivision_tpu.ops import distance
from iivision_tpu.video_mode import VideoMode


class Peaks(NamedTuple):
    bf16_tflops: float  # dense tensor-core bf16
    f32_tflops: float  # float32 outside the tensor cores (HIGHEST dots)
    hbm_gbps: float


# NVIDIA H100 SXM data sheet (dense, no sparsity), at the full 700 W power
# limit; a card set below it cannot hold these clocks under load.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(989.0, 67.0, 3350.0),
}


def device_peaks(device) -> Peaks:
    """Published peaks for a jax device, looked up by its device_kind."""
    kind = getattr(device, "device_kind", None)
    if kind not in _PEAKS:
        raise ValueError("no published peaks for device kind %r (known: %s)"
                         % (kind, sorted(_PEAKS)))
    return _PEAKS[kind]


@dataclass
class EncodeCost:
    """Modelled cost of one batched encode-scan invocation."""
    flops: float  # total FLOPs (batch)
    hbm_bytes_min: float  # slab carry aliased across bodies
    hbm_bytes_max: float  # slab carry copied read+write every body
    flops_recompute: float  # chunk-start diff DP + slab build share
    n_chunks: int
    n_steps: int
    n_subops: int  # sequential dependent iterations (latency floor)


def encode_cost(plan, mode: VideoMode, batch: int = 1) -> EncodeCost:
    """Cost model for encoder.encode_movie(plan) vmapped over `batch`."""
    spec = screen.spec_for_mode(mode)
    L = int(spec.MASKED_DOTS)
    C = distance.n_contents(mode)
    k, j = plan.k, plan.j
    S = int(len(plan.step_frame))
    Sc = int(plan.chunk_steps)
    bodies = S // Sc
    n_rec = int(plan.step_recompute.sum())
    # slab strategy mirrors encoder.py's slab_body switch: single-body
    # chunks rebuild the ACTIVE bank's slab every body (no carry, no
    # cond); multi-body chunks carry a both-bank pair rebuilt on frame
    # changes only
    from iivision_tpu.encoder import BODY_CAP
    slab_body = Sc < BODY_CAP
    cells = 32 * 128  # per-lane (page, offset-pair) cells

    # --- chunk-start recompute (per occurrence, per movie) -----------------
    # dist_pixel_pairs on 2 selected lane pairs: one-hot build
    # (2 sides x L x 16 compares), einsum ...ki,ij,...kj->...k
    # (L x (16x16 MAC + 16 MAC)), DP loop (~6 elementwise ops per pos)
    dp_flops = cells * (2 * L * 16 + L * (16 * 16 * 2 + 16 * 2) + L * 6)
    lanes_sides = 2 * int(spec.N_LANES)  # cur+tgt, all lanes extracted
    pix_flops = cells * L * 6 * lanes_sides  # shift/mask/rotate per dot
    diff_post = cells * 8  # holes mask, up accumulate, selects
    rec_flops = 2 * dp_flops + pix_flops + diff_post
    rec_bytes = 2 * 32 * 256 * 4 * 3  # banks read, lanes, diff arrays
    n_banks = 2 if mode == VideoMode.DHGR else 1
    if slab_body:
        # per-body ACTIVE-bank rebuild: gathered table rows + write
        n_slab = bodies
        slab_bytes = 32 * 256 * C * 2 * 2
    else:
        # carried pair rebuilt on frame CHANGES only, both banks
        sf = np.asarray(plan.step_frame)
        sr = np.asarray(plan.step_recompute)
        n_slab = int(1 + (sr[1:] & (sf[1:] != sf[:-1])).sum())
        slab_bytes = n_banks * 32 * 256 * C * 2 * 2

    # --- per-step selection math (per movie) -------------------------------
    extract = 2 * k * 32 * 1024  # one-hot page-row extraction matmul
    writeback = 2 * 32 * k * 768
    sub_flops = (k * 256) * (4 + 3 + 2  # nonce+score+argmax, one-hot, content
                             + 3 * 8    # 3 companion argmax rounds
                             + 12)      # masked updates
    step_flops = extract + writeback + j * sub_flops + 32 * 8  # top_k etc
    step_bytes = (j * k * 256 * 2      # slab row gathers (int16)
                  + 32 * 1024 * 4 * 2)  # stacked rows read + write back (f32)

    # --- scan carry (per body, per movie) -----------------------------------
    state_bytes = 3 * 32 * 256 * 4 * 2  # active-bank up/dw/banks read+write
    # carried slab pair read+write if XLA copies it per body (carry mode
    # only: per-body rebuild keeps the slab out of the while-loop carry)
    slab_carry = 0 if slab_body else n_banks * 32 * C * 256 * 2 * 2

    per_movie_flops = n_rec * rec_flops + S * step_flops
    per_movie_min = (n_rec * rec_bytes + n_slab * slab_bytes
                     + S * step_bytes + bodies * state_bytes)
    per_movie_max = per_movie_min + bodies * slab_carry

    return EncodeCost(
        flops=float(per_movie_flops) * batch,
        hbm_bytes_min=float(per_movie_min) * batch,
        hbm_bytes_max=float(per_movie_max) * batch,
        flops_recompute=float(n_rec * rec_flops) * batch,
        n_chunks=n_rec,
        n_steps=S,
        n_subops=bodies * Sc * j,
    )


def report(plan, mode: VideoMode, batch: int, seconds: float,
           device) -> dict:
    """One roofline record for a measured encode of `seconds` wall.

    Returns a dict (ready for the bench JSON line) and a human-readable
    summary under key "line".
    """
    cost = encode_cost(plan, mode, batch)
    peaks = device_peaks(device)
    peak_tf, peak_bw = peaks.bf16_tflops, peaks.hbm_gbps
    tflops = cost.flops / seconds / 1e12
    gbps_min = cost.hbm_bytes_min / seconds / 1e9
    gbps_max = cost.hbm_bytes_max / seconds / 1e9
    mfu = tflops / peak_tf
    hbm_frac = gbps_max / peak_bw
    # sequential dependent iterations set the latency floor when neither
    # resource is near saturation
    us_per_subop = seconds / max(cost.n_subops, 1) * 1e6
    if mfu > 0.5:
        bound = "compute"
    elif hbm_frac > 0.5:
        bound = "hbm"
    else:
        bound = "latency(%d seq sub-ops @ %.0fus)" % (cost.n_subops,
                                                      us_per_subop)
    rec = {
        "model_tflop": round(cost.flops / 1e12, 4),
        "recompute_tflop": round(cost.flops_recompute / 1e12, 4),
        "achieved_tflops": round(tflops, 3),
        "mfu_pct": round(100 * mfu, 2),
        "hbm_gbps": [round(gbps_min, 1), round(gbps_max, 1)],
        "hbm_pct_of_peak": round(100 * hbm_frac, 1),
        "bound": bound,
        "peak": {"device_kind": device.device_kind,
                 "tflops_bf16": peak_tf, "hbm_gbps": peak_bw},
    }
    rec["line"] = (
        "roofline[B=%d %s k=%d j=%d]: %.2fs -> %.2f TFLOP/s (%.2f%% MFU), "
        "HBM %.0f-%.0f GB/s (<=%.0f%% of peak), recompute %.0f%% of "
        "modelled flops, %d chunks / %d steps / %d seq sub-ops -> %s-bound"
        % (batch, mode.name, plan.k, plan.j, seconds, tflops,
           100 * mfu, gbps_min, gbps_max, 100 * hbm_frac,
           100 * cost.flops_recompute / max(cost.flops, 1),
           cost.n_chunks, cost.n_steps, cost.n_subops, rec["bound"]))
    return rec
