"""On-the-fly perceptual distances: the encoder's gather-free compute path.

The reference (and our ops/editdist.py artifact generator) materialises the
full pairwise edit-distance LUT: 512MB-1GB of uint16 indexed by
(src_lane << B) + tgt_lane.  Random gathers from tables that size are the
slow access pattern on an accelerator.  This module computes the same
distances directly:

- `dist_pairs`: the diagonal Damerau-Levenshtein recurrence (see
  ops/editdist.py for the proof it equals the reference's metric) evaluated
  *elementwise* on arrays of lane-value pairs.  Substitution costs come from
  a 16x16 CIE2000 matrix via one-hot contractions - dense vector and
  matmul work, zero gathers.  Used for the per-chunk diff recompute
  (current screen vs target).
- `store_cost_table`: D(masked_update(t, c), t) for every (lane value t,
  content c) - only (n_lanes, 2^B, n_contents) f32 (4-32MB), computed once
  per (mode, palette) in milliseconds.  The encoder turns it into a
  per-frame cost slab with one one-hot matmul at frame boundaries, making
  companion-offset evaluation a tiny batched contraction per step.

Equality with the LUT path is exact (same recurrence, integer values) and
tested against the scalar oracle.
"""

import contextlib
import functools
import os

import numpy as np

from iivision_tpu import palettes, screen
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode

TRANSPOSE_COST = 1.0
BIG = 1e9

# Bump when store-cost semantics change (invalidates shipped artifacts).
STORE_COST_VERSION = 1
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


# Name scope of the f32 dots that are exact at any matmul precision
# (TF32, bf16) because their operands are small integers; every other f32
# dot on the device path asks for HIGHEST (tests/test_precision.py).
EXACT_INT_SCOPE = "exact_int_dot"


def exact_int_scope(xp):
    """jax.named_scope(EXACT_INT_SCOPE) for jnp arrays, a no-op for numpy."""
    if xp is np:
        return contextlib.nullcontext()
    import jax
    return jax.named_scope(EXACT_INT_SCOPE)


def _einsum_highest(xp, spec, *operands):
    """einsum at full f32 precision (numpy is always full precision)."""
    if xp is np:
        return np.einsum(spec, *operands)
    import jax
    return xp.einsum(spec, *operands, precision=jax.lax.Precision.HIGHEST)


def lane_pixels(vals, mode: VideoMode, lane: int):
    """Masked lane values -> (..., L) pixel colour codes (jnp or numpy).

    Vectorised masked-value -> dots -> sliding-window colour extraction at
    the lane's NTSC phase (reference transcoder/colours.py:100-134).
    """
    xp = screen._xp(vals)
    spec = screen.spec_for_mode(mode)
    dots = spec.to_dots(vals.astype(xp.int32), lane)
    L = int(spec.MASKED_DOTS)
    ph = spec.PHASES[lane]
    cols = []
    for i in range(L):
        w = (dots >> i) & 0xF
        r = (ph + i) % 4
        if r:
            w = ((w << r) | (w >> (4 - r))) & 0xF
        cols.append(w)
    return xp.stack(cols, axis=-1)


def dist_pixel_pairs(pa, pb, sub16):
    """Elementwise diagonal DP distance between pixel-code arrays.

    pa, pb: (..., L) int codes; sub16: (16, 16) float costs.
    Returns (...,) float32 distances (exact integers).  Works for jnp and
    numpy inputs.
    """
    xp = screen._xp(pa)
    L = pa.shape[-1]
    eye = xp.arange(16, dtype=pa.dtype)
    oa = (pa[..., None] == eye).astype(sub16.dtype)  # (..., L, 16)
    ob = (pb[..., None] == eye).astype(sub16.dtype)
    # sub_k = C[a_k, b_k] via one-hot contraction (no gathers).  Exact at
    # any matmul precision: the operands are 0/1 one-hots and integer
    # costs <= 110 (< 2^8, exact in bf16 and TF32), and each sum has one
    # nonzero term.  (bf16 operands measured no faster on an H100.)
    with exact_int_scope(xp):
        sub_all = xp.einsum("...ki,ij,...kj->...k", oa, sub16, ob)
    # adjacent-transposition eligibility
    swap = (pa[..., 1:] == pb[..., :-1]) & (pa[..., :-1] == pb[..., 1:])
    swap = swap.astype(sub16.dtype)

    d_m2 = xp.zeros(pa.shape[:-1], sub16.dtype)
    d_m1 = sub_all[..., 0]
    for k in range(1, L):
        dk = d_m1 + sub_all[..., k]
        dk = xp.minimum(dk, d_m2 + TRANSPOSE_COST
                        + (1.0 - swap[..., k - 1]) * BIG)
        d_m2, d_m1 = d_m1, dk
    return d_m1


def dist_window_sums(wa, wb, subs):
    """Per-position pair costs summed (YIQ model: no alignment DP).

    wa, wb: (..., L) 7-bit window codes; subs: (L, 128, 128) costs.
    """
    xp = screen._xp(wa)
    eye = xp.arange(128, dtype=wa.dtype)
    oa = (wa[..., None] == eye).astype(subs.dtype)
    ob = (wb[..., None] == eye).astype(subs.dtype)
    # fractional costs: HIGHEST, or TF32 would round them
    d = _einsum_highest(xp, "...ki,kij,...kj->...k", oa, subs, ob)
    return d.sum(axis=-1)


def dist_window_sums_sub2(wa, wb, subs2):
    """dist_window_sums with a leading stack axis carrying its own subs.

    wa, wb: (S, ..., L) window codes; subs2: (S, L, 128, 128) costs.
    Bit-identical to stacking S separate dist_window_sums calls (the
    einsum is elementwise over the leading axis) - used to run both of a
    bank's lanes through one call in the encoder's chunk recompute.
    """
    xp = screen._xp(wa)
    eye = xp.arange(128, dtype=wa.dtype)
    oa = (wa[..., None] == eye).astype(subs2.dtype)
    ob = (wb[..., None] == eye).astype(subs2.dtype)
    d = _einsum_highest(xp, "s...ki,skij,s...kj->s...k", oa, subs2, ob)
    return d.sum(axis=-1)


def dist_lane_pairs(va, vb, mode: VideoMode, lane: int, sub16):
    """Distance between masked-lane value arrays (elementwise pairs).

    The cost basis rides in `sub16`'s rank: (16, 16) selects the reference's
    windowed-colour Damerau-Levenshtein; (n_lanes, L, 128, 128) selects the
    NTSC-composite YIQ model (ops/yiq.py).  Everything downstream (encoder
    scan, host oracle, quality metrics) is agnostic.
    """
    if getattr(sub16, "ndim", 2) == 4:
        from iivision_tpu.ops import yiq
        return dist_window_sums(yiq.lane_windows(va, mode, lane),
                                yiq.lane_windows(vb, mode, lane),
                                sub16[lane])
    return dist_pixel_pairs(lane_pixels(va, mode, lane),
                            lane_pixels(vb, mode, lane), sub16)


@functools.lru_cache(None)
def sub16(palette: Palette) -> np.ndarray:
    return palettes.diff_matrix(palette).astype(np.float32)


@functools.lru_cache(None)
def sub16_mono() -> np.ndarray:
    """16x16 monochrome-monitor basis: dot-level hamming distance.

    A nominal colour's 4-bit VALUE is its dot window, and the window->
    colour phase rotation is the same for both operands at any position,
    so popcount(a ^ b) is exactly the number of differing DOTS - what a
    mono monitor displays (reference README.md "Mono playback mode").
    Scaled x25 so magnitudes are comparable to the CIEDE2000 basis
    (max 100); palette-independent.
    """
    a = np.arange(16)
    ham = np.unpackbits(
        (a[:, None] ^ a[None, :]).astype(np.uint8)[..., None],
        axis=-1).sum(axis=-1)
    return (ham * 25).astype(np.float32)


def sub_for(mode: VideoMode, palette: Palette,
            model: str = "window") -> np.ndarray:
    """Cost basis for `model`: 'window' (reference parity), 'yiq', or
    'mono' (dot-level hamming for monochrome monitors)."""
    if model == "yiq":
        from iivision_tpu.ops import yiq
        return yiq.lane_subs(mode, palette)
    if model == "mono":
        return sub16_mono()
    if model != "window":
        raise ValueError("unknown colour model: %r" % (model,))
    return sub16(palette)


def n_contents(mode: VideoMode) -> int:
    """Distinct content bytes a store can carry: DHGR bytes are 7-bit
    (palette bit unused, reference video.py:135-137), HGR full 8-bit."""
    return 128 if mode == VideoMode.DHGR else 256


def store_cost_path(mode: VideoMode, palette: Palette, model: str,
                    data_dir=None) -> str:
    """Artifact path for a store-cost table (shipped for common configs)."""
    return os.path.join(
        data_dir or DATA_DIR, "store_cost",
        "v%d_%s_%s_%s.npz" % (STORE_COST_VERSION, mode.name,
                              palette.name, model))


def _user_cache_dir() -> str:
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.expanduser("~/.cache")), "iivision_tpu")


@functools.lru_cache(None)
def store_cost_table(mode: VideoMode, palette: Palette,
                     model: str = "window"):
    """(n_lanes, 2^B, n_contents) f32: cost of storing content c over a
    target whose lane window is t - D(masked_update(t, c), t).

    This is the whole distance model the encoder needs: companion-offset
    costs read it directly, and residual priorities are exactly these values
    (reference byte_pair_difference, screen.py:383-398, evaluated against
    the target's packed data as in video.py:163-170).

    Cold-start path: shipped npz artifacts (package data/store_cost/, the
    analogue of the reference shipping transcoder/data/*.npz,
    reference README.md:61-67) or a per-user cache load in ~0.1s; a cache
    miss builds on-device and persists to the user cache.  Window-model
    values are exact integers < 2^12, stored as uint16 (bit-exact reload);
    yiq values are stored f32.
    """
    import jax.numpy as jnp

    for d in (None, _user_cache_dir()):
        path = store_cost_path(mode, palette, model, d)
        if os.path.exists(path):
            return jnp.asarray(
                np.load(path)["cost"].astype(np.float32))
    table = _build_store_cost(mode, palette, model)
    try:
        save_store_cost(np.asarray(table), mode, palette, model,
                        _user_cache_dir())
    except OSError:
        pass  # read-only home: rebuild next process
    return table


def save_store_cost(cost: np.ndarray, mode: VideoMode, palette: Palette,
                    model: str, data_dir=None) -> str:
    path = store_cost_path(mode, palette, model, data_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if model in ("window", "mono"):  # exact ints < 2^12: uint16 round-trips
        assert float(np.abs(cost - np.round(cost)).max()) == 0.0
        out = cost.astype(np.uint16)
    else:
        out = cost.astype(np.float32)
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "wb") as f:
        np.savez_compressed(f, cost=out)
    os.replace(tmp, path)
    return path


def _build_store_cost(mode: VideoMode, palette: Palette,
                      model: str = "window"):
    import jax

    return jax.jit(store_cost_fn(mode, palette, model))()


def store_cost_fn(mode: VideoMode, palette: Palette, model: str = "window"):
    """The store-cost build as a traceable zero-argument function."""
    import jax
    import jax.numpy as jnp

    spec = screen.spec_for_mode(mode)
    n = 1 << int(spec.MASKED_BITS)
    C = n_contents(mode)
    sub = jnp.asarray(sub_for(mode, palette, model))
    # bound the one-hot transients to ~tens of MB: (chunk, C, L, width) f32
    # per operand, where width is 16 (window model) or 128 (yiq)
    chunk = 32 if model == "yiq" else 256

    def build():
        c = jnp.arange(C, dtype=jnp.int32)[None, :]  # (1, C)
        outs = []
        for lane in range(int(spec.N_LANES)):
            def one_chunk(t0, lane=lane):
                t = (t0 * chunk
                     + jnp.arange(chunk, dtype=jnp.int32))[:, None]
                if mode == VideoMode.DHGR:
                    new = spec.masked_update(t, c)
                else:
                    new = spec.masked_update(t, c, lane)
                tt = jnp.broadcast_to(t, (chunk, C))
                return dist_lane_pairs(new, tt, mode, lane, sub)

            rows = jax.lax.map(one_chunk,
                               jnp.arange(n // chunk, dtype=jnp.int32))
            outs.append(rows.reshape(n, C))
        return jnp.stack(outs)

    return build


class ComputedDistance:
    """Distance provider for the encoder: store-cost slab + on-the-fly DP.

    Replaces the LUT tables; all members are small device arrays.
    model: 'window' (reference-parity nominal colours) or 'yiq'
    (NTSC-composite demodulation, ops/yiq.py).
    """

    def __init__(self, mode: VideoMode, palette: Palette,
                 model: str = "window"):
        self.mode = mode
        self.palette = palette
        self.model = model
        self.spec = screen.spec_for_mode(mode)
        self.store_cost = store_cost_table(mode, palette, model)
        import jax.numpy as jnp
        self.sub = jnp.asarray(sub_for(mode, palette, model))
        self.n_contents = n_contents(mode)

    def lane_diff(self, cur_lane_vals, tgt_lane_vals, lane: int):
        """D(cur, tgt) elementwise - used at chunk-start recomputes."""
        return dist_lane_pairs(cur_lane_vals, tgt_lane_vals, self.mode,
                               lane, self.sub)
