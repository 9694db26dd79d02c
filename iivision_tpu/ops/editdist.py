"""Perceptual edit-distance table generation on the accelerator.

This replaces the reference's ~90-minute offline step (reference transcoder/
make_data_tables.py:111-204: 134M-268M Cython Damerau-Levenshtein DPs on CPU)
with a few batched matmul programs.

The mathematical reduction
--------------------------
The reference computes, for every pair (i, j) of masked screen-byte windows,
the weighted Damerau-Levenshtein distance between their nominal-colour pixel
strings, with substitution costs = CIE2000 distances (<= ~120), transposition
cost = 1, and insertion/deletion cost = 100000 (reference make_data_tables.py:
30-52).  Both strings always have the same length L, and the result is
asserted < 2^16 (make_data_tables.py:107).  Any DP path that leaves the main
diagonal must use at least one insertion AND one deletion (>= 200000), so
every optimal alignment stays on the diagonal and the full DP collapses to a
linear recurrence over positions k = 0..L-1:

    D[0] = 0
    D[k] = min(D[k-1] + sub(a[k-1], b[k-1]),
               D[k-2] + 1   if a[k-1] == b[k-2] and a[k-2] == b[k-1])

(transposition only for k >= 2).  For a whole (M x N) tile of string pairs,
each step becomes three small matmuls against 16-wide one-hot encodings:

    sub_k  = onehot(A[:, k]) @ C @ onehot(B[:, k]).T       (CIE2000 costs)
    swap_k = (onehot(A[:,k]) @ onehot(B[:,k-1]).T)
           * (onehot(A[:,k-1]) @ onehot(B[:,k]).T)          (0/1 eligibility)

which is matmul-shaped work.  A blocked pure-XLA path runs it on every
backend, and a scalar full-Damerau-Levenshtein oracle guards the diagonal
reduction in tests.

Table layout parity: reference stores an upper-triangle matrix encoded as
dist[o][(i << MASKED_BITS) + j], j < i, and symmetrises at load time
(reference screen.py:343-367).  `save_tables` writes that exact npz layout so
generated files are drop-in replacements; `load_tables`/`build_tables` return
the full symmetric matrix the encoder gathers from.
"""

import functools
import os
from typing import Optional

import numpy as np

from iivision_tpu import colours, palettes, screen
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode

TRANSPOSE_COST = 1
INDEL_COST = 100000

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


# --- pixel-code strings -------------------------------------------------------

@functools.lru_cache(None)
def lane_pixel_codes(mode: VideoMode, lane: int) -> np.ndarray:
    """(2^MASKED_BITS, MASKED_DOTS) uint8 colour codes for all masked values.

    Enumerates every masked window value of a packed lane, expands it to
    display dots (identity for DHGR; palette-bit shifting for HGR, reference
    screen.py:741-789) and runs the sliding-window NTSC colour model at the
    lane's clock phase (reference make_data_tables.py:143-151).
    """
    spec = screen.spec_for_mode(mode)
    n = 1 << spec.MASKED_BITS
    vals = np.arange(n, dtype=np.int64)
    dots = spec.to_dots(vals, lane)
    return colours.dots_to_pixels_vec(
        dots, num_bits=int(spec.MASKED_DOTS),
        init_phase=spec.PHASES[lane]).astype(np.uint8)


def substitute_matrix(palette: Palette) -> np.ndarray:
    """(16,16) int32 CIE2000 substitution costs."""
    return palettes.diff_matrix(palette)


# --- scalar oracle: full weighted Damerau-Levenshtein ------------------------

def dam_lev_scalar(a, b, sub: np.ndarray,
                   transpose_cost: float = TRANSPOSE_COST,
                   indel_cost: float = INDEL_COST) -> float:
    """Textbook weighted Damerau-Levenshtein (with the DA 'last seen' table).

    Behavioural oracle for the diagonal reduction; mirrors the semantics of
    the weighted_levenshtein.dam_lev C extension the reference calls
    (reference make_data_tables.py:92-108).  Host-side, test use only.
    """
    la, lb = len(a), len(b)
    maxdist = (la + lb) * indel_cost + 1
    d = np.full((la + 2, lb + 2), maxdist, dtype=np.float64)
    d[1, 1] = 0
    for i in range(1, la + 1):
        d[i + 1, 1] = i * indel_cost
    for j in range(1, lb + 1):
        d[1, j + 1] = j * indel_cost
    da = {}
    for i in range(1, la + 1):
        db = 0
        for j in range(1, lb + 1):
            k = da.get(b[j - 1], 0)
            l_ = db
            if a[i - 1] == b[j - 1]:
                cost = 0.0
                db = j
            else:
                cost = float(sub[a[i - 1], b[j - 1]])
            d[i + 1, j + 1] = min(
                d[i, j] + cost,  # substitution
                d[i + 1, j] + indel_cost,  # insertion
                d[i, j + 1] + indel_cost,  # deletion
                d[k, l_] + (i - k - 1) * indel_cost + transpose_cost
                + (j - l_ - 1) * indel_cost,  # transposition
            )
        da[a[i - 1]] = i
    return float(d[la + 1, lb + 1])


def diagonal_dp_scalar(a, b, sub: np.ndarray) -> float:
    """Scalar form of the diagonal recurrence (test cross-check)."""
    assert len(a) == len(b)
    dm2, dm1 = 0.0, None
    for k in range(len(a)):
        dk = (dm1 if dm1 is not None else 0.0) + float(sub[a[k], b[k]])
        if k >= 1 and a[k] == b[k - 1] and a[k - 1] == b[k]:
            dk = min(dk, dm2 + TRANSPOSE_COST)
        dm2, dm1 = (dm1 if dm1 is not None else 0.0), dk
    return dm1 if dm1 is not None else 0.0


# --- XLA batched diagonal DP ---------------------------------------------------
#
# Second reduction (on top of the diagonal one): under swap eligibility
# (a[k] == b[k-1] and a[k-1] == b[k]) the two substitutions a transposition
# replaces cost sub[k-1] + sub[k] = C[a[k-1], b[k-1]] + C[a[k], b[k]]
#                                 = 2 * C[a[k-1], a[k]]     (C symmetric),
# i.e. the replaced cost depends ONLY on the A string.  So
#
#   D = sum_k C[a[k], b[k]]                       <- ONE (M,16L)@(16L,N) matmul
#     + min over non-overlapping eligible swaps of sum (T - 2*C[a[k-1],a[k]])
#
# and the min is a max-savings independent-set scan whose per-position
# saving matrix is a single pair-code one-hot matmul with the A-side
# one-hot pre-scaled by the (clamped) saving:
#
#   s_k(i,j) = sa_k(i) * [pa_k(i) == pbswap_k(j)],   sa_k <= 0
#
# This turns the hot work from 3L K=16 matmuls into one K=16L matmul +
# (L-1) K=256 matmuls.


def dp_distance_tile(a_codes, b_codes, sub_f32):
    """Distance matrix for all pairs of pixel strings (pure jax.numpy).

    Args:
      a_codes: (M, L) int32 colour codes.
      b_codes: (N, L) int32 colour codes.
      sub_f32: (16, 16) float32 substitution costs (symmetric).
    Returns:
      (M, N) float32 distances (exact integers).

    Every dot here is exact at any matmul precision (TF32, bf16): its
    operands are 0/1 one-hots and integers of magnitude <= 219 (CIE2000
    costs <= 110 and clamped savings 2*cost - 1, all < 2^11), and it
    accumulates in f32.
    """
    import jax

    from iivision_tpu.ops.distance import EXACT_INT_SCOPE

    with jax.named_scope(EXACT_INT_SCOPE):
        return _dp_distance_tile(a_codes, b_codes, sub_f32)


def _dp_distance_tile(a_codes, b_codes, sub_f32):
    import jax.numpy as jnp

    L = a_codes.shape[-1]
    eye16 = jnp.arange(16, dtype=jnp.int32)
    eye256 = jnp.arange(256, dtype=jnp.int32)

    def onehot16(col):
        return (col[:, None] == eye16[None, :]).astype(jnp.float32)

    def onehot256(col):
        return (col[:, None] == eye256[None, :]).astype(jnp.float32)

    # base = sum_k C[a_k, b_k]: one matmul over concatenated one-hots
    oa = jnp.concatenate([onehot16(a_codes[:, k]) for k in range(L)], axis=1)
    wb = jnp.concatenate(
        [sub_f32 @ onehot16(b_codes[:, k]).T for k in range(L)], axis=0)
    base = oa @ wb  # (M, N)
    if L < 2:
        return base

    # per-row clamped savings sa_k = min(T - 2*C[a[k-1], a[k]], 0)
    ca = jnp.einsum("mki,ij,mkj->mk", onehot16(
        a_codes[:, :-1].reshape(-1)).reshape(a_codes.shape[0], L - 1, 16),
        sub_f32,
        onehot16(a_codes[:, 1:].reshape(-1)).reshape(
            a_codes.shape[0], L - 1, 16))
    sa = jnp.minimum(TRANSPOSE_COST - 2.0 * ca, 0.0)  # (M, L-1)

    pa = a_codes[:, :-1] * 16 + a_codes[:, 1:]  # (M, L-1) pair codes
    pbsw = b_codes[:, 1:] * 16 + b_codes[:, :-1]  # swapped pair codes

    # max-savings independent-set scan over positions k = 1..L-1
    f_m2 = jnp.zeros((a_codes.shape[0], b_codes.shape[0]), jnp.float32)
    f_m1 = f_m2
    for k in range(L - 1):
        spa = onehot256(pa[:, k]) * sa[:, k][:, None]
        s_k = spa @ onehot256(pbsw[:, k]).T  # (M, N), <= 0
        f_k = jnp.minimum(f_m1, f_m2 + s_k)
        f_m2, f_m1 = f_m1, f_k
    return base + f_m1


def edit_distance_matrix_xla(mode: VideoMode, palette: Palette, lane: int,
                             block: int = 2048,
                             n_rows: Optional[int] = None):
    """(n_rows, N) uint16 distance matrix for one lane, blocked over rows
    (n_rows=None: all N rows, the full matrix)."""
    import jax
    import jax.numpy as jnp

    codes = jnp.asarray(lane_pixel_codes(mode, lane).astype(np.int32))
    sub = jnp.asarray(substitute_matrix(palette).astype(np.float32))
    n = codes.shape[0] if n_rows is None else n_rows

    @jax.jit
    def block_fn(a_block):
        return dp_distance_tile(a_block, codes, sub).astype(jnp.uint16)

    rows = [block_fn(codes[i:min(i + block, n)]) for i in range(0, n, block)]
    return jnp.concatenate(rows, axis=0)


# --- public API -----------------------------------------------------------------

def build_tables(mode: VideoMode, palette: Palette,
                 n_rows: Optional[int] = None):
    """Build edit-distance LUTs for all lanes of a video mode.

    Returns (n_lanes, 2^(2*MASKED_BITS)) uint16 on the default JAX device:
    the full symmetric matrix, indexed by (src << MASKED_BITS) + tgt.
    n_rows limits each lane to its first n_rows source values (tests and
    dry runs), as in parallel.mesh.build_tables_sharded.
    """
    import jax.numpy as jnp

    spec = screen.spec_for_mode(mode)
    return jnp.stack([
        edit_distance_matrix_xla(mode, palette, lane, n_rows=n_rows)
        .reshape(-1) for lane in range(spec.N_LANES)])


def table_path(mode: VideoMode, palette: Palette,
               data_dir: Optional[str] = None) -> str:
    spec = screen.spec_for_mode(mode)
    return os.path.join(
        data_dir or DATA_DIR,
        "%s_palette_%d_edit_distance.npz" % (spec.NAME, palette.value))


def save_tables(tables, mode: VideoMode, palette: Palette,
                data_dir: Optional[str] = None) -> str:
    """Save LUTs in the reference's npz layout (upper triangle only).

    Written files are drop-in replacements for the reference's
    transcoder/data/*.npz artifacts (reference make_data_tables.py:177-188).
    """
    spec = screen.spec_for_mode(mode)
    bits = spec.MASKED_BITS
    n = 1 << bits
    full = np.asarray(tables).reshape(len(tables), n, n)
    tri = np.where(
        np.arange(n)[:, None] > np.arange(n)[None, :], full, 0
    ).astype(np.uint16)
    path = table_path(mode, palette, data_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, edit_distance=tri.reshape(len(tables), n * n))
    return path


def load_tables(mode: VideoMode, palette: Palette,
                data_dir: Optional[str] = None) -> np.ndarray:
    """Load + symmetrise reference-layout npz (reference screen.py:343-367)."""
    spec = screen.spec_for_mode(mode)
    n = 1 << spec.MASKED_BITS
    dist = np.load(table_path(mode, palette, data_dir))["edit_distance"]
    full = dist.reshape(len(dist), n, n)
    full = full + np.transpose(full, (0, 2, 1))
    return full.reshape(len(dist), n * n)
