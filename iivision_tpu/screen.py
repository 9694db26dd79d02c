"""Apple II (D)HGR screen-memory model as functional array transforms.

Redesign rationale (vs reference transcoder/screen.py:128-341): the reference
packs pairs/quads of screen bytes into stateful uint64 scalars with 3-bit
header/footer halos that must be imperatively patched on every store.  XLA
wants functional state and 32-bit integer vector ops, so here screen state is
just the raw byte arrays (main: (32,256) u8, aux: (32,256) u8) and the packed
"masked lanes" - the 13-bit (DHGR) / 14-bit (HGR) windows whose pixels a byte
store influences - are *derived* from the byte arrays by pure int32 bit
arithmetic (shifts, masks, one roll for the inter-column halos).  Every halo
invariant the reference maintains by hand holds here by construction.

Packed-representation semantics are bit-identical to the reference:

DHGR (reference screen.py:819-1007): per column pair, 34-bit layout
    [hdr:3][aux_even:7][main_even:7][aux_odd:7][main_odd:7][ftr:3]
  hdr = top 3 bits of previous column's main_odd; ftr = low 3 bits of next
  column's aux_even; masked lane o = bits [7o, 7o+13).

HGR (reference screen.py:550-816): per column pair, 22-bit layout
    [hdr:3][even:8][odd_pal:1][odd_data:7][ftr:3]
  hdr = {odd.5, odd.6, odd.7(palette)} of previous column's odd byte;
  ftr = {even.7(palette), even.0, even.1} of next column's even byte;
  masked lane 0 = bits [0,14), lane 1 = bits [8,22).

All functions below take/return numpy or jax.numpy arrays interchangeably.
"""

from typing import Tuple

import numpy as np

from iivision_tpu.video_mode import VideoMode


# --- Address arithmetic (parity: reference screen.py:16-69) -----------------

def y_to_base_addr(y: int, page: int = 0) -> int:
    """Map y coordinate to base memory address on the given screen page."""
    a = y // 64
    d = y - 64 * a
    b = d // 8
    c = d - 8 * b
    return 8192 * (page + 1) + 1024 * c + 128 * b + 40 * a


Y_TO_BASE_ADDR = [
    [y_to_base_addr(y, screen_page) for y in range(192)]
    for screen_page in (0, 1)
]

PAGE_OFFSET_TO_X = np.zeros((32, 256), dtype=np.uint8)
PAGE_OFFSET_TO_Y = np.zeros((32, 256), dtype=np.uint8)
X_Y_TO_PAGE = np.zeros((192, 40), dtype=np.uint8)
X_Y_TO_OFFSET = np.zeros((192, 40), dtype=np.uint8)
SCREEN_HOLES = np.full((32, 256), True, dtype=bool)
ADDR_TO_COORDS = {}


def _populate_mappings():
    for y in range(192):
        for x in range(40):
            y_base = Y_TO_BASE_ADDR[0][y]
            page = y_base >> 8
            offset = y_base - (page << 8) + x
            PAGE_OFFSET_TO_Y[page - 32, offset] = y
            PAGE_OFFSET_TO_X[page - 32, offset] = x
            X_Y_TO_PAGE[y, x] = page - 32
            X_Y_TO_OFFSET[y, x] = offset
            SCREEN_HOLES[page - 32, offset] = False
            for p in range(2):
                ADDR_TO_COORDS[Y_TO_BASE_ADDR[p][y] + x] = (p, y, x)


_populate_mappings()


# --- Bitmap specifications ---------------------------------------------------

class DHGR:
    """DHGR packed-representation constants (reference screen.py:879-919)."""
    NAME = "DHGR"
    HEADER_BITS = 3
    BODY_BITS = 28
    FOOTER_BITS = 3
    MASKED_BITS = 13
    MASKED_DOTS = 10
    N_LANES = 4
    # NTSC clock phase at the first masked bit of each lane
    PHASES = (1, 0, 3, 2)

    @staticmethod
    def byte_offset(page_offset: int, is_aux: bool) -> int:
        """(page offset parity, bank) -> packed lane index 0..3."""
        is_odd = page_offset % 2 == 1
        if is_aux:
            return 2 if is_odd else 0
        return 3 if is_odd else 1

    @staticmethod
    def bank_lanes(is_aux: bool) -> Tuple[int, int]:
        """Lane indices for (even, odd) page offsets of a memory bank."""
        return (0, 2) if is_aux else (1, 3)

    @staticmethod
    def to_dots(masked_val, byte_offset: int):
        """13-bit masked lane is already the 13-dot display sequence."""
        return masked_val

    @staticmethod
    def masked_update(lane_vals, content):
        """Store a screen byte into lane-local masked values (all lanes alike:
        content occupies window bits [3,10))."""
        return (lane_vals & ~(0x7F << 3)) | ((content & 0x7F) << 3)


class HGR:
    """HGR packed-representation constants (reference screen.py:606-645)."""
    NAME = "HGR"
    HEADER_BITS = 3
    BODY_BITS = 16
    FOOTER_BITS = 3
    MASKED_BITS = 14
    MASKED_DOTS = 18
    N_LANES = 2
    PHASES = (1, 3)

    @staticmethod
    def byte_offset(page_offset: int, is_aux: bool) -> int:
        assert not is_aux
        return page_offset % 2

    @staticmethod
    def bank_lanes(is_aux: bool) -> Tuple[int, int]:
        assert not is_aux
        return (0, 1)

    @staticmethod
    def masked_update(lane_vals, content, lane: int = 0):
        """Store a screen byte into lane-local masked values.

        Lane 0 (even byte): all 8 bits at window bits [3,11).
        Lane 1 (odd byte): palette bit at window bit 3, data bits at [4,11)
        (reference screen.py:791-816, shifted into window-local coordinates).
        """
        if lane == 0:
            return (lane_vals & ~(0xFF << 3)) | ((content & 0xFF) << 3)
        shifted = ((content & 0x7F) << 1) | ((content & 0x80) >> 7)
        return (lane_vals & ~(0xFF << 3)) | (shifted << 3)

    @staticmethod
    def to_dots(masked_vals, byte_offset: int):
        return hgr_to_dots(masked_vals, byte_offset)


def spec_for_mode(mode: VideoMode):
    return DHGR if mode == VideoMode.DHGR else HGR


# --- Masked-lane derivation ---------------------------------------------------

def _xp(a):
    """Pick numpy or jax.numpy based on array type."""
    if type(a).__module__.startswith("jax") or "Array" in type(a).__name__:
        import jax.numpy as jnp
        return jnp
    return np


def dhgr_masked_lanes(main, aux):
    """Derive DHGR masked lanes from raw screen bytes.

    Args:
      main, aux: (..., 32, 256) uint8/int arrays of screen bytes.
    Returns:
      (..., 32, 128, 4) int32: the 13-bit masked window for each packed lane.
      Headers/footers never leak across page boundaries (column 0 header and
      column 127 footer are zero), matching reference screen.py:214-224.
    """
    xp = _xp(main)
    main = main.astype(xp.int32)
    aux = aux.astype(xp.int32)
    a0 = aux[..., 0::2] & 0x7F
    m0 = main[..., 0::2] & 0x7F
    a1 = aux[..., 1::2] & 0x7F
    m1 = main[..., 1::2] & 0x7F

    prev_m1 = xp.roll(m1, 1, axis=-1)
    prev_m1 = _zero_col(prev_m1, 0, xp)
    next_a0 = xp.roll(a0, -1, axis=-1)
    next_a0 = _zero_col(next_a0, -1, xp)

    hdr = prev_m1 >> 4
    ftr = next_a0 & 0b111

    lane0 = hdr | (a0 << 3) | ((m0 & 0b111) << 10)
    lane1 = (a0 >> 4) | (m0 << 3) | ((a1 & 0b111) << 10)
    lane2 = (m0 >> 4) | (a1 << 3) | ((m1 & 0b111) << 10)
    lane3 = (a1 >> 4) | (m1 << 3) | (ftr << 10)
    return xp.stack([lane0, lane1, lane2, lane3], axis=-1)


def hgr_masked_lanes(main):
    """Derive HGR masked lanes from raw screen bytes.

    Args:
      main: (..., 32, 256) uint8/int array of screen bytes.
    Returns:
      (..., 32, 128, 2) int32: the 14-bit masked window for each packed lane.
    """
    xp = _xp(main)
    main = main.astype(xp.int32)
    even = main[..., 0::2]
    odd = main[..., 1::2]

    prev_odd = xp.roll(odd, 1, axis=-1)
    prev_odd = _zero_col(prev_odd, 0, xp)
    next_even = xp.roll(even, -1, axis=-1)
    next_even = _zero_col(next_even, -1, xp)

    # header bits {0,1} = prev odd byte bits {5,6}; header bit 2 = its bit 7
    hdr = ((prev_odd >> 5) & 0b011) | ((prev_odd >> 5) & 0b100)
    # footer bit 0 = next even byte bit 7; footer bits {1,2} = its bits {0,1}
    ftr = ((next_even >> 7) & 1) | ((next_even & 0b11) << 1)

    packed = (hdr
              | (even << 3)
              | ((odd & 0x80) << 4)
              | ((odd & 0x7F) << 12)
              | (ftr << 19))
    lane0 = packed & 0x3FFF
    lane1 = (packed >> 8) & 0x3FFF
    return xp.stack([lane0, lane1], axis=-1)


def masked_lanes(main, aux, mode: VideoMode):
    if mode == VideoMode.DHGR:
        return dhgr_masked_lanes(main, aux)
    return hgr_masked_lanes(main)


def _zero_col(a, col, xp):
    if xp is np:
        a = a.copy()
        a[..., col] = 0
        return a
    return a.at[..., col].set(0)


# --- HGR dot expansion (parity: reference screen.py:710-789) -----------------

def _double_pixels(x):
    """Each of bits 0..6 controls two dots; bit 6 spills a third dot (bit 14)
    in case the following byte is palette-shifted."""
    dp = x & 0
    for k in range(7):
        bit = (x >> k) & 1
        dp = dp | (bit << (2 * k)) | (bit << (2 * k + 1))
    dp = dp | (((x >> 6) & 1) << 14)
    return dp


def hgr_to_dots(masked_vals, byte_offset: int):
    """Convert HGR 14-bit masked values to 21-bit display dot sequences.

    Vectorised port of the scalar algorithm in reference screen.py:741-789:
    each data bit doubles into two dots, the palette bit delays a byte's dots
    by one position, and a palette-shifted byte overwrites the spilled third
    dot of its predecessor's bit 6.
    """
    mv = masked_vals
    # 3-bit header occupies dot positions as a partial byte (bits 5,6 + palette)
    h = (mv & 0b111) << 5
    hp = (h & 0x80) >> 7
    res = _double_pixels(h & 0x7F) >> (11 - hp)

    if byte_offset == 0:
        b = (mv >> 3) & 0xFF
        bp = (b & 0x80) >> 7
        body = b & 0x7F
    else:
        bp = (mv >> 3) & 0x01
        body = (mv >> 4) & 0x7F
    # mask out in case we overwrite the spilled high dot of the header
    res = res & ~((2 ** 14 - 1) << (3 + bp))
    res = res ^ (_double_pixels(body) << (3 + bp))

    f = (mv >> 12) & 0b11
    fp = (mv >> 11) & 0b01
    res = res & ~((2 ** 4 - 1) << (17 + fp))
    res = res ^ (_double_pixels(f) << (17 + fp))
    return res & (2 ** 21 - 1)


# --- Whole-screen lane <-> diff helpers --------------------------------------

def interleave_bank_lanes(even_vals, odd_vals):
    """Interleave per-lane (..., N) arrays into (..., 2N) screen page-offset
    order (even page offsets from even_vals, odd from odd_vals)."""
    xp = _xp(even_vals)
    stacked = xp.stack([even_vals, odd_vals], axis=-1)
    return stacked.reshape(stacked.shape[:-2] + (stacked.shape[-2] * 2,))


def lane_pair_index(src_lanes, tgt_lanes, masked_bits: int):
    """Combine source/target masked lanes into edit-distance LUT indices."""
    return (src_lanes << masked_bits) + tgt_lanes
