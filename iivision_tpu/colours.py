"""Apple II nominal display colours via the 4-bit NTSC sliding-window model.

The Apple II produces colour through NTSC artifacting: the colour of each
display dot is determined by a sliding 4-bit window of the surrounding dot
stream, rotated by the NTSC clock phase at that dot.  This module provides
both scalar and fully vectorised (numpy / JAX) implementations of that model.

Behavioural parity with reference transcoder/colours.py:18-148 (colour enums,
rol/ror, dots_to_nominal_colour_pixels).  The vectorised forms are new: they
map *arrays* of dot-streams to pixel-value arrays in one shot, which is what
the device table-generation path consumes (see ops/editdist.py).
"""

import enum
from typing import Tuple, Type

import numpy as np


class NominalColours(enum.Enum):
    pass


class HGRColours(NominalColours):
    """4-bit dot window -> nominal colour, HGR phase convention.

    Dots are in memory bit order (MSB -> LSB), opposite to screen order.
    HGR and DHGR mappings are 4-bit rotations of each other due to a 1-tick
    phase difference in the colour reference signal.
    """
    BLACK = 0b0000
    MAGENTA = 0b0001
    BROWN = 0b1000
    ORANGE = 0b1001
    DARK_GREEN = 0b0100
    GREY1 = 0b0101
    GREEN = 0b1100
    YELLOW = 0b1101
    DARK_BLUE = 0b0010
    VIOLET = 0b0011
    GREY2 = 0b1010
    PINK = 0b1011
    MED_BLUE = 0b0110
    LIGHT_BLUE = 0b0111
    AQUA = 0b1110
    WHITE = 0b1111


class DHGRColours(NominalColours):
    """4-bit dot window -> nominal colour, DHGR phase convention."""
    BLACK = 0b0000
    MAGENTA = 0b1000
    BROWN = 0b0100
    ORANGE = 0b1100
    DARK_GREEN = 0b0010
    GREY1 = 0b1010
    GREEN = 0b0110
    YELLOW = 0b1110
    DARK_BLUE = 0b0001
    VIOLET = 0b1001
    GREY2 = 0b0101
    PINK = 0b1101
    MED_BLUE = 0b0011
    LIGHT_BLUE = 0b1011
    AQUA = 0b0111
    WHITE = 0b1111


def ror(int4: int, howmany: int) -> int:
    """Rotate-right a 4-bit value `howmany` times."""
    r = howmany % 4
    return ((int4 >> r) | (int4 << (4 - r))) & 0b1111


def rol(int4: int, howmany: int) -> int:
    """Rotate-left a 4-bit value `howmany` times."""
    r = howmany % 4
    return ((int4 << r) | (int4 >> (4 - r))) & 0b1111


def dots_to_nominal_colour_pixels(
        num_bits: int,
        dots: int,
        colours: Type[NominalColours],
        init_phase: int = 1,
) -> Tuple[NominalColours, ...]:
    """Scalar reference: sequence of nominal colours via sliding 4-bit window.

    Pixel i is the 4-bit window dots[i:i+4], rotated left by the NTSC phase
    (init_phase + i) mod 4.  Includes the 3-bit header region, i.e. the first
    windows straddle the trailing bits of the previous packed column.
    """
    res = []
    shifted = dots
    phase = init_phase
    for _ in range(num_bits):
        res.append(colours(rol(shifted & 0b1111, phase)))
        shifted >>= 1
        phase = (phase + 1) % 4
    return tuple(res)


def dots_to_nominal_colour_pixel_values(
        num_bits: int,
        dots: int,
        colours: Type[NominalColours],
        init_phase: int = 1,
) -> Tuple[int, ...]:
    return tuple(
        p.value for p in
        dots_to_nominal_colour_pixels(num_bits, dots, colours, init_phase))


def dots_to_pixels_vec(
        dots: np.ndarray,
        num_bits: int,
        init_phase: int,
) -> np.ndarray:
    """Vectorised sliding-window colour extraction (numpy or jax.numpy arrays).

    Args:
      dots: integer array of dot streams (any shape), bit i = dot i.
      num_bits: number of pixel windows to extract.
      init_phase: NTSC phase of the first window.

    Returns:
      int array of shape dots.shape + (num_bits,), each entry in 0..15: the
      4-bit window value rotated left by its phase.  Works identically for
      numpy and jax.numpy inputs (pure ufunc arithmetic).

    The enum mapping (HGRColours vs DHGRColours) is the identity on values -
    enums only assign *names* to the 4-bit codes - so downstream consumers
    (CIE2000 cost lookup) index by these raw window values directly.
    """
    xp = np  # ufunc arithmetic below is numpy/jnp agnostic via __array_ufunc__
    d = dots[..., None]
    shifts = xp.arange(num_bits, dtype=dots.dtype if hasattr(dots, "dtype") else np.int64)
    win = (d >> shifts) & 0b1111
    phases = (init_phase + np.arange(num_bits)) % 4
    # rotate-left each window by its phase
    out = ((win << phases) | (win >> (4 - phases))) & 0b1111
    return out
