"""Discretized-torus scalar helpers and gadget decomposition (64-bit torus).

A torus element x / 2^64 is carried as an ``int64`` tensor holding the u64
bit pattern: PyTorch has no unsigned 64-bit arithmetic on the CPU, and
int64 ``+``, ``-`` and ``*`` wrap mod 2^64 exactly like u64.  ``>>`` on
int64 is arithmetic, so every logical right shift below is followed by a
mask.  Helpers mirror the reference's `src/misc.c:9-28`.
"""

from __future__ import annotations

import torch

TORUS_BITS = 64
TORUS_MASK = (1 << TORUS_BITS) - 1


def to_i64(x: int) -> int:
    """A u64 Python int as the int64 value with the same bit pattern."""
    x &= TORUS_MASK
    return x - (1 << 64) if x >= (1 << 63) else x


def double2torus(x, device=None):
    """float64 -> torus: round-free frac(x) * 2^64 via a hi/lo split.

    Well-defined for every x (the reference's `(Torus)(int64_t)(x*2^64)`,
    `misc.c:13-15`, is not at |x| >= 0.5)."""
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    frac = x - torch.floor(x)                        # [0, 1)
    hi = torch.floor(frac * 4294967296.0)
    lo = (frac * 4294967296.0 - hi) * 4294967296.0
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def torus2int(x, log_scale: int):
    """round(x * 2^log_scale) as integer in [0, 2^log_scale) (`misc.c:18-22`)."""
    shift = TORUS_BITS - log_scale
    round_offset = 1 << (shift - 1)
    return ((x + round_offset) >> shift) & ((1 << log_scale) - 1)


def int2torus(x, log_scale: int):
    """integer -> torus multiple of 2^-log_scale (`misc.c:25-28`)."""
    return x << (TORUS_BITS - log_scale)


def gadget_offset(Bg_bit: int, l: int, rounded: bool = True) -> int:
    """The decomposition offset as a u64 Python int.

    `polynomial_decompose_i` (`polynomial.c:74-89`, every hot path) adds a
    rounding half-bit below the last digit; `polynomial_decompose`
    (`polynomial.c:55-72`) does not."""
    offset = 0
    for i in range(l):
        offset += 1 << (TORUS_BITS - i * Bg_bit - 1)
    if rounded:
        offset += 1 << (TORUS_BITS - l * Bg_bit - 1)
    return offset & TORUS_MASK


def gadget_decompose(x, Bg_bit: int, l: int, rounded: bool = True):
    """Signed gadget digits of torus tensor ``x`` [..., N] -> int32
    [..., l, N] in [-Bg/2, Bg/2), x ~ sum_i d_i * 2^(64-(i+1)*Bg_bit).

    The arithmetic shift needs no extra mask: ``& mask`` keeps Bg_bit bits,
    all below the sign-extended ones (shift + Bg_bit <= 64)."""
    offset = to_i64(gadget_offset(Bg_bit, l, rounded))
    shifts = torch.tensor([TORUS_BITS - (i + 1) * Bg_bit for i in range(l)],
                          dtype=torch.int64, device=x.device)
    shifted = (x + offset).unsqueeze(-2) >> shifts[:, None]
    digits = (shifted & ((1 << Bg_bit) - 1)) - (1 << (Bg_bit - 1))
    return digits.to(torch.int32)
