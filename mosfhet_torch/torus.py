"""Discretized-torus scalar helpers and gadget decomposition.

A torus element x / 2^TORUS_BITS is carried as a signed integer tensor
holding the unsigned bit pattern: ``int64`` words at the 64-bit torus (the
default), ``int32`` words at the 32-bit one.  PyTorch has no unsigned
arithmetic on the CPU, and signed ``+``, ``-`` and ``*`` wrap mod 2^64 and
2^32 exactly like u64 and u32.  ``>>`` is arithmetic, so every logical
right shift below is followed by a mask.  Helpers mirror the reference's
`src/misc.c:9-28`.

Like the reference's compile-time ``-DTORUS32`` flag, the width is fixed at
import time: ``MOSFHET_TORUS_BITS=32`` in the environment selects the
32-bit torus (default 64).  Functions that take torus tensors read the
width from the tensor's dtype, so both widths can meet in one process
(the kernel tests do); functions that make words use the module's width.
"""

from __future__ import annotations

import os

import torch

TORUS_BITS = int(os.environ.get("MOSFHET_TORUS_BITS", "64"))
if TORUS_BITS not in (32, 64):
    raise ValueError("MOSFHET_TORUS_BITS must be 32 or 64")
TORUS_DTYPE = torch.int64 if TORUS_BITS == 64 else torch.int32
# The TPU package's signed view of a word; here the words already are it.
SIGNED_DTYPE = TORUS_DTYPE
TORUS_MASK = (1 << TORUS_BITS) - 1


def word_bits(x: torch.Tensor) -> int:
    """The torus width of a word tensor: 32 for int32, 64 for int64."""
    if x.dtype == torch.int32:
        return 32
    if x.dtype == torch.int64:
        return 64
    raise TypeError(f"torus words are int32 or int64 tensors, not {x.dtype}")


def to_signed(x: int, bits: int = TORUS_BITS) -> int:
    """A ``bits``-bit unsigned Python int as the signed value with the same
    bit pattern: the constant a word tensor of that width holds."""
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


def wrap(x: torch.Tensor, dtype: torch.dtype = TORUS_DTYPE) -> torch.Tensor:
    """Integer tensor -> torus words of ``dtype``, mod 2^32 or 2^64.  The
    int64 -> int32 conversion keeps the low 32 bits (two's complement);
    `tests/test_torch_torus32.py` holds that against Python ints."""
    return x.to(dtype)


def torus2double(x):
    """Torus words -> float64 in [0, 1] (`misc.c:9-11`): the unsigned value
    over 2^bits, rounded once (a u64 word's 32-bit halves are each exact in
    float64), so 1.0 where the word rounds up to 2^64."""
    if x.dtype == torch.int32:
        return (x.to(torch.int64) & 0xFFFFFFFF).to(torch.float64) / 2.0**32
    hi = ((x >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (x & 0xFFFFFFFF).to(torch.float64)
    return (hi * 2.0**32 + lo) / 2.0**64


def double2torus(x, device=None):
    """float64 -> torus words of the module's width: round-free
    frac(x) * 2^bits (a hi/lo split at 64 bits, the reference package's
    form at both widths).

    Well-defined for every x (the reference's `(Torus)(int64_t)(x*2^64)`,
    `misc.c:13-15`, is not at |x| >= 0.5)."""
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    frac = x - torch.floor(x)                        # [0, 1)
    if TORUS_BITS == 32:
        return wrap(torch.floor(frac * 4294967296.0).to(torch.int64))
    hi = torch.floor(frac * 4294967296.0)
    lo = (frac * 4294967296.0 - hi) * 4294967296.0
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def torus2int(x, log_scale: int):
    """round(x * 2^log_scale) as integer in [0, 2^log_scale) (`misc.c:18-22`),
    of x's dtype."""
    shift = word_bits(x) - log_scale
    round_offset = 1 << (shift - 1)
    return ((x + round_offset) >> shift) & ((1 << log_scale) - 1)


def int2torus(x, log_scale: int):
    """integer -> torus multiple of 2^-log_scale (`misc.c:25-28`), a word of
    the module's width."""
    return wrap(torch.as_tensor(x)) << (TORUS_BITS - log_scale)


def gadget_offset(Bg_bit: int, l: int, rounded: bool = True,
                  bits: int = TORUS_BITS) -> int:
    """The decomposition offset as an unsigned ``bits``-bit Python int.

    `polynomial_decompose_i` (`polynomial.c:74-89`, every hot path) adds a
    rounding half-bit below the last digit; `polynomial_decompose`
    (`polynomial.c:55-72`) does not."""
    offset = 0
    for i in range(l):
        offset += 1 << (bits - i * Bg_bit - 1)
    if rounded:
        offset += 1 << (bits - l * Bg_bit - 1)
    return offset & ((1 << bits) - 1)


def gadget_decompose(x, Bg_bit: int, l: int, rounded: bool = True):
    """Signed gadget digits of torus tensor ``x`` [..., N] -> int32
    [..., l, N] in [-Bg/2, Bg/2), x ~ sum_i d_i * 2^(bits-(i+1)*Bg_bit),
    at x's width.

    The arithmetic shift needs no extra mask: ``& mask`` keeps Bg_bit bits,
    all below the sign-extended ones (shift + Bg_bit <= bits)."""
    bits = word_bits(x)
    offset = to_signed(gadget_offset(Bg_bit, l, rounded, bits), bits)
    shifts = torch.tensor([bits - (i + 1) * Bg_bit for i in range(l)],
                          dtype=x.dtype, device=x.device)
    shifted = (x + offset).unsqueeze(-2) >> shifts[:, None]
    digits = (shifted & ((1 << Bg_bit) - 1)) - (1 << (Bg_bit - 1))
    return digits.to(torch.int32)


def gadget_recompose(digits, Bg_bit: int):
    """sum_i d_i * 2^(bits-(i+1)*Bg_bit) mod 2^bits of signed digits [...,
    l, N] -> torus words [..., N] of the module's width: the inverse of
    `gadget_decompose` up to its rounding (a test helper)."""
    l = digits.shape[-2]
    weights = torch.tensor(
        [to_signed(1 << (TORUS_BITS - (i + 1) * Bg_bit)) for i in range(l)],
        dtype=TORUS_DTYPE, device=digits.device)
    d = wrap(digits.to(torch.int64))
    return (d * weights[:, None]).sum(dim=-2, dtype=TORUS_DTYPE)
