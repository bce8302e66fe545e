"""The threefry-2x32 counter stream of the TPU package's randomness, in
plain PyTorch.

A seeded sample (`seeded.SeededTRLWE`) and a seeded key-switch key store a
threefry key instead of their uniform mask, and the mask *is* the stream of
that key in the TPU package (its `rng.uniform_torus`, `rng.py:27-34`).  So
a seeded key made by the TPU package decrypts in the port only if the port
regenerates the same words, which this module does:

    counts = iota(total); (y0, y1) = threefry2x32(key, (hi(i), lo(i)))
    word i = y0 ^ y1

(the partitionable mapping, that package's default: the 64-bit flat index
split into two 32-bit counter words, hi 0 below 2^32 words).  A u64 torus
word takes its high half from the key and its low half from the key folded
with 1 (`folded_key_data`).  The port's own randomness stays on
``torch.Generator`` (`rng`); this stream only expands seeds.

CPU PyTorch has no uint32 add or shift, so every u32 value is carried in
an int64 tensor in [0, 2^32) and masked after each add and shift.
`tests/test_torch_prng.py` holds the stream to the TPU package's word for
word, the only guard it has: the card's machine has no TPU package.
"""

from __future__ import annotations

import math

import torch

from ..torus import TORUS_BITS, TORUS_DTYPE, wrap

U32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & U32


def threefry2x32(k1, k2, x0, x1):
    """One threefry-2x32 block (20 rounds, the reference schedule of
    Salmon et al., SC'11) over int64 tensors of u32 values that broadcast
    together; returns (y0, y1)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & U32
    x1 = (x1 + ks[1]) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & U32
    return x0, x1


def random_u32_at(k1, k2, fidx):
    """Words ``fidx`` (int64 flat indices below 2^32) of the key (k1, k2)'s
    u32 stream, as int64 values in [0, 2^32)."""
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(fidx), fidx)
    return y0 ^ y1


def folded_key_data(seed):
    """The key folded with 1 for keys ``seed`` [..., 2] (u32 values in
    int64): one threefry block on the counter (0, 1)."""
    zero = torch.zeros_like(seed[..., 0])
    y0, y1 = threefry2x32(seed[..., 0], seed[..., 1], zero, zero + 1)
    return torch.stack([y0, y1], dim=-1)


def mask_u64_words_at(key_hi, key_lo, fidx):
    """(hi, lo) u32 halves of the u64 torus words at flat indices ``fidx``:
    hi from ``key_hi`` (a sample's stored key), lo from ``key_lo`` (its
    `folded_key_data`).  Keys [..., 2] broadcast against fidx's leading
    axes with one more axis for the index."""
    hi = random_u32_at(key_hi[..., 0, None], key_hi[..., 1, None], fidx)
    lo = random_u32_at(key_lo[..., 0, None], key_lo[..., 1, None], fidx)
    return hi, lo


def uniform_torus_from_key_data(seed, shape):
    """The TPU package's ``rng.uniform_torus`` of each key of ``seed``
    [..., 2] (u32 values in int64) and ``shape``: torus words [...,
    *shape] of the module's width, on seed's device."""
    shape = tuple(shape)
    total = math.prod(shape)
    if total >= 1 << 32:
        raise ValueError(f"{total} words per key: the stream counts below 2^32")
    fidx = torch.arange(total, dtype=torch.int64, device=seed.device)
    seed = seed.to(torch.int64)
    lead = tuple(seed.shape[:-1])
    if TORUS_BITS == 32:
        w = random_u32_at(seed[..., 0, None], seed[..., 1, None], fidx)
        return wrap(w, TORUS_DTYPE).reshape(lead + shape)
    hi, lo = mask_u64_words_at(seed, folded_key_data(seed), fidx)
    return ((hi << 32) | lo).reshape(lead + shape)
