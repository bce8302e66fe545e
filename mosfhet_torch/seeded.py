"""Seeded (compressed) TRLWE samples (`src/trlwe_compressed.c`).

The reference stores a seed in place of the mask ``a`` and regenerates the
mask when it is needed, halving key material.  Here, as in the TPU package,
the seed is a threefry key and the mask is the words
``rng.uniform_torus`` of the TPU package gives for it, regenerated by
`ops.prng` (plain PyTorch on the seeds' device), so seeded keys cross
between the two packages.  Seeds are drawn from the caller's
``torch.Generator``.

A seed is a pair of u32 words held as int64 values in [0, 2^32), [..., 2].
The reference's own wire format, a 16-byte seed whose mask is the stream of
xoroshiro128++ or SHAKE-128, is `MosfhetSeededTRLWE`; `expand_mosfhet`
regenerates its mask on the host through `native`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native as _native
from . import rng as _rng
from . import trlwe as _trlwe
from .ops import prng as _prng
from .trlwe import TRLWE, TRLWEKey
from .torus import wrap


@dataclasses.dataclass
class SeededTRLWE:
    """(seed, b): ``a`` is the stream of ``seed``
    (`trlwe_new_compressed_sample`, `trlwe_compressed.c:37-53`)."""
    seed: torch.Tensor  # [..., 2] int64, u32 key words
    b: torch.Tensor     # [..., N] torus words
    k: int

    @property
    def N(self):
        return self.b.shape[-1]


def _expand_a(seed, k: int, N: int):
    """The masks [..., k, N] of the keys ``seed`` [..., 2]."""
    return _prng.uniform_torus_from_key_data(seed, (k, N))


def encrypt(m, key: TRLWEKey, generator: torch.Generator) -> SeededTRLWE:
    """Compressed encryption: fresh seeds from ``generator``, the mask from
    their stream, only (seed, b) kept.  m: [..., N] torus words or None."""
    N, k, dev = key.N, key.k, key.s.device
    batch = () if m is None else tuple(m.shape[:-1])
    seed = _rng._bits32(generator, batch + (2,), dev)
    a = _expand_a(seed, k, N)
    e = _rng.normal_torus(generator, key.sigma, batch + (N,), dev)
    b = _trlwe._key_mul_accum(a, key) + e
    if m is not None:
        b = b + wrap(m)
    return SeededTRLWE(seed=seed, b=b, k=k)


def expand(c: SeededTRLWE) -> TRLWE:
    """Decompress to a full TRLWE (`trlwe_compressed.c:101-116`)."""
    return TRLWE(a=_expand_a(c.seed, c.k, c.N), b=c.b)


def subto(c: TRLWE, s: SeededTRLWE) -> TRLWE:
    """c - expand(s) (`trlwe_compressed_subto`,
    `trlwe_compressed.c:118-154`)."""
    return _trlwe.sub(c, expand(s))


# --- reference-format seeded samples -----------------------------------------

@dataclasses.dataclass
class MosfhetSeededTRLWE:
    """A seeded TRLWE in the reference's wire format: a 16-byte seed and the
    b polynomial (`trlwe_save_compressed_sample`, `trlwe_compressed.c:66-69`);
    the mask is the seed's xoroshiro128++ stream (``prng="xoroshiro"``, the
    reference's default) or SHAKE-128 stream (``prng="shake"``, USE_SHAKE
    builds)."""
    seed: torch.Tensor  # [..., 16] uint8
    b: torch.Tensor     # [..., N] torus words
    k: int
    prng: str = "xoroshiro"

    @property
    def N(self):
        return self.b.shape[-1]


def expand_mosfhet(c: MosfhetSeededTRLWE) -> TRLWE:
    """Decompress a reference-format seeded sample bit for bit: the masks
    are expanded on the host by `native` (`trlwe_compressed_sample`,
    `trlwe_compressed.c:72-99`) and moved to ``c.b``'s device."""
    if c.prng not in ("xoroshiro", "shake"):
        raise ValueError(f"unknown prng {c.prng!r}")
    expand = (_native.xoroshiro_expand if c.prng == "xoroshiro"
              else _native.shake_mask_expand)
    N, k = c.N, c.k
    seeds = c.seed.cpu().numpy().astype(np.uint8)
    batch = seeds.shape[:-1]
    masks = [expand(s.tobytes(), k, N) for s in seeds.reshape(-1, 16)]
    a = np.stack(masks).reshape(batch + (k, N)).view(np.int64)
    return TRLWE(a=wrap(torch.from_numpy(a).to(c.b.device), c.b.dtype),
                 b=c.b)
