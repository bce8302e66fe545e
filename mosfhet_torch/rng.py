"""Randomness from an explicit ``torch.Generator``.

The reference expands RDRAND seeds with AES-CTR and samples gaussians with
Box-Muller (`src/misc.c:30-97`); its tests constrain only distributions.
The streams here are PyTorch's, not the TPU package's threefry streams:
key material that has to be identical crosses through `bridge`.

Draws happen on the generator's device and are then moved to ``device``,
so a CPU generator serves a CUDA run and the stream does not depend on
where the result lives.
"""

from __future__ import annotations

import os

import torch

from .torus import TORUS_BITS, TORUS_DTYPE, wrap


def new_seed() -> torch.Generator:
    """A CPU generator seeded from OS entropy (the reference's
    `generate_rnd_seed`, `misc.c:32-50`); its draws move to wherever the
    results live."""
    return torch.Generator().manual_seed(
        int.from_bytes(os.urandom(8), "little"))


def split(generator: torch.Generator, num: int = 2) -> list[torch.Generator]:
    """``num`` generators on the parent's device, each seeded from two
    32-bit draws of the parent, so a stream can be handed to independent
    consumers."""
    hi, lo = torch.randint(0, 1 << 32, (2, num), dtype=torch.int64,
                           generator=generator, device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(
        (int(h) << 32) | int(l)) for h, l in zip(hi, lo)]


def _bits32(generator: torch.Generator, shape, device) -> torch.Tensor:
    r = torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64,
                      generator=generator, device=generator.device)
    return r.to(device)


def uniform_torus(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform torus words of the module's width: u64 (as int64) from two
    32-bit draws, u32 (as int32) from one."""
    hi = _bits32(generator, shape, device)
    if TORUS_BITS == 32:
        return wrap(hi)
    lo = _bits32(generator, shape, device)
    return (hi << 32) | lo


def normal_torus(generator: torch.Generator, sigma: float, shape,
                 device) -> torch.Tensor:
    """round(N(0, sigma) * 2^bits) mod 2^bits at the module's width,
    sampled in float32 like the reference package (quantization
    sigma * 2^-24, far below sigma)."""
    e = torch.randn(tuple(shape), dtype=torch.float32, generator=generator,
                    device=generator.device).to(device)
    scaled = e * torch.tensor(sigma * float(1 << TORUS_BITS),
                              dtype=torch.float32)
    return wrap(scaled.to(torch.int64), TORUS_DTYPE)


def bounded_key_array(generator: torch.Generator, shape, bound: int,
                      device) -> torch.Tensor:
    """Secret-key coefficients uniform in [-(bound/2 - 1), bound/2]
    (`tlwe.c:70-78`, `trlwe.c:119-130`); bound=2 gives {0, 1}.  int64."""
    r = _bits32(generator, shape, device)
    return (r & (bound - 1)) - ((bound >> 1) - 1)


def binary_key_array(generator: torch.Generator, shape,
                     device) -> torch.Tensor:
    return bounded_key_array(generator, shape, 2, device)
