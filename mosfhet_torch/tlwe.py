"""TLWE: LWE over the discretized torus, with a leading batch axis.

Mirrors `src/tlwe.c:70-141`: keygen, encryption and phase.  Ciphertexts
are dataclasses of int64 tensors holding u64 words.
"""

from __future__ import annotations

import dataclasses

import torch

from . import rng as _rng
from ._device import default_device


@dataclasses.dataclass
class TLWE:
    """Ciphertext (a, b) with b = m + <s, a> + e."""
    a: torch.Tensor  # [..., n]
    b: torch.Tensor  # [...]

    @property
    def n(self):
        return self.a.shape[-1]


@dataclasses.dataclass
class TLWEKey:
    s: torch.Tensor  # [n] int64, small entries
    sigma: float

    @property
    def n(self):
        return self.s.shape[-1]


def new_binary_key(n: int, sigma: float, generator: torch.Generator,
                   device=None) -> TLWEKey:
    """Uniform binary key (`tlwe.c:70-78`)."""
    return TLWEKey(s=_rng.binary_key_array(generator, (n,),
                                           default_device(device)),
                   sigma=sigma)


def encrypt(m, skey: TLWEKey, generator: torch.Generator) -> TLWE:
    """b = m + sum_i s_i a_i + e (`tlwe.c:106-115`); ``m`` is a torus
    tensor of any batch shape on the key's device."""
    dev = skey.s.device
    m = torch.as_tensor(m, dtype=torch.int64, device=dev)
    a = _rng.uniform_torus(generator, m.shape + (skey.n,), dev)
    e = _rng.normal_torus(generator, skey.sigma, m.shape, dev)
    return TLWE(a=a, b=m + (a * skey.s).sum(-1) + e)


def phase(c: TLWE, skey: TLWEKey):
    """b - <s, a> (`tlwe.c:135-141`)."""
    return c.b - (c.a * skey.s).sum(-1)
