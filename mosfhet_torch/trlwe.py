"""TRLWE: ring-LWE over T_N[X] = R[X]/(X^N+1) with a leading batch axis.

Mirrors `src/trlwe.c`: binary keygen, encryption, phase, per-batch X^a
rotations, sample extraction and LUT packing.  Torus words are int64
tensors holding u64 bits, or int32 holding u32 bits at the 32-bit torus.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ntt as _ntt
from . import polynomial as _poly
from . import rng as _rng
from ._device import default_device
from .tlwe import TLWE, TLWEKey
from .torus import gadget_decompose, int2torus, wrap


@dataclasses.dataclass
class TRLWE:
    """Ciphertext (a_1..a_k, b) with b = sum a_i * s_i + m + e."""
    a: torch.Tensor  # [..., k, N]
    b: torch.Tensor  # [..., N]

    @property
    def k(self):
        return self.a.shape[-2]

    @property
    def N(self):
        return self.b.shape[-1]

    def stacked(self):
        """[..., k+1, N] with b last: the decomposition/TRGSW row order."""
        return torch.cat([self.a, self.b.unsqueeze(-2)], dim=-2)


def from_stacked(x) -> TRLWE:
    return TRLWE(a=x[..., :-1, :], b=x[..., -1, :])


@dataclasses.dataclass
class TRLWEKey:
    s: torch.Tensor  # [k, N] int64, small entries
    sigma: float
    s_bound: int     # max |s|

    @property
    def k(self):
        return self.s.shape[0]

    @property
    def N(self):
        return self.s.shape[-1]

    def plan(self) -> _ntt.NTTPlan:
        """NTT plan wide enough for key-times-ciphertext products."""
        bound = _ntt.conv_bound(self.N, max(self.s_bound, 1), self.k)
        return _ntt.get_plan(self.N, _ntt.primes_for_bound(bound),
                             self.s.device)


def new_binary_key(N: int, k: int, sigma: float, generator: torch.Generator,
                   device=None) -> TRLWEKey:
    """Uniform binary key (`trlwe.c:119-130`)."""
    s = _rng.binary_key_array(generator, (k, N), default_device(device))
    return TRLWEKey(s=s, sigma=sigma, s_bound=1)


def extract_tlwe_key(key: TRLWEKey) -> TLWEKey:
    """TRLWE key -> k*N-dim TLWE key (`trlwe.c:531-538`)."""
    return TLWEKey(s=key.s.reshape(-1), sigma=key.sigma)


def _key_mul_accum(a, key: TRLWEKey):
    """sum_i a_i (*) s_i, exact through the NTT (`trlwe.c:307-309`)."""
    plan = key.plan()
    fa = _ntt.to_ntt_u64(a, plan)                        # [..., k, P, N]
    fs = _ntt.forward_ntt(_ntt.to_resi_small(key.s, plan), plan)
    prod = _ntt.pointwise_mul(fa, fs, plan)
    acc = prod[..., 0, :, :]
    for i in range(1, key.k):
        acc = _ntt.add(acc, prod[..., i, :, :], plan)
    return _ntt.from_ntt_u64(acc, plan)


def encrypt(m, key: TRLWEKey, generator: torch.Generator) -> TRLWE:
    """(`trlwe_sample`, `trlwe.c:296-316`).  m: [..., N] torus or None."""
    N, k, dev = key.N, key.k, key.s.device
    batch = () if m is None else tuple(m.shape[:-1])
    a = _rng.uniform_torus(generator, batch + (k, N), dev)
    e = _rng.normal_torus(generator, key.sigma, batch + (N,), dev)
    b = _key_mul_accum(a, key) + e
    if m is not None:
        b = b + wrap(m)
    return TRLWE(a=a, b=b)


def noiseless_trivial(m, k: int, N: int) -> TRLWE:
    """(0, m) (`trlwe.c:261-280`); m: [..., N] torus."""
    return TRLWE(a=torch.zeros(m.shape[:-1] + (k, N), dtype=m.dtype,
                               device=m.device), b=m)


def phase(c: TRLWE, key: TRLWEKey):
    """b - sum a_i (*) s_i (`trlwe.c:324-331`)."""
    return c.b - _key_mul_accum(c.a, key)


def mul_by_xai(c: TRLWE, a) -> TRLWE:
    """Rotate all components by X^a; ``a`` may be per-batch
    (`trlwe.c:507-513`)."""
    a = torch.as_tensor(a, device=c.b.device)
    return TRLWE(a=_poly.mul_by_xai(c.a, a.unsqueeze(-1)),
                 b=_poly.mul_by_xai(c.b, a))


def permute(c: TRLWE, gen: int) -> TRLWE:
    """The Galois automorphism X -> X^gen on every component (first half of
    `trlwe_eval_automorphism`, `trlwe.c:775-781`)."""
    return TRLWE(a=_poly.permute(c.a, gen), b=_poly.permute(c.b, gen))


def extract_tlwe(c: TRLWE, idx: int = 0) -> TLWE:
    """TRLWE -> TLWE of coefficient ``idx`` of the phase (`trlwe.c:540-552`):
    a'[i*N + j] = a_i[idx-j] for j <= idx, else -a_i[N+idx-j]."""
    N, k = c.N, c.k
    j = torch.arange(N, device=c.a.device)
    src = torch.where(j <= idx, idx - j, N + idx - j)
    g = c.a.index_select(-1, src)                        # [..., k, N]
    g = torch.where(j > idx, -g, g)
    return TLWE(a=g.reshape(g.shape[:-2] + (k * N,)), b=c.b[..., idx])


def decompose(c: TRLWE, Bg_bit: int, l: int, rounded: bool = True):
    """All components' gadget digits in TRGSW row order [..., (k+1)l, N]
    (row = comp*l + digit, b last; `trlwe_decompose`, `trlwe.c:636-660`),
    with the rounded offset of the hot paths by default."""
    d = gadget_decompose(c.stacked(), Bg_bit, l, rounded)  # [..., k+1, l, N]
    return d.reshape(d.shape[:-3] + ((c.k + 1) * l, c.N))


def torus_packing(values, k: int, N: int) -> TRLWE:
    """Trivial TRLWE whose b repeats each of the ``size`` values over N/size
    slots (`trlwe_torus_packing`, `trlwe.c:662-667`)."""
    size = values.shape[-1]
    return noiseless_trivial(
        torch.repeat_interleave(values, N // size, dim=-1), k, N)


def torus_packing_many_lut(values, lut_size: int, n_luts: int, k: int,
                           N: int) -> TRLWE:
    """b[(i*n_luts + j)*N/(lut_size*n_luts) + c] = in[j*lut_size + i]
    (`trlwe_torus_packing_many_LUT`, `trlwe.c:678-687`)."""
    interleaved = values.reshape(n_luts, lut_size).t().reshape(-1)
    return noiseless_trivial(torch.repeat_interleave(
        interleaved, N // (lut_size * n_luts), dim=-1), k, N)


def lut_packing(values, in_prec: int, out_prec: int, k: int, N: int) -> TRLWE:
    """Integer LUT -> torus packing (`trlwe_LUT_packing`, `trlwe.c:669-675`)."""
    values = int2torus(torch.as_tensor(values, dtype=torch.int64), out_prec)
    if values.shape[-1] != 1 << in_prec:
        raise ValueError(f"a LUT of precision {in_prec} has {1 << in_prec} "
                         f"entries, got {values.shape[-1]}")
    return torus_packing(values, k, N)
