"""TRLWE: ring-LWE over T_N[X] = R[X]/(X^N+1) with a leading batch axis.

Mirrors `src/trlwe.c`: key generation (binary, bounded, ternary, sparse,
Gaussian), encryption, phase, linear ops, per-batch X^a rotations, sample
extraction (plain and multi-value), gadget decomposition, LUT packing and
the NTT-domain ("DFT") form.  Torus words are int64 tensors holding u64
bits, or int32 holding u32 bits at the 32-bit torus.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ntt as _ntt
from . import polynomial as _poly
from . import rng as _rng
from ._device import default_device
from . import tlwe as _tlwe
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
class TRLWEDFT:
    """NTT-domain ciphertext: canonical residues [..., k+1, P, N] int64 (b
    last), with Shoup companions ``vs`` (key material) or None (transient
    values).  The primes recover the plan."""
    v: torch.Tensor
    vs: torch.Tensor | None
    primes: tuple

    @property
    def k(self):
        return self.v.shape[-3] - 1

    @property
    def N(self):
        return self.v.shape[-1]

    def plan(self) -> _ntt.NTTPlan:
        return _ntt.get_plan(self.N, self.primes, self.v.device)


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


def new_bounded_key(N: int, k: int, bound: int, sigma: float,
                    generator: torch.Generator, device=None) -> TRLWEKey:
    """Uniform key in [-(bound/2-1), bound/2] (`trlwe.c:104-130`)."""
    s = _rng.bounded_key_array(generator, (k, N), bound,
                               default_device(device))
    return TRLWEKey(s=s, sigma=sigma, s_bound=max(bound // 2, 1))


def new_binary_key(N: int, k: int, sigma: float, generator: torch.Generator,
                   device=None) -> TRLWEKey:
    """Uniform binary key (`trlwe.c:119-130`)."""
    s = _rng.binary_key_array(generator, (k, N), default_device(device))
    return TRLWEKey(s=s, sigma=sigma, s_bound=1)


def _sparse_values(generator, size: int, h: int, values, device):
    """``values`` (h of them) at h uniform distinct positions of ``size``
    zeros (`gen_sparse_array`, `trlwe.c:137-155`)."""
    perm = torch.randperm(size, generator=generator, device=generator.device)
    out = torch.zeros(size, dtype=torch.int64, device=generator.device)
    out[perm[:h]] = values.to(generator.device)
    return out.to(device)


def _alternating(h: int):
    """+1, -1, +1, ... (h values), the reference's ternary fill."""
    return 1 - 2 * (torch.arange(h) % 2)


def new_ternary_key(N: int, k: int, h: int, sigma: float,
                    generator: torch.Generator, device=None) -> TRLWEKey:
    """Hamming weight h per polynomial, alternating +1/-1 values
    (`trlwe_new_ternary_key`, `trlwe.c:158-165`)."""
    dev = default_device(device)
    s = torch.stack([_sparse_values(generator, N, h, _alternating(h), dev)
                     for _ in range(k)])
    return TRLWEKey(s=s, sigma=sigma, s_bound=1)


def new_sparse_ternary_key(N: int, k: int, h: int, sigma: float,
                           generator: torch.Generator,
                           device=None) -> TRLWEKey:
    """Hamming weight h over all k polynomials together, alternating +1/-1
    values (`trlwe.c:168-177`)."""
    s = _sparse_values(generator, k * N, h, _alternating(h),
                       default_device(device)).reshape(k, N)
    return TRLWEKey(s=s, sigma=sigma, s_bound=1)


def new_sparse_binary_key(N: int, k: int, h: int, sigma: float,
                          generator: torch.Generator,
                          device=None) -> TRLWEKey:
    """h ones per polynomial."""
    dev = default_device(device)
    s = torch.stack([_sparse_values(generator, N, h,
                                    torch.ones(h, dtype=torch.int64), dev)
                     for _ in range(k)])
    return TRLWEKey(s=s, sigma=sigma, s_bound=1)


def _gaussian_ints(generator, key_sigma: float, shape, device):
    """N(0, key_sigma) sampled in float32, truncated towards zero."""
    g = torch.randn(shape, dtype=torch.float32, generator=generator,
                    device=generator.device) * key_sigma
    return g.to(torch.int64).to(device)


def new_gaussian_key(N: int, k: int, key_sigma: float, noise_sigma: float,
                     generator: torch.Generator, device=None) -> TRLWEKey:
    """Coefficients round-towards-zero N(0, key_sigma)
    (`trlwe_new_gaussian_key`, `trlwe.c:219-228`); s_bound is the largest
    |s| drawn (at least 1)."""
    s = _gaussian_ints(generator, key_sigma, (k, N), default_device(device))
    return TRLWEKey(s=s, sigma=noise_sigma,
                    s_bound=max(1, int(s.abs().max())))


def new_sparse_gaussian_key(N: int, k: int, h: int, key_sigma: float,
                            noise_sigma: float, generator: torch.Generator,
                            device=None) -> TRLWEKey:
    """h positions per polynomial holding Gaussian values, a drawn 0 taken
    as 1 (`trlwe.c:188-200`)."""
    base = new_sparse_binary_key(N, k, h, noise_sigma, generator, device)
    g = _gaussian_ints(generator, key_sigma, (k, N), base.s.device)
    g = torch.where(g == 0, 1, g)
    s = torch.where(base.s == 1, g, 0)
    return TRLWEKey(s=s, sigma=noise_sigma,
                    s_bound=max(1, int(s.abs().max())))


def new_sparse_generic_key(N: int, k: int, h: int, key_bound: int,
                           noise_sigma: float, generator: torch.Generator,
                           device=None) -> TRLWEKey:
    """h positions per polynomial holding uniform values in
    [-(key_bound/2-1), key_bound/2], a drawn 0 taken as 1
    (`trlwe.c:203-217`)."""
    base = new_sparse_binary_key(N, k, h, noise_sigma, generator, device)
    v = _rng.bounded_key_array(generator, (k, N), key_bound, base.s.device)
    v = torch.where(v == 0, 1, v)
    s = torch.where(base.s == 1, v, 0)
    return TRLWEKey(s=s, sigma=noise_sigma, s_bound=max(key_bound // 2, 1))


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


def add(c1: TRLWE, c2: TRLWE) -> TRLWE:
    return TRLWE(a=c1.a + c2.a, b=c1.b + c2.b)


def sub(c1: TRLWE, c2: TRLWE) -> TRLWE:
    return TRLWE(a=c1.a - c2.a, b=c1.b - c2.b)


def neg(c: TRLWE) -> TRLWE:
    return TRLWE(a=-c.a, b=-c.b)


def scale(c: TRLWE, w) -> TRLWE:
    """Every coefficient times the integer ``w``, which may be per-batch
    (`trlwe_scale`, `trlwe.c:269-274`)."""
    w = wrap(torch.as_tensor(w, device=c.b.device), c.b.dtype)
    return TRLWE(a=c.a * w[..., None, None], b=c.b * w[..., None])


def mul_by_xai(c: TRLWE, a) -> TRLWE:
    """Rotate all components by X^a; ``a`` may be per-batch
    (`trlwe.c:507-513`)."""
    a = torch.as_tensor(a, device=c.b.device)
    return TRLWE(a=_poly.mul_by_xai(c.a, a.unsqueeze(-1)),
                 b=_poly.mul_by_xai(c.b, a))


def mul_by_xai_minus_1(c: TRLWE, a) -> TRLWE:
    """c * (X^a - 1) on all components; ``a`` may be per-batch."""
    a = torch.as_tensor(a, device=c.b.device)
    return TRLWE(a=_poly.mul_by_xai_minus_1(c.a, a.unsqueeze(-1)),
                 b=_poly.mul_by_xai_minus_1(c.b, a))


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


def mv_extract_tlwe(c: TRLWE, amount: int) -> list[TLWE]:
    """Multi-value extraction: the first amount/2 coefficients, then the
    top ones negated (`trlwe_mv_extract_tlwe`, `trlwe.c:580-589`)."""
    out = [extract_tlwe(c, i) for i in range(amount // 2)]
    for i in range(amount // 2, amount):
        out.append(_tlwe.neg(extract_tlwe(c, c.N - 1 - (i - amount // 2))))
    return out


def mv_extract_tlwe_scaling_delta(c: TRLWE, scale_: int) -> TLWE:
    """The additive term of `trlwe_mv_extract_tlwe_scaling_addto`
    (`trlwe.c:602-610`): the low extracts minus the top ones, from zero."""
    amount = scale_
    zero = torch.zeros(c.b.shape[:-1], dtype=c.b.dtype, device=c.b.device)
    out = _tlwe.noiseless_trivial(zero, c.N * c.k)
    for i in range(amount // 2, amount):
        out = _tlwe.sub(out, extract_tlwe(c, c.N - 1 - (i - amount // 2)))
    for i in range(amount // 2):
        out = _tlwe.add(out, extract_tlwe(c, i))
    return out


def mv_extract_tlwe_scaling(c: TRLWE, scale_: int) -> TLWE:
    """The extract of coefficient scale/2, minus the top extracts, plus the
    low ones: the message-composition trick
    (`trlwe_mv_extract_tlwe_scaling`, `trlwe.c:591-600`)."""
    amount = scale_
    out = extract_tlwe(c, amount // 2)
    for i in range(amount // 2 + 1, amount):
        out = _tlwe.sub(out, extract_tlwe(c, c.N - 1 - (i - amount // 2)))
    for i in range(amount // 2):
        out = _tlwe.add(out, extract_tlwe(c, i))
    return out


def to_dft(c: TRLWE, plan: _ntt.NTTPlan,
           with_shoup: bool = False) -> TRLWEDFT:
    v = _ntt.to_ntt_u64(c.stacked(), plan)
    vs = _ntt.make_shoup(v, plan.p[:, None]) if with_shoup else None
    return TRLWEDFT(v=v, vs=vs, primes=plan.primes)


def from_dft(c: TRLWEDFT) -> TRLWE:
    return from_stacked(_ntt.from_ntt_u64(c.v, c.plan()))


def dft_add(c1: TRLWEDFT, c2: TRLWEDFT) -> TRLWEDFT:
    return TRLWEDFT(v=_ntt.add(c1.v, c2.v, c1.plan()), vs=None,
                    primes=c1.primes)


def dft_sub(c1: TRLWEDFT, c2: TRLWEDFT) -> TRLWEDFT:
    return TRLWEDFT(v=_ntt.sub(c1.v, c2.v, c1.plan()), vs=None,
                    primes=c1.primes)


def dft_phase(c: TRLWEDFT, key: TRLWEKey):
    """Decryption in the NTT domain (`trlwe_DFT_phase`, `trlwe.c:372-382`):
    the torus words of b - sum a_i s_i, at the module's width."""
    plan = c.plan()
    fs = _ntt.forward_ntt(_ntt.to_resi_small(key.s, plan), plan)
    prod = _ntt.pointwise_mul(c.v[..., :-1, :, :], fs, plan)
    acc = prod[..., 0, :, :]
    for i in range(1, key.k):
        acc = _ntt.add(acc, prod[..., i, :, :], plan)
    return _ntt.from_ntt_u64(_ntt.sub(c.v[..., -1, :, :], acc, plan), plan)


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
