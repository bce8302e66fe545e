"""Bootstrapping without unfolding: key generation, blind rotation, the
functional / programmable bootstrap and the full-domain bootstrap "this
work" (`src/bootstrap.c:3-21,107-122,192-220,519-538`).

The reference's `if a_i == 0: continue` branch is dropped: X^0 - 1 = 0, so
the dense CMUX adds exactly zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import tlwe as _tlwe
from . import trgsw as _trgsw
from . import trlwe as _trlwe
from ._device import default_device
from .ops import pbs_kernel as _pk
from .tlwe import TLWE, TLWEKey
from .torus import TORUS_BITS, to_i64, torus2int
from .trgsw import TRGSWKey
from .trlwe import TRLWE, from_stacked


class BootstrapKey(nn.Module):
    """NTT-form TRGSW(s_i) stacked over i, [n, (k+1)l, k+1, P, N].

    Only the kernel's 32-bit copies are held (residues and Shoup companions
    are < 2^32, so nothing is lost): ``v32``/``vs32`` as int32 buffers with
    u32 bits, so ``.to(device)`` moves them.  ``v``/``vs`` give the int64
    values."""

    def __init__(self, v32: torch.Tensor, vs32: torch.Tensor, n: int, k: int,
                 N: int, l: int, Bg_bit: int, primes):
        super().__init__()
        self.register_buffer("v32", v32)
        self.register_buffer("vs32", vs32)
        self.n, self.k, self.N, self.l, self.Bg_bit = n, k, N, l, Bg_bit
        self.primes = tuple(int(p) for p in primes)

    @classmethod
    def from_dft(cls, v, vs, n, k, N, l, Bg_bit, primes) -> "BootstrapKey":
        """From int64 residues and Shoup companions (canonical, < 2^32)."""
        return cls(_pk.u32_as_i32(v), _pk.u32_as_i32(vs), n, k, N, l, Bg_bit,
                   primes)

    @property
    def v(self):
        return _pk.i32_as_u32(self.v32)

    @property
    def vs(self):
        return _pk.i32_as_u32(self.vs32)

    def kernel_plan(self) -> _pk.PBSKernelPlan:
        return _pk.get_kernel_plan(self.N, self.primes, self.l, self.Bg_bit,
                                   self.k, self.v32.device)


def new_key(out_key: TRGSWKey, in_key: TLWEKey, generator: torch.Generator,
            device=None) -> BootstrapKey:
    """TRGSW(s_i) for every input-key coefficient, batched over the n keys
    (`new_bootstrap_key_wo_unfolding`, `bootstrap.c:3-21`).  Computed where
    the keys live, returned on ``device``."""
    dev = default_device(device)
    l, Bg_bit = out_key.l, out_key.Bg_bit
    k, N = out_key.trlwe_key.k, out_key.trlwe_key.N
    plan = out_key.plan()
    s = in_key.s.to(plan.device)
    g = _trgsw.monomial_encrypt(s, torch.zeros_like(s), out_key, generator)
    gd = _trgsw.to_dft(g, plan, with_shoup=True)
    bk = BootstrapKey.from_dft(gd.v, gd.vs, in_key.n, k, N, l, Bg_bit,
                               plan.primes)
    return bk.to(dev)


def blind_rotate_inputs(tv: TRLWE, a, bk: BootstrapKey):
    """The kernel's operands for `blind_rotate`: the accumulators flattened
    to [B, k+1, N], the exponents round(a * 2N) as int32 [n, B], and the
    batch shape."""
    N, k = bk.N, bk.k
    log_N2 = int(math.log2(2 * N))
    batch = tuple(a.shape[:-1])
    B = math.prod(batch)
    acc0 = tv.stacked().expand(batch + (k + 1, N)).reshape(B, k + 1, N)
    a_int = torus2int(a.reshape(B, -1), log_N2).to(torch.int32)
    return acc0.contiguous(), a_int.t().contiguous(), batch


def blind_rotate(tv: TRLWE, a, bk: BootstrapKey) -> TRLWE:
    """n-step CMUX chain (`blind_rotate`, `bootstrap.c:107-122`).

    tv: TRLWE accumulator (batched or not); a: [..., n] LWE mask.  On CUDA
    tensors one kernel launch, on CPU tensors the plain version."""
    acc0, a_int, batch = blind_rotate_inputs(tv, a, bk)
    acc = _pk.blind_rotate_scan(acc0, a_int, bk.v32, bk.vs32, bk.kernel_plan())
    return from_stacked(acc.reshape(batch + (bk.k + 1, bk.N)))


def _prec_offset(torus_base: int) -> int:
    """double2torus(1/(4*torus_base)) (`bootstrap.c:194`)."""
    return to_i64((1 << TORUS_BITS) // (4 * torus_base))


def rotate_test_vector(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                       torus_base: int) -> TRLWE:
    """X^{-round(b)} * tv per ciphertext: the blind rotation's starting
    accumulators (`bootstrap.c:192-197`)."""
    log_N2 = int(math.log2(2 * bk.N))
    b_int = torus2int(c.b + _prec_offset(torus_base), log_N2)
    return _trlwe.mul_by_xai(tv, 2 * bk.N - b_int)


def functional_bootstrap_wo_extract(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                                    torus_base: int) -> TRLWE:
    """Rotate the test vector by -round(b), then blind-rotate by the mask
    (`bootstrap.c:192-198`)."""
    return blind_rotate(rotate_test_vector(tv, c, bk, torus_base), c.a, bk)


def functional_bootstrap(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                         torus_base: int) -> TLWE:
    """The programmable bootstrap (`functional_bootstrap`,
    `bootstrap.c:200-206`)."""
    acc = functional_bootstrap_wo_extract(tv, c, bk, torus_base)
    return _trlwe.extract_tlwe(acc, 0)


def programmable_bootstrap(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                           precision: int, kappa: int, theta: int) -> TLWE:
    """Input rounding (kappa shift, theta mask), then the bootstrap
    (`programmable_bootstrap`, `bootstrap.c:208-220`)."""
    log_N2 = int(math.log2(2 * bk.N))
    rnd_os = to_i64(1 << (TORUS_BITS - log_N2 + theta - 1))
    theta_mask = to_i64(~((1 << (TORUS_BITS - log_N2 + theta)) - 1))
    a = ((c.a << kappa) + rnd_os) & theta_mask
    b = ((c.b << kappa) + rnd_os) & theta_mask
    return functional_bootstrap(tv, TLWE(a=a, b=b), bk, 1 << (precision - 1))


def fdfb_this_work(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                   tlwe_ksk: _tlwe.TLWEKSKey, precision: int) -> TLWE:
    """Full-domain functional bootstrap ("this work"): a sign bootstrap, its
    key switch back to the LWE key added to the input, then a half-domain
    bootstrap (`full_domain_functional_bootstrap`, `bootstrap.c:519-538`).
    On CUDA tensors two blind-rotate launches and one key-switch launch."""
    sign = to_i64((1 << (TORUS_BITS - 2)) - (1 << (TORUS_BITS - precision - 2)))
    tv_sign = _trlwe.torus_packing(
        torch.tensor([sign], dtype=torch.int64, device=c.b.device), bk.k, bk.N)
    ct_sign = functional_bootstrap(tv_sign, c, bk, 1 << (precision - 1))
    ct_sign = TLWE(a=ct_sign.a, b=ct_sign.b - sign)
    in2 = _tlwe.add(_tlwe.keyswitch(ct_sign, tlwe_ksk), c)
    return functional_bootstrap(tv, in2, bk, 1 << precision)
