"""Bootstrapping: key generation, the blind rotation without and with
unfolding, the functional / programmable bootstrap, the multi-value
bootstraps (CLOT21, the factorized phases 1/2, UBR), the TRGSW-accumulator
bootstrap, the circuit bootstrap, the public mux and the full-domain
bootstraps KS21, CLOT21 and "this work" (`src/bootstrap.c`).

The reference's `if a_i == 0: continue` branch is dropped: X^0 - 1 = 0, so
the dense CMUX adds exactly zero.

At the 32-bit torus (``MOSFHET_TORUS_BITS=32``) every path here runs on
int32 words holding u32 bits: `new_key` (unfolded too), the bootstraps,
`fdfb_this_work` and UBR, through the one-limb forms of K1-K5.

Three entry points reach the TPU package's superseded kernel forms, each a
function beside the fused path and giving its words:
`blind_rotate_stepwise` (one launch of K1-step per CMUX step),
`multivalue_bootstrap_UBR_phase2_stepwise` (one launch of K3-step per
cached group) and `multivalue_bootstrap_UBR_phase1_v1` (K5-v1).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import ntt as _ntt
from . import tlwe as _tlwe
from . import trgsw as _trgsw
from . import trlwe as _trlwe
from ._device import default_device
from .ops import pbs_kernel as _pk
from .tlwe import TLWE, TLWEKey
from .torus import (TORUS_BITS, TORUS_DTYPE, gadget_decompose, to_signed,
                    torus2int)
from .trgsw import TRGSW, TRGSWDFT, TRGSWKey
from .trlwe import TRLWE, from_stacked

# TRGSWs encrypted at once by the unfolded keygen: the encryption's
# intermediates (mask NTTs) stay near 1.6 GB at TFHEpp-L2 beside the key.
KEYGEN_CHUNK = 1024


class BootstrapKey(nn.Module):
    """The bootstrap key, held once as buffers, so ``.to(device)`` moves it.

    unfolding == 1: NTT-form TRGSW(s_i) stacked over i, [n, (k+1)l, k+1, P,
    N], as the kernel's 32-bit copies (residues and Shoup companions are
    < 2^32, so nothing is lost): ``v32``/``vs32`` int32 buffers with u32
    bits; ``v``/``vs`` give the int64 values.

    unfolding == u > 1: the time-domain TRGSWs of the key-bit products
    (`bootstrap.c:23-48`), ``su`` [n/u, 2^u, (k+1)l, k+1, N] torus words
    (int64 holding u64 bits, or int32 holding u32 bits at the 32-bit
    torus), the layout the unfolded kernels read."""

    def __init__(self, v32: torch.Tensor | None, vs32: torch.Tensor | None,
                 n: int, k: int, N: int, l: int, Bg_bit: int, primes,
                 su: torch.Tensor | None = None, unfolding: int = 1):
        super().__init__()
        self.register_buffer("v32", v32)
        self.register_buffer("vs32", vs32)
        self.register_buffer("su", su)
        self.n, self.k, self.N, self.l, self.Bg_bit = n, k, N, l, Bg_bit
        self.unfolding = unfolding
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

    @property
    def device(self) -> torch.device:
        return (self.su if self.unfolding > 1 else self.v32).device

    def plan(self) -> _ntt.NTTPlan:
        return _ntt.get_plan(self.N, self.primes, self.device)

    def su_u64(self):
        """The key products [n/u, 2^u, (k+1)l, k+1, N] as torus words."""
        return self.su

    def kernel_plan(self) -> _pk.PBSKernelPlan:
        """The kernels' plan at the module's torus width."""
        return _pk.get_kernel_plan(self.N, self.primes, self.l, self.Bg_bit,
                                   self.k, self.device, TORUS_BITS)


def _unfolded_messages(s, unfolding: int):
    """prod_u (j_u ? s[g u + u'] : 1 - s[g u + u']) for every group g and
    mask combination j, [n/u * 2^u] (`bootstrap.c:39-43`)."""
    u, M = unfolding, 1 << unfolding
    s = s.reshape(-1, u)
    bits = (torch.arange(M, device=s.device)[:, None]
            >> torch.arange(u, device=s.device)) & 1           # [M, u]
    terms = torch.where(bits[None] == 1, s[:, None, :], 1 - s[:, None, :])
    return terms.prod(dim=-1).reshape(-1)


def new_key(out_key: TRGSWKey, in_key: TLWEKey, generator: torch.Generator,
            device=None, unfolding: int = 1) -> BootstrapKey:
    """Bootstrap key generation (`new_bootstrap_key`, `bootstrap.c:3-48`).

    unfolding 1: TRGSW(s_i) for every input-key coefficient, batched over
    the n keys.  unfolding u > 1: TRGSW of the 2^u key-bit products of each
    group of u coefficients, encrypted in chunks of ``KEYGEN_CHUNK`` straight
    into the key buffer (n/u * 2^u TRGSWs: 5.3 GB at TFHEpp-L2, u=8; 249 MB
    at L2_32, u=4).
    Computed where the keys live, returned on ``device``."""
    dev = default_device(device)
    l, Bg_bit = out_key.l, out_key.Bg_bit
    k, N = out_key.trlwe_key.k, out_key.trlwe_key.N
    n = in_key.n
    plan = out_key.plan()
    s = in_key.s.to(plan.device)
    if unfolding == 1:
        g = _trgsw.monomial_encrypt(s, torch.zeros_like(s), out_key,
                                    generator)
        gd = _trgsw.to_dft(g, plan, with_shoup=True)
        bk = BootstrapKey.from_dft(gd.v, gd.vs, n, k, N, l, Bg_bit,
                                   plan.primes)
        return bk.to(dev)
    if unfolding < 1 or n % unfolding:
        raise ValueError(f"unfolding {unfolding} must divide n = {n}")
    ms = _unfolded_messages(s, unfolding)
    R = (k + 1) * l
    su = torch.empty((ms.shape[0], R, k + 1, N), dtype=TORUS_DTYPE,
                     device=plan.device)
    for i0 in range(0, ms.shape[0], KEYGEN_CHUNK):
        m = ms[i0:i0 + KEYGEN_CHUNK]
        su[i0:i0 + m.shape[0]] = _trgsw.monomial_encrypt(
            m, torch.zeros_like(m), out_key, generator).rows
    su = su.reshape(n // unfolding, 1 << unfolding, R, k + 1, N)
    return BootstrapKey(None, None, n, k, N, l, Bg_bit, plan.primes, su=su,
                        unfolding=unfolding).to(dev)


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


def blind_rotate(tv: TRLWE, a, bk: BootstrapKey,
                 rot_ntt: bool = False) -> TRLWE:
    """n-step CMUX chain (`blind_rotate`, `bootstrap.c:107-122`).

    tv: TRLWE accumulator (batched or not); a: [..., n] LWE mask.  On CUDA
    tensors one kernel launch, on CPU tensors the plain version.

    ``rot_ntt``: the rotation-free step (`_cmux_step_rotntt`; the TPU
    package's ``MOSFHET_ROT_NTT=1``).  Its words are not the classic
    step's, and its per-step noise variance is up to ~2x theirs (up to half
    a bit of output margin).  Raises ValueError on a prime set without the
    Barrett window the step needs, where the TPU package falls back to the
    classic step."""
    if bk.unfolding != 1:
        raise ValueError("blind_rotate needs a key without unfolding")
    acc0, a_int, batch = blind_rotate_inputs(tv, a, bk)
    acc = _pk.blind_rotate_scan(acc0, a_int, bk.v32, bk.vs32, bk.kernel_plan(),
                                rot_ntt=rot_ntt)
    return from_stacked(acc.reshape(batch + (bk.k + 1, bk.N)))


def blind_rotate_stepwise(tv: TRLWE, a, bk: BootstrapKey,
                          rot_ntt: bool = False) -> TRLWE:
    """`blind_rotate` one CMUX step per launch (K1-step), the accumulator
    through device memory between steps: the TPU package's per-step
    `blind_rotate_scan`, `lax.scan` of `_pbs_step_tiles`.  The same words
    as `blind_rotate` (with the same ``rot_ntt``); n launches on CUDA
    tensors, n plain calls on CPU tensors."""
    if bk.unfolding != 1:
        raise ValueError("blind_rotate_stepwise needs a key without "
                         "unfolding")
    acc0, a_int, batch = blind_rotate_inputs(tv, a, bk)
    kp = bk.kernel_plan()
    acc = acc0.clone()                  # updated in place, step by step
    for i in range(bk.n):
        _pk.pbs_step(acc, a_int[i], bk.v32[i], bk.vs32[i], kp,
                     rot_ntt=rot_ntt)
    return from_stacked(acc.reshape(batch + (bk.k + 1, bk.N)))


def _cmux_step_rotntt(acc_st, bk_v, bk_vs, ai, plan: _ntt.NTTPlan, l: int,
                      Bg_bit: int, k: int, N: int):
    """The rotation-free CMUX step (the TPU package's ``MOSFHET_ROT_NTT``
    step; plain PyTorch): the accumulator is gadget-decomposed directly and
    the factor X^{a_i} - 1 applied in the NTT domain, where a monomial is
    diagonal (`ntt.xpow`):

        acc += invNTT((zeta^a - 1) . sum_j NTT(decompose(acc)_j) * KEY_j)

    acc_st [..., k+1, N] words; ai [...] exponents in [0, 2N]; bk_v, bk_vs
    [(k+1)l, k+1, P, N] int64 canonical key residues and Shoup companions.
    Rotation commutes with gadget recomposition, so this equals the classic
    step up to the decomposition's rounding term, here scaled by X^a - 1
    (covered by `ntt.external_product_bound`'s doubled prime budget).  That
    factor also scales the key-noise term: up to half a bit of output noise
    margin against the classic step.  It is the oracle of the N-sharded
    blind rotation (`parallel.dist_ntt.make_dist_blind_rotate`) and the
    plain version of the kernels' rotation-free step
    (`blind_rotate(..., rot_ntt=True)`).

    Raises ValueError on a plan that is not Barrett-capable (the TPU package
    takes the step only when ``plan.barrett_ok``)."""
    if not plan.barrett_ok:
        raise ValueError("the rotation-free step needs a Barrett-capable "
                         "prime set (every prime > 2^30 / 1.75)")
    digits = gadget_decompose(acc_st, Bg_bit, l)          # [..., k+1, l, N]
    digits = digits.reshape(digits.shape[:-3] + ((k + 1) * l, N))
    spec = _ntt.to_ntt_small(digits, plan)                # [..., J, P, N]
    acc_ntt = _ntt.pointwise_mul_acc_key(spec.unsqueeze(-3), bk_v, bk_vs,
                                         plan, dim=-4)    # [..., C, P, N]
    # zeta^a - 1, canonical: zeta^a is a root power, never 0
    t = _ntt.xpow(ai, plan) - 1                           # [..., P, N]
    acc_ntt = _ntt.barrett_mul(acc_ntt, t.unsqueeze(-3), plan)
    return acc_st + _ntt.from_ntt_u64(acc_ntt, plan, acc_st.dtype)


def _unfold_rotations(a, bk: BootstrapKey):
    """Per group and mask combination, round((sum_{i in m} a[g u + i]) 2N)
    (`bootstrap.c:128-136`): int32 [..., n/u, 2^u] in [0, 2N), as the TPU
    package computes them.  A sum that rounds to 2N wraps to 0, the same
    rotation; the kernels also take 2N itself."""
    u, M = bk.unfolding, 1 << bk.unfolding
    a_grp = a.reshape(tuple(a.shape[:-1]) + (bk.n // u, 1, u))
    bits = ((torch.arange(M, device=a.device)[:, None]
             >> torch.arange(u, device=a.device)) & 1).to(a.dtype)  # [M, u]
    sums = (a_grp * bits).unbind(-1)                      # u x [..., G, M]
    total = sums[0]
    for t in sums[1:]:
        total = total + t                             # wraps mod 2^64 or 2^32
    return torus2int(total, int(math.log2(2 * bk.N))).to(torch.int32)


def unfolded_rotate_inputs(tv: TRLWE, a, bk: BootstrapKey):
    """The kernel's operands for `blind_rotate_unfolded`: the accumulators
    flattened to [B, k+1, N], the exponents int32 [B, n/u, 2^u], and the
    batch shape (that of ``tv`` and ``a`` broadcast)."""
    N, k = bk.N, bk.k
    st = tv.stacked()
    batch = torch.broadcast_shapes(tuple(a.shape[:-1]), tuple(st.shape[:-2]))
    B = math.prod(batch)
    acc0 = st.expand(batch + (k + 1, N)).reshape(B, k + 1, N).contiguous()
    a_full = a.expand(batch + tuple(a.shape[-1:])).reshape(B, -1)
    return acc0, _unfold_rotations(a_full, bk).contiguous(), batch


def blind_rotate_unfolded(tv: TRLWE, a, bk: BootstrapKey) -> TRLWE:
    """Unfolded blind rotation (`blind_rotate_unfolded`,
    `bootstrap.c:124-148`): per group of u mask coefficients, the 2^u key
    TRGSWs rotated by X^{sum a} and summed mod 2^64 (2^32 at the 32-bit
    torus), then one external product.  On CUDA tensors one kernel launch
    for all groups, on CPU tensors the plain version."""
    if bk.unfolding == 1:
        raise ValueError("blind_rotate_unfolded needs an unfolded key")
    acc0, rot, batch = unfolded_rotate_inputs(tv, a, bk)
    acc = _pk.unfolded_rotate(acc0, rot, bk.su, bk.kernel_plan())
    return from_stacked(acc.reshape(batch + (bk.k + 1, bk.N)))


def _prec_offset(torus_base: int) -> int:
    """double2torus(1/(4*torus_base)) (`bootstrap.c:194`)."""
    return to_signed((1 << TORUS_BITS) // (4 * torus_base))


def rotate_test_vector(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                       torus_base: int) -> TRLWE:
    """X^{-round(b)} * tv per ciphertext: the blind rotation's starting
    accumulators (`bootstrap.c:192-197`)."""
    log_N2 = int(math.log2(2 * bk.N))
    b_int = torus2int(c.b + _prec_offset(torus_base), log_N2)
    return _trlwe.mul_by_xai(tv, 2 * bk.N - b_int)


def functional_bootstrap_wo_extract(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                                    torus_base: int,
                                    rot_ntt: bool = False) -> TRLWE:
    """Rotate the test vector by -round(b), then blind-rotate by the mask,
    unfolded when the key is (`bootstrap.c:192-198`).  ``rot_ntt``: the
    rotation-free step (`blind_rotate`); an unfolded key has none, and
    raises ValueError (the TPU package's unfolded rotation ignores its
    switch)."""
    acc = rotate_test_vector(tv, c, bk, torus_base)
    if bk.unfolding == 1:
        return blind_rotate(acc, c.a, bk, rot_ntt=rot_ntt)
    if rot_ntt:
        raise ValueError("the unfolded rotation has no rotation-free step")
    return blind_rotate_unfolded(acc, c.a, bk)


def functional_bootstrap(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                         torus_base: int, rot_ntt: bool = False) -> TLWE:
    """The programmable bootstrap (`functional_bootstrap`,
    `bootstrap.c:200-206`); ``rot_ntt`` as in `blind_rotate`."""
    acc = functional_bootstrap_wo_extract(tv, c, bk, torus_base, rot_ntt)
    return _trlwe.extract_tlwe(acc, 0)


def programmable_bootstrap(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                           precision: int, kappa: int, theta: int,
                           rot_ntt: bool = False) -> TLWE:
    """Input rounding (kappa shift, theta mask), then the bootstrap
    (`programmable_bootstrap`, `bootstrap.c:208-220`); ``rot_ntt`` as in
    `blind_rotate`."""
    log_N2 = int(math.log2(2 * bk.N))
    rnd_os = to_signed(1 << (TORUS_BITS - log_N2 + theta - 1))
    theta_mask = to_signed(~((1 << (TORUS_BITS - log_N2 + theta)) - 1))
    a = ((c.a << kappa) + rnd_os) & theta_mask
    b = ((c.b << kappa) + rnd_os) & theta_mask
    return functional_bootstrap(tv, TLWE(a=a, b=b), bk, 1 << (precision - 1),
                                rot_ntt)


def fdfb_this_work(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                   tlwe_ksk: _tlwe.TLWEKSKey, precision: int) -> TLWE:
    """Full-domain functional bootstrap ("this work"): a sign bootstrap, its
    key switch back to the LWE key added to the input, then a half-domain
    bootstrap (`full_domain_functional_bootstrap`, `bootstrap.c:519-538`).
    On CUDA tensors two blind-rotate launches (unfolded ones with an
    unfolded key) and one key-switch launch."""
    sign = to_signed((1 << (TORUS_BITS - 2))
                     - (1 << (TORUS_BITS - precision - 2)))
    tv_sign = _trlwe.torus_packing(
        torch.tensor([sign], dtype=TORUS_DTYPE, device=c.b.device), bk.k,
        bk.N)
    ct_sign = functional_bootstrap(tv_sign, c, bk, 1 << (precision - 1))
    ct_sign = TLWE(a=ct_sign.a, b=ct_sign.b - sign)
    in2 = _tlwe.add(_tlwe.keyswitch(ct_sign, tlwe_ksk), c)
    return functional_bootstrap(tv, in2, bk, 1 << precision)


# --- multi-value bootstrapping (`bootstrap.c:222-265`) ----------------------

def multivalue_bootstrap_CLOT21(tv: TRLWE, c: TLWE, bk: BootstrapKey,
                                torus_base: int, n_luts: int) -> list[TLWE]:
    """One blind rotation, ``n_luts`` LUT outputs by extraction offset
    (`multivalue_bootstrap_CLOT21`, `bootstrap.c:222-230`).  One rotation
    launch on CUDA tensors (unfolded with an unfolded key)."""
    slot = bk.N // (n_luts * torus_base)
    acc = functional_bootstrap_wo_extract(tv, c, bk, torus_base * n_luts)
    return [_trlwe.extract_tlwe(acc, i * slot) for i in range(n_luts)]


def multivalue_bootstrap_phase1(c: TLWE, bk: BootstrapKey,
                                torus_base: int) -> list[TRLWE]:
    """Blind-rotate a constant test vector once; phase 2 composes any LUT
    as a cleartext combination (`multivalue_bootstrap_phase1`,
    `bootstrap.c:232-243`).  Returns torus_base + 1 TRLWEs: the rotation
    r0, r0 X^(i N / torus_base) for 0 < i < torus_base, and r0 X^torus_base
    + r0.  One rotation launch on CUDA tensors."""
    N = bk.N
    const = torch.full((N,), _prec_offset(torus_base), dtype=TORUS_DTYPE,
                       device=c.b.device)
    tv = _trlwe.noiseless_trivial(const, bk.k, N)
    r0 = functional_bootstrap_wo_extract(tv, c, bk, torus_base)
    out = [r0] + [_trlwe.mul_by_xai(r0, i * N // torus_base)
                  for i in range(1, torus_base)]
    out.append(_trlwe.add(_trlwe.mul_by_xai(r0, torus_base), r0))
    return out


def _phase2_weights(lut_values, torus_base: int, log_torus_base: int):
    """Per-bit-plane rotation weights of the phase-2 composition
    (`bootstrap.c:245-265`): [(j, i, w)] with w in {-1, +1}; w0 == 2 maps
    to weight 1 on rotated[torus_base] = r0 X^torus_base + r0."""
    terms = []
    for j in range(log_torus_base):
        w0 = ((lut_values[0] >> j) & 1) + \
            ((lut_values[torus_base - 1] >> j) & 1)
        if w0 == 2:
            terms.append((j, torus_base, 1))
        elif w0 != 0:
            terms.append((j, 0, w0))
        for i in range(1, torus_base):
            wi = ((lut_values[i] >> j) & 1) - ((lut_values[i - 1] >> j) & 1)
            if wi != 0:
                terms.append((j, i, wi))
    return terms


def _zero_tlwe(rotated: list[TRLWE], lead=()) -> TLWE:
    r = rotated[0]
    zero = torch.zeros(tuple(lead) + tuple(r.b.shape[:-1]), dtype=r.b.dtype,
                       device=r.b.device)
    return _tlwe.noiseless_trivial(zero, r.N * r.k)


def multivalue_bootstrap_phase2(lut_values, rotated: list[TRLWE],
                                torus_base: int, log_torus_base: int) -> TLWE:
    """Compose a cleartext LUT (Python ints) from phase 1's rotations by
    bit-plane (`multivalue_bootstrap_phase2`, `bootstrap.c:245-265`),
    extraction first: out = sum_{j,i} w[j,i] E_j(rotated[i]) (exact:
    extraction and negation are linear mod 2^64), as the TPU package
    orders it.  No kernel: extractions and adds."""
    out = None
    for j, i, w in _phase2_weights(lut_values, torus_base, log_torus_base):
        e = _trlwe.mv_extract_tlwe_scaling_delta(rotated[i], 1 << j)
        t = _tlwe.neg(e) if w < 0 else e
        out = t if out is None else _tlwe.add(out, t)
    return _zero_tlwe(rotated) if out is None else out


def multivalue_bootstrap_phase2_many(lut_tables, rotated: list[TRLWE],
                                     torus_base: int,
                                     log_torus_base: int) -> TLWE:
    """Phase 2 for K cleartext LUTs at once (lut_tables [K, torus_base]
    Python ints): a TLWE with a leading K axis before phase 1's batch axes,
    the words of K calls of `multivalue_bootstrap_phase2`.  Each of the
    log_tb x (tb+1) extractions is taken once, and every LUT is a {-1, 0,
    1}-weighted sum of them.  No kernel."""
    K, tb = len(lut_tables), torus_base
    w = np.zeros((log_torus_base, K, tb + 1), np.int64)
    for ki, lv in enumerate(lut_tables):
        for j, i, wi in _phase2_weights(lv, tb, log_torus_base):
            w[j, ki, i] = wi
    out_a = out_b = None
    for j in range(log_torus_base):
        for i in range(tb + 1):
            if not np.any(w[j, :, i]):
                continue
            e = _trlwe.mv_extract_tlwe_scaling_delta(rotated[i], 1 << j)
            wj = torch.from_numpy(w[j, :, i]).to(e.b.device, e.b.dtype)
            ta = wj.reshape((K,) + (1,) * e.a.dim()) * e.a
            tbv = wj.reshape((K,) + (1,) * e.b.dim()) * e.b
            out_a = ta if out_a is None else out_a + ta
            out_b = tbv if out_b is None else out_b + tbv
    if out_a is None:
        return _zero_tlwe(rotated, (K,))
    return TLWE(a=out_a, b=out_b)


# --- UBR multi-value bootstrap (`bootstrap.c:151-190`) ---------------------

def ubr_phase1_inputs(c: TLWE, bk: BootstrapKey):
    """The kernel's operand for phase 1: the exponents int32 [B, n/u, 2^u]
    of the flattened ciphertexts, and their batch shape."""
    if bk.unfolding == 1:
        raise ValueError("UBR needs an unfolded bootstrap key")
    batch = tuple(c.a.shape[:-1])
    rot = _unfold_rotations(c.a.reshape(math.prod(batch), -1), bk)
    return rot.contiguous(), batch


def _phase1_cache(c: TLWE, bk: BootstrapKey, combine) -> TRGSWDFT:
    rot, batch = ubr_phase1_inputs(c, bk)
    v32 = combine(bk.su, rot, bk.kernel_plan())
    return TRGSWDFT(v=_pk.i32_as_u32(v32).reshape(batch + v32.shape[1:]),
                    vs=None, l=bk.l, Bg_bit=bk.Bg_bit, primes=bk.primes)


def multivalue_bootstrap_UBR_phase1(c: TLWE, bk: BootstrapKey) -> TRGSWDFT:
    """Cache the per-group combined TRGSWs of ciphertext(s) ``c`` for reuse
    across LUTs (`multivalue_bootstrap_UBR_phase1`).  Returns an NTT-form
    TRGSW [..., n/u, (k+1)l, k+1, P, N] without Shoup companions.  On CUDA
    tensors one kernel launch, on CPU tensors the plain version."""
    return _phase1_cache(c, bk, _pk.ubr_phase1_combine)


def multivalue_bootstrap_UBR_phase1_v1(c: TLWE, bk: BootstrapKey) -> TRGSWDFT:
    """`multivalue_bootstrap_UBR_phase1` through K5-v1, the TPU package's
    first phase-1 kernel design (`ubr_phase1_combine`): the same cache.  On
    CUDA tensors one launch, on CPU tensors its plain version."""
    return _phase1_cache(c, bk, _pk.ubr_phase1_combine_v1)


def ubr_phase2_inputs(tv: TRLWE, c: TLWE, sa: TRGSWDFT, bk: BootstrapKey,
                      torus_base: int):
    """The kernel's operands for phase 2: the rotated test vectors
    flattened to [B, k+1, N]; the cache as u32 residues in int32, [n/u, J,
    C, P, N] when it is one ciphertext's (broadcast over the batch) or
    [n/u, B, J, C, P, N] when it is batched (one per row); that choice; and
    the batch shape."""
    N, k = bk.N, bk.k
    acc_st = rotate_test_vector(tv, c, bk, torus_base).stacked()
    v32 = _pk.u32_as_i32(sa.v)
    key_shape = tuple(v32.shape[-5:])                          # G, J, C, P, N
    per_row = v32.dim() > 5
    batch = torch.broadcast_shapes(tuple(acc_st.shape[:-2]),
                                   tuple(v32.shape[:-5]))
    B = math.prod(batch)
    acc0 = acc_st.expand(batch + (k + 1, N)).reshape(B, k + 1, N).contiguous()
    if per_row:
        v32 = v32.expand(batch + key_shape).reshape((B,) + key_shape) \
                 .transpose(0, 1)                              # [G, B, ...]
    return acc0, v32.contiguous(), per_row, batch


def multivalue_bootstrap_UBR_phase2(tv: TRLWE, c: TLWE, sa: TRGSWDFT,
                                    bk: BootstrapKey,
                                    torus_base: int) -> TLWE:
    """Apply the cached products to test vectors
    (`multivalue_bootstrap_UBR_phase2`, `bootstrap.c:176-190`).

    An unbatched cache ``sa`` [n/u, J, C, P, N] (one ciphertext) is applied
    to a batch of test vectors ``tv`` (many LUTs): one kernel launch with
    the cache broadcast.  A batched cache [..., n/u, J, C, P, N] (one per
    ciphertext of ``c``) is one launch with a cache per row.  CPU tensors
    take the plain version."""
    acc0, sa32, per_row, batch = ubr_phase2_inputs(tv, c, sa, bk, torus_base)
    out = _pk.ext_product_apply_scan(acc0, sa32, bk.kernel_plan(), per_row)
    return _trlwe.extract_tlwe(
        from_stacked(out.reshape(batch + (bk.k + 1, bk.N))), 0)


def multivalue_bootstrap_UBR_phase2_stepwise(tv: TRLWE, c: TLWE,
                                             sa: TRGSWDFT, bk: BootstrapKey,
                                             torus_base: int) -> TLWE:
    """`multivalue_bootstrap_UBR_phase2` one cached group per launch
    (K3-step), the accumulators through device memory between them: the
    TPU package's per-step `ext_product_apply_scan`.  The same words for
    both cache forms (one ciphertext's, broadcast; one per row); n/u
    launches on CUDA tensors, n/u plain calls on CPU tensors."""
    acc0, sa32, per_row, batch = ubr_phase2_inputs(tv, c, sa, bk, torus_base)
    kp = bk.kernel_plan()
    acc = acc0.clone()                  # updated in place, group by group
    for g in range(sa32.shape[0]):
        _pk.ext_product_apply_step(acc, sa32[g], kp, per_row)
    return _trlwe.extract_tlwe(
        from_stacked(acc.reshape(batch + (bk.k + 1, bk.N))), 0)


# --- TRGSW-accumulator blind rotation (`bootstrap.c:267-306`) ---------------

def blind_rotate_trgsw(tv: TRGSW, a, bk: BootstrapKey) -> TRGSW:
    """The CMUX chain on a TRGSW accumulator (`blind_rotate_trgsw`): its
    (k+1)l rows are a batch axis, each row rotated by its ciphertext's mask
    ``a`` [..., n] (broadcast against tv's batch axes).  On CUDA tensors one
    K1 launch on B (k+1)l rows, each ciphertext's exponents repeated once
    per row, as the TPU package's kernel path does; on CPU tensors the
    plain version.  tv's gadget must be the key's."""
    if bk.unfolding != 1:
        raise ValueError("blind_rotate_trgsw needs a key without unfolding")
    if (tv.l, tv.Bg_bit) != (bk.l, bk.Bg_bit):
        raise ValueError(f"the accumulator's gadget (l={tv.l}, Bg_bit="
                         f"{tv.Bg_bit}) is not the key's (l={bk.l}, "
                         f"Bg_bit={bk.Bg_bit})")
    rows = tv.rows
    R = rows.shape[-3]
    batch = torch.broadcast_shapes(tuple(rows.shape[:-3]),
                                   tuple(a.shape[:-1]))
    a_rows = a.unsqueeze(-2).expand(batch + (R, a.shape[-1]))
    acc0, a_int, _ = blind_rotate_inputs(from_stacked(rows), a_rows, bk)
    acc = _pk.blind_rotate_scan(acc0, a_int, bk.v32, bk.vs32, bk.kernel_plan())
    return TRGSW(rows=acc.reshape(batch + tuple(rows.shape[-3:])), l=tv.l,
                 Bg_bit=tv.Bg_bit)


def functional_bootstrap_trgsw_phase1(c: TLWE, bk: BootstrapKey,
                                      torus_base: int, l: int,
                                      Bg_bit: int) -> TRGSWDFT:
    """Blind-rotate the trivial TRGSW(1) rotated by -round(b) to get
    TRGSW(X^-phase), in NTT form with Shoup companions
    (`functional_bootstrap_trgsw_phase1`, `bootstrap.c:285-295`)."""
    tv = _trgsw.noiseless_trivial(1, l, Bg_bit, bk.k, bk.N, c.b.device)
    log_N2 = int(math.log2(2 * bk.N))
    b_int = torus2int(c.b + _prec_offset(torus_base), log_N2)
    tv = _trgsw.mul_by_xai(tv, 2 * bk.N - b_int)
    rot = blind_rotate_trgsw(tv, c.a, bk)
    return _trgsw.to_dft(rot, bk.plan(), with_shoup=True)


def functional_bootstrap_trgsw_phase2(g: TRGSWDFT, tv: TRLWE) -> TLWE:
    """One external product against any test vector, then the extract
    (`functional_bootstrap_trgsw_phase2`, `bootstrap.c:297-306`): one K3
    launch on CUDA tensors."""
    return _trlwe.extract_tlwe(_trgsw.external_product(tv, g), 0)


# --- circuit bootstrap: TLWE -> TRGSW (`bootstrap.c:309-366`) ---------------

def _gadget_h(i: int, Bg_bit: int) -> int:
    return to_signed(1 << (TORUS_BITS - (i + 1) * Bg_bit))


def _check_cb_k(bk: BootstrapKey):
    if bk.k != 1:
        raise ValueError(f"the circuit bootstrap needs k = 1, got {bk.k}")


def _level_lut(l: int, Bg_bit: int, bk: BootstrapKey, dev) -> TRLWE:
    """The many-LUT test vector of CB v2/v3: l zeros, then h_0..h_{l-1}."""
    lut = torch.tensor([0] * l + [_gadget_h(i, Bg_bit) for i in range(l)],
                       dtype=TORUS_DTYPE, device=dev)
    return _trlwe.torus_packing(lut, bk.k, bk.N)


def circuit_bootstrap(c: TLWE, bk: BootstrapKey, kska, kskb, l: int,
                      Bg_bit: int) -> TRGSW:
    """v1: l functional bootstraps, each followed by the private-SK switch
    (a rows) and the packing1 switch (b rows) (`circuit_bootstrap`,
    `bootstrap.c:309-322`).  k must be 1.  On CUDA tensors l K1 launches
    and 2l K2 launches on dense tables (the streamed gather on seeded
    ones)."""
    from . import keyswitch as _ks
    _check_cb_k(bk)
    rows_a, rows_b = [], []
    for i in range(l):
        lut = torch.tensor([0, _gadget_h(i, Bg_bit)], dtype=TORUS_DTYPE,
                           device=c.b.device)
        tmp = functional_bootstrap(_trlwe.torus_packing(lut, bk.k, bk.N), c,
                                   bk, 2)
        rows_a.append(_ks.priv_keyswitch(tmp, kska).stacked())
        rows_b.append(_ks.packing1_keyswitch(tmp, kskb).stacked())
    return TRGSW(rows=torch.stack(rows_a + rows_b, dim=-3), l=l,
                 Bg_bit=Bg_bit)


def circuit_bootstrap_2(c: TLWE, bk: BootstrapKey, kska, kskb, l: int,
                        Bg_bit: int) -> TRGSW:
    """v2: one many-LUT bootstrap, then both switches per level
    (`circuit_bootstrap_2`, `bootstrap.c:324-344`).  k must be 1.  On CUDA
    tensors 1 K1 launch and 2l K2 launches on dense tables."""
    from . import keyswitch as _ks
    _check_cb_k(bk)
    slot = bk.N // (2 * l)
    acc = functional_bootstrap_wo_extract(
        _level_lut(l, Bg_bit, bk, c.b.device), c, bk, 2 * l)
    rows_a, rows_b = [], []
    for i in range(l):
        tmp = _trlwe.extract_tlwe(acc, i * slot)
        rows_a.append(_ks.priv_keyswitch(tmp, kska).stacked())
        rows_b.append(_ks.packing1_keyswitch(tmp, kskb).stacked())
    return TRGSW(rows=torch.stack(rows_a + rows_b, dim=-3), l=l,
                 Bg_bit=Bg_bit)


def circuit_bootstrap_3(c: TLWE, bk: BootstrapKey, kska_pair, kskb, l: int,
                        Bg_bit: int) -> TRGSW:
    """v3: one many-LUT bootstrap; per level the packing1 switch gives the b
    rows and the TRLWE private-KS pair turns them into the a rows
    (`circuit_bootstrap_3`, `bootstrap.c:346-366`).  k must be 1.  On CUDA
    tensors 1 K1 launch, l K2 launches and 2l K6 launches."""
    from . import keyswitch as _ks
    _check_cb_k(bk)
    slot = bk.N // (2 * l)
    acc = functional_bootstrap_wo_extract(
        _level_lut(l, Bg_bit, bk, c.b.device), c, bk, 2 * l)
    rows_a, rows_b = [], []
    for i in range(l):
        b_row = _ks.packing1_keyswitch(_trlwe.extract_tlwe(acc, i * slot),
                                       kskb)
        rows_b.append(b_row.stacked())
        rows_a.append(_ks.priv_keyswitch_2(b_row, kska_pair).stacked())
    return TRGSW(rows=torch.stack(rows_a + rows_b, dim=-3), l=l,
                 Bg_bit=Bg_bit)


# --- public mux, full-domain bootstraps (`bootstrap.c:368-538`) -------------

def public_mux(p0, p1, selector_v, l: int, Bg_bit: int, k: int, N: int,
               primes) -> TRLWE:
    """out = {p0, p1}[selector]: the cleartext difference p1 - p0
    gadget-decomposed (unrounded) and accumulated against the NTT-form
    selector rows, plus p0 (`public_mux`, `bootstrap.c:368-389`).  p0, p1
    [..., N] torus words; selector_v [..., l, k+1, P, N] canonical
    residues.  Plain PyTorch on the NTT (the TPU package runs jnp here)."""
    plan = _ntt.get_plan(N, primes, selector_v.device)
    dec = gadget_decompose(p1 - p0, Bg_bit, l, rounded=False)   # [..., l, N]
    spec = _ntt.to_ntt_small(dec, plan)                         # [..., l, P, N]
    prods = _ntt.pointwise_mul(selector_v, spec.unsqueeze(-3), plan)
    acc = prods[..., 0, :, :, :]
    for i in range(1, l):
        acc = _ntt.add(acc, prods[..., i, :, :, :], plan)
    out = from_stacked(_ntt.from_ntt_u64(acc, plan))
    return TRLWE(a=out.a, b=out.b + p0)


def _half_h(i: int, Bg_bit: int) -> int:
    """-(h_i / 2), the sign value of level i of the KS21 selector."""
    return to_signed(-((1 << (TORUS_BITS - (i + 1) * Bg_bit)) >> 1))


def fdfb_ks21(tv_poly, c: TLWE, bk: BootstrapKey, ksk, torus_base: int,
              use_many_lut: bool = True) -> TLWE:
    """Full-domain functional bootstrap, KS21 style: bootstrap the
    decomposed sign, pack each level into a TRLWE selector row, public-mux
    the two halves of the 2N-entry cleartext test vector ``tv_poly``, then
    bootstrap again (`full_domain_functional_bootstrap_KS21{,_2}`,
    `bootstrap.c:391-454`).  On CUDA tensors: with ``use_many_lut`` 2 K1
    launches and l K2 launches (packing1 on a dense table), else l + 1 K1
    and l K2; the mux is plain PyTorch."""
    from . import keyswitch as _ks
    N, k, l, Bg_bit = bk.N, bk.k, bk.l, bk.Bg_bit
    dev = c.b.device
    tvp = torch.as_tensor(tv_poly, device=dev)
    if tvp.shape[-1] != 2 * N:
        raise ValueError(f"tv_poly has {tvp.shape[-1]} entries, want 2N = "
                         f"{2 * N}")
    sel_rows = []
    if use_many_lut:
        half = torus_base // 2
        slot = N // (l * half)
        lut = torch.tensor([_half_h(i, Bg_bit) for i in range(l)
                            for _ in range(half)], dtype=TORUS_DTYPE,
                           device=dev)
        tv1 = _trlwe.torus_packing_many_lut(lut, half, l, k, N)
        acc = functional_bootstrap_wo_extract(tv1, c, bk, l * half)
        tmps = [_trlwe.extract_tlwe(acc, i * slot) for i in range(l)]
    else:
        tmps = [functional_bootstrap(_trlwe.torus_packing(torch.tensor(
            [_half_h(i, Bg_bit)], dtype=TORUS_DTYPE, device=dev), k, N),
            c, bk, torus_base // 2) for i in range(l)]
    for i, tmp in enumerate(tmps):
        tmp = TLWE(a=tmp.a, b=tmp.b - _half_h(i, Bg_bit))
        sel_rows.append(_ks.packing1_keyswitch(tmp, ksk))
    plan = bk.plan()
    sel_v = torch.stack([_ntt.to_ntt_u64(r.stacked(), plan)
                         for r in sel_rows], dim=-4)
    muxed = public_mux(tvp[..., :N], -tvp[..., N:], sel_v, l, Bg_bit, k, N,
                       bk.primes)
    return functional_bootstrap(muxed, c, bk, torus_base // 2)


def _check_64bit(name: str):
    if TORUS_BITS != 64:
        raise NotImplementedError(
            f"{name} runs on product.tlwe_mul, whose relinearization gadget "
            f"does not fit the {TORUS_BITS}-bit torus")


def _clot21_combine(ct_f0: TLWE, ct_f1: TLWE, ct_sign: TLWE, sign: int, ksk,
                    rlk, precision: int) -> TLWE:
    """f0 (s + 1) + f1 (s - 1) by two TLWE products, s the sign bootstrap's
    output (`bootstrap.c:472-480`)."""
    from .product import tlwe_mul
    s_minus = TLWE(a=ct_sign.a, b=ct_sign.b - sign)
    ct_f1 = tlwe_mul(ct_f1, s_minus, precision, ksk, rlk)
    s_plus = TLWE(a=s_minus.a, b=s_minus.b + sign + sign)
    ct_f0 = tlwe_mul(ct_f0, s_plus, precision, ksk, rlk)
    return _tlwe.add(ct_f0, ct_f1)


def fdfb_clot21(tv0: TRLWE, tv1: TRLWE, c: TLWE, bk: BootstrapKey, ksk, rlk,
                precision: int) -> TLWE:
    """FDFB through the f0 / f1 / sign bootstraps and two TLWE products
    (`full_domain_functional_bootstrap_CLOT21`, `bootstrap.c:456-481`).
    64-bit torus only, like `product.tlwe_mul`.  On CUDA tensors 3 K1, 2 K2
    (packing1, both operands of a product in one launch) and 2 K6
    launches."""
    _check_64bit("fdfb_clot21")
    sign = to_signed(1 << (TORUS_BITS - precision - 1))
    tv_sign = _trlwe.torus_packing(torch.tensor(
        [sign], dtype=TORUS_DTYPE, device=c.b.device), bk.k, bk.N)
    tb = 1 << (precision - 1)
    ct_f0 = functional_bootstrap(tv0, c, bk, tb)
    ct_f1 = functional_bootstrap(tv1, c, bk, tb)
    ct_sign = functional_bootstrap(tv_sign, c, bk, tb)
    return _clot21_combine(ct_f0, ct_f1, ct_sign, sign, ksk, rlk, precision)


def fdfb_clot21_2(tv_values, c: TLWE, bk: BootstrapKey, ksk, rlk,
                  precision: int) -> TLWE:
    """CLOT21 FDFB from one many-LUT blind rotation (`bootstrap.c:483-517`):
    tv_values [2 torus_base] torus words (the f0 then the f1 half).  64-bit
    torus only.  On CUDA tensors 1 K1, 2 K2 and 2 K6 launches."""
    _check_64bit("fdfb_clot21_2")
    N = bk.N
    torus_base = 1 << (precision - 2)
    slot = N // (4 * torus_base)
    sign = to_signed(1 << (TORUS_BITS - precision - 1))
    dev = c.b.device
    lut = torch.cat([
        torch.as_tensor(tv_values, dtype=TORUS_DTYPE, device=dev),
        torch.full((torus_base,), sign, dtype=TORUS_DTYPE, device=dev),
        torch.zeros((torus_base,), dtype=TORUS_DTYPE, device=dev)])
    tv = _trlwe.torus_packing_many_lut(lut, torus_base, 4, bk.k, N)
    acc = functional_bootstrap_wo_extract(tv, c, bk, 4 * torus_base)
    return _clot21_combine(_trlwe.extract_tlwe(acc, 0),
                           _trlwe.extract_tlwe(acc, slot),
                           _trlwe.extract_tlwe(acc, 2 * slot), sign, ksk,
                           rlk, precision)
