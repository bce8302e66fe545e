"""Blind rotation via Galois automorphisms (eprint 2022/198 Alg. 4, the
all-odd variant): MOSFHET's GA bootstrap, `src/bootstrap_ga.c`.

The rotation exponents become automorphism generators, data-dependent per
ciphertext: each step is an external product with TRGSW(X^{s_i}), the
Galois permutation of the step's generator and a key switch with the
keyset entry that generator selects from the all-odd keyset.  On CUDA
tensors the initial psi_{w0} is one launch of the automorphism key-switch
kernel (K6, ``ops/csrc/auto_keyswitch.cu``) and the n steps one launch of
the GA rotation kernel (K7, ``ops/csrc/ga_scan.cu``); on CPU tensors their
plain versions.  Both torus widths: under ``MOSFHET_TORUS_BITS=32`` the
key holds the 32-bit keyset and K6 and K7 run their one-limb forms, with
the words of the TPU package's jnp scan (its TPU kernels are 64-bit only).

Two per-step forms give the same words with one launch per stage, as the
TPU package's two-kernel forms do: `blind_rotate_ga_stepwise` (an external
product launch, K1-delta ``ops/csrc/cmux_delta.cu``, then K6 per step) and
`blind_rotate_ga_gathered` (K1-delta, then the permutation and the keyset
gather in PyTorch and the gathered-key switch K6-old per step).  Both are
64-bit only, as K1-delta is; `functional_bootstrap_ga` runs
`blind_rotate_ga`.

Parameter envelope (the reference's forced-all-odd variant,
`bootstrap_ga.c:37`): rounding every mask coefficient to an odd multiple of
1/2N biases the accumulated rotation by ~n/4 slots, so decryption needs
roughly n < 2N / torus_base (n=632, N=2048, torus_base=4 at TFHEpp-L2).
The words agree with the TPU package's outside it too.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from . import keyswitch as _ks
from . import polynomial as _poly
from . import trgsw as _trgsw
from . import trlwe as _trlwe
from ._device import default_device
from .bootstrap import rotate_test_vector
from .ops import pbs_kernel as _pk
from .tlwe import TLWE, TLWEKey
from .torus import torus2int
from .trgsw import TRGSWKey
from .trlwe import TRLWE, from_stacked

# Generators whose automorphism keys are encrypted at once by `new_key`:
# 1,024 TRLWEs at TFHEpp-L2, whose NTT intermediates stay near 0.2 GB.
GA_KEYGEN_CHUNK = 256


def inverse_mod_2n_table(N: int) -> np.ndarray:
    """inv[x >> 1] = x^-1 mod 2N for odd x (`inverse_mod_2N`,
    `misc.c:142-159`)."""
    out = np.zeros(N, dtype=np.int32)
    for x in range(1, 2 * N, 2):
        out[x >> 1] = pow(x, -1, 2 * N)
    return out


class GABootstrapKey(nn.Module):
    """TRGSW(X^{s_i}) per key bit and the all-odd automorphism keyset
    (`new_bootstrap_key_ga`, `bootstrap_ga.c:5-24`), held once as buffers:

      s_v32, s_vs32  [n, (k+1)l, k+1, P, N]    int32 with u32 bits: NTT-form
                                               residues and Shoup companions
      ak             [N, k t, k+1, P_ks, N]    int32 with u32 bits: the KS
                                               key of generator g at (g-1)/2
      inv2n          [N]                       int32, g^-1 mod 2N at (g-1)/2

    The kernels multiply keyset entries by Barrett, so the keyset keeps no
    Shoup companions.  The keyset has an entry for every odd generator, so
    the indices `ga_rotate_inputs` derives (all below N) stay inside it."""

    def __init__(self, s_v32, s_vs32, ak, inv2n, n: int, k: int, N: int,
                 l: int, Bg_bit: int, ks_t: int, ks_base_bit: int, primes,
                 ks_primes):
        if ak.shape[0] != N or tuple(inv2n.shape) != (N,):
            raise ValueError(f"want a keyset of N={N} entries and inv2n [N], "
                             f"got {tuple(ak.shape)} and "
                             f"{tuple(inv2n.shape)}")
        super().__init__()
        self.register_buffer("s_v32", s_v32)
        self.register_buffer("s_vs32", s_vs32)
        self.register_buffer("ak", ak)
        self.register_buffer("inv2n", inv2n)
        self.n, self.k, self.N, self.l, self.Bg_bit = n, k, N, l, Bg_bit
        self.ks_t, self.ks_base_bit = ks_t, ks_base_bit
        self.primes = tuple(int(p) for p in primes)
        self.ks_primes = tuple(int(p) for p in ks_primes)

    @property
    def s_v(self):
        return _pk.i32_as_u32(self.s_v32)

    @property
    def s_vs(self):
        return _pk.i32_as_u32(self.s_vs32)

    @property
    def device(self) -> torch.device:
        return self.s_v32.device

    def kernel_plans(self):
        """(external-product plan, key-switch plan) on the key's device."""
        return (_pk.get_kernel_plan(self.N, self.primes, self.l, self.Bg_bit,
                                    self.k, self.device),
                _pk.get_kernel_plan(self.N, self.ks_primes, self.ks_t,
                                    self.ks_base_bit, self.k, self.device))


def new_key(out_key: TRGSWKey, in_key: TLWEKey, generator: torch.Generator,
            device=None) -> GABootstrapKey:
    """GA bootstrap key generation: TRGSW(X^{s_i}), then the KS key of every
    odd generator g, s(X^g) -> s, with the TRGSW decomposition reused as
    the key switch's (`bootstrap_ga.c:5-24` passes l and Bg_bit as t and
    base_bit).  The keyset is encrypted ``GA_KEYGEN_CHUNK`` generators at a
    time straight into its buffer.  At the module's torus width (the gadget
    values, the words and the key-switch plan's prime count follow it).
    Computed where the keys live, returned on ``device``."""
    dev = default_device(device)
    tk = out_key.trlwe_key
    l, Bg_bit, k, N = out_key.l, out_key.Bg_bit, tk.k, tk.N
    plan = out_key.plan()
    s = in_key.s.to(plan.device)
    gd = _trgsw.to_dft(_trgsw.monomial_encrypt(torch.ones_like(s), s,
                                               out_key, generator),
                       plan, with_shoup=True)
    t, base_bit = l, Bg_bit
    ks_plan = _ks._ks_plan(N, base_bit, t, k * t, plan.device)
    inv2n = torch.from_numpy(inverse_mod_2n_table(N)).to(plan.device)
    vals = _trgsw._gadget_values(t, base_bit, plan.device)
    ak = torch.empty((N, k * t, k + 1, ks_plan.P, N), dtype=torch.int32,
                     device=plan.device)
    for g0 in range(0, N, GA_KEYGEN_CHUNK):
        ginv = inv2n[g0:g0 + GA_KEYGEN_CHUNK, None]
        s_perm = _poly.permute_by_inverse(tk.s, ginv)           # [G, k, N]
        ms = s_perm[:, :, None, :] * vals[:, None]              # [G, k, t, N]
        v = _ks._encrypt_batch_to_dft(ms, tk, generator, ks_plan)
        ak[g0:g0 + ginv.shape[0]] = _pk.u32_as_i32(v).reshape(
            (-1,) + tuple(ak.shape[1:]))
    return GABootstrapKey(_pk.u32_as_i32(gd.v), _pk.u32_as_i32(gd.vs), ak,
                          inv2n, in_key.n, k, N, l, Bg_bit, t, base_bit,
                          plan.primes, ks_plan.primes).to(dev)


@functools.lru_cache(maxsize=None)
def _ga_log_tables(N: int):
    """Discrete logs of the odd automorphism group: every odd g mod 2N is
    (-1)^s 3^e with e < N/2.  Returns (dlog [N] int32 holding (e << 1) | s
    at index (g-1)/2, the inverses of 3^(2^i) for i < log2(N/2), and the
    inverse of -1)."""
    order = N // 2
    dlog = np.zeros(N, np.int32)
    val = 1
    for e in range(order):
        dlog[(val - 1) >> 1] = e << 1
        dlog[(2 * N - val - 1) >> 1] = (e << 1) | 1
        val = (val * 3) % (2 * N)
    inverses, h = [], 3
    for _ in range(order.bit_length() - 1):
        inverses.append(pow(h, -1, 2 * N))
        h = (h * h) % (2 * N)
    return dlog, tuple(inverses), 2 * N - 1


def _permute_log(x, gen, N: int):
    """psi_gen through gen = (-1)^s 3^e: one conditional fixed permutation
    per bit of e, then one for s.  x [..., C, N]; gen [...] odd.  The same
    words as `_permute_dyn`."""
    dlog, inverses, neg_inverse = _ga_log_tables(N)
    se = torch.from_numpy(dlog).to(x.device)[(gen.to(torch.int64) - 1) >> 1]
    e, s = se >> 1, se & 1
    for i, ginv in enumerate(inverses):
        bit = (((e >> i) & 1) == 1)[..., None, None]
        x = torch.where(bit, _poly.permute_by_inverse(x, ginv), x)
    return torch.where((s == 1)[..., None, None],
                       _poly.permute_by_inverse(x, neg_inverse), x)


def _permute_dyn(x, gen, inv2n, N: int):
    """Galois permutation with a per-row odd generator: x [..., C, N], gen
    [...] int; ginv looked up in ``inv2n``."""
    ginv = inv2n.to(torch.int64)[(gen.to(torch.int64) - 1) >> 1]
    return _poly.permute_by_inverse(x, ginv[..., None])


def _eval_auto_dyn(acc_st, gen, bk: GABootstrapKey):
    """Permute by a per-row generator, then key-switch with the keyset entry
    it selects (`trlwe_eval_automorphism` with a runtime key), in plain
    PyTorch: acc_st [B, k+1, N], gen [B]."""
    kidx = (gen.to(torch.int64) - 1) >> 1
    return _pk.auto_keyswitch_rows(acc_st, bk.ak, kidx,
                                   bk.inv2n.to(torch.int64)[kidx],
                                   bk.kernel_plans()[1])


def ga_rotate_inputs(tv: TRLWE, a, bk: GABootstrapKey):
    """The kernels' operands for `blind_rotate_ga`: the accumulators
    flattened to [B, k+1, N]; the initial key switch's keyset index
    (w0 - 1)/2 and generator inverse, int32 [B]; the step generators int32
    [n, B]; the batch shape (``tv``'s and ``a``'s broadcast).

    a_i = round(a_i 2N) | 1 (odd), w_i = a_i^-1 mod 2N (looked up), and
    the step generators are a_i w_{i+1} for i < n-1, then a_{n-1} itself."""
    N, k = bk.N, bk.k
    st = tv.stacked()
    batch = torch.broadcast_shapes(tuple(a.shape[:-1]), tuple(st.shape[:-2]))
    B = math.prod(batch)
    acc0 = st.expand(batch + (k + 1, N)).reshape(B, k + 1, N).contiguous()
    a_int = torus2int(a.expand(batch + tuple(a.shape[-1:])).reshape(B, -1),
                      int(math.log2(2 * N))) | 1                 # [B, n]
    inv = bk.inv2n.to(torch.int64)
    w = inv[(a_int - 1) >> 1]
    kidx0 = (w[:, 0] - 1) >> 1
    gens = torch.cat([(a_int[:, :-1] * w[:, 1:]) & (2 * N - 1),
                      a_int[:, -1:]], dim=1)
    return (acc0, kidx0.to(torch.int32), inv[kidx0].to(torch.int32),
            gens.t().to(torch.int32).contiguous(), batch)


def blind_rotate_ga(tv: TRLWE, a, bk: GABootstrapKey) -> TRLWE:
    """(`blind_rotate_ga`, `bootstrap_ga.c:39-60`), batched:
    acc = psi_{w0}(tv); per step acc = psi_{a_i w_{i+1}}(BK_i (x) acc); the
    last step's generator is a_{n-1}.  On CUDA tensors one K6 launch and
    one K7 launch, on CPU tensors their plain versions."""
    acc0, kidx0, ginv0, gens, batch = ga_rotate_inputs(tv, a, bk)
    kp, kp_ks = bk.kernel_plans()
    acc = _pk.auto_keyswitch_stream(acc0, bk.ak, kidx0, ginv0, kp_ks)
    acc = _pk.ga_scan_fused(acc, gens, bk.s_v32, bk.s_vs32, bk.ak, bk.inv2n,
                            kp, kp_ks)
    return from_stacked(acc.reshape(batch + (bk.k + 1, bk.N)))


def _step_generators(gens, bk: GABootstrapKey):
    """Keyset indices (g - 1)/2 and generator inverses of the step
    generators ``gens`` [n, B], both int32 [n, B] on the key's device."""
    kidx = (gens.to(torch.int64) - 1) >> 1
    return (kidx.to(torch.int32).contiguous(),
            bk.inv2n.to(torch.int64)[kidx].to(torch.int32).contiguous())


def blind_rotate_ga_stepwise(tv: TRLWE, a, bk: GABootstrapKey) -> TRLWE:
    """`blind_rotate_ga` one stage per launch, the TPU package's two-kernel
    form (`MOSFHET_GA_ONEKERNEL=0`): psi_{w0} by K6, then per step the
    external product BK_i (x) acc by K1-delta and psi_{g_i} with its key
    switch by K6 (which permutes as it loads).  On CUDA tensors n K1-delta
    launches and n+1 K6 launches, on CPU tensors their plain versions; the
    words are `blind_rotate_ga`'s.  64-bit torus only."""
    _pk._u64_only("blind_rotate_ga_stepwise", tv.b)
    acc, kidx0, ginv0, gens, batch = ga_rotate_inputs(tv, a, bk)
    kp, kp_ks = bk.kernel_plans()
    kidx, ginv = _step_generators(gens, bk)
    acc = _pk.auto_keyswitch_stream(acc, bk.ak, kidx0, ginv0, kp_ks)
    for i in range(gens.shape[0]):
        t = _pk.cmux_delta(acc, bk.s_v32[i], bk.s_vs32[i], kp)
        acc = _pk.auto_keyswitch_stream(t, bk.ak, kidx[i], ginv[i], kp_ks)
    return from_stacked(acc.reshape(batch + (bk.k + 1, bk.N)))


def blind_rotate_ga_gathered(tv: TRLWE, a, bk: GABootstrapKey) -> TRLWE:
    """`blind_rotate_ga` with the keyset rows gathered per ciphertext before
    each key switch, the TPU package's `MOSFHET_GA_STREAM=0` form: each key
    switch (psi_{w0} and one per step) is the Galois permutation and the
    gather ``bk.ak[(g - 1)/2]`` in PyTorch, then one K6-old launch; each
    step puts the external product (K1-delta) in front.  On CUDA tensors n
    K1-delta launches and n+1 K6-old launches, on CPU tensors their plain
    versions; the words are `blind_rotate_ga`'s.  64-bit torus only."""
    _pk._u64_only("blind_rotate_ga_gathered", tv.b)
    acc, kidx0, ginv0, gens, batch = ga_rotate_inputs(tv, a, bk)
    kp, kp_ks = bk.kernel_plans()
    kidx, ginv = _step_generators(gens, bk)

    def switch(x, k_idx, g_inv):
        perm = _poly.permute_by_inverse(x, g_inv.to(torch.int64)[:, None])
        return _pk.auto_keyswitch(perm, bk.ak[k_idx.to(torch.int64)], kp_ks)

    acc = switch(acc, kidx0, ginv0)
    for i in range(gens.shape[0]):
        acc = switch(_pk.cmux_delta(acc, bk.s_v32[i], bk.s_vs32[i], kp),
                     kidx[i], ginv[i])
    return from_stacked(acc.reshape(batch + (bk.k + 1, bk.N)))


def functional_bootstrap_ga(tv: TRLWE, c: TLWE, bk: GABootstrapKey,
                            torus_base: int) -> TLWE:
    """(`functional_bootstrap_ga`, `bootstrap_ga.c:62-76`): rotate the test
    vector by -round(b), GA blind rotation, extract coefficient 0."""
    acc = rotate_test_vector(tv, c, bk, torus_base)
    return _trlwe.extract_tlwe(blind_rotate_ga(acc, c.a, bk), 0)
