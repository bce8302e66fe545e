"""Key switching: the family of `src/keyswitch.c`.

- TRLWE -> TRLWE key switch, dense and seeded keys       (`keyswitch.c:12-37,162-193`)
- relinearization key (s^2)                              (`keyswitch.c:3-10`)
- private KS pair TRLWE(M) -> TRLWE(m (-s))              (`keyswitch.c:39-63`)
- RLWE private KS with a multiplicand polynomial v       (`keyswitch.c:65-97,575-608`)
- full packing, n TLWEs -> one TRLWE                     (`keyswitch.c:99-107,195-227`)
- LUT packing, packing1 and private-SK switches          (`keyswitch.c:244-475,611-656`)
- CDKS21 packing by the automorphism trace               (`keyswitch.c:477-546`)
- automorphism keysets and EvalAuto                      (`keyswitch.c:500-524`, `trlwe.c:775-781`)
- gadget -> RGSW conversion                              (`keyswitch.c:548-572`)

Where each runs on the card:
- the digit-decomposed switches (`trlwe_keyswitch`, `eval_automorphism`,
  `priv_keyswitch_2`, the CDKS21 trace, `rlwe_priv_keyswitch`, and the
  relinearization in `product`) are launches of the automorphism
  key-switch kernel (K6, ``ops/csrc/auto_keyswitch.cu``), which computes
  (0, b) - sum_{i,j} dec_j(a_i) (x) KS[i][j]: a key is a keyset of one
  entry selected by index 0, `eval_automorphism` passes the generator's
  inverse and the kernel permutes as it loads.  A seeded key's masks are
  regenerated and transformed (plain PyTorch) and the switch is one K6
  launch on the assembled key;
- the gather-style switches on a dense table (`packing1_keyswitch`,
  `priv_keyswitch`, `lut_packing_keyswitch`) are one launch each of the key
  switch's select-sum kernel (K2, ``ops/csrc/tlwe_keyswitch.cu``) on the
  table [R, t, base-1, k+1, N] viewed as rows of (k+1) N words;
- on a seeded table they run the streamed gather in plain PyTorch, as the
  TPU package runs it in jnp: only the selected entries' masks are
  regenerated, the dense table is never built;
- full packing (k_in = n rows for a TRLWE of k_out) is plain PyTorch on the
  NTT, as in the TPU package.
On CPU tensors every kernel call takes its plain version.

Both torus widths wherever the TPU package defines the function: under
``MOSFHET_TORUS_BITS=32`` keys encrypt the 32-bit gadget values and the
kernels run their one-limb forms on int32 words.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import ntt as _ntt
from . import polynomial as _poly
from . import seeded as _seeded
from . import tlwe as _tlwe
from . import trlwe as _trlwe
from ._device import default_device
from .ops import pbs_kernel as _pk
from .tlwe import TLWE, TLWEKey
from .trgsw import _gadget_values
from .trlwe import TRLWE, TRLWEKey, from_stacked
from .torus import TORUS_BITS, TORUS_DTYPE, gadget_decompose, wrap

# Table slots encrypted per keygen step: keeps a keygen's transient near
# a chunk's NTTs whatever the table's size (1.6 GB at TFHEpp-L2, N=2048).
KEYGEN_CHUNK = 2048
# Bytes of the streamed gather's selected entries per step.
STREAM_BYTES = 64 << 20


# =========================================================================
# TRLWE -> TRLWE key switch (digit decomposition)
# =========================================================================

class TRLWEKSKey(nn.Module):
    """NTT-form encryptions of s_in[i] 2^(TORUS_BITS - (j+1) base_bit) under
    the output key (`trlwe_new_KS_key`): ``v32`` [k_in, t, k_out+1, P, N]
    int32 holding u32 canonical residues (the kernel multiplies runtime keys
    by Barrett, so no Shoup companions are kept); ``v`` gives the int64
    values."""

    def __init__(self, v32: torch.Tensor, t: int, base_bit: int, primes):
        super().__init__()
        self.register_buffer("v32", v32)
        self.t, self.base_bit = t, base_bit
        self.primes = tuple(int(p) for p in primes)

    @property
    def v(self):
        return _pk.i32_as_u32(self.v32)

    @property
    def k_in(self) -> int:
        return self.v32.shape[0]

    @property
    def N(self) -> int:
        return self.v32.shape[-1]

    def kernel_plan(self) -> _pk.PBSKernelPlan:
        """K6's plan: the key switch's t and base_bit as its l and Bg_bit."""
        return _pk.get_kernel_plan(self.N, self.primes, self.t, self.base_bit,
                                   self.v32.shape[2] - 1, self.v32.device)


class SeededTRLWEKSKey(nn.Module):
    """A TRLWE key-switch key with its masks as seeds: ``seeds`` [k_in, t, 2]
    (u32 key words in int64) and the b polynomials' NTT form ``b_v32``
    [k_in, t, P, N] (u32 residues in int32).  The masks are regenerated,
    transformed and joined to the b rows at apply time (`expanded`), the
    exact-arithmetic form of the reference's DFT-domain compressed samples
    (`trlwe_compressed_vaes.c:88-202`): a mask must be defined by its
    coefficients, or the CRT bound breaks."""

    def __init__(self, seeds: torch.Tensor, b_v32: torch.Tensor, k_out: int,
                 t: int, base_bit: int, primes):
        super().__init__()
        self.register_buffer("seeds", seeds)
        self.register_buffer("b_v32", b_v32)
        self.k_out, self.t, self.base_bit = k_out, t, base_bit
        self.primes = tuple(int(p) for p in primes)

    @property
    def k_in(self) -> int:
        return self.seeds.shape[0]

    @property
    def N(self) -> int:
        return self.b_v32.shape[-1]

    def expanded(self) -> TRLWEKSKey:
        """The dense key: the masks [k_in, t, k_out, N] from the seeds, to
        the NTT domain, then the b rows after them."""
        plan = _ntt.get_plan(self.N, self.primes, self.seeds.device)
        a = _seeded._expand_a(self.seeds, self.k_out, self.N)
        av = _pk.u32_as_i32(_ntt.to_ntt_u64(a, plan))
        v32 = torch.cat([av, self.b_v32.unsqueeze(2)], dim=2)
        return TRLWEKSKey(v32, self.t, self.base_bit, self.primes)


def _ks_plan(N: int, base_bit: int, t: int, k_in: int, device) -> _ntt.NTTPlan:
    bound = _ntt.conv_bound(N, 1 << (base_bit - 1), k_in * t)
    return _ntt.get_plan(N, _ntt.primes_for_bound(bound), device)


def _shift_values(t: int, base_bit: int, device) -> torch.Tensor:
    """2^(TORUS_BITS - (j+1) base_bit) for j < t, as int64 (u64 bits at the
    64-bit torus)."""
    return _gadget_values(t, base_bit, device).to(torch.int64)


def _ks_messages(in_s, t: int, base_bit: int):
    """ms[i, j] = s_in[i] 2^shift_j [k_in, t, N] in int64; wrapped to the
    torus width by the encryption."""
    return in_s[:, None, :] * _shift_values(t, base_bit, in_s.device)[:, None]


def _encrypt_batch_to_dft(ms, out_key: TRLWEKey, generator: torch.Generator,
                          plan: _ntt.NTTPlan):
    """Encrypt a [..., N] batch of messages; return the stacked NTT form
    [..., k+1, P, N] as int64 residues."""
    c = _trlwe.encrypt(ms, out_key, generator)
    return _ntt.to_ntt_u64(c.stacked(), plan)


def new_trlwe_ks_key(out_key: TRLWEKey, in_key: TRLWEKey, t: int,
                     base_bit: int, generator: torch.Generator,
                     device=None) -> TRLWEKSKey:
    """(`trlwe_new_KS_key`, `keyswitch.c:12-37`), at the module's torus
    width.  Computed where the keys live, returned on ``device``."""
    dev = default_device(device)
    plan = _ks_plan(out_key.N, base_bit, t, in_key.k * t, out_key.s.device)
    v = _encrypt_batch_to_dft(_ks_messages(in_key.s, t, base_bit), out_key,
                              generator, plan)
    return TRLWEKSKey(_pk.u32_as_i32(v), t, base_bit, plan.primes).to(dev)


def new_trlwe_ks_key_seeded(out_key: TRLWEKey, in_key: TRLWEKey, t: int,
                            base_bit: int, generator: torch.Generator,
                            device=None) -> SeededTRLWEKSKey:
    """Seeded `trlwe_new_KS_key`: the dense keygen's encryptions, masks
    drawn from seeds (`trlwe_new_compressed_sample`,
    `trlwe_compressed.c:37-53`, lifted to the key's table)."""
    dev = default_device(device)
    plan = _ks_plan(out_key.N, base_bit, t, in_key.k * t, out_key.s.device)
    sc = _seeded.encrypt(_ks_messages(in_key.s, t, base_bit), out_key,
                         generator)
    b_v = _pk.u32_as_i32(_ntt.to_ntt_u64(sc.b, plan))
    return SeededTRLWEKSKey(sc.seed, b_v, out_key.k, t, base_bit,
                            plan.primes).to(dev)


def _dense(ksk) -> TRLWEKSKey:
    return ksk.expanded() if isinstance(ksk, SeededTRLWEKSKey) else ksk


def _switch(c: TRLWE, ksk: TRLWEKSKey, ginv: int) -> TRLWE:
    """One K6 launch over the flattened batch of ``c``: permute by ginv,
    then switch with the key's one entry."""
    k, N = c.k, c.N
    if ksk.v32.shape[:3] != (k, ksk.t, k + 1):
        raise ValueError(f"a key [k_in, t, k_out+1] = {tuple(ksk.v32.shape[:3])}"
                         f" does not switch a k={k} TRLWE to k={k}")
    return _launch_k6(c.stacked(), ksk.v32, ksk.kernel_plan(), ginv)


def _launch_k6(st, rows, kp: _pk.PBSKernelPlan, ginv: int) -> TRLWE:
    """(0, b) - sum dec(a) (x) rows of the stacked TRLWEs ``st`` [..., k+1,
    N], permuted by ginv first: one K6 launch on the key ``rows`` [k, t,
    k+1, P, N] (a view, read in place) as a keyset of one entry."""
    batch = tuple(st.shape[:-2])
    C, N = st.shape[-2:]
    x = st.reshape(math.prod(batch), C, N).contiguous()
    entry = rows.reshape((1, rows.shape[0] * rows.shape[1])
                         + tuple(rows.shape[2:]))
    kidx = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    out = _pk.auto_keyswitch_stream(x, entry, kidx,
                                    torch.full_like(kidx, ginv), kp)
    return from_stacked(out.reshape(batch + (C, N)))


def trlwe_keyswitch(c: TRLWE, ksk) -> TRLWE:
    """(`trlwe_keyswitch`, `keyswitch.c:162-193`):
    out = (0, b) - sum_{i,j} dec_j(a_i) (x) KS[i][j], for a dense or seeded
    key with k_in = k_out.  On CUDA tensors one K6 launch, on CPU tensors
    its plain version."""
    return _switch(c, _dense(ksk), 1)


def eval_automorphism(c: TRLWE, gen: int, ksk) -> TRLWE:
    """x^i -> x^(gen i), then the key switch back (`trlwe_eval_automorphism`,
    `trlwe.c:775-781`): ``trlwe_keyswitch(trlwe.permute(c, gen), ksk)``, as
    one K6 launch that permutes as it loads.  Dense or seeded keys."""
    if gen % 2 != 1:
        raise ValueError(f"an automorphism needs an odd generator, got {gen}")
    return _switch(c, _dense(ksk), pow(int(gen), -1, 2 * c.N))


def new_rl_key(key: TRLWEKey, t: int, base_bit: int,
               generator: torch.Generator, device=None) -> TRLWEKSKey:
    """Relinearization key: the KS key for s^2 (`trlwe_new_RL_key`,
    `keyswitch.c:3-10`).  k must be 1."""
    if key.k != 1:
        raise ValueError(f"a relinearization key needs k = 1, got {key.k}")
    s2 = _poly.ntt_mul_small_small(key.s[0], key.s[0], key.s_bound,
                                   key.s_bound)
    key2 = TRLWEKey(s=s2[None], sigma=key.sigma,
                    s_bound=key.s_bound * key.s_bound * key.N)
    return new_trlwe_ks_key(key, key2, t, base_bit, generator, device)


def new_priv_ks_key_pair(out_key: TRLWEKey, in_key: TRLWEKey, t: int,
                         base_bit: int, generator: torch.Generator,
                         device=None):
    """[KS for -s_out s_in, KS for -s_out] (`trlwe_new_priv_KS_key`,
    `keyswitch.c:39-63`).  out_key's k must be 1."""
    if out_key.k != 1:
        raise ValueError(f"a private KS pair needs k_out = 1, got {out_key.k}")
    prod = _poly.ntt_mul_small_small(-out_key.s[0], in_key.s[0],
                                     out_key.s_bound, in_key.s_bound)
    tmp1 = TRLWEKey(s=prod[None], sigma=out_key.sigma,
                    s_bound=out_key.s_bound * in_key.s_bound * out_key.N)
    tmp2 = TRLWEKey(s=-out_key.s, sigma=out_key.sigma,
                    s_bound=out_key.s_bound)
    return (new_trlwe_ks_key(out_key, tmp1, t, base_bit, generator, device),
            new_trlwe_ks_key(out_key, tmp2, t, base_bit, generator, device))


def priv_keyswitch_2(c: TRLWE, ks_pair) -> TRLWE:
    """(`trlwe_priv_keyswitch_2`, `keyswitch.c:52-63`): the switch of
    (-b, 0) by the second key plus that of (a, 0) by the first, two K6
    launches on the card.  k must be 1."""
    if c.k != 1:
        raise ValueError(f"priv_keyswitch_2 needs k = 1, got {c.k}")
    zero = torch.zeros_like(c.b)
    tmp = trlwe_keyswitch(TRLWE(a=(-c.b).unsqueeze(-2), b=zero), ks_pair[1])
    out = trlwe_keyswitch(TRLWE(a=c.a, b=zero), ks_pair[0])
    return _trlwe.add(out, tmp)


def new_rlwe_priv_ks_key(out_key: TRLWEKey, in_key: TRLWEKey, v, t: int,
                         base_bit: int, generator: torch.Generator,
                         device=None) -> TRLWEKSKey:
    """KS with a multiplicand polynomial v: rows for each a_i carry s_i v,
    one more row for b carries v itself (`trlwe_new_RLWE_priv_KS_key`,
    `keyswitch.c:575-608`).  v: [N] torus words.  Key [k_in+1, t, k_out+1,
    P, N]."""
    dev = default_device(device)
    plan = _ks_plan(out_key.N, base_bit, t, (in_key.k + 1) * t,
                    out_key.s.device)
    v = wrap(torch.as_tensor(v, device=out_key.s.device))
    sv = torch.stack([_poly.ntt_mul_small(in_key.s[i], v, in_key.plan())
                      for i in range(in_key.k)] + [v])     # [k_in+1, N]
    ms = sv.to(torch.int64)[:, None, :] \
        * _shift_values(t, base_bit, sv.device)[:, None]   # [k_in+1, t, N]
    vv = _encrypt_batch_to_dft(ms, out_key, generator, plan)
    return TRLWEKSKey(_pk.u32_as_i32(vv), t, base_bit, plan.primes).to(dev)


def rlwe_priv_keyswitch(c: TRLWE, ksk: TRLWEKSKey) -> TRLWE:
    """(`trlwe_RLWE_priv_keyswitch`, `keyswitch.c:65-97`):
    out = sum dec(b) (x) KS[k] - sum_i dec(a_i) (x) KS[i], for k_in =
    k_out = k.  Two K6 launches: (a, 0) against rows 0..k-1 gives -as, and
    (0, .., 0, b, 0) against rows 1..k (b in the last mask slot, whose rows
    are KS[k]; the zero slots' digits are 0) gives -bs; their difference is
    bs - as mod 2^bits.  Each partial sums fewer terms than the key's plan
    was sized for ((k+1) t), so each is exact, and so is the difference:
    the words of the TPU package's one reconstruction of bs - as."""
    k, N = c.k, c.N
    if ksk.v32.shape[:3] != (k + 1, ksk.t, k + 1):
        raise ValueError(f"an RLWE private KS key [k_in+1, t, k_out+1] = "
                         f"{tuple(ksk.v32.shape[:3])} does not switch a k={k}"
                         f" TRLWE to k={k}")
    kp = ksk.kernel_plan()
    zero = torch.zeros_like(c.b).unsqueeze(-2)
    xa = torch.cat([c.a, zero], dim=-2)
    xb = torch.cat([torch.zeros_like(c.a[..., 1:, :]), c.b.unsqueeze(-2),
                    zero], dim=-2)
    minus_as = _launch_k6(xa, ksk.v32[:k], kp, 1)
    minus_bs = _launch_k6(xb, ksk.v32[1:], kp, 1)
    return _trlwe.sub(minus_as, minus_bs)


# =========================================================================
# full packing: n TLWEs -> one TRLWE (`keyswitch.c:99-107,195-227`)
# =========================================================================

class FullPackingKSKey(nn.Module):
    """v / vs [n, t, k_out+1, P, N] int64: TRLWE(s_i 2^shift_j X^0) in NTT
    form with Shoup companions."""

    def __init__(self, v: torch.Tensor, vs: torch.Tensor, t: int,
                 base_bit: int, primes):
        super().__init__()
        self.register_buffer("v", v)
        self.register_buffer("vs", vs)
        self.t, self.base_bit = t, base_bit
        self.primes = tuple(int(p) for p in primes)

    def plan(self) -> _ntt.NTTPlan:
        return _ntt.get_plan(self.v.shape[-1], self.primes, self.v.device)


def new_full_packing_ks_key(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                            base_bit: int, generator: torch.Generator,
                            device=None) -> FullPackingKSKey:
    dev = default_device(device)
    N, n, kdev = out_key.N, in_key.n, out_key.s.device
    plan = _ks_plan(N, base_bit, t, n * t, kdev)     # a sum over n t rows
    const = in_key.s.to(kdev)[:, None] * _shift_values(t, base_bit, kdev)
    ms = torch.zeros((n, t, N), dtype=torch.int64, device=kdev)
    ms[:, :, 0] = const
    v = _encrypt_batch_to_dft(ms, out_key, generator, plan)
    return FullPackingKSKey(v, _ntt.make_shoup(v, plan.p[:, None]), t,
                            base_bit, plan.primes).to(dev)


def _decompose_digits(x, base_bit: int, t: int):
    """[..., C, N] -> [..., C t, N] rounded digits (decompose_i offsets)."""
    d = gadget_decompose(x, base_bit, t)      # [..., C, t, N]
    return d.reshape(d.shape[:-3] + (d.shape[-3] * t, d.shape[-1]))


def full_packing_keyswitch(cs: TLWE, size: int,
                           ksk: FullPackingKSKey) -> TRLWE:
    """Pack ``size`` TLWEs (cs's axis -2 of a) into the first coefficients
    of one TRLWE (`trlwe_full_packing_keyswitch`, `keyswitch.c:195-227`).
    Plain PyTorch, as in the TPU package: the key has n rows for a TRLWE of
    k_out, outside K6's form."""
    plan = ksk.plan()
    N = ksk.v.shape[-1]
    # a_poly[i, coefficient j] = cs.a[j, i]: the ciphertext is the coefficient
    a_i = cs.a.transpose(-1, -2)                       # [..., n, size]
    a_i = nn.functional.pad(a_i, (0, N - size))        # [..., n, N]
    spec = _ntt.to_ntt_small(_decompose_digits(a_i, ksk.base_bit, ksk.t),
                             plan)                      # [..., n t, P, N]
    kv = ksk.v.reshape((-1,) + tuple(ksk.v.shape[2:]))
    kvs = ksk.vs.reshape(kv.shape)
    acc = _ntt.pointwise_mul_acc_key(spec.unsqueeze(-3), kv, kvs, plan,
                                     dim=-4)
    out = _trlwe.neg(from_stacked(_ntt.from_ntt_u64(acc, plan,
                                                    cs.b.dtype)))
    b = out.b.clone()
    b[..., :size] += cs.b
    return TRLWE(a=out.a, b=b)


# =========================================================================
# gather-style packing keyswitches (`keyswitch.c:244-475,611-656`)
# =========================================================================

class GenericKSKey(nn.Module):
    """Table of TRLWEs ``table`` [n(+1), t, base-1, k+1, N] torus words
    (`Generic_KS_Key`, `mosfhet.h:100-104`); the b row is included for the
    private-SK flavour."""

    def __init__(self, table: torch.Tensor, t: int, base_bit: int,
                 include_b: bool):
        super().__init__()
        self.register_buffer("table", table)
        self.t, self.base_bit, self.include_b = t, base_bit, include_b


class LUTPackingKSKey(nn.Module):
    """Table [n, torus_base, t, base-1, k+1, N] (`LUT_Packing_KS_Key`)."""

    def __init__(self, table: torch.Tensor, t: int, base_bit: int,
                 torus_base: int):
        super().__init__()
        self.register_buffer("table", table)
        self.t, self.base_bit, self.torus_base = t, base_bit, torus_base


class SeededGenericKSKey(nn.Module):
    """A `GenericKSKey` with its masks as seeds: ``seeds`` [n(+1), t, base-1,
    2] (u32 key words in int64) and ``b`` [n(+1), t, base-1, N], the key
    material on b (the reference's USE_COMPRESSED_TRLWE tables,
    `keyswitch.c:231-241`): 1/(k+1) of the dense table's bytes."""

    def __init__(self, seeds: torch.Tensor, b: torch.Tensor, k: int, t: int,
                 base_bit: int, include_b: bool):
        super().__init__()
        self.register_buffer("seeds", seeds)
        self.register_buffer("b", b)
        self.k, self.t, self.base_bit, self.include_b = \
            k, t, base_bit, include_b


class SeededLUTPackingKSKey(nn.Module):
    """A `LUTPackingKSKey` with its masks as seeds: ``seeds`` [n,
    torus_base, t, base-1, 2], ``b`` [n, torus_base, t, base-1, N]."""

    def __init__(self, seeds: torch.Tensor, b: torch.Tensor, k: int, t: int,
                 base_bit: int, torus_base: int):
        super().__init__()
        self.register_buffer("seeds", seeds)
        self.register_buffer("b", b)
        self.k, self.t, self.base_bit, self.torus_base = \
            k, t, base_bit, torus_base


def _zero_table(out_key: TRLWEKey, total: int, generator: torch.Generator,
                add_fn, seeded: bool):
    """Encryptions of zero for ``total`` table slots, KEYGEN_CHUNK at a time,
    each chunk's b plus ``add_fn(idx)`` [chunk, N] (the key material of
    slots idx), written straight into the result: (seeds [total, 2], b
    [total, N]) if ``seeded``, else the table [total, k+1, N]."""
    N, k, dev = out_key.N, out_key.k, out_key.s.device
    if seeded:
        seeds = torch.empty((total, 2), dtype=torch.int64, device=dev)
        bs = torch.empty((total, N), dtype=TORUS_DTYPE, device=dev)
    else:
        tab = torch.empty((total, k + 1, N), dtype=TORUS_DTYPE, device=dev)
    for i0 in range(0, total, KEYGEN_CHUNK):
        i1 = min(total, i0 + KEYGEN_CHUNK)
        idx = torch.arange(i0, i1, device=dev)
        zeros = torch.zeros((i1 - i0, N), dtype=TORUS_DTYPE, device=dev)
        if seeded:
            c = _seeded.encrypt(zeros, out_key, generator)
            seeds[i0:i1] = c.seed
            bs[i0:i1] = c.b + wrap(add_fn(idx))
        else:
            c = _trlwe.encrypt(zeros, out_key, generator)
            tab[i0:i1, :k] = c.a
            tab[i0:i1, k] = c.b + wrap(add_fn(idx))
    return (seeds, bs) if seeded else tab


def _dec_key_values(in_s, t: int, base_bit: int):
    """dec[i, j, v] = s_i (v+1) 2^(TORUS_BITS-(j+1) base_bit) [R, t, base-1],
    int64 (u64 bits at the 64-bit torus; wrapped by the caller)."""
    vals = torch.arange(1, 1 << base_bit, dtype=torch.int64,
                        device=in_s.device)
    return (in_s.to(torch.int64)[:, None, None] * vals
            * _shift_values(t, base_bit, in_s.device)[:, None])


def _packing1_add(in_key: TLWEKey, t: int, base_bit: int, N: int, dev):
    """packing1's key material: slot (i, j, v) adds dec[i, j, v] to
    coefficient 0 of b."""
    dec = _dec_key_values(in_key.s.to(dev), t, base_bit).reshape(-1)

    def add_fn(idx):
        out = torch.zeros((idx.numel(), N), dtype=torch.int64, device=dev)
        out[:, 0] = dec[idx]
        return out
    return add_fn


def _priv_sk_add(out_key: TRLWEKey, in_key: TLWEKey, t: int, base_bit: int):
    """The private-SK key material: slot (i, j, v) adds dec[i, j, v] (-s_out)
    to b, with s_n = -1 for the b row."""
    dev = out_key.s.device
    s_ext = torch.cat([in_key.s.to(dev).to(torch.int64),
                       torch.full((1,), -1, dtype=torch.int64, device=dev)])
    dec = _dec_key_values(s_ext, t, base_bit).reshape(-1)
    minus_s = -out_key.s[0].to(torch.int64)
    return lambda idx: dec[idx][:, None] * minus_s


def _lut_packing_add(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                     base_bit: int, torus_base: int):
    """LUT packing's key material: slot (i, e, j, v) adds dec[i, j, v] to
    the coefficients of b in slot e."""
    dev, N = out_key.s.device, out_key.N
    base_m1 = (1 << base_bit) - 1
    dec = _dec_key_values(in_key.s.to(dev), t, base_bit).reshape(-1)
    slot_of = torch.arange(N, device=dev) // (N // torus_base)
    mask = (slot_of == torch.arange(torus_base, device=dev)[:, None]) \
        .to(torch.int64)                                       # [tb, N]

    def add_fn(idx):      # table layout (i, e, j, v), row-major
        i = idx // (torus_base * t * base_m1)
        e = (idx // (t * base_m1)) % torus_base
        return dec[i * t * base_m1 + idx % (t * base_m1)][:, None] * mask[e]
    return add_fn


def new_packing1_ks_key(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                        base_bit: int, generator: torch.Generator,
                        device=None) -> GenericKSKey:
    """TLWE(m) -> TRLWE(m X^0) key (`trlwe_new_packing1_KS_key`,
    `keyswitch.c:368-390`)."""
    dev = default_device(device)
    shape = (in_key.n, t, (1 << base_bit) - 1)
    tab = _zero_table(out_key, math.prod(shape), generator,
                      _packing1_add(in_key, t, base_bit, out_key.N,
                                    out_key.s.device), seeded=False)
    return GenericKSKey(tab.reshape(shape + tab.shape[1:]), t, base_bit,
                        False).to(dev)


def new_priv_sk_ks_key(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                       base_bit: int, generator: torch.Generator,
                       device=None) -> GenericKSKey:
    """TLWE(M) -> TRLWE(m (-s)) in n^2 (`trlwe_new_priv_SK_KS_key_N2`,
    `keyswitch.c:611-637`).  out_key's k must be 1."""
    if out_key.k != 1:
        raise ValueError(f"a private-SK key needs k_out = 1, got {out_key.k}")
    dev = default_device(device)
    shape = (in_key.n + 1, t, (1 << base_bit) - 1)
    tab = _zero_table(out_key, math.prod(shape), generator,
                      _priv_sk_add(out_key, in_key, t, base_bit),
                      seeded=False)
    return GenericKSKey(tab.reshape(shape + tab.shape[1:]), t, base_bit,
                        True).to(dev)


def new_lut_packing_ks_key(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                           base_bit: int, torus_base: int,
                           generator: torch.Generator,
                           device=None) -> LUTPackingKSKey:
    """(`trlwe_new_packing_KS_key`, `keyswitch.c:244-270`): entry [i, e, j,
    v] puts the decomposed key value into slot e."""
    dev = default_device(device)
    shape = (in_key.n, torus_base, t, (1 << base_bit) - 1)
    tab = _zero_table(out_key, math.prod(shape), generator,
                      _lut_packing_add(out_key, in_key, t, base_bit,
                                       torus_base), seeded=False)
    return LUTPackingKSKey(tab.reshape(shape + tab.shape[1:]), t, base_bit,
                           torus_base).to(dev)


def new_packing1_ks_key_seeded(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                               base_bit: int, generator: torch.Generator,
                               device=None) -> SeededGenericKSKey:
    """Seeded `trlwe_new_packing1_KS_key` (`keyswitch.c:368-390`)."""
    dev = default_device(device)
    shape = (in_key.n, t, (1 << base_bit) - 1)
    seeds, b = _zero_table(out_key, math.prod(shape), generator,
                           _packing1_add(in_key, t, base_bit, out_key.N,
                                         out_key.s.device), seeded=True)
    return SeededGenericKSKey(seeds.reshape(shape + (2,)),
                              b.reshape(shape + (out_key.N,)), out_key.k, t,
                              base_bit, False).to(dev)


def new_priv_sk_ks_key_seeded(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                              base_bit: int, generator: torch.Generator,
                              device=None) -> SeededGenericKSKey:
    """Seeded `trlwe_new_priv_SK_KS_key_N2` (`keyswitch.c:611-637`)."""
    if out_key.k != 1:
        raise ValueError(f"a private-SK key needs k_out = 1, got {out_key.k}")
    dev = default_device(device)
    shape = (in_key.n + 1, t, (1 << base_bit) - 1)
    seeds, b = _zero_table(out_key, math.prod(shape), generator,
                           _priv_sk_add(out_key, in_key, t, base_bit),
                           seeded=True)
    return SeededGenericKSKey(seeds.reshape(shape + (2,)),
                              b.reshape(shape + (out_key.N,)), out_key.k, t,
                              base_bit, True).to(dev)


def new_lut_packing_ks_key_seeded(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                                  base_bit: int, torus_base: int,
                                  generator: torch.Generator,
                                  device=None) -> SeededLUTPackingKSKey:
    """Seeded `new_lut_packing_ks_key`."""
    dev = default_device(device)
    shape = (in_key.n, torus_base, t, (1 << base_bit) - 1)
    seeds, b = _zero_table(out_key, math.prod(shape), generator,
                           _lut_packing_add(out_key, in_key, t, base_bit,
                                            torus_base), seeded=True)
    return SeededLUTPackingKSKey(seeds.reshape(shape + (2,)),
                                 b.reshape(shape + (out_key.N,)), out_key.k,
                                 t, base_bit, torus_base).to(dev)


def _expand_table(seeds, b, k: int):
    """The dense table [..., k+1, N] of seeded slots, KEYGEN_CHUNK slots at a
    time."""
    N = b.shape[-1]
    shape = tuple(b.shape[:-1])
    flat_s, flat_b = seeds.reshape(-1, 2), b.reshape(-1, N)
    tab = torch.empty((flat_b.shape[0], k + 1, N), dtype=b.dtype,
                      device=b.device)
    for i0 in range(0, flat_b.shape[0], KEYGEN_CHUNK):
        i1 = i0 + KEYGEN_CHUNK
        tab[i0:i1, :k] = _seeded._expand_a(flat_s[i0:i1], k, N)
        tab[i0:i1, k] = flat_b[i0:i1]
    return tab.reshape(shape + (k + 1, N))


def expand_generic_ks_key(sk: SeededGenericKSKey) -> GenericKSKey:
    """Regenerate the masks and assemble the dense table."""
    return GenericKSKey(_expand_table(sk.seeds, sk.b, sk.k), sk.t,
                        sk.base_bit, sk.include_b)


def expand_lut_packing_ks_key(sk: SeededLUTPackingKSKey) -> LUTPackingKSKey:
    """Regenerate the masks and assemble the dense table."""
    return LUTPackingKSKey(_expand_table(sk.seeds, sk.b, sk.k), sk.t,
                           sk.base_bit, sk.torus_base)


def _gather_digits(a_vals, R: int, t: int, base_bit: int):
    """The digits [B, R, t] int32 of a_vals [..., R] that select table
    entries, with the TLWE key switch's offset (`tlwe.keyswitch_inputs`)."""
    prec_offset = 1 << (TORUS_BITS - (1 + base_bit * t))
    dig = _tlwe._ks_digits(a_vals, t, base_bit, prec_offset)
    return dig.reshape(-1, R, t).to(torch.int32).contiguous()


def _gather_subtract(table, a_vals, t: int, base_bit: int):
    """sum over (rows, digits) of the table entries the digits of a_vals
    select: the reference's `if aij != 0` subtract loops.  table [R, t,
    base-1, k+1, N]; a_vals [..., R].  One K2 launch on the table viewed as
    rows of (k+1) N words.  Returns [..., k+1, N]."""
    R, _, base_m1, C, N = table.shape
    sub_ = _pk.tlwe_keyswitch_sum(_gather_digits(a_vals, R, t, base_bit),
                                  table.reshape(R, t, base_m1, C * N))
    return sub_.reshape(tuple(a_vals.shape[:-1]) + (C, N))


def _gather_subtract_streamed(seeds, b, k: int, a_vals, t: int,
                              base_bit: int):
    """`_gather_subtract` on a seeded table, the dense table never built:
    the digits select one entry per (row, digit), and only those entries'
    masks are regenerated from their seeds, beside their stored b (the
    reference's USE_COMPRESSED_TRLWE apply, `keyswitch.c:231-241,343-364`).
    Plain PyTorch over the rows in chunks whose selected entries take about
    STREAM_BYTES.  seeds [R, t, base-1, 2]; b [R, t, base-1, N]; a_vals
    [..., R].  Returns [..., k+1, N]."""
    R, _, base_m1, N = b.shape
    dig = _gather_digits(a_vals, R, t, base_bit).to(torch.int64)  # [B, R, t]
    B = dig.shape[0]
    flat_s = seeds.reshape(R * t * base_m1, 2)
    flat_b = b.reshape(R * t * base_m1, N)
    chunk = min(R, max(1, STREAM_BYTES // max(1, B * t * (k + 1) * N * 8)))
    # flat position of entry (row, digit, 0) within the table
    pos = (torch.arange(R, device=b.device)[:, None] * t
           + torch.arange(t, device=b.device)) * base_m1          # [R, t]
    acc = torch.zeros((B, k + 1, N), dtype=torch.int64, device=b.device)
    for i0 in range(0, R, chunk):
        d = dig[:, i0:i0 + chunk]                                 # [B, c, t]
        flat = pos[i0:i0 + chunk] + (d - 1).clamp(min=0)
        g = torch.cat([_seeded._expand_a(flat_s[flat], k, N),
                       flat_b[flat].unsqueeze(-2)], dim=-2)  # [B, c, t, k+1, N]
        g = torch.where((d != 0)[..., None, None], g, 0)
        acc += g.sum((1, 2), dtype=torch.int64)
    return wrap(acc, b.dtype).reshape(tuple(a_vals.shape[:-1]) + (k + 1, N))


def _generic_subtract(ksk, a_vals):
    if isinstance(ksk, (SeededGenericKSKey, SeededLUTPackingKSKey)):
        seeds = ksk.seeds.reshape((-1,) + tuple(ksk.seeds.shape[-3:]))
        b = ksk.b.reshape((-1,) + tuple(ksk.b.shape[-3:]))
        return _gather_subtract_streamed(seeds, b, ksk.k, a_vals, ksk.t,
                                         ksk.base_bit)
    table = ksk.table.reshape((-1,) + tuple(ksk.table.shape[-4:]))
    return _gather_subtract(table, a_vals, ksk.t, ksk.base_bit)


def packing1_keyswitch(c: TLWE, ksk) -> TRLWE:
    """(`trlwe_packing1_keyswitch`, `keyswitch.c:458-475`).  A dense
    `GenericKSKey` (one K2 launch) or a `SeededGenericKSKey` (the streamed
    gather)."""
    out = from_stacked(-_generic_subtract(ksk, c.a))
    b = out.b.clone()
    b[..., 0] += c.b
    return TRLWE(a=out.a, b=b)


def priv_keyswitch(c: TLWE, ksk) -> TRLWE:
    """(`trlwe_priv_keyswitch`, `keyswitch.c:639-656`): the b row included.
    Dense (one K2 launch) or seeded (the streamed gather) keys."""
    if not ksk.include_b:
        raise ValueError("priv_keyswitch needs a key with the b row "
                         "(new_priv_sk_ks_key)")
    av = torch.cat([c.a, c.b.unsqueeze(-1)], dim=-1)
    return from_stacked(-_generic_subtract(ksk, av))


def lut_packing_keyswitch(cs: TLWE, ksk) -> TRLWE:
    """Pack torus_base TLWEs (cs's axis -2 of a) into LUT slots
    (`trlwe_packing_keyswitch`, `keyswitch.c:343-364`).  A dense
    `LUTPackingKSKey` (one K2 launch) or a `SeededLUTPackingKSKey` (the
    streamed gather)."""
    tb = ksk.torus_base
    n = cs.a.shape[-1]
    # a_vals[(i, e)] = cs.a[e, i], e-major per i
    a_vals = cs.a.transpose(-1, -2).reshape(tuple(cs.a.shape[:-2])
                                            + (n * tb,))
    out = from_stacked(-_generic_subtract(ksk, a_vals))
    b_rep = torch.repeat_interleave(cs.b, out.N // tb, dim=-1)
    return TRLWE(a=out.a, b=out.b + b_rep)


# =========================================================================
# automorphisms / CDKS21 (`keyswitch.c:477-546`, `trlwe.c:775-781`)
# =========================================================================

def _permuted_key(key: TRLWEKey, gen: int) -> TRLWEKey:
    return TRLWEKey(s=_poly.permute(key.s, int(gen)), sigma=key.sigma,
                    s_bound=key.s_bound)


def new_automorphism_ks_keyset(key: TRLWEKey, gens, t: int, base_bit: int,
                               generator: torch.Generator,
                               device=None) -> dict:
    """KS keys for the permuted keys s(X^gen) -> s
    (`trlwe_new_automorphism_KS_keyset`, `keyswitch.c:500-524`).  Returns
    {gen: TRLWEKSKey}."""
    return {int(gen): new_trlwe_ks_key(key, _permuted_key(key, gen), t,
                                       base_bit, generator, device)
            for gen in gens}


def new_automorphism_ks_keyset_seeded(key: TRLWEKey, gens, t: int,
                                      base_bit: int,
                                      generator: torch.Generator,
                                      device=None) -> dict:
    """{gen: SeededTRLWEKSKey}: half the dense keyset's bytes;
    `eval_automorphism` takes the entries as they are."""
    return {int(gen): new_trlwe_ks_key_seeded(key, _permuted_key(key, gen),
                                              t, base_bit, generator, device)
            for gen in gens}


def all_odd_gens(N: int):
    return tuple(range(1, 2 * N, 2))


def new_cdks21_packing_keys(out_key: TRLWEKey, in_key: TLWEKey, t: int,
                            base_bit: int, generator: torch.Generator,
                            device=None) -> list:
    """log N trace keys (`trlwe_new_packing1_KS_key_CDKS21`,
    `keyswitch.c:477-498`)."""
    N = out_key.N
    log_N = int(math.log2(N))
    s_emb = torch.zeros((N,), dtype=torch.int64, device=out_key.s.device)
    s_emb[:in_key.n] = in_key.s
    keys = []
    for j in range(log_N):
        gen = (1 << (log_N - j)) + 1
        key2 = TRLWEKey(s=_poly.permute(s_emb, gen)[None],
                        sigma=in_key.sigma, s_bound=1)
        keys.append(new_trlwe_ks_key(out_key, key2, t, base_bit, generator,
                                     device))
    return keys


def packing1_keyswitch_cdks21(c: TLWE, keys: list) -> TRLWE:
    """Trace-based packing (`trlwe_packing1_keyswitch_CDKS21`,
    `keyswitch.c:526-546`): log N automorphisms, each one K6 launch."""
    N = keys[0].N
    n = c.a.shape[-1]
    a_poly = torch.zeros(tuple(c.a.shape[:-1]) + (N,), dtype=c.a.dtype,
                         device=c.a.device)
    a_poly[..., 0] = c.a[..., 0]
    a_poly[..., N - n + 1:] = -c.a[..., 1:].flip(-1)    # a[N-i] = -a[i]
    b_poly = torch.zeros_like(a_poly)
    b_poly[..., 0] = c.b
    out = TRLWE(a=a_poly.unsqueeze(-2), b=b_poly)
    for j in range(int(math.log2(N))):
        out = _trlwe.add(out, eval_automorphism(out, (N >> j) + 1, keys[j]))
    return out


# =========================================================================
# gadget -> RGSW conversion (`keyswitch.c:548-572`)
# =========================================================================

def new_gadget_to_rgsw_keys(key: TRLWEKey, t: int, base_bit: int,
                            generator: torch.Generator, device=None) -> list:
    """One RLWE private KS key per component, with v = -s_i
    (`trlwe_new_gadget_to_RGSW_KS`)."""
    return [new_rlwe_priv_ks_key(key, key, -key.s[i], t, base_bit,
                                 generator, device) for i in range(key.k)]


def trgsw_from_gadget(gadget: list, ksks: list, l: int, Bg_bit: int):
    """Assemble a TRGSW from l gadget TRLWEs (`trgsw_from_gadget`,
    `keyswitch.c:559-572`): row j l + i is the RLWE private switch of
    gadget[i] by ksks[j], the last l rows the gadget TRLWEs.  The l gadget
    TRLWEs go through each key as one batch (two K6 launches per key)."""
    from . import trgsw as _trgsw
    g = torch.stack([c.stacked() for c in gadget], dim=-3)  # [..., l, k+1, N]
    rows = [rlwe_priv_keyswitch(from_stacked(g), ksk).stacked()
            for ksk in ksks[:gadget[0].k]]
    return _trgsw.TRGSW(rows=torch.cat(rows + [g], dim=-3), l=l,
                        Bg_bit=Bg_bit)
