"""TLWE: LWE over the discretized torus, with a leading batch axis.

Mirrors `src/tlwe.c`: keygen, (noiseless) encryption, phase, linear ops and
the digit-decomposed key switch in its three forms (precomputed table,
no-precomputation table, and the int8-product form of the latter).
Ciphertexts are dataclasses of torus-word tensors: int64 holding u64
words, or int32 holding u32 words at the 32-bit torus (`torus.TORUS_BITS`).
Sums of products are formed in int64 and wrapped to the word width.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from . import rng as _rng
from ._device import default_device
from .ops import pbs_kernel as _pk
from .torus import TORUS_BITS, TORUS_DTYPE, to_signed, wrap


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


def new_bounded_key(n: int, bound: int, sigma: float,
                    generator: torch.Generator, device=None) -> TLWEKey:
    """Uniform key in [-(bound/2-1), bound/2] (`tlwe.c:70-78`)."""
    return TLWEKey(s=_rng.bounded_key_array(generator, (n,), bound,
                                            default_device(device)),
                   sigma=sigma)


def new_binary_key(n: int, sigma: float, generator: torch.Generator,
                   device=None) -> TLWEKey:
    return new_bounded_key(n, 2, sigma, generator, device)


def encrypt(m, skey: TLWEKey, generator: torch.Generator) -> TLWE:
    """b = m + sum_i s_i a_i + e (`tlwe.c:106-115`); ``m`` is a torus
    tensor of any batch shape on the key's device."""
    dev = skey.s.device
    m = wrap(torch.as_tensor(m, device=dev))
    a = _rng.uniform_torus(generator, m.shape + (skey.n,), dev)
    e = _rng.normal_torus(generator, skey.sigma, m.shape, dev)
    return TLWE(a=a, b=m + _dot(a, skey.s) + e)


def _dot(a, s):
    """sum_i a_i s_i over the last axis, as words of a's width."""
    return wrap((a * s).sum(-1), a.dtype)


def noiseless_trivial(m, n: int) -> TLWE:
    """(0, m) (`tlwe.c:19-29`); ``m`` is a torus tensor."""
    return TLWE(a=torch.zeros(m.shape + (n,), dtype=m.dtype,
                              device=m.device), b=m)


def phase(c: TLWE, skey: TLWEKey):
    """b - <s, a> (`tlwe.c:135-141`)."""
    return c.b - _dot(c.a, skey.s)


# --- linear algebra (`tlwe.c:143-191`) ------------------------------------

def add(c1: TLWE, c2: TLWE) -> TLWE:
    return TLWE(a=c1.a + c2.a, b=c1.b + c2.b)


def sub(c1: TLWE, c2: TLWE) -> TLWE:
    return TLWE(a=c1.a - c2.a, b=c1.b - c2.b)


def neg(c: TLWE) -> TLWE:
    return TLWE(a=-c.a, b=-c.b)


def scale(c: TLWE, w) -> TLWE:
    w = wrap(torch.as_tensor(w, device=c.b.device), c.b.dtype)
    return TLWE(a=c.a * w[..., None], b=c.b * w)


# --- key switching ---------------------------------------------------------

def _ks_shifts(t: int, base_bit: int, device,
               dtype: torch.dtype = TORUS_DTYPE) -> torch.Tensor:
    return torch.tensor([TORUS_BITS - (j + 1) * base_bit for j in range(t)],
                        dtype=dtype, device=device)


def _ks_digits(a, t: int, base_bit: int, offset: int = 0):
    """The key switch's digits of ``a + offset`` [..., n_in] -> [..., n_in,
    t] in [0, 2^base_bit), of a's dtype: digit j holds bits
    [bits-(j+1)base_bit, bits-j base_bit).  The arithmetic shift needs no
    extra mask: ``& mask`` keeps bits below the sign-extended ones."""
    shifts = _ks_shifts(t, base_bit, a.device, a.dtype)
    return (((a + to_signed(offset)).unsqueeze(-1) >> shifts)
            & ((1 << base_bit) - 1))


class TLWEKSKey(nn.Module):
    """Precomputed table: entry [i, j, v] encrypts
    s_in[i] * (v+1) * 2^(64-(j+1)*base_bit) under the output key
    (`tlwe_new_KS_key`, `tlwe.c:193-212`).

    Held once, as the kernel reads it: the buffer ``ab`` [n_in, t, base-1,
    n_out+1] of torus words (int64, or int32 at the 32-bit torus) holds
    each entry's mask words with its b as the last column.  ``a`` and ``b``
    are views of it."""

    def __init__(self, ab: torch.Tensor, t: int, base_bit: int):
        super().__init__()
        self.register_buffer("ab", ab)
        self.t, self.base_bit = t, base_bit

    @property
    def a(self):
        return self.ab[..., :-1]    # [n_in, t, base-1, n_out]

    @property
    def b(self):
        return self.ab[..., -1]     # [n_in, t, base-1]


def new_ks_key(out_key: TLWEKey, in_key: TLWEKey, t: int, base_bit: int,
               generator: torch.Generator, device=None) -> TLWEKSKey:
    """The precomputed table, encrypted in chunks over n_in straight into
    the one buffer, so the peak stays near the table's own size (1.24 GB at
    TFHEpp-L2) instead of several times it."""
    dev = default_device(device)
    base_m1 = (1 << base_bit) - 1
    n_in, n_out = in_key.n, out_key.n
    okey = TLWEKey(s=out_key.s.to(dev), sigma=out_key.sigma)
    s_in = in_key.s.to(dev)
    ab = torch.empty((n_in, t, base_m1, n_out + 1), dtype=TORUS_DTYPE,
                     device=dev)
    shifts = _ks_shifts(t, base_bit, dev, torch.int64)
    vals = torch.arange(1, base_m1 + 1, dtype=torch.int64, device=dev)
    chunk = max(1, (64 << 20) // (t * base_m1 * n_out * 8))
    for i0 in range(0, n_in, chunk):
        s = s_in[i0:i0 + chunk]
        # m[i, j, v] = s_in[i] * (v+1) << shift_j
        m = wrap((s[:, None, None] * vals) << shifts[:, None])
        c = encrypt(m, okey, generator)
        ab[i0:i0 + chunk, ..., :n_out] = c.a
        ab[i0:i0 + chunk, ..., n_out] = c.b
    return TLWEKSKey(ab, t, base_bit)


def keyswitch_inputs(c: TLWE, ksk: TLWEKSKey) -> torch.Tensor:
    """The select-sum's digits for `keyswitch`: int32 [B, n_in, t] over the
    flattened batch."""
    t, base_bit = ksk.t, ksk.base_bit
    prec_offset = 1 << (TORUS_BITS - (1 + base_bit * t))
    dig = _ks_digits(c.a, t, base_bit, prec_offset)
    return dig.reshape(-1, ksk.ab.shape[0], t).to(torch.int32)


def keyswitch(c: TLWE, ksk: TLWEKSKey) -> TLWE:
    """Digit-decompose each a_i and subtract table entries
    (`tlwe_keyswitch`, `tlwe.c:289-303`): out = (0, b) - sum_{i,j} of
    KS[i][j][d_ij - 1] over the nonzero digits d_ij.  The select-sum is
    `ops.pbs_kernel.tlwe_keyswitch_sum`: the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors; both give the same words."""
    n_out = ksk.ab.shape[-1] - 1
    sub_ = _pk.tlwe_keyswitch_sum(keyswitch_inputs(c, ksk), ksk.ab)
    sub_ = sub_.reshape(tuple(c.b.shape) + (n_out + 1,))
    return TLWE(a=-sub_[..., :n_out], b=c.b - sub_[..., n_out])


@dataclasses.dataclass
class TLWEKSKeyM:
    """No-precomputation KS key: entry [i, j] encrypts
    s_in[i] * 2^(64-(j+1)*base_bit); the digit multiplies at switch time
    (`tlwe_new_KS_key_no_precomp`, `tlwe.c:214-230`).  (base-1)x smaller
    than `TLWEKSKey` at the cost of a multiply per entry."""
    a: torch.Tensor  # [n_in, t, n_out] int64
    b: torch.Tensor  # [n_in, t] int64
    t: int
    base_bit: int


def new_ks_key_no_precomp(out_key: TLWEKey, in_key: TLWEKey, t: int,
                          base_bit: int, generator: torch.Generator,
                          device=None) -> TLWEKSKeyM:
    dev = default_device(device)
    m = wrap(in_key.s.to(dev)[:, None]
             << _ks_shifts(t, base_bit, dev, torch.int64))
    c = encrypt(m, TLWEKey(s=out_key.s.to(dev), sigma=out_key.sigma),
                generator)
    return TLWEKSKeyM(a=c.a, b=c.b, t=t, base_bit=base_bit)


def _no_precomp_digits(c: TLWE, t: int, base_bit: int):
    """Digits with the extra rounding half-bit the no-precomputation
    variant adds (`tlwe.c:305-320`)."""
    prec_offset = 1 << (TORUS_BITS - (1 + base_bit * t))
    offset = 1 << (TORUS_BITS - base_bit * t - 1)
    return _ks_digits(c.a, t, base_bit, prec_offset + offset)


def keyswitch_no_precomp(c: TLWE, ksk: TLWEKSKeyM) -> TLWE:
    """out = (0, b) - sum_{i,j} d_ij * KS[i][j]
    (`tlwe_keyswitch_no_precomp`, `tlwe.c:305-320`), over n_in in chunks
    of 128 so the [batch, chunk, t, n_out] product stays bounded."""
    dig = _no_precomp_digits(c, ksk.t, ksk.base_bit)     # [..., n_in, t]
    sb = wrap((dig * ksk.b).sum((-2, -1)), c.b.dtype)
    sa = torch.zeros(c.b.shape + (ksk.a.shape[-1],), dtype=torch.int64,
                     device=c.b.device)
    chunk = 128
    for i0 in range(0, ksk.a.shape[0], chunk):
        d = dig[..., i0:i0 + chunk, :]
        sa += (d[..., None] * ksk.a[i0:i0 + chunk]).sum((-3, -2))
    return TLWE(a=wrap(-sa, c.b.dtype), b=c.b - sb)


@dataclasses.dataclass
class TLWEKSKeyPrepared:
    """`TLWEKSKeyM` with its words split into 4-bit limbs, so the digit
    contraction is an exact int8 product: the no-precomputation switch is
    linear in the digits, a [batch, n_in*t] x [n_in*t, n_out+1] integer
    product, and with 4-bit limbs and digits < 2^7 every int32 sum is exact
    (n_in*t * 127 * 15 < 2^31); a few shifts recombine the limbs mod 2^bits
    (16 limbs at the 64-bit torus, 8 at the 32-bit one)."""
    a_nib: torch.Tensor  # [_LIMBS, n_in*t, n_out] int8
    b_nib: torch.Tensor  # [_LIMBS, n_in*t] int8
    t: int
    base_bit: int


_LIMBS = TORUS_BITS // 4


def prepare_ks_key_mxu(ksk: TLWEKSKeyM) -> TLWEKSKeyPrepared:
    if ksk.base_bit > 7:
        raise ValueError("the int8 key switch needs digits below 2^7")
    K = ksk.a.shape[0] * ksk.a.shape[1]
    a = ksk.a.reshape(K, -1)
    b = ksk.b.reshape(K)
    shifts = torch.arange(_LIMBS, dtype=torch.int64, device=a.device) * 4
    a_nib = ((a[None] >> shifts[:, None, None]) & 0xF).to(torch.int8)
    b_nib = ((b[None] >> shifts[:, None]) & 0xF).to(torch.int8)
    return TLWEKSKeyPrepared(a_nib=a_nib, b_nib=b_nib, t=ksk.t,
                             base_bit=ksk.base_bit)


def _int8_product(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """D [M, K] int8 times W [K, Nc] int8, exact, as int32 [M, Nc].  On the
    CPU an int32 matmul; on CUDA `torch._int_mm`, zero-padded to its shape
    rules (M > 16; K and Nc multiples of 8)."""
    if D.device.type == "cpu":
        return torch.matmul(D.to(torch.int32), W.to(torch.int32))
    M, K = D.shape
    Nc = W.shape[1]
    pm, pk, pn = max(0, 17 - M), (-K) % 8, (-Nc) % 8
    if pm or pk:
        D = nn.functional.pad(D, (0, pk, 0, pm))
    if pk or pn:
        W = nn.functional.pad(W, (0, pn, 0, pk))
    return torch._int_mm(D, W.contiguous())[:M, :Nc]


def keyswitch_mxu(c: TLWE, ksk: TLWEKSKeyPrepared) -> TLWE:
    """`keyswitch_no_precomp` as int8 products, one per 4-bit key limb:
    bit-identical to it."""
    batch = tuple(c.b.shape)
    dig = _no_precomp_digits(c, ksk.t, ksk.base_bit)
    D = dig.reshape(math.prod(batch), -1).to(torch.int8)        # [B, K]
    w = torch.arange(_LIMBS, dtype=torch.int64, device=D.device) * 4
    sa = torch.zeros((D.shape[0], ksk.a_nib.shape[-1]), dtype=torch.int64,
                     device=D.device)
    for limb in range(_LIMBS):
        sa += _int8_product(D, ksk.a_nib[limb]).to(torch.int64) << (4 * limb)
    pb = _int8_product(D, ksk.b_nib.t())                    # [B, _LIMBS]
    sb = wrap((pb.to(torch.int64) << w).sum(-1), c.b.dtype)
    return TLWE(a=wrap(-sa, c.b.dtype).reshape(batch + (-1,)),
                b=c.b - sb.reshape(batch))
