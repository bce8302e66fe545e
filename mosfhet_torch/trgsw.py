"""TRGSW: gadget ciphertexts and the external product (`src/trgsw.c:130-175,
385-423`).

A TRGSW is (k+1)*l TRLWE rows in one tensor; row r = comp*l + digit
encrypts m * X^e * h_digit added at component ``comp``.  The NTT form may
carry Shoup companions for key multiplies; the external product does not
read them, the NTT-domain products (`external_product_dft`,
`mul_trgsw_dft`) do.  Also the linear ops (`trgsw.c:275-342`), the
exponent decrypt oracle (`trgsw.c:189-268`) and the registers
(`src/register.c`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import ntt as _ntt
from . import polynomial as _poly
from . import trlwe as _trlwe
from ._device import default_device
from .ops import pbs_kernel as _pk
from .torus import TORUS_BITS, TORUS_DTYPE, to_signed, word_bits, wrap
from .trlwe import TRLWE, TRLWEDFT, TRLWEKey, from_stacked


@dataclasses.dataclass
class TRGSWKey:
    trlwe_key: TRLWEKey
    l: int
    Bg_bit: int

    def plan(self) -> _ntt.NTTPlan:
        """Plan for external products: J=(k+1)l digit convolutions with
        |digit| <= Bg/2 against centred torus operands."""
        N, k = self.trlwe_key.N, self.trlwe_key.k
        bound = _ntt.external_product_bound(N, self.Bg_bit, self.l, k)
        return _ntt.get_plan(N, _ntt.primes_for_bound(bound),
                             self.trlwe_key.s.device)


def new_key(trlwe_key: TRLWEKey, l: int, Bg_bit: int) -> TRGSWKey:
    return TRGSWKey(trlwe_key=trlwe_key, l=l, Bg_bit=Bg_bit)


@dataclasses.dataclass
class TRGSW:
    """rows[..., r, c, N]: r = comp*l + digit, c the component (b last)."""
    rows: torch.Tensor
    l: int
    Bg_bit: int

    @property
    def k(self):
        return self.rows.shape[-2] - 1

    @property
    def N(self):
        return self.rows.shape[-1]


@dataclasses.dataclass
class TRGSWDFT:
    """NTT-form TRGSW [..., r, c, P, N] int64 canonical residues, with Shoup
    companions ``vs`` or without (None)."""
    v: torch.Tensor
    vs: torch.Tensor | None
    l: int
    Bg_bit: int
    primes: tuple

    @property
    def k(self):
        return self.v.shape[-3] - 1

    @property
    def N(self):
        return self.v.shape[-1]

    def plan(self) -> _ntt.NTTPlan:
        return _ntt.get_plan(self.N, self.primes, self.v.device)


def _gadget_values(l: int, Bg_bit: int, device):
    return torch.tensor([to_signed(1 << (TORUS_BITS - (i + 1) * Bg_bit))
                         for i in range(l)], dtype=TORUS_DTYPE, device=device)


def _add_monomial_rows(rows, m, e, l, Bg_bit, k, N):
    """rows[..., comp*l + i, comp, :] += m * h_i * X^(e mod N) with the sign
    of X^N folded into m (`trgsw.c:152-168`).  m, e: int64 tensors of the
    batch shape rows.shape[:-3]."""
    dev = rows.device
    m = torch.where((e & N) != 0, -m, m)
    e = e & (N - 1)
    h = _gadget_values(l, Bg_bit, dev) * m.unsqueeze(-1)           # [..., l]
    onehot = (torch.arange(N, device=dev) == e.unsqueeze(-1)).to(torch.int64)
    r = torch.arange((k + 1) * l, device=dev) // l                 # comp of row
    c = torch.arange(k + 1, device=dev)
    sel = (r[:, None] == c[None, :]).to(torch.int64)               # [R, k+1]
    hh = h.repeat((1,) * (h.dim() - 1) + (k + 1,))                 # [..., R]
    return rows + wrap(sel[:, :, None] * hh[..., :, None, None]
                       * onehot[..., None, None, :], rows.dtype)


def monomial_encrypt(m, e, key: TRGSWKey,
                     generator: torch.Generator) -> TRGSW:
    """TRGSW(m * X^e) (`trgsw_monomial_sample`, `trgsw.c:152-175`), batched
    over the shape of the int64 tensors ``m`` and ``e``."""
    l, Bg_bit = key.l, key.Bg_bit
    k, N = key.trlwe_key.k, key.trlwe_key.N
    R = (k + 1) * l
    dev = key.trlwe_key.s.device
    m = torch.as_tensor(m, dtype=torch.int64, device=dev)
    e = torch.as_tensor(e, dtype=torch.int64, device=dev)
    zeros = torch.zeros(m.shape + (R, N), dtype=TORUS_DTYPE, device=dev)
    rows = _trlwe.encrypt(zeros, key.trlwe_key, generator).stacked()
    rows = _add_monomial_rows(rows, m, e, l, Bg_bit, k, N)
    return TRGSW(rows=rows, l=l, Bg_bit=Bg_bit)


def encrypt(m, key: TRGSWKey, generator: torch.Generator) -> TRGSW:
    return monomial_encrypt(m, 0, key, generator)


def noiseless_trivial(m, l: int, Bg_bit: int, k: int, N: int,
                      device=None) -> TRGSW:
    """The noiseless TRGSW of the integer ``m`` (an int or an int64 tensor;
    batched over its shape), `trgsw_noiseless_trivial_sample`
    (`trgsw.c:130-148`)."""
    dev = default_device(device)
    m = torch.as_tensor(m, dtype=torch.int64, device=dev)
    rows = torch.zeros(m.shape + ((k + 1) * l, k + 1, N), dtype=TORUS_DTYPE,
                       device=dev)
    rows = _add_monomial_rows(rows, m, torch.zeros_like(m), l, Bg_bit, k, N)
    return TRGSW(rows=rows, l=l, Bg_bit=Bg_bit)


def to_dft(g: TRGSW, plan: _ntt.NTTPlan, with_shoup: bool = True) -> TRGSWDFT:
    v = _ntt.to_ntt_u64(g.rows, plan)
    vs = _ntt.make_shoup(v, plan.p[:, None]) if with_shoup else None
    return TRGSWDFT(v=v, vs=vs, l=g.l, Bg_bit=g.Bg_bit, primes=plan.primes)


def from_dft(g: TRGSWDFT) -> TRGSW:
    return TRGSW(rows=_ntt.from_ntt_u64(g.v, g.plan()), l=g.l,
                 Bg_bit=g.Bg_bit)


def _with_shoup(g: TRGSWDFT) -> TRGSWDFT:
    plan = g.plan()
    return dataclasses.replace(g, vs=_ntt.make_shoup(g.v, plan.p[:, None]))


# --- linear ops (`trgsw.c:275-342`) ------------------------------------------

def add(g1: TRGSW, g2: TRGSW) -> TRGSW:
    return TRGSW(rows=g1.rows + g2.rows, l=g1.l, Bg_bit=g1.Bg_bit)


def sub(g1: TRGSW, g2: TRGSW) -> TRGSW:
    return TRGSW(rows=g1.rows - g2.rows, l=g1.l, Bg_bit=g1.Bg_bit)


def dft_add(g1: TRGSWDFT, g2: TRGSWDFT) -> TRGSWDFT:
    return TRGSWDFT(v=_ntt.add(g1.v, g2.v, g1.plan()), vs=None, l=g1.l,
                    Bg_bit=g1.Bg_bit, primes=g1.primes)


def dft_sub(g1: TRGSWDFT, g2: TRGSWDFT) -> TRGSWDFT:
    return TRGSWDFT(v=_ntt.sub(g1.v, g2.v, g1.plan()), vs=None, l=g1.l,
                    Bg_bit=g1.Bg_bit, primes=g1.primes)


def mul_by_xai(g: TRGSW, a) -> TRGSW:
    """Every row times X^a; ``a`` may be per-batch."""
    a = torch.as_tensor(a, device=g.rows.device)
    return TRGSW(rows=_poly.mul_by_xai(g.rows, a[..., None, None]), l=g.l,
                 Bg_bit=g.Bg_bit)


def mul_by_xai_minus_1(g: TRGSW, a) -> TRGSW:
    a = torch.as_tensor(a, device=g.rows.device)
    return TRGSW(rows=_poly.mul_by_xai_minus_1(g.rows, a[..., None, None]),
                 l=g.l, Bg_bit=g.Bg_bit)


def external_product(c: TRLWE, g: TRGSWDFT) -> TRLWE:
    """TRGSW (x) TRLWE, the library's hot kernel (`trgsw_mul_trlwe_DFT`,
    `trgsw.c:385-423`), batched over the leading axes of both operands.

    On CUDA tensors one launch of the apply-scan kernel with G=1 (its
    one-limb form for the int32 words of the 32-bit torus): one TRGSW [J, C,
    P, N] is broadcast over the batch, a batch of them [..., J, C, P, N] is
    taken one per row.  On CPU tensors its plain version.  ``g.vs`` is not
    read."""
    k, N = g.k, g.N
    st = c.stacked()
    kp = _pk.get_kernel_plan(N, g.primes, g.l, g.Bg_bit, k, g.v.device,
                             word_bits(st))
    per_row = g.v.dim() > 4
    batch = torch.broadcast_shapes(st.shape[:-2], g.v.shape[:-4])
    B = math.prod(batch)
    x = st.expand(batch + st.shape[-2:]).reshape(B, k + 1, N).contiguous()
    v32 = _pk.u32_as_i32(g.v)
    key_shape = tuple(v32.shape[-4:])
    if per_row:
        sa = v32.expand(batch + key_shape).reshape((1, B) + key_shape)
    else:
        sa = v32.reshape((1,) + key_shape)
    out = _pk.ext_product_apply_scan(x, sa.contiguous(), kp, per_row)
    return from_stacked(out.reshape(batch + (k + 1, N)))


def external_product_dft(c: TRLWE, g: TRGSWDFT) -> TRLWEDFT:
    """TRGSW (x) TRLWE left in the NTT domain, for callers that add several
    products before converting: [..., k+1, P, N] canonical residues, the
    batch axes of both operands broadcast.  Plain PyTorch (the TPU package
    runs jnp here): the apply-scan kernel replaces acc after its Garner
    step, so it does not compute this.  Reads ``g.vs``."""
    if g.vs is None:
        raise ValueError("external_product_dft needs g's Shoup companions "
                         "(to_dft with with_shoup=True)")
    plan = g.plan()
    digits = _trlwe.decompose(c, g.Bg_bit, g.l)                # [..., J, N]
    spec = _ntt.to_ntt_small(digits, plan)                     # [..., J, P, N]
    acc = _ntt.pointwise_mul_acc_key(spec[..., :, None, :, :], g.v, g.vs,
                                     plan, dim=-4)             # [..., C, P, N]
    return TRLWEDFT(v=acc, vs=None, primes=g.primes)


def mul_trgsw_dft(g1: TRGSW, g2: TRGSWDFT) -> TRGSWDFT:
    """TRGSW x TRGSW: g1's rows each times g2 (`trgsw_mul_DFT`,
    `trgsw.c:425-431`), the rows a batch axis of one NTT-domain product.
    Batched over leading axes: g1 [..., R, C, N] pairs with g2 [..., J, C,
    P, N], g2 broadcast over g1's rows."""
    vs = None if g2.vs is None else g2.vs.unsqueeze(-5)
    g2 = dataclasses.replace(g2, v=g2.v.unsqueeze(-5), vs=vs)
    out = external_product_dft(from_stacked(g1.rows), g2)  # [..., R, C, P, N]
    return TRGSWDFT(v=out.v, vs=None, l=g1.l, Bg_bit=g1.Bg_bit,
                    primes=g2.primes)


def mul_trgsw_dft2(g1: TRGSWDFT, g2: TRGSWDFT) -> TRGSWDFT:
    """TRGSW x TRGSW with both in NTT form: g1 back to coefficients first
    (`trgsw_mul_DFT2`, `trgsw.c:433-442`)."""
    return mul_trgsw_dft(from_dft(g1), g2)


def ks_b_to_a(g: TRGSW, ksk_pair) -> TRGSW:
    """Rebuild the component-0 (a-side) rows of a TRGSW from its b-side rows
    by the TRLWE private-KS pair (`trgsw_ks_b_to_a`, `trgsw.c:479-483`):
    `keyswitch.priv_keyswitch_2` on the l b-side rows as one batch, two K6
    launches on the card.  k must be 1."""
    from . import keyswitch as _ks
    l = g.l
    if g.k != 1:
        raise ValueError(f"ks_b_to_a takes the reference's k = 1 layout, "
                         f"got k = {g.k}")
    b_rows = g.rows[..., l:2 * l, :, :]
    a_rows = _ks.priv_keyswitch_2(from_stacked(b_rows), ksk_pair)
    return TRGSW(rows=torch.cat([a_rows.stacked(), b_rows], dim=-3), l=l,
                 Bg_bit=g.Bg_bit)


def _unique_monomial(ph, Bg_bit: int):
    """The index of the one coefficient of phases [..., N] whose signed
    value lies outside [-delta, delta], delta = 2^(bits-1-Bg_bit) (the
    reference's unsigned test delta < ph < -delta), as int32; -1 where none
    or several do."""
    delta = 1 << (word_bits(ph) - 1 - Bg_bit)
    mask = (ph > delta) | (ph < -delta)
    idx = torch.argmax(mask.to(torch.int32), dim=-1).to(torch.int32)
    return torch.where(mask.sum(-1) == 1, idx, -1).to(torch.int32)


def debug_decrypt_exp(g: TRGSW, key: TRGSWKey):
    """The exponent e of a TRGSW(X^e), from the phase of row l (digit 0 of
    the b component): int32 e in [0, N), or -1 where no coefficient or more
    than one stands out (`_debug_trgsw_decrypt_exp_sample`,
    `trgsw.c:189-216`).  Batched over g's leading axes."""
    row = from_stacked(g.rows[..., g.l, :, :])
    return _unique_monomial(_trlwe.phase(row, key.trlwe_key), g.Bg_bit)


def debug_decrypt_exp_dft(g: TRGSWDFT, key: TRGSWKey):
    """The exponent of an NTT-form TRGSW(X^e): its external product with
    the trivial TRLWE (0, h X^0), h = 2^(bits-Bg_bit), then the same scan
    (`_debug_trgsw_decrypt_exp_DFT_sample`, `trgsw.c:240-268`).  One launch
    of the apply-scan kernel on CUDA (one key per row when g is batched);
    the Shoup companions are not needed."""
    k, N = key.trlwe_key.k, key.trlwe_key.N
    b = torch.zeros(N, dtype=TORUS_DTYPE, device=g.v.device)
    b[0] = to_signed(1 << (TORUS_BITS - g.Bg_bit))
    res = external_product(_trlwe.noiseless_trivial(b, k, N), g)
    return _unique_monomial(_trlwe.phase(res, key.trlwe_key), g.Bg_bit)


def naive_mul_trlwe(c: TRLWE, g: TRGSW) -> TRLWE:
    """The O(N^2) external product on unrounded digits
    (`trgsw_naive_mul_trlwe`, `trgsw.c:452-470`): the test oracle."""
    digits = _trlwe.decompose(c, g.Bg_bit, g.l, rounded=False)
    d = wrap(digits.to(torch.int64), g.rows.dtype)           # [..., J, N]
    prods = _poly.naive_negacyclic_mul(d[..., :, None, :], g.rows)
    return from_stacked(prods.sum(dim=-3, dtype=g.rows.dtype))


# --- TRGSW registers (`src/register.c`) -------------------------------------

@dataclasses.dataclass
class TRGSWReg:
    """NTT-form TRGSWs of X^m and X^-m (`register.c`,
    `mosfhet.h:123-127`)."""
    positive: TRGSWDFT
    negative: TRGSWDFT


def reg_encrypt(m: int, key: TRGSWKey,
                generator: torch.Generator) -> TRGSWReg:
    plan = key.plan()
    pos = to_dft(monomial_encrypt(1, m, key, generator), plan)
    neg = to_dft(monomial_encrypt(1, -m, key, generator), plan)
    return TRGSWReg(positive=pos, negative=neg)


def reg_add(r1: TRGSWReg, r2: TRGSWReg) -> TRGSWReg:
    """X^(m1+m2) through TRGSW x TRGSW products (`register.c:46-58`)."""
    p = mul_trgsw_dft(from_dft(r1.positive), r2.positive)
    n = mul_trgsw_dft(from_dft(r1.negative), r2.negative)
    return TRGSWReg(positive=_with_shoup(p), negative=_with_shoup(n))


def reg_sub(r1: TRGSWReg, r2: TRGSWReg) -> TRGSWReg:
    """X^(m1-m2) (`register.c:60-71`)."""
    p = mul_trgsw_dft(from_dft(r1.positive), r2.negative)
    n = mul_trgsw_dft(from_dft(r1.negative), r2.positive)
    return TRGSWReg(positive=_with_shoup(p), negative=_with_shoup(n))
