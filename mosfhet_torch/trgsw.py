"""TRGSW: gadget ciphertexts and the external product (`src/trgsw.c:130-175,
385-423`).

A TRGSW is (k+1)*l TRLWE rows in one tensor; row r = comp*l + digit
encrypts m * X^e * h_digit added at component ``comp``.  The NTT form may
carry Shoup companions for key multiplies; the external product does not
read them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import ntt as _ntt
from . import trlwe as _trlwe
from .ops import pbs_kernel as _pk
from .torus import TORUS_BITS, TORUS_DTYPE, to_signed, word_bits, wrap
from .trlwe import TRLWE, TRLWEKey, from_stacked


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


def to_dft(g: TRGSW, plan: _ntt.NTTPlan, with_shoup: bool = True) -> TRGSWDFT:
    v = _ntt.to_ntt_u64(g.rows, plan)
    vs = _ntt.make_shoup(v, plan.p[:, None]) if with_shoup else None
    return TRGSWDFT(v=v, vs=vs, l=g.l, Bg_bit=g.Bg_bit, primes=plan.primes)


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
