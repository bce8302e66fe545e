"""Ciphertext-by-ciphertext multiplication: TRLWE tensor products (BFV-like)
with relinearization, and TLWE x TLWE on top (`trlwe.c:692-771`,
`tlwe.c:322-332`).

- `tensor_prod`: exact wide products (the reference's 128-bit Karatsuba
  path, `fft/karatsuba.c`) through the wide-prime CRT-NTT
  (`ntt.TENSOR_PRIMES`) and the shifted 128-bit readback
  (`polynomial.full_mul_with_scale`);
- `tensor_prod_fft`: half-precision pre-scaling, then single-width
  products (`trlwe_tensor_prod_FFT`, `trlwe.c:727-771`); the products are
  exact, only the pre-scaling rounds, as in the reference.

The products are plain PyTorch, as the TPU package runs them in jnp; the
relinearization is one launch of the key-switch kernel K6
(`keyswitch.trlwe_keyswitch`), and `tlwe_mul`'s two packing switches are
one K2 launch (or one streamed gather on a seeded key).  k must be 1.
The relinearization gadget (t base_bit = 40 bits) does not fit the 32-bit
torus, so these run at 64 bits.
"""

from __future__ import annotations

import torch

from . import keyswitch as _ks
from . import ntt as _ntt
from . import polynomial as _poly
from . import trlwe as _trlwe
from .tlwe import TLWE
from .trlwe import TRLWE
from .torus import TORUS_BITS


def _relinearize(t_a, out_a, out_b, rl_key) -> TRLWE:
    """(out_a, out_b) - KS_rl((t_a, 0)): the s^2 term switched back to s."""
    t = _ks.trlwe_keyswitch(TRLWE(a=t_a.unsqueeze(-2),
                                  b=torch.zeros_like(t_a)), rl_key)
    return _trlwe.sub(TRLWE(a=out_a.unsqueeze(-2), b=out_b), t)


def _check_k1(c1: TRLWE, c2: TRLWE):
    if c1.k != 1 or c2.k != 1:
        raise ValueError(f"the tensor product needs k = 1, got {c1.k}, "
                         f"{c2.k}")


def tensor_prod(c1: TRLWE, c2: TRLWE, precision: int, rl_key) -> TRLWE:
    """Exact tensor product and relinearization (`trlwe_tensor_prod`,
    `trlwe.c:692-712`)."""
    _check_k1(c1, c2)
    bit_scale = TORUS_BITS - precision
    a1, b1 = c1.a[..., 0, :], c1.b
    a2, b2 = c2.a[..., 0, :], c2.b
    t_a = _poly.full_mul_with_scale(a1, a2, bit_scale)
    out_a = (_poly.full_mul_with_scale(a1, b2, bit_scale)
             + _poly.full_mul_with_scale(b1, a2, bit_scale))
    out_b = _poly.full_mul_with_scale(b1, b2, bit_scale)
    return _relinearize(t_a, out_a, out_b, rl_key)


def tensor_prod_fft(c1: TRLWE, c2: TRLWE, precision: int, rl_key) -> TRLWE:
    """Half-precision pre-scaled tensor product (`trlwe_tensor_prod_FFT`,
    `trlwe.c:727-771`): operands rounded to half_prec{1,2} integer bits,
    then exact NTT products (the reference adds FFT error here; this does
    not)."""
    _check_k1(c1, c2)
    N = c1.N
    half_prec1 = TORUS_BITS - (TORUS_BITS - precision) // 2
    half_prec2 = TORUS_BITS - (TORUS_BITS - precision + 1) // 2
    # integer magnitudes ~2^half_prec; convolution bound N 2^(h1+h2)
    bound = N << (half_prec1 + half_prec2)
    plan = _ntt.get_plan(N, _ntt.primes_for_bound(bound), c1.b.device)

    def scaled_ntt(x, log_scale):
        return _ntt.to_ntt_u64(_poly.torus_scale_round(x, log_scale), plan)

    A1 = scaled_ntt(c1.a[..., 0, :], half_prec1)
    A2 = scaled_ntt(c2.a[..., 0, :], half_prec2)
    B1 = scaled_ntt(c1.b, half_prec1)
    B2 = scaled_ntt(c2.b, half_prec2)
    t_a = _ntt.from_ntt_u64(_ntt.pointwise_mul(A1, A2, plan), plan)
    out_a = _ntt.from_ntt_u64(
        _ntt.add(_ntt.pointwise_mul(A1, B2, plan),
                 _ntt.pointwise_mul(B1, A2, plan), plan), plan)
    out_b = _ntt.from_ntt_u64(_ntt.pointwise_mul(B1, B2, plan), plan)
    return _relinearize(t_a, out_a, out_b, rl_key)


def tlwe_mul(c1: TLWE, c2: TLWE, precision: int, ksk, rlk) -> TLWE:
    """TLWE x TLWE: packing1 switches, the tensor product, the extract of
    coefficient 0 (`tlwe_mul`, `tlwe.c:322-332`).  c1 and c2 go through one
    packing switch as one batch (the same words as two)."""
    both = TLWE(a=torch.stack([c1.a, c2.a]), b=torch.stack([c1.b, c2.b]))
    t = _ks.packing1_keyswitch(both, ksk)
    prod = tensor_prod_fft(TRLWE(a=t.a[0], b=t.b[0]),
                           TRLWE(a=t.a[1], b=t.b[1]), precision, rlk)
    return _trlwe.extract_tlwe(prod, 0)
