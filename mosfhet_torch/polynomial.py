"""Negacyclic polynomial arithmetic on torus tensors [..., N] (int64 words
holding u64 bits, or int32 holding u32 bits).

Mirrors `src/polynomial.c`: rotations by X^a and Galois automorphisms
(`:184-235,442-450`), the naive O(N^2) product (the test oracle) and exact
products through the CRT-NTT.  Rotation amounts and generator inverses may
be per-batch tensors: the blind rotate turns every ciphertext by its own
exponent, the GA rotation by its own generator.  Products take the word
width from their torus operand's dtype.
"""

from __future__ import annotations

import torch

from . import ntt as _ntt
from .torus import torus2int, wrap


def _rot_gather(x, a, N):
    """out[..., i] = sign * x[..., (i - a) mod N] with the negacyclic sign.
    a: integer tensor (or int) broadcastable to x.shape[:-1]."""
    i = torch.arange(N, dtype=torch.int64, device=x.device)
    a = torch.as_tensor(a, dtype=torch.int64, device=x.device)
    m = torch.remainder(i - a.unsqueeze(-1), 2 * N)       # [..., N] in [0, 2N)
    neg = m >= N
    idx = torch.where(neg, m - N, m)
    shape = torch.broadcast_shapes(x.shape, idx.shape)
    g = torch.gather(x.expand(shape), -1, idx.expand(shape))
    return torch.where(neg.expand(shape), -g, g)


def mul_by_xai(x, a):
    """x * X^a (negacyclic), `torus_polynomial_mul_by_xai`."""
    return _rot_gather(x, a, x.shape[-1])


def mul_by_xai_minus_1(x, a):
    """x * (X^a - 1)."""
    return mul_by_xai(x, a) - x


def permute_by_inverse(x, ginv):
    """The Galois automorphism X^i -> X^(g i) of an odd generator g given by
    its inverse mod 2N: out[..., j] = +-x[..., (j ginv mod 2N) mod N],
    negated when (j ginv mod 2N) >= N.  ``ginv``: an odd int or an integer
    tensor broadcastable to x.shape[:-1]."""
    N = x.shape[-1]
    j = torch.arange(N, dtype=torch.int64, device=x.device)
    ginv = torch.as_tensor(ginv, dtype=torch.int64, device=x.device)
    ic = (j * ginv.unsqueeze(-1)) & (2 * N - 1)
    neg = (ic & N) != 0
    idx = ic & (N - 1)
    shape = torch.broadcast_shapes(x.shape, idx.shape)
    g = torch.gather(x.expand(shape), -1, idx.expand(shape))
    return torch.where(neg.expand(shape), -g, g)


def permute(x, gen: int):
    """x^i -> x^(gen i) for an odd ``gen`` (`polynomial_permute`,
    `polynomial.c:442-450`; even generators are not automorphisms)."""
    if gen % 2 != 1:
        raise ValueError(f"permute needs an odd Galois generator, got {gen}")
    return permute_by_inverse(x, pow(int(gen), -1, 2 * x.shape[-1]))


def naive_negacyclic_mul(a, b):
    """The exact O(N^2) negacyclic product mod 2^bits of two torus tensors
    [..., N] of one dtype (`polynomial_naive_mul_torus`,
    `polynomial.c:290-303`): the differential-testing oracle."""
    N = a.shape[-1]
    i = torch.arange(N, device=a.device)[:, None]      # input index of b
    j = torch.arange(N, device=a.device)[None, :]      # output index
    d = j - i
    sign = torch.where(d < 0, -1, 1).to(a.dtype)
    # M[..., i, j] = sign(i, j) * a[..., (j - i) mod N]
    M = a[..., torch.remainder(d, N)] * sign
    return (M * b.unsqueeze(-1)).sum(dim=-2, dtype=a.dtype)


def ntt_mul(a, b, plan=None):
    """The exact negacyclic product of two torus polynomials mod 2^bits
    through the CRT-NTT (replaces `polynomial_mul_torus`,
    `polynomial.c:266-277`).  Both operands centred below 2^63 need about
    2^138 of CRT range: the default plan is the 5-prime TENSOR_PRIMES."""
    if plan is None:
        plan = _ntt.get_plan(a.shape[-1], _ntt.TENSOR_PRIMES, a.device)
    fa = _ntt.to_ntt_u64(a, plan)
    fb = _ntt.to_ntt_u64(b, plan)
    return _ntt.from_ntt_u64(_ntt.pointwise_mul(fa, fb, plan), plan, a.dtype)


def ntt_mul_small(a_small, b, plan):
    """The exact negacyclic product of small signed coefficients (secret
    keys, gadget digits) and torus words ``b``; the plan's range must cover
    N * max|a| * 2^(bits-1)."""
    fa = _ntt.to_ntt_small(a_small, plan)
    fb = _ntt.to_ntt_u64(b, plan)
    return _ntt.from_ntt_u64(_ntt.pointwise_mul(fa, fb, plan), plan, b.dtype)


def ntt_mul_small_small(a, b, bound_a: int, bound_b: int):
    """The exact signed product of two small-coefficient polynomials (the
    secret-key products of relinearization and private key-switch keys,
    `keyswitch.c:3-10,39-47`) as int64; |result| <= N bound_a bound_b must
    stay below 2^62.  At the 32-bit torus the result is the product's low
    32 bits, zero-extended, as the TPU package gives it (its readback is a
    u32 word)."""
    N = a.shape[-1]
    bound = N * max(bound_a, 1) * max(bound_b, 1)
    if bound >= 1 << 62:
        raise ValueError(f"bound 2^{bound.bit_length() - 1} >= 2^62")
    plan = _ntt.get_plan(N, _ntt.primes_for_bound(bound), a.device)
    fa = _ntt.to_ntt_small(a.to(torch.int64), plan)
    fb = _ntt.to_ntt_small(b.to(torch.int64), plan)
    r = _ntt.from_ntt_u64(_ntt.pointwise_mul(fa, fb, plan), plan)
    if r.dtype == torch.int32:
        return r.to(torch.int64) & 0xFFFFFFFF
    return r


def full_mul_with_scale(a, b, bit_scale: int, plan=None):
    """((a (*) b) >> bit_scale) mod 2^bits of the exact 128-bit negacyclic
    product of the operands' unsigned representatives, a logical shift
    (replaces `polynomial_full_mul_with_scale`, `polynomial.c:429-437`, and
    its Karatsuba readback, `fft/karatsuba.c:92-101`), computed from the CRT
    digits in two 64-bit limbs."""
    if plan is None:
        plan = _ntt.get_plan(a.shape[-1], _ntt.TENSOR_PRIMES, a.device)
    fa = _ntt.forward_ntt(_ntt.to_resi_u64_raw(a, plan), plan)
    fb = _ntt.forward_ntt(_ntt.to_resi_u64_raw(b, plan), plan)
    r = _ntt.inverse_ntt(_ntt.pointwise_mul(fa, fb, plan), plan)
    return wrap(_ntt.garner_shifted_u64(r, plan, bit_scale), a.dtype)


def torus_scale_round(x, log_scale: int):
    """out[i] = round(x[i] * 2^log_scale) (`polynomial_torus_scale`,
    `polynomial.c:322-326`), words of x's width."""
    return torus2int(x, log_scale)
