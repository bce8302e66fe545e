"""Negacyclic polynomial rotations and Galois automorphisms on torus
tensors [..., N] (int64 bits).

Mirrors `src/polynomial.c:184-235,442-450`.  Rotation amounts and
generator inverses may be per-batch tensors: the blind rotate turns every
ciphertext by its own exponent, the GA rotation by its own generator.
"""

from __future__ import annotations

import torch


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
