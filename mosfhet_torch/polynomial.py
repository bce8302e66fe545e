"""Negacyclic polynomial rotations on torus tensors [..., N] (int64 bits).

Mirrors `src/polynomial.c:184-235`.  Rotation amounts may be per-batch
tensors: the blind rotate turns every ciphertext by its own exponent.
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
