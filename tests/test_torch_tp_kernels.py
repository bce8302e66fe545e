"""The TPU kernels of the gadget-row sharded CMUX step,
`partial_step_tiles` (K8a) and `finish_step_tiles` (K8b), each run directly
in Pallas interpret mode for one step, against the port's plain versions on
the same random inputs, bit for bit, at the widths of the TPU package's
kernel-TP mesh test (N=128, l=2, Bg_bit=10): the second of two shards
(j0 = j_local) and the psum of two partials.  Then the split step itself:
the partials of every shard, finished, give `cmux_step`'s words.  The CUDA
kernels meet the same plain versions in `test_torch_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu.ops import pbs_kernel as jpk
from mosfhet_torch import ntt as tntt
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

N, K, L, BG_BIT = 128, 1, 2, 10
C, J = K + 1, (K + 1) * L
PRIMES = tntt.primes_for_bound(tntt.external_product_bound(N, BG_BIT, L, K))
P = len(PRIMES)
B = 8          # one TPU tile (bt=8), so the TPU kernels pad nothing


def _residues(rng, shape):
    return rng.integers(0, 1 << 62, shape, dtype=np.uint64) \
        % np.array(PRIMES, np.uint64)[:, None]


def _i32(x):
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def _plans():
    return (jpk.get_kernel_plan(N, PRIMES, L, BG_BIT, K, bt=B, mxu=False,
                                rot_ntt=False),
            tpk.get_kernel_plan(N, PRIMES, L, BG_BIT, K, "cpu"))


def _tiles(x):
    """[B, C, P, N] -> the TPU kernels' [nb, C, P, BT, N] (nb = 1)."""
    return x.reshape(1, B, C, P, N).transpose(0, 2, 3, 1, 4)


def test_partial_step_plain_matches_tpu_kernel_interpret():
    """The second shard's rows [2, 4) of J=4; exponents 0 and 2N present."""
    rng = np.random.default_rng(85)
    j_local = J // 2
    j0 = j_local
    acc0 = rng.integers(0, 1 << 64, (B, C, N), dtype=np.uint64)
    a = rng.integers(0, 2 * N + 1, B).astype(np.int32)
    a[0], a[-1] = 0, 2 * N
    keyv = _residues(rng, (j_local, C, P, N))
    keyvs = (keyv << np.uint64(32)) // np.array(PRIMES, np.uint64)[:, None]
    jkp, kp = _plans()
    want = jpk.partial_step_tiles(
        jpk.split_limbs(jnp.asarray(acc0), jkp),
        jnp.asarray(a).reshape(1, B, 1), jnp.asarray([j0], jnp.int32),
        jnp.asarray(keyv.astype(np.uint32)),
        jnp.asarray(keyvs.astype(np.uint32)), jkp, interpret=True)
    calls = tpk.partial_step_plain.calls
    got = tpk.partial_step(to_tensor(acc0, "cpu"), torch.from_numpy(a), j0,
                           _i32(keyv), _i32(keyvs), kp)
    assert tpk.partial_step_plain.calls == calls + 1
    np.testing.assert_array_equal(
        tpk.i32_as_u32(got).numpy(),
        np.asarray(want).transpose(0, 3, 1, 2, 4).reshape(B, C, P, N))


def test_finish_step_plain_matches_tpu_kernel_interpret():
    """The psum of two exact partials (n_parts = 2), finished into acc."""
    rng = np.random.default_rng(86)
    acc0 = rng.integers(0, 1 << 64, (B, C, N), dtype=np.uint64)
    parts = _residues(rng, (2, B, C, P, N))
    parts[0, 0, 0, :, 0] = np.array(PRIMES) - 1        # the sum's top
    parts[1, 0, 0, :, 0] = np.array(PRIMES) - 1
    jkp, kp = _plans()
    want = jpk.merge_limbs(jpk.finish_step_tiles(
        jpk.split_limbs(jnp.asarray(acc0), jkp),
        jnp.asarray(_tiles(parts.sum(0)).astype(np.uint32)), jkp, 2,
        interpret=True))
    acc = to_tensor(acc0, "cpu")
    calls = tpk.finish_step_plain.calls
    got = tpk.finish_step(acc, _i32(parts), kp)
    assert tpk.finish_step_plain.calls == calls + 1
    assert got is acc                                   # updated in place
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_split_step_matches_cmux_step(m):
    """The partials of m shards of J=4 rows, finished, equal one CMUX."""
    rng = np.random.default_rng(87 + m)
    acc0 = to_tensor(rng.integers(0, 1 << 64, (B, C, N), dtype=np.uint64),
                     "cpu")
    a = torch.from_numpy(rng.integers(0, 2 * N + 1, B).astype(np.int32))
    keyv = _residues(rng, (J, C, P, N))
    keyvs = (keyv << np.uint64(32)) // np.array(PRIMES, np.uint64)[:, None]
    _, kp = _plans()
    want = tpk.cmux_step(acc0, to_tensor(keyv, "cpu"),
                         to_tensor(keyvs, "cpu"), a, kp.ntt, L, BG_BIT)
    jl = J // m
    parts = torch.stack([
        tpk.partial_step(acc0, a, s * jl, _i32(keyv[s * jl:(s + 1) * jl]),
                         _i32(keyvs[s * jl:(s + 1) * jl]), kp)
        for s in range(m)])
    got = tpk.finish_step(acc0.clone(), parts, kp)
    assert torch.equal(got, want)
