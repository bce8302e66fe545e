"""The TPU kernels of the GA path, `auto_keyswitch_stream` (with its
in-kernel Galois permutation) and `ga_scan_fused`, each run directly in
Pallas interpret mode, against the port's plain versions on the same random
inputs, bit for bit, at the GA tests' widths.  The CUDA kernels meet the
same plain versions in `test_torch_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import torch

from mosfhet_tpu.ops import pbs_kernel as jpk
from mosfhet_torch import bootstrap_ga as tga, ntt as tntt
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

N, K, L, BG_BIT = 128, 1, 2, 10
C, J = K + 1, (K + 1) * L
PRIMES = tntt.primes_for_bound(tntt.external_product_bound(N, BG_BIT, L, K))
KS_PRIMES = tntt.primes_for_bound(tntt.conv_bound(N, 1 << (BG_BIT - 1),
                                                  K * L * L))
B = 8          # one TPU tile (bt=8), so the TPU kernels pad nothing


def _residues(rng, shape, primes):
    return rng.integers(0, 1 << 62, shape, dtype=np.uint64) \
        % np.array(primes, np.uint64)[:, None]


def _u32(x):
    return jnp.asarray(x.astype(np.uint32))


def _i32(x):
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def _plans():
    return (jpk.get_kernel_plan(N, PRIMES, L, BG_BIT, K, bt=B, mxu=False),
            jpk.get_kernel_plan(N, KS_PRIMES, L, BG_BIT, K, bt=B, mxu=False),
            tpk.get_kernel_plan(N, PRIMES, L, BG_BIT, K, "cpu"),
            tpk.get_kernel_plan(N, KS_PRIMES, L, BG_BIT, K, "cpu"))


def test_auto_keyswitch_plain_matches_tpu_kernel_interpret():
    """8 rows, a random keyset of 16 entries (kidx 0 and 15 present), one
    generator inverse per row (1 and 2N-1 present)."""
    rng = np.random.default_rng(16)
    G = 16
    ak = _residues(rng, (G, K * L, C, len(KS_PRIMES), N), KS_PRIMES)
    x = rng.integers(0, 1 << 64, (B, C, N), dtype=np.uint64)
    kidx = rng.integers(0, G, B).astype(np.int32)
    kidx[0], kidx[-1] = 0, G - 1
    ginv = (rng.integers(0, N, B) * 2 + 1).astype(np.int32)
    ginv[0], ginv[1] = 1, 2 * N - 1
    _, jkp_ks, _, kp_ks = _plans()
    want = jpk.auto_keyswitch_stream(
        jnp.asarray(x), _u32(ak), jnp.asarray(kidx), jkp_ks, interpret=True,
        ginv=jnp.asarray(ginv))
    got = tpk.auto_keyswitch_stream_plain(
        to_tensor(x, "cpu"), _i32(ak), torch.from_numpy(kidx),
        torch.from_numpy(ginv), kp_ks)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_ga_scan_plain_matches_tpu_kernel_interpret():
    """2 steps, 8 ciphertexts, a random whole keyset (G = N), generators 1
    and 2N-1 present."""
    rng = np.random.default_rng(14)
    n = 2
    sv = _residues(rng, (n, J, C, len(PRIMES), N), PRIMES)
    svs = (sv << np.uint64(32)) // np.array(PRIMES, np.uint64)[:, None]
    ak = _residues(rng, (N, K * L, C, len(KS_PRIMES), N), KS_PRIMES)
    acc0 = rng.integers(0, 1 << 64, (B, C, N), dtype=np.uint64)
    gens = (rng.integers(0, N, (n, B)) * 2 + 1).astype(np.int32)
    gens[0, 0], gens[-1, -1] = 1, 2 * N - 1
    inv = tga.inverse_mod_2n_table(N)
    jkp, jkp_ks, kp, kp_ks = _plans()
    want = jpk.ga_scan_fused(
        jnp.asarray(acc0), jnp.asarray(gens), _u32(sv), _u32(svs),
        _u32(ak).reshape(N, -1, 1, N), jnp.asarray(inv), jkp, jkp_ks,
        interpret=True)
    got = tpk.ga_scan_fused_plain(
        to_tensor(acc0, "cpu"), torch.from_numpy(gens), _i32(sv), _i32(svs),
        _i32(ak), torch.from_numpy(inv), kp, kp_ks)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
