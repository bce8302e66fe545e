"""The port's NTT module against the TPU package's, bit for bit: plan tables,
transforms, Garner CRT, residue maps and the pointwise products."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import ntt as jntt
from mosfhet_torch import ntt as tntt
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk

PRIMES = jntt.DEFAULT_PRIMES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this file's torch ops are small, and idle
    threads spinning in each of the suite's workers slow the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u64(x):
    return np.asarray(x).astype(np.uint64)


def _resi(rng, shape, primes):
    p = np.array(primes, dtype=np.uint64)[:, None]
    return rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % p


@pytest.mark.parametrize("N", [64, 256, 2048])
def test_plan_tables_match(N):
    jp = jntt.get_plan(N, PRIMES)
    tp = tntt.get_plan(N, PRIMES, "cpu")
    assert tp.primes == jp.primes and tp.P == jp.P and tp.logN == jp.logN
    for name in ("p", "mu", "mu62", "psi_rev", "psi_rev_shoup", "ipsi_rev",
                 "ipsi_rev_shoup", "n_inv", "n_inv_shoup"):
        np.testing.assert_array_equal(
            to_numpy(getattr(tp, name)), _u64(getattr(jp, name)), name)
    assert tp.barrett_ok == jp.barrett_ok
    assert tp.crt_half_range == jp.crt_half_range
    assert tp.half_last == int(jp.half_last)
    for m in range(jp.P):
        assert [(int(w), int(ws)) for w, ws in jp.garner_w[m]] == \
            tp.garner_w[m]
        if m:
            assert tuple(int(c) for c in jp.garner_cinv[m]) == \
                tp.garner_cinv[m]


@pytest.mark.parametrize("N", [64, 2048])
def test_kernel_plan_matches(N):
    """The CUDA kernel's tables: psi/ipsi and their Shoup companions as u32
    bits, and the TPU kernel plan's Garner constants and gadget offset."""
    from mosfhet_tpu.ops import pbs_kernel as jpk
    l, Bg_bit, k = 4, 9, 1
    jp = jntt.get_plan(N, PRIMES)
    jkp = jpk.PBSKernelPlan(N, PRIMES, l, Bg_bit, k, bt=8)
    kp = tpk.get_kernel_plan(N, PRIMES, l, Bg_bit, k, "cpu")
    for mine, theirs in ((kp.fwd_tw, jp.psi_rev), (kp.fwd_tws, jp.psi_rev_shoup),
                         (kp.inv_tw, jp.ipsi_rev),
                         (kp.inv_tws, jp.ipsi_rev_shoup)):
        assert mine.dtype == torch.int32
        np.testing.assert_array_equal(
            mine.numpy().view(np.uint32), _u64(theirs).astype(np.uint32))
    assert kp.offset == (jkp.off_hi << 32 | jkp.off_lo)
    P = kp.P
    c = kp.host_consts
    assert list(c[6:6 + P]) == list(PRIMES)
    gw = c[6 + 5 * P:6 + 5 * P + P * P].reshape(P, P)
    gws = c[6 + 5 * P + P * P:6 + 5 * P + 2 * P * P].reshape(P, P)
    for m in range(P):
        for j, (w, ws) in enumerate(jkp.garner_w[m]):
            assert (gw[m, j], gws[m, j]) == (w, ws)
        if m:
            assert (c[6 + 3 * P + m], c[6 + 4 * P + m]) == jkp.garner_cinv[m]
    # the runtime-key Barrett constant and the centred u64 reduction's
    mup, red1, c32, c32s, c64m = c[6 + 5 * P + 2 * P * P:].reshape(5, P)
    assert list(mup) == jkp.mup and list(red1) == jkp.red1
    assert list(zip(c32, c32s)) == jkp.c32 and list(c64m) == jkp.c64m


@pytest.mark.parametrize("N", [64, 256, 2048])
def test_forward_inverse_garner_match(N):
    rng = np.random.default_rng(N)
    jp = jntt.get_plan(N, PRIMES)
    tp = tntt.get_plan(N, PRIMES, "cpu")
    x = _resi(rng, (3, len(PRIMES), N), PRIMES)
    fj = np.asarray(jntt.forward_ntt(jnp.asarray(x), jp))
    ft = tntt.forward_ntt(to_tensor(x, "cpu"), tp)
    np.testing.assert_array_equal(to_numpy(ft), fj)
    ij = np.asarray(jntt.inverse_ntt(jnp.asarray(x), jp))
    it = tntt.inverse_ntt(to_tensor(x, "cpu"), tp)
    np.testing.assert_array_equal(to_numpy(it), ij)
    gj = np.asarray(jntt.garner_u64(jnp.asarray(x), jp))
    gt = tntt.garner_u64(to_tensor(x, "cpu"), tp)
    np.testing.assert_array_equal(to_numpy(gt), gj)


def test_residue_maps_and_round_trip():
    N = 256
    rng = np.random.default_rng(3)
    jp = jntt.get_plan(N, PRIMES)
    tp = tntt.get_plan(N, PRIMES, "cpu")
    w = np.concatenate([np.array([0, 1, (1 << 63) - 1, 1 << 63,
                                  (1 << 64) - 1], np.uint64),
                        rng.integers(0, 1 << 64, N - 5, dtype=np.uint64)])
    np.testing.assert_array_equal(
        to_numpy(tntt.to_resi_u64(to_tensor(w, "cpu"), tp)),
        np.asarray(jntt.to_resi_u64(jnp.asarray(w), jp)))
    s = rng.integers(-(1 << 40), 1 << 40, N, dtype=np.int64)
    np.testing.assert_array_equal(
        tntt.to_resi_i64(torch.from_numpy(s), tp).numpy(),
        np.asarray(jntt.to_resi_i64(jnp.asarray(s), jp)).astype(np.int64))
    d = rng.integers(-256, 256, (4, N)).astype(np.int32)
    np.testing.assert_array_equal(
        tntt.to_resi_small(torch.from_numpy(d), tp).numpy(),
        np.asarray(jntt.to_resi_small(jnp.asarray(d), jp)).astype(np.int64))
    # small-digit products stay inside the CRT range: exact round trip
    spec = tntt.to_ntt_small(torch.from_numpy(d), tp)
    np.testing.assert_array_equal(
        to_numpy(spec), np.asarray(jntt.to_ntt_small(jnp.asarray(d), jp)))
    np.testing.assert_array_equal(
        tntt.from_ntt_u64(spec, tp).numpy(), d.astype(np.int64))
    np.testing.assert_array_equal(
        to_numpy(tntt.to_ntt_u64(to_tensor(w, "cpu"), tp)),
        np.asarray(jntt.to_ntt_u64(jnp.asarray(w), jp)))


def test_pointwise_products_match():
    N = 256
    rng = np.random.default_rng(11)
    jp = jntt.get_plan(N, PRIMES)
    tp = tntt.get_plan(N, PRIMES, "cpu")
    a = _resi(rng, (2, 5, 1, len(PRIMES), N), PRIMES)
    kv = _resi(rng, (5, 2, len(PRIMES), N), PRIMES)
    kvs_j = np.asarray(jntt.make_shoup(jnp.asarray(kv), jp.p[:, None]))
    kvs_t = tntt.make_shoup(to_tensor(kv, "cpu"), tp.p[:, None])
    np.testing.assert_array_equal(to_numpy(kvs_t), kvs_j)
    want = jntt.pointwise_mul_acc_key(jnp.asarray(a), jnp.asarray(kv),
                                      jnp.asarray(kvs_j), jp, axis=-4)
    got = tntt.pointwise_mul_acc_key(to_tensor(a, "cpu"), to_tensor(kv, "cpu"),
                                     kvs_t, tp, dim=-4)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    b = _resi(rng, (2, 5, 1, len(PRIMES), N), PRIMES)
    np.testing.assert_array_equal(
        to_numpy(tntt.pointwise_mul(to_tensor(a, "cpu"), to_tensor(b, "cpu"),
                                    tp)),
        np.asarray(jntt.pointwise_mul(jnp.asarray(a), jnp.asarray(b), jp)))
    np.testing.assert_array_equal(
        to_numpy(tntt.add(to_tensor(a, "cpu"), to_tensor(b, "cpu"), tp)),
        np.asarray(jntt.add(jnp.asarray(a), jnp.asarray(b), jp)))


def test_shoup_and_barrett_primitives_match():
    rng = np.random.default_rng(17)
    p = np.uint64(PRIMES[1])
    a = rng.integers(0, int(p), 500, dtype=np.uint64)
    w = rng.integers(0, int(p), 500, dtype=np.uint64)
    ws = np.asarray(jntt.make_shoup(jnp.asarray(w), jnp.uint64(p)))
    jt = tntt.make_shoup(to_tensor(w, "cpu"), int(p))
    np.testing.assert_array_equal(to_numpy(jt), ws)
    for fj, ft in ((jntt.shoup_mul_lazy, tntt.shoup_mul_lazy),
                   (jntt.shoup_mul, tntt.shoup_mul)):
        np.testing.assert_array_equal(
            to_numpy(ft(to_tensor(a, "cpu"), to_tensor(w, "cpu"), jt, int(p))),
            np.asarray(fj(jnp.asarray(a), jnp.asarray(w), jnp.asarray(ws),
                          jnp.uint64(p))))
    z = rng.integers(0, 1 << 59, 500, dtype=np.uint64)
    mu = np.uint64((1 << 60) // int(p))
    np.testing.assert_array_equal(
        to_numpy(tntt.barrett_small(to_tensor(z, "cpu"), int(p), int(mu))),
        np.asarray(jntt.barrett_small(jnp.asarray(z), jnp.uint64(p),
                                      jnp.uint64(mu))))


@pytest.mark.parametrize("bound", [2**40, 2**80, 2**86, 2**98, 2**120])
def test_primes_for_bound_matches(bound):
    assert tntt.primes_for_bound(bound) == jntt.primes_for_bound(bound)
    assert tntt.conv_bound(2048, 256, 8) == jntt.conv_bound(2048, 256, 8)
    assert tntt.external_product_bound(2048, 9, 4, 1) == \
        jntt.external_product_bound(2048, 9, 4, 1)
