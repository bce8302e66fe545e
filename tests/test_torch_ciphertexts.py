"""TLWE / TRLWE / TRGSW of the port against the TPU package, bit for bit,
with keys and ciphertexts made by the TPU package and carried by `bridge`.
The port's own encryption uses PyTorch's generator, so it is held to the
noise bound instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import params, polynomial as jpoly, tlwe as jtlwe, \
    trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_torch import bridge, polynomial as tpoly, tlwe as ttlwe, \
    trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy, to_tensor
from tests.test_torch_suite_env import port_test_env  # noqa: F401

KEY = jax.random.PRNGKey(314)
CPU = "cpu"


def _keys(p, seed):
    k0, k1 = jax.random.split(jax.random.fold_in(KEY, seed))
    jt = jtlwe.new_binary_key(k0, p.n, p.lwe_sigma)
    jr = jtrlwe.new_binary_key(k1, p.N, p.k, p.rlwe_sigma)
    tt = bridge.tlwe_key_from_numpy(np.asarray(jt.s), jt.sigma, CPU)
    tr = bridge.trlwe_key_from_numpy(np.asarray(jr.s), jr.sigma, jr.s_bound,
                                     CPU)
    return jt, jr, tt, tr


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _signed_err(got, want):
    d = (to_numpy(got) - np.asarray(want, np.uint64)).view(np.int64)
    return np.abs(d.astype(np.float64)).max()


@pytest.mark.parametrize("p", [params.TOY, params.TOY_K2], ids=lambda p: p.name)
def test_tlwe_and_trlwe_phase_match(p):
    jt, jr, tt, tr = _keys(p, 1)
    ms = jnp.asarray(np.arange(6, dtype=np.uint64) << np.uint64(60))
    c = jax.jit(jtlwe.encrypt)(ms, jt, jax.random.fold_in(KEY, 2))
    tc = bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)
    _eq(ttlwe.phase(tc, tt), jtlwe.phase(c, jt))

    m = jnp.asarray(np.random.default_rng(3).integers(
        0, 1 << 64, (3, p.N), dtype=np.uint64))
    rc = jax.jit(jtrlwe.encrypt)(m, jr, jax.random.fold_in(KEY, 4))
    trc = bridge.trlwe_from_numpy(np.asarray(rc.a), np.asarray(rc.b), CPU)
    _eq(ttrlwe.phase(trc, tr), jax.jit(jtrlwe.phase)(rc, jr))
    _eq(trc.stacked(), rc.stacked())
    kt = ttrlwe.extract_tlwe_key(tr)
    np.testing.assert_array_equal(kt.s.numpy(),
                                  np.asarray(jtrlwe.extract_tlwe_key(jr).s))


@pytest.mark.parametrize("p", [params.TOY, params.TOY_K2], ids=lambda p: p.name)
def test_rotation_extraction_packing_match(p):
    rng = np.random.default_rng(5)
    B, N, k = 7, p.N, p.k
    a = rng.integers(0, 1 << 64, (B, k, N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (B, N), dtype=np.uint64)
    e = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1, 2 * N], np.int32)
    jc = jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b))
    tc = bridge.trlwe_from_numpy(a, b, CPU)
    jr = jtrlwe.mul_by_xai(jc, jnp.asarray(e))
    tr = ttrlwe.mul_by_xai(tc, torch.from_numpy(e))
    _eq(tr.a, jr.a)
    _eq(tr.b, jr.b)
    _eq(tpoly.mul_by_xai_minus_1(tc.b, torch.from_numpy(e)),
        jpoly.mul_by_xai_minus_1(jc.b, jnp.asarray(e)))
    for idx in (0, 1, N // 2, N - 1):
        je = jtrlwe.extract_tlwe(jc, idx)
        te = ttrlwe.extract_tlwe(tc, idx)
        _eq(te.a, je.a)
        _eq(te.b, je.b)
    vals = rng.integers(0, 1 << 64, (4,), dtype=np.uint64)
    jp = jtrlwe.torus_packing(jnp.asarray(vals), k, N)
    tp = ttrlwe.torus_packing(to_tensor(vals, CPU), k, N)
    _eq(tp.stacked(), jp.stacked())


@pytest.mark.parametrize("p", [params.TOY, params.TOY_K2], ids=lambda p: p.name)
def test_trgsw_monomial_rows_and_to_dft_match(p):
    _, jr, _, tr = _keys(p, 6)
    gk = jtrgsw.new_key(jr, p.l, p.Bg_bit)
    tgk = ttrgsw.new_key(tr, p.l, p.Bg_bit)
    R, C = (p.k + 1) * p.l, p.k + 1
    plan = gk.plan()

    def make(rk):
        g = jtrgsw.monomial_encrypt(3, p.N + 5, gk, rk)
        return g, jtrgsw.to_dft(g, plan)

    g, jd = jax.jit(make)(jax.random.fold_in(KEY, 7))
    tg = bridge.trgsw_from_numpy(np.asarray(g.rows), p.l, p.Bg_bit, CPU)
    td = ttrgsw.to_dft(tg, tgk.plan())
    assert td.primes == jd.primes
    _eq(td.v, jd.v)
    _eq(td.vs, jd.vs)
    # the monomial rows themselves, sign fold of X^N included
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 1 << 64, (3, R, C, p.N), dtype=np.uint64)
    ms = np.array([1, -2, 5], np.int64)
    es = np.array([0, p.N + 3, 2 * p.N - 1], np.int64)
    for i in range(3):
        want = jtrgsw._add_monomial_rows(jnp.asarray(rows[i]), int(ms[i]),
                                         int(es[i]), p.l, p.Bg_bit, p.k, p.N)
        got = ttrgsw._add_monomial_rows(
            to_tensor(rows, CPU), torch.from_numpy(ms), torch.from_numpy(es),
            p.l, p.Bg_bit, p.k, p.N)[i]
        _eq(got, want)


def test_port_encryption_decrypts_within_noise():
    """Own-generator encryption: the streams differ from the TPU package's,
    so the phase is held to the noise bound (6 sigma is far below 2^-40)."""
    p = params.TOY
    _, _, tt, tr = _keys(p, 9)
    gen = torch.Generator().manual_seed(10)
    ms = to_tensor(np.arange(8, dtype=np.uint64) << np.uint64(61), CPU)
    c = ttlwe.encrypt(ms, tt, gen)
    assert _signed_err(ttlwe.phase(c, tt), to_numpy(ms)) < 2.0**40
    m = to_tensor(np.random.default_rng(11).integers(
        0, 1 << 64, (2, p.N), dtype=np.uint64), CPU)
    rc = ttrlwe.encrypt(m, tr, gen)
    assert _signed_err(ttrlwe.phase(rc, tr), to_numpy(m)) < 2.0**40
    # TRGSW(X^e): row comp*l + i has phase h_i X^e at component comp
    gk = ttrgsw.new_key(tr, p.l, p.Bg_bit)
    g = ttrgsw.monomial_encrypt(torch.tensor([1]), torch.tensor([3]), gk, gen)
    ph = ttrlwe.phase(ttrlwe.from_stacked(g.rows[0]), tr)     # [R, N]
    want = ttrgsw._add_monomial_rows(
        torch.zeros_like(g.rows), torch.tensor([1]), torch.tensor([3]),
        p.l, p.Bg_bit, p.k, p.N)[0]
    want_phase = ttrlwe.phase(ttrlwe.from_stacked(want), tr)
    assert _signed_err(ph, to_numpy(want_phase)) < 2.0**40


def test_bridge_round_trips():
    """Every numpy -> port -> numpy converter returns the same words."""
    rng = np.random.default_rng(12)
    w = lambda *shape: rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    s = rng.integers(-1, 2, 16).astype(np.int64)
    assert np.array_equal(
        bridge.key_to_numpy(bridge.tlwe_key_from_numpy(s, 0.1, CPU)), s)
    assert np.array_equal(bridge.key_to_numpy(
        bridge.trlwe_key_from_numpy(s.reshape(2, 8), 0.1, 1, CPU)),
        s.reshape(2, 8))
    a, b = w(3, 5), w(3)
    for got, want in zip(bridge.tlwe_to_numpy(
            bridge.tlwe_from_numpy(a, b, CPU)), (a, b)):
        np.testing.assert_array_equal(got, want)
    a, b = w(3, 2, 8), w(3, 8)
    for got, want in zip(bridge.trlwe_to_numpy(
            bridge.trlwe_from_numpy(a.view(np.int64), b, CPU)), (a, b)):
        np.testing.assert_array_equal(got, want)
    rows = w(6, 2, 8)
    np.testing.assert_array_equal(
        bridge.trgsw_to_numpy(bridge.trgsw_from_numpy(rows, 3, 8, CPU)), rows)
    primes = (998244353, 1004535809, 1012924417)
    v = w(2, 6, 2, 3, 8) % np.array(primes, np.uint64)[:, None]
    vs = (v << np.uint64(32)) // np.array(primes, np.uint64)[:, None]
    for got, want in zip(bridge.trgsw_dft_to_numpy(
            bridge.trgsw_dft_from_numpy(v, vs, 3, 8, primes, CPU)), (v, vs)):
        np.testing.assert_array_equal(got, want)
    bk = bridge.bootstrap_key_from_numpy(v, vs, 2, 1, 8, 3, 8, primes, CPU)
    assert bk.v32.dtype == torch.int32 and bk.vs32.dtype == torch.int32
    for got, want in zip(bridge.bootstrap_key_to_numpy(bk), (v, vs)):
        np.testing.assert_array_equal(got, want)
