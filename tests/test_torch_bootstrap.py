"""The port's bootstrap against the TPU package's jnp path, bit for bit, with
key material made by the TPU package and carried by `bridge`; plus the
port's own keygen end to end and its refusal to pick the CPU by itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap as jbs, params, rng as jrng, \
    tlwe as jtlwe, torus as jtorus, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_torch import bootstrap as tbs, bridge, rng as trng, \
    tlwe as ttlwe, torus as ttorus, trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy

KEY = jax.random.PRNGKey(2718)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this file's torch ops are small, and idle
    threads spinning in each of the suite's workers slow the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_keys(p, seed, n=None):
    """TPU-package keys; ``n`` cuts the LWE dimension (the bootstrap key's
    depth) while keeping every other width."""
    n = p.n if n is None else n
    k0, k1, k2 = jax.random.split(jax.random.fold_in(KEY, seed), 3)
    key_tlwe = jtlwe.new_binary_key(k0, n, p.lwe_sigma)
    key_trlwe = jtrlwe.new_binary_key(k1, p.N, p.k, p.rlwe_sigma)
    gk = jtrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    return key_tlwe, key_trlwe, gk, k2


def _jax_bk(gk, k2, key_tlwe):
    """The TPU package's key generation, compiled as one program (eager it
    takes ten times longer)."""
    return jax.jit(lambda rk, kt: jbs.new_key(rk, gk, kt))(k2, key_tlwe)


def _port_bk(bk):
    return bridge.bootstrap_key_from_numpy(
        np.asarray(bk.v), np.asarray(bk.vs), bk.n, bk.k, bk.N, bk.l,
        bk.Bg_bit, bk.primes, CPU)


def _rotate_both(p, bk_j, bk_t, B, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 64, (B, p.k, p.N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (B, p.N), dtype=np.uint64)
    mask = rng.integers(0, 1 << 64, (B, bk_j.n), dtype=np.uint64)
    want = jbs.blind_rotate(jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
                            jnp.asarray(mask), bk_j, impl="jnp")
    got = tbs.blind_rotate(bridge.trlwe_from_numpy(a, b, CPU),
                           bridge.to_tensor(mask, CPU), bk_t)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))


@pytest.mark.parametrize("p", [params.TOY, params.TOY_K2], ids=lambda p: p.name)
def test_blind_rotate_matches_jnp(p):
    key_tlwe, _, gk, k2 = _jax_keys(p, 1)
    bk = _jax_bk(gk, k2, key_tlwe)
    _rotate_both(p, bk, _port_bk(bk), B=3, seed=2)


def test_blind_rotate_matches_jnp_at_l2_widths():
    """TFHEpp-L2 widths (N=2048, k=1, l=4, Bg_bit=9, 3 primes) with the
    rotation cut to n=4 steps.  The port's own `to_dft` builds the key from
    the TPU package's TRGSW rows, so the L2 NTT form is checked too."""
    p = params.TFHEPP_L2
    key_tlwe, key_trlwe, gk, k2 = _jax_keys(p, 3, n=4)
    plan = gk.plan()

    def make(rk, s):
        g = jbs._batched_monomial_encrypt(s, jnp.zeros((4,), jnp.int32), gk,
                                          rk)
        return g, jtrgsw.to_dft(g, plan, with_shoup=True)

    g, gd = jax.jit(make)(k2, key_tlwe.s)
    bk_j = jbs.BootstrapKey(v=gd.v, vs=gd.vs, su=None, n=4, k=p.k, N=p.N,
                            l=p.l, Bg_bit=p.Bg_bit, unfolding=1,
                            primes=plan.primes)
    tgk = ttrgsw.new_key(bridge.trlwe_key_from_numpy(
        np.asarray(key_trlwe.s), key_trlwe.sigma, key_trlwe.s_bound, CPU),
        p.l, p.Bg_bit)
    td = ttrgsw.to_dft(
        bridge.trgsw_from_numpy(np.asarray(g.rows), p.l, p.Bg_bit, CPU),
        tgk.plan())
    np.testing.assert_array_equal(to_numpy(td.v), np.asarray(gd.v))
    np.testing.assert_array_equal(to_numpy(td.vs), np.asarray(gd.vs))
    bk_t = tbs.BootstrapKey.from_dft(td.v, td.vs, 4, p.k, p.N, p.l, p.Bg_bit,
                                     td.primes)
    _rotate_both(p, bk_j, bk_t, B=2, seed=4)


def _lut_inputs(p, key_tlwe, seed, batch):
    luts = jrng.uniform_torus(jax.random.fold_in(KEY, seed), (4,))
    tv = jtrlwe.torus_packing(luts, p.k, p.N)
    ms = jtorus.double2torus((jnp.arange(batch) % 4) / 8.0)
    cs = jtlwe.encrypt(ms, key_tlwe, jax.random.fold_in(KEY, seed + 1))
    ttv = bridge.trlwe_from_numpy(np.asarray(tv.a), np.asarray(tv.b), CPU)
    tcs = bridge.tlwe_from_numpy(np.asarray(cs.a), np.asarray(cs.b), CPU)
    return luts, tv, cs, ttv, tcs


def test_functional_and_programmable_bootstrap_match():
    p = params.TOY
    key_tlwe, key_trlwe, gk, k2 = _jax_keys(p, 5)
    bk = _jax_bk(gk, k2, key_tlwe)
    bk_t = _port_bk(bk)
    luts, tv, cs, ttv, tcs = _lut_inputs(p, key_tlwe, 6, batch=8)
    want = jbs.functional_bootstrap(tv, cs, bk, 4)
    got = tbs.functional_bootstrap(ttv, tcs, bk_t, 4)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))
    want = jbs.programmable_bootstrap(tv, cs, bk, 2, 3, 1)
    got = tbs.programmable_bootstrap(ttv, tcs, bk_t, 2, 3, 1)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))


def test_port_keygen_and_bootstrap_decrypt():
    """The port alone: keygen from a torch.Generator, encrypt, bootstrap,
    decrypt every slot to within 2^58 (the TPU package's bound)."""
    p = params.TOY
    gen = torch.Generator().manual_seed(7)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    key_out = ttrlwe.extract_tlwe_key(key_trlwe)
    bk = tbs.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe, gen,
                     CPU)
    assert bk.v32.shape == (p.n, (p.k + 1) * p.l, p.k + 1, 3, p.N)
    luts = trng.uniform_torus(gen, (4,), CPU)
    tv = ttrlwe.torus_packing(luts, p.k, p.N)
    ms = ttorus.double2torus((torch.arange(8) % 4) / 8.0)
    cs = ttlwe.encrypt(ms, key_tlwe, gen)
    out = tbs.functional_bootstrap(tv, cs, bk, 4)
    ph = ttlwe.phase(out, key_out)
    err = to_numpy(ph - luts[torch.arange(8) % 4]).view(np.int64)
    assert np.abs(err.astype(np.float64)).max() <= 2.0**58


def test_entry_points_refuse_to_pick_the_cpu(monkeypatch):
    """Without a card, an entry point called without ``device`` raises; it
    never runs on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = params.TOY
    gen = torch.Generator().manual_seed(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttlwe.new_binary_key(p.n, p.lwe_sigma, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.to_tensor(np.zeros(4, np.uint64))
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbs.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe, gen)
