"""The port's UBR multi-value bootstrap against the TPU package, bit for
bit: phase 1 (the plain version of the combine kernel) against the jnp path
at small widths and at TFHEpp-L2 widths with u=8, and against the TPU kernel
`ubr_phase1_combine_v2` in Pallas interpret mode; phase 2 with 3 LUTs, one
cache broadcast over them (against the interpret-mode apply-scan kernel)
and one cache per ciphertext; the port's own phase 1 -> phase 2
decrypting.  The CUDA kernels are held against their plain versions in
`test_torch_gpu.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap as jbs, params, rng as jrng, \
    tlwe as jtlwe, torus as jtorus, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_torch import bootstrap as tbs, bridge, ntt as tntt, \
    rng as trng, tlwe as ttlwe, torus as ttorus, trgsw as ttrgsw, \
    trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

KEY = jax.random.PRNGKey(3141)
CPU = "cpu"
UNFOLD_TEST = params.TFHEParams(
    n=8, N=128, k=1, l=2, Bg_bit=10, t=6, base_bit=4,
    lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44, name="UNFOLD_TEST")
U = 2


@functools.cache
def _jax_setup():
    """TPU-package keys at u=2 and their port copies, once for the file."""
    p = UNFOLD_TEST
    k0, k1, k2 = jax.random.split(KEY, 3)
    key_tlwe = jtlwe.new_binary_key(k0, p.n, p.lwe_sigma)
    key_trlwe = jtrlwe.new_binary_key(k1, p.N, p.k, p.rlwe_sigma)
    gk = jtrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = jax.jit(lambda rk, kt: jbs.new_key(rk, gk, kt, U))(k2, key_tlwe)
    bk_t = bridge.unfolded_bootstrap_key_from_numpy(
        np.asarray(bk.su), bk.n, bk.k, bk.N, bk.l, bk.Bg_bit, bk.primes, U,
        CPU)
    return key_tlwe, key_trlwe, bk, bk_t


def _encrypt(key_tlwe, slots, seed):
    """Messages slot/8 under the TPU package's key, and their port copy."""
    ms = jtorus.double2torus(jnp.asarray(slots, jnp.float64) / 8.0)
    c = jtlwe.encrypt(ms, key_tlwe, jax.random.fold_in(KEY, seed))
    return c, bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)


def _phase1_both(c, tc, bk, bk_t, impl):
    want = jax.jit(lambda c_: jbs.multivalue_bootstrap_UBR_phase1(
        c_, bk, impl=impl).v)(c)
    calls = tpk.ubr_phase1_combine_plain.calls
    got = tbs.multivalue_bootstrap_UBR_phase1(tc, bk_t)
    assert tpk.ubr_phase1_combine_plain.calls == calls + 1
    assert got.vs is None
    np.testing.assert_array_equal(to_numpy(got.v), np.asarray(want, np.uint64))
    return got


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_phase1_matches(impl):
    """Two ciphertexts, one cache each: [2, n/u, J, C, P, N]."""
    key_tlwe, _, bk, bk_t = _jax_setup()
    c, tc = _encrypt(key_tlwe, [2, 1], seed=1)
    got = _phase1_both(c, tc, bk, bk_t, impl)
    assert tuple(got.v.shape) == (2, 4, 4, 2, len(bk.primes), UNFOLD_TEST.N)


def test_phase1_matches_jnp_at_l2_widths():
    """TFHEpp-L2 widths at u=8 (M = 256 key products per group), n cut to
    8 (one group), random key products, one ciphertext."""
    p, u, n = params.TFHEPP_L2, 8, 8
    rng = np.random.default_rng(5)
    primes = tntt.primes_for_bound(
        tntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    su = rng.integers(0, 1 << 64, (n // u, 1 << u, 8, 2, p.N),
                      dtype=np.uint64)
    planes = np.stack([(su & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (su >> np.uint64(32)).astype(np.uint32)])
    bk = jbs.BootstrapKey(v=None, vs=None, su=jnp.asarray(planes), n=n,
                          k=p.k, N=p.N, l=p.l, Bg_bit=p.Bg_bit, unfolding=u,
                          primes=tuple(primes))
    bk_t = bridge.unfolded_bootstrap_key_from_numpy(
        planes, n, p.k, p.N, p.l, p.Bg_bit, primes, u, CPU)
    a = rng.integers(0, 1 << 64, (n,), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (), dtype=np.uint64)
    c = jtlwe.TLWE(a=jnp.asarray(a), b=jnp.asarray(b))
    got = _phase1_both(c, bridge.tlwe_from_numpy(a, b, CPU), bk, bk_t, "jnp")
    assert tuple(got.v.shape) == (1, 8, 2, 3, p.N)


def _luts(seed, n_luts):
    luts = jrng.uniform_torus(jax.random.fold_in(KEY, seed), (n_luts, 4))
    tv = jtrlwe.torus_packing(luts, UNFOLD_TEST.k, UNFOLD_TEST.N)
    return luts, tv, bridge.trlwe_from_numpy(np.asarray(tv.a),
                                             np.asarray(tv.b), CPU)


def _phase2_both(tv, c, ttv, tc, sa_t, bk, bk_t, impl):
    """Phase 2 of both packages on the port's phase-1 cache ``sa_t`` (held
    equal to the TPU package's by the phase-1 tests), handed over as u64
    residues."""
    want = jax.jit(lambda tv_, c_, v_: jbs.multivalue_bootstrap_UBR_phase2(
        tv_, c_, jtrgsw.TRGSWDFT(v=v_, vs=None, l=bk.l, Bg_bit=bk.Bg_bit,
                                 primes=bk.primes), bk, 4, impl=impl))(
        tv, c, jnp.asarray(to_numpy(sa_t.v)))
    calls = tpk.ext_product_apply_scan_plain.calls
    got = tbs.multivalue_bootstrap_UBR_phase2(ttv, tc, sa_t, bk_t, 4)
    assert tpk.ext_product_apply_scan_plain.calls == calls + 1
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))
    return got


def _decrypt_err(got, key_trlwe, want):
    key_out = jtrlwe.extract_tlwe_key(key_trlwe)
    ph = ttlwe.phase(got, bridge.tlwe_key_from_numpy(
        np.asarray(key_out.s), key_out.sigma, CPU))
    d = (to_numpy(ph) - np.asarray(want, np.uint64)).view(np.int64)
    return np.abs(d.astype(np.float64)).max()


def test_phase2_broadcast_cache_matches_tpu_kernel_interpret():
    """One ciphertext (m = 1/8), its cache applied to 3 LUTs: the TPU
    package's jnp phase 2, which its apply-scan kernel in interpret mode
    gives at these widths, u and batch (`tests/test_unfolded_kernel.py::
    test_ubr_phase2_kernel_bit_exact`); K3 meets its interpret-mode TPU
    kernel in `test_torch_external_product.py`."""
    key_tlwe, key_trlwe, bk, bk_t = _jax_setup()
    c, tc = _encrypt(key_tlwe, 1, seed=2)
    sa_t = tbs.multivalue_bootstrap_UBR_phase1(tc, bk_t)
    luts, tv, ttv = _luts(3, 3)
    got = _phase2_both(tv, c, ttv, tc, sa_t, bk, bk_t, "jnp")
    assert _decrypt_err(got, key_trlwe, np.asarray(luts)[:, 1]) <= 2.0**58


def test_phase2_batched_cache_matches_jnp():
    """Three ciphertexts, one cache each, each applied to its own LUT."""
    key_tlwe, key_trlwe, bk, bk_t = _jax_setup()
    c, tc = _encrypt(key_tlwe, [0, 3, 2], seed=4)
    sa_t = tbs.multivalue_bootstrap_UBR_phase1(tc, bk_t)
    luts, tv, ttv = _luts(5, 3)
    got = _phase2_both(tv, c, ttv, tc, sa_t, bk, bk_t, "jnp")
    want = np.asarray(luts)[np.arange(3), [0, 3, 2]]
    assert _decrypt_err(got, key_trlwe, want) <= 2.0**58


def test_port_ubr_phase1_phase2_decrypt():
    """The port alone at u=2: keygen, one ciphertext per message 0..3, its
    phase-1 cache, then phase 2 of 5 LUTs for the ciphertext of m = 2/8
    (broadcast cache) and of one LUT per ciphertext (batched caches), each
    output within 2^58 of its LUT slot."""
    p = UNFOLD_TEST
    gen = torch.Generator().manual_seed(31)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    key_out = ttrlwe.extract_tlwe_key(key_trlwe)
    bk = tbs.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe, gen,
                     CPU, unfolding=U)
    slots = torch.arange(4)
    cs = ttlwe.encrypt(ttorus.double2torus(slots / 8.0), key_tlwe, gen)
    sa = tbs.multivalue_bootstrap_UBR_phase1(cs, bk)
    luts = trng.uniform_torus(gen, (5, 4), CPU)
    tv = ttrlwe.torus_packing(luts, p.k, p.N)

    def err(out, want):
        d = to_numpy(ttlwe.phase(out, key_out) - want).view(np.int64)
        return np.abs(d.astype(np.float64)).max()

    one = ttrgsw.TRGSWDFT(v=sa.v[2], vs=None, l=sa.l, Bg_bit=sa.Bg_bit,
                          primes=sa.primes)
    c2 = ttlwe.TLWE(a=cs.a[2], b=cs.b[2])
    out = tbs.multivalue_bootstrap_UBR_phase2(tv, c2, one, bk, 4)
    assert out.a.shape == (5, p.k * p.N)
    assert err(out, luts[:, 2]) <= 2.0**58
    tv4 = ttrlwe.TRLWE(a=tv.a[:4], b=tv.b[:4])
    out = tbs.multivalue_bootstrap_UBR_phase2(tv4, cs, sa, bk, 4)
    assert err(out, luts[slots, slots]) <= 2.0**58
