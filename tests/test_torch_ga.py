"""The port's GA bootstrap against the TPU package, bit for bit: the Galois
permutations (static, per-row and through discrete logs), the inverse
table, `functional_bootstrap_ga` (so `blind_rotate_ga`) against the jnp
path with key material made by the TPU package, the per-step automorphism
composition, and the port's own GA keygen end to end.  The TPU kernels in
Pallas interpret mode meet the plain versions in `test_torch_ga_kernels.py`
and `test_torch_ga_interpret.py`, the CUDA kernels in
`test_torch_gpu.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap_ga as jga, params, polynomial as jpoly, \
    rng as jrng, tlwe as jtlwe, torus as jtorus, trgsw as jtrgsw, \
    trlwe as jtrlwe
from mosfhet_torch import bootstrap_ga as tga, bridge, polynomial as tpoly, \
    rng as trng, tlwe as ttlwe, torus as ttorus, \
    trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

KEY = jax.random.PRNGKey(2022)
CPU = "cpu"
# Inside the GA envelope n < 2N / torus_base (`tests/test_ga_kernel.py`).
P_GA = params.TFHEParams(
    n=8, N=128, k=1, l=2, Bg_bit=10, t=6, base_bit=4,
    lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44, name="GA_TEST")


@functools.cache
def _jax_keys(p=P_GA):
    """TPU-package keys with a GA bootstrap key, generated as one compiled
    program, once for the whole file."""
    k0, k1, k2 = jax.random.split(KEY, 3)
    key_tlwe = jtlwe.new_binary_key(k0, p.n, p.lwe_sigma)
    key_trlwe = jtrlwe.new_binary_key(k1, p.N, p.k, p.rlwe_sigma)
    gk = jtrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = jax.jit(lambda rk, s: jga.new_key(
        rk, gk, jtlwe.TLWEKey(s=s, sigma=key_tlwe.sigma)))(k2, key_tlwe.s)
    return key_tlwe, key_trlwe, bk


def _port_bk(bk):
    return bridge.ga_bootstrap_key_from_numpy(
        np.asarray(bk.s_v), np.asarray(bk.s_vs), np.asarray(bk.ak_v),
        np.asarray(bk.inv2n), bk.n, bk.k, bk.N, bk.l, bk.Bg_bit, bk.ks_t,
        bk.ks_base_bit, bk.primes, bk.ks_primes, CPU)


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))


@pytest.mark.parametrize("N", [64, 2048])
def test_inverse_mod_2n_table_matches(N):
    got = tga.inverse_mod_2n_table(N)
    np.testing.assert_array_equal(got, jga.inverse_mod_2n_table(N))
    odd = np.arange(1, 2 * N, 2, dtype=np.int64)
    assert np.all((odd * got) % (2 * N) == 1)


def test_permutations_match():
    """`polynomial.permute` / `trlwe.permute` at fixed generators (1 and
    2N-1 among them), `_permute_dyn` and `_permute_log` with one generator
    per row, all against the TPU package's."""
    N = P_GA.N
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 64, (5, 2, N), dtype=np.uint64)
    for gen in (1, 3, 5 ** 7 % (2 * N), 2 * N - 1):
        np.testing.assert_array_equal(
            to_numpy(tpoly.permute(to_tensor(x, CPU), gen)),
            np.asarray(jax.jit(lambda y: jpoly.permute(y, gen))(
                jnp.asarray(x))))
        c = jtrlwe.TRLWE(a=jnp.asarray(x[:, :1]), b=jnp.asarray(x[:, 1]))
        _eq(ttrlwe.permute(bridge.trlwe_from_numpy(x[:, :1], x[:, 1], CPU),
                           gen), jax.jit(lambda y: jtrlwe.permute(y, gen))(c))
    gens = (rng.integers(0, N, 5) * 2 + 1).astype(np.int32)
    gens[0], gens[1] = 1, 2 * N - 1
    inv = tga.inverse_mod_2n_table(N)
    want = np.asarray(jax.jit(lambda *a: jga._permute_dyn(*a, N))(
        jnp.asarray(x), jnp.asarray(gens), jnp.asarray(inv)))
    got = tga._permute_dyn(to_tensor(x, CPU), torch.from_numpy(gens),
                           torch.from_numpy(inv), N)
    np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_array_equal(
        to_numpy(tga._permute_log(to_tensor(x, CPU), torch.from_numpy(gens),
                                  N)),
        np.asarray(jax.jit(lambda *a: jga._permute_log(*a, N))(
            jnp.asarray(x), jnp.asarray(gens))))
    np.testing.assert_array_equal(to_numpy(tga._permute_log(
        to_tensor(x, CPU), torch.from_numpy(gens), N)), want)
    with pytest.raises(ValueError, match="odd"):
        tpoly.permute(to_tensor(x, CPU), 4)


def test_eval_auto_dyn_matches():
    """One step's automorphism (permutation, then the key switch with the
    keyset entry the generator selects) against the TPU package's."""
    _, _, bk = _jax_keys()
    rng = np.random.default_rng(12)
    acc = rng.integers(0, 1 << 64, (4, 2, P_GA.N), dtype=np.uint64)
    gens = (rng.integers(0, P_GA.N, 4) * 2 + 1).astype(np.int32)
    gens[0], gens[-1] = 1, 2 * P_GA.N - 1
    want = jax.jit(lambda x, g: jga._eval_auto_dyn(x, g, bk))(
        jnp.asarray(acc), jnp.asarray(gens))
    got = tga._eval_auto_dyn(to_tensor(acc, CPU), torch.from_numpy(gens),
                             _port_bk(bk))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_functional_bootstrap_ga_matches_and_decrypts():
    """An odd batch of 5 ciphertexts through the TPU package's jnp GA
    rotation (its default off the TPU) and the port's plain K6 and K7, one
    call each: the same words, decrypted within 2^58.  An unbatched test
    vector meets the TPU kernels in `test_torch_ga_interpret.py`."""
    p = P_GA
    key_tlwe, key_trlwe, bk = _jax_keys()
    luts = jrng.uniform_torus(jax.random.fold_in(KEY, 5), (4,))
    tv = jtrlwe.torus_packing(luts, p.k, p.N)
    ms = jtorus.double2torus((jnp.arange(5) % 4) / 8.0)
    cs = jax.jit(jtlwe.encrypt)(ms, key_tlwe, jax.random.fold_in(KEY, 6))
    want = jax.jit(lambda c: jga.functional_bootstrap_ga(tv, c, bk, 4))(cs)
    calls = (tpk.auto_keyswitch_stream_plain.calls,
             tpk.ga_scan_fused_plain.calls)
    got = tga.functional_bootstrap_ga(
        bridge.trlwe_from_numpy(np.asarray(tv.a), np.asarray(tv.b), CPU),
        bridge.tlwe_from_numpy(np.asarray(cs.a), np.asarray(cs.b), CPU),
        _port_bk(bk), 4)
    assert (tpk.auto_keyswitch_stream_plain.calls,
            tpk.ga_scan_fused_plain.calls) == (calls[0] + 1, calls[1] + 1)
    _eq(got, want)
    key_out = jtrlwe.extract_tlwe_key(key_trlwe)
    ph = ttlwe.phase(got, bridge.tlwe_key_from_numpy(np.asarray(key_out.s),
                                                     key_out.sigma, CPU))
    err = (to_numpy(ph) - np.asarray(luts)[np.arange(5) % 4]).view(np.int64)
    assert np.abs(err.astype(np.float64)).max() <= 2.0**58


def test_ga_key_bridge_round_trip():
    _, _, bk = _jax_keys()
    bk_t = _port_bk(bk)
    assert bk_t.ak.dtype == torch.int32 and bk_t.inv2n.dtype == torch.int32
    assert tuple(bk_t.ak.shape) == tuple(bk.ak_v.shape)
    for got, want in zip(bridge.ga_bootstrap_key_to_numpy(bk_t),
                         (bk.s_v, bk.s_vs, bk.ak_v, bk.inv2n)):
        np.testing.assert_array_equal(got, np.asarray(want))
    # the kernels index the keyset by generator unchecked: a key without an
    # entry for every odd generator is refused
    with pytest.raises(ValueError, match="keyset of N=128"):
        bridge.ga_bootstrap_key_from_numpy(
            np.asarray(bk.s_v), np.asarray(bk.s_vs),
            np.asarray(bk.ak_v)[:16], np.asarray(bk.inv2n), bk.n, bk.k,
            bk.N, bk.l, bk.Bg_bit, bk.ks_t, bk.ks_base_bit, bk.primes,
            bk.ks_primes, CPU)


def test_port_ga_keygen_and_bootstrap_decrypt(monkeypatch):
    """The port alone: GA keygen with the keyset in chunks of 48 generators
    (128 = 48 + 48 + 32), encrypt, bootstrap through the plain K6 and K7,
    every slot decrypted to within 2^58."""
    monkeypatch.setattr(tga, "GA_KEYGEN_CHUNK", 48)
    p = P_GA
    gen = torch.Generator().manual_seed(31)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    key_out = ttrlwe.extract_tlwe_key(key_trlwe)
    bk = tga.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe, gen,
                     CPU)
    assert tuple(bk.s_v32.shape) == (p.n, 4, 2, 3, p.N)
    assert tuple(bk.ak.shape) == (p.N, 2, 2, 3, p.N)
    luts = trng.uniform_torus(gen, (4,), CPU)
    tv = ttrlwe.torus_packing(luts, p.k, p.N)
    ms = ttorus.double2torus((torch.arange(8) % 4) / 8.0)
    cs = ttlwe.encrypt(ms, key_tlwe, gen)
    out = tga.functional_bootstrap_ga(tv, cs, bk, 4)
    err = to_numpy(ttlwe.phase(out, key_out) - luts[torch.arange(8) % 4])
    assert np.abs(err.view(np.int64).astype(np.float64)).max() <= 2.0**58


def test_ga_keygen_refuses_to_pick_the_cpu(monkeypatch):
    """Without a card, GA keygen called without ``device`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = P_GA
    gen = torch.Generator().manual_seed(1)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tga.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe, gen)
