"""The port's TRLWE key switch and Galois automorphisms against the TPU
package, bit for bit: `trlwe_keyswitch` and `eval_automorphism` with key
material made by the TPU package's keygens (jnp path), the key's bridge,
and the port's own keygens end to end (decryption).  Both run through the
automorphism key switch's plain version here; the CUDA kernel is held
against it in `test_torch_gpu.py`, the TPU kernel in
`test_torch_ga_kernels.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import keyswitch as jks, params, polynomial as jpoly, \
    trlwe as jtrlwe
from mosfhet_torch import bridge, keyswitch as tks, polynomial as tpoly, \
    rng as trng, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk

KEY = jax.random.PRNGKey(5150)
CPU = "cpu"
P = params.TFHEParams(
    n=8, N=128, k=1, l=2, Bg_bit=10, t=4, base_bit=9,
    lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44, name="TRLWE_KS_TEST")
GENS = (3, 2 * P.N - 1)
# At these widths the switch adds sigma ~2^31.8 (k t N = 512 digit x noise
# products, |digit| <= 2^8, key noise 2^20 in words; the dropped 2^-36 of
# each mask word against the binary key adds ~2^29.2): 2^40 is ~2^8 sigma.
KS_BOUND = 2.0**40


@functools.cache
def _jax_keys():
    """Two ring keys, the KS key from the second to the first and the
    first key's automorphism keyset for GENS, as compiled programs."""
    k0, k1, k2, k3 = jax.random.split(KEY, 4)
    key = jtrlwe.new_binary_key(k0, P.N, P.k, P.rlwe_sigma)
    key2 = jtrlwe.new_binary_key(k1, P.N, P.k, P.rlwe_sigma)
    ksk = jax.jit(lambda rk: jks.new_trlwe_ks_key(rk, key, key2, P.t,
                                                  P.base_bit))(k2)
    keyset = jax.jit(lambda rk: jks.new_automorphism_ks_keyset(
        rk, key, GENS, P.t, P.base_bit))(k3)
    return key, key2, ksk, keyset


def _port_ksk(ksk):
    return bridge.trlwe_ks_key_from_numpy(np.asarray(ksk.v), ksk.t,
                                          ksk.base_bit, ksk.primes, CPU)


def _random_trlwe(seed, batch):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 64, batch + (P.k, P.N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, batch + (P.N,), dtype=np.uint64)
    return (jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
            bridge.trlwe_from_numpy(a, b, CPU))


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))


def test_trlwe_keyswitch_matches_jnp():
    """A [2, 3] batch of random TRLWEs: one plain call, the jnp words."""
    _, _, ksk, _ = _jax_keys()
    c_j, c_t = _random_trlwe(1, (2, 3))
    calls = tpk.auto_keyswitch_stream_plain.calls
    got = tks.trlwe_keyswitch(c_t, _port_ksk(ksk))
    assert tpk.auto_keyswitch_stream_plain.calls == calls + 1
    assert got.a.shape == (2, 3, P.k, P.N)
    _eq(got, jax.jit(jks.trlwe_keyswitch)(c_j, ksk))


@pytest.mark.parametrize("gen", GENS)
def test_eval_automorphism_matches_jnp(gen):
    _, _, _, keyset = _jax_keys()
    c_j, c_t = _random_trlwe(gen, (4,))
    want = jax.jit(lambda c: jks.eval_automorphism(c, gen, keyset[gen]))(c_j)
    _eq(tks.eval_automorphism(c_t, gen, _port_ksk(keyset[gen])), want)
    # and it is the key switch of the permuted ciphertext
    _eq(tks.trlwe_keyswitch(ttrlwe.permute(c_t, gen),
                            _port_ksk(keyset[gen])), want)


def test_trlwe_ks_key_bridge_round_trip():
    _, _, ksk, _ = _jax_keys()
    ksk_t = _port_ksk(ksk)
    assert ksk_t.v32.dtype == torch.int32 and ksk_t.k_in == P.k
    np.testing.assert_array_equal(bridge.trlwe_ks_key_to_numpy(ksk_t),
                                  np.asarray(ksk.v))
    assert ksk_t.primes == tuple(ksk.primes)


def test_permute_of_key_matches():
    """The keyset's permuted keys: `polynomial.permute` of small signed
    keys, as int64 words, equals the TPU package's."""
    s = np.array([[1, 0, -1, 2] * (P.N // 4)], np.int64)
    for gen in GENS:
        np.testing.assert_array_equal(
            tpoly.permute(torch.from_numpy(s), gen).numpy(),
            np.asarray(jpoly.permute(jnp.asarray(s.astype(np.uint64)),
                                     gen)).view(np.int64))


def test_port_keygens_and_switches_decrypt():
    """The port alone: a KS key from a second ring key, the automorphism
    keyset for GENS, then 6 TRLWEs switched and automorphed, each within
    KS_BOUND of its message (the permuted message for an automorphism)."""
    gen = torch.Generator().manual_seed(41)
    key = ttrlwe.new_binary_key(P.N, P.k, P.rlwe_sigma, gen, CPU)
    key2 = ttrlwe.new_binary_key(P.N, P.k, P.rlwe_sigma, gen, CPU)
    ksk = tks.new_trlwe_ks_key(key, key2, P.t, P.base_bit, gen, CPU)
    assert tuple(ksk.v32.shape) == (P.k, P.t, P.k + 1, 3, P.N)
    keyset = tks.new_automorphism_ks_keyset(key, GENS, P.t, P.base_bit, gen,
                                            CPU)
    assert sorted(keyset) == sorted(GENS)
    m = trng.uniform_torus(gen, (6, P.N), CPU)

    def err(c, want):
        d = to_numpy(ttrlwe.phase(c, key) - want).view(np.int64)
        return np.abs(d.astype(np.float64)).max()

    assert err(tks.trlwe_keyswitch(ttrlwe.encrypt(m, key2, gen), ksk),
               m) <= KS_BOUND
    for g in GENS:
        c = ttrlwe.encrypt(m, key, gen)
        assert err(tks.eval_automorphism(c, g, keyset[g]),
                   tpoly.permute(m, g)) <= KS_BOUND
    assert tks.all_odd_gens(4) == (1, 3, 5, 7)


def test_keyswitch_refuses_mismatched_keys(monkeypatch):
    """A key for k_in != k_out and an even generator are refused; without a
    card, keygen called without ``device`` raises."""
    gen = torch.Generator().manual_seed(42)
    key = ttrlwe.new_binary_key(P.N, 1, P.rlwe_sigma, gen, CPU)
    key2 = ttrlwe.new_binary_key(P.N, 2, P.rlwe_sigma, gen, CPU)
    ksk = tks.new_trlwe_ks_key(key, key2, P.t, P.base_bit, gen, CPU)
    with pytest.raises(ValueError, match="does not switch"):
        tks.trlwe_keyswitch(ttrlwe.encrypt(None, key2, gen), ksk)
    with pytest.raises(ValueError, match="odd"):
        tks.eval_automorphism(ttrlwe.encrypt(None, key, gen), 4, ksk)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tks.new_trlwe_ks_key(key, key, P.t, P.base_bit, gen)
