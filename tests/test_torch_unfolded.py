"""The port's unfolded bootstrap against the TPU package, bit for bit: the
unfolded rotation's plain version and `blind_rotate_unfolded` against the
TPU kernel `unfolded_rotate` in Pallas interpret mode (u=2, random key
products) and the jnp path (u=4, key material made by the TPU package), and
against the jnp path at TFHEpp-L2 widths (u=4 and 8, random key products);
the bootstrap with an unfolded key, the port's own unfolded keygen end to end,
the rotation exponents and the key's bridge.  The CUDA kernel itself is
held against the plain version in `test_torch_gpu.py`."""

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

KEY = jax.random.PRNGKey(1618)
CPU = "cpu"
UNFOLD_TEST = params.TFHEParams(
    n=8, N=128, k=1, l=2, Bg_bit=10, t=6, base_bit=4,
    lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44, name="UNFOLD_TEST")


@functools.cache
def _jax_keys(u, p=UNFOLD_TEST):
    """TPU-package keys with an unfolded bootstrap key, generated as one
    compiled program, once per unfolding for the whole file."""
    k0, k1, k2 = jax.random.split(jax.random.fold_in(KEY, u), 3)
    key_tlwe = jtlwe.new_binary_key(k0, p.n, p.lwe_sigma)
    key_trlwe = jtrlwe.new_binary_key(k1, p.N, p.k, p.rlwe_sigma)
    gk = jtrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = jax.jit(lambda rk, kt: jbs.new_key(rk, gk, kt, u))(k2, key_tlwe)
    return key_tlwe, key_trlwe, bk


def _port_bk(bk):
    return bridge.unfolded_bootstrap_key_from_numpy(
        np.asarray(bk.su), bk.n, bk.k, bk.N, bk.l, bk.Bg_bit, bk.primes,
        bk.unfolding, CPU)


def _random_bk(p, n, u, seed):
    """Both packages' keys holding the same random key products at the
    widths of ``p`` with ``n`` mask coefficients."""
    rng = np.random.default_rng(seed)
    primes = tntt.primes_for_bound(
        tntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    C = p.k + 1
    su = rng.integers(0, 1 << 64, (n // u, 1 << u, C * p.l, C, p.N),
                      dtype=np.uint64)
    planes = np.stack([(su & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (su >> np.uint64(32)).astype(np.uint32)])
    bk_j = jbs.BootstrapKey(v=None, vs=None, su=jnp.asarray(planes), n=n,
                            k=p.k, N=p.N, l=p.l, Bg_bit=p.Bg_bit,
                            unfolding=u, primes=tuple(primes))
    return bk_j, _port_bk(bk_j)


def _rotate_both(p, bk_j, bk_t, B, seed, impl="jnp"):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 64, (B, p.k, p.N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (B, p.N), dtype=np.uint64)
    mask = rng.integers(0, 1 << 64, (B, bk_j.n), dtype=np.uint64)
    want = jax.jit(lambda tv, m: jbs.blind_rotate_unfolded(
        tv, m, bk_j, impl=impl))(
        jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)), jnp.asarray(mask))
    calls = tpk.unfolded_rotate_plain.calls
    got = tbs.blind_rotate_unfolded(bridge.trlwe_from_numpy(a, b, CPU),
                                    bridge.to_tensor(mask, CPU), bk_t)
    assert tpk.unfolded_rotate_plain.calls == calls + 1
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))


def test_blind_rotate_unfolded_matches_tpu_kernel_interpret():
    """u=2 against the TPU kernel `unfolded_rotate` in interpret mode, with
    random key products and a ragged batch of 5 (the TPU package pads it
    to its tile)."""
    bk_j, bk_t = _random_bk(UNFOLD_TEST, 8, 2, seed=2)
    _rotate_both(UNFOLD_TEST, bk_j, bk_t, B=5, seed=3,
                 impl="pallas_interpret")


def test_blind_rotate_unfolded_matches_jnp():
    """u=4 with key material from the TPU package's keygen, a ragged batch
    of 5, against the jnp path."""
    _, _, bk = _jax_keys(4)
    _rotate_both(UNFOLD_TEST, bk, _port_bk(bk), B=5, seed=4)


@pytest.mark.parametrize("u", [4, 8])
def test_blind_rotate_unfolded_matches_jnp_at_l2_widths(u):
    """TFHEpp-L2 widths (N=2048, k=1, l=4, Bg_bit=9, 3 primes) with n cut
    to 8 mask coefficients (G = 2 groups at u=4, 1 at u=8)."""
    p = params.TFHEPP_L2
    bk_j, bk_t = _random_bk(p, 8, u, seed=100 + u)
    assert tuple(bk_t.su.shape) == (8 // u, 1 << u, 8, 2, p.N)
    _rotate_both(p, bk_j, bk_t, B=3 if u == 4 else 1, seed=200 + u)


def _lut_inputs(p, key_tlwe, seed, batch):
    luts = jrng.uniform_torus(jax.random.fold_in(KEY, seed), (4,))
    tv = jtrlwe.torus_packing(luts, p.k, p.N)
    ms = jtorus.double2torus((jnp.arange(batch) % 4) / 8.0)
    cs = jtlwe.encrypt(ms, key_tlwe, jax.random.fold_in(KEY, seed + 1))
    ttv = bridge.trlwe_from_numpy(np.asarray(tv.a), np.asarray(tv.b), CPU)
    tcs = bridge.tlwe_from_numpy(np.asarray(cs.a), np.asarray(cs.b), CPU)
    return luts, tv, cs, ttv, tcs


def test_functional_bootstrap_with_unfolded_key_matches():
    """functional_bootstrap takes an unfolded key unchanged (u=4), and
    decrypts."""
    p = UNFOLD_TEST
    key_tlwe, key_trlwe, bk = _jax_keys(4)
    bk_t = _port_bk(bk)
    luts, tv, cs, ttv, tcs = _lut_inputs(p, key_tlwe, 10, batch=6)
    want = jax.jit(lambda c: jbs.functional_bootstrap(tv, c, bk, 4))(cs)
    got = tbs.functional_bootstrap(ttv, tcs, bk_t, 4)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))
    key_out = jtrlwe.extract_tlwe_key(key_trlwe)
    ph = ttlwe.phase(got, bridge.tlwe_key_from_numpy(
        np.asarray(key_out.s), key_out.sigma, CPU))
    err = (to_numpy(ph) - np.asarray(luts)[np.arange(6) % 4]).view(np.int64)
    assert np.abs(err.astype(np.float64)).max() <= 2.0**58


def test_port_unfolded_keygen_and_bootstrap_decrypt(monkeypatch):
    """The port alone at u=2: keygen in chunks of 5 TRGSWs (16 in all),
    encrypt, bootstrap through the unfolded rotation's plain version,
    decrypt every slot to within 2^58."""
    monkeypatch.setattr(tbs, "KEYGEN_CHUNK", 5)
    p = UNFOLD_TEST
    gen = torch.Generator().manual_seed(29)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    key_out = ttrlwe.extract_tlwe_key(key_trlwe)
    bk = tbs.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe, gen,
                     CPU, unfolding=2)
    assert bk.su.dtype == torch.int64 and bk.v32 is None
    assert tuple(bk.su_u64().shape) == (4, 4, 4, 2, p.N)
    luts = trng.uniform_torus(gen, (4,), CPU)
    tv = ttrlwe.torus_packing(luts, p.k, p.N)
    ms = ttorus.double2torus((torch.arange(8) % 4) / 8.0)
    cs = ttlwe.encrypt(ms, key_tlwe, gen)
    calls = (tpk.unfolded_rotate_plain.calls,
             tpk.blind_rotate_scan_plain.calls)
    out = tbs.functional_bootstrap(tv, cs, bk, 4)
    assert (tpk.unfolded_rotate_plain.calls,
            tpk.blind_rotate_scan_plain.calls) == (calls[0] + 1, calls[1])
    err = to_numpy(ttlwe.phase(out, key_out) - luts[torch.arange(8) % 4])
    assert np.abs(err.view(np.int64).astype(np.float64)).max() <= 2.0**58


def test_unfold_rotations_match_and_2n_is_the_identity():
    """Exponents equal the TPU package's, in [0, 2N): a group sum that rounds
    to 2N wraps to 0 in both.  The rotation's plain version takes 2N as the
    identity, the same words as 0."""
    p = UNFOLD_TEST
    bk_j, bk_t = _random_bk(p, 8, 2, seed=300)
    rng = np.random.default_rng(301)
    mask = rng.integers(0, 1 << 64, (3, 8), dtype=np.uint64)
    mask[0, :2] = [(1 << 64) - 1, 0]             # rounds to 2N
    mask[1, :2] = [(1 << 63), (1 << 63) - 1]     # sums to 2^64 - 1
    mask[2, :2] = [1 << 56, 1 << 56]             # 2^57 = 2 * 2^64 / 2N
    want = np.asarray(jbs._unfold_rotations(jnp.asarray(mask), bk_j))
    got = tbs._unfold_rotations(bridge.to_tensor(mask, CPU), bk_t)
    assert got.dtype == torch.int32 and got.shape == (3, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 1] == 0 and got[1, 0, 3] == 0 and got[2, 0, 3] == 2
    assert int(got.min()) >= 0 and int(got.max()) < 2 * p.N
    kp = bk_t.kernel_plan()
    acc0 = bridge.to_tensor(rng.integers(0, 1 << 64, (2, 2, p.N),
                                         dtype=np.uint64), CPU)
    su = bk_t.su[:1, :, :, :, :]
    zero = tpk.unfolded_rotate_plain(
        acc0, torch.zeros((2, 1, 4), dtype=torch.int32), su, kp)
    full = tpk.unfolded_rotate_plain(
        acc0, torch.full((2, 1, 4), 2 * p.N, dtype=torch.int32), su, kp)
    assert torch.equal(zero, full)


def test_unfolded_key_bridge_round_trip():
    _, _, bk = _jax_keys(4)
    bk_t = _port_bk(bk)
    assert bk_t.su.dtype == torch.int64
    assert tuple(bk_t.su.shape) == tuple(bk.su.shape[1:])
    np.testing.assert_array_equal(bridge.unfolded_bootstrap_key_to_numpy(bk_t),
                                  np.asarray(bk.su))
    np.testing.assert_array_equal(to_numpy(bk_t.su_u64()),
                                  np.asarray(bk.su_u64()))
