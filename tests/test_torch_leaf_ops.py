"""The port's leaf helpers of `trlwe`, `ntt`, `polynomial`, `torus` and `rng`
against the TPU package, bit for bit (no tolerance), at TOY and TOY_K2
widths: the NTT-domain TRLWE, the linear ops and multi-value extraction,
the modular primitives and monomial spectra, the 128-bit CRT readback
(`garner_u128`, `garner_shifted_u64`, `full_mul_with_scale`) also against a
Python big-int oracle, and the exact polynomial products.  Random keys
cannot equal `jax.random`'s streams, so the seven TRLWE key generators are
held to their definitions instead.  The JAX side is jitted where eager
dispatch would dominate."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import (ntt as jntt, params, polynomial as jpoly,
                         torus as jtorus, trlwe as jtrlwe)
from mosfhet_torch import (bridge, ntt as tntt, polynomial as tpoly,
                           rng as trng, torus as ttorus, trlwe as ttrlwe)
from mosfhet_torch.bridge import to_numpy, to_tensor

CPU = "cpu"
M64, M128 = 1 << 64, 1 << 128
PARAMS = [params.TOY, params.TOY_K2]


def _words(rs, shape):
    return rs.integers(0, M64, shape, dtype=np.uint64)


def _residues(rs, batch, primes, N):
    pr = np.array(primes, np.uint64)[:, None]
    return rs.integers(0, 1 << 62, batch + (len(primes), N),
                       dtype=np.uint64) % pr


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _oracle_u128(a, b):
    """The negacyclic product of unsigned words mod 2^128, accumulated as
    the reference's ``__uint128_t`` (`fft/karatsuba.c:61-90`)."""
    N = len(a)
    acc = [0] * N
    for i in range(N):
        for j in range(N):
            v = int(a[i]) * int(b[j])
            if i + j >= N:
                acc[i + j - N] = (acc[i + j - N] - v) % M128
            else:
                acc[i + j] = (acc[i + j] + v) % M128
    return acc


# --- ntt ----------------------------------------------------------------------

@pytest.mark.parametrize("primes", [jntt.DEFAULT_PRIMES, jntt.TENSOR_PRIMES],
                         ids=["default", "tensor"])
def test_ntt_leaf_helpers_match(primes):
    """TENSOR_PRIMES, the monomial tables, sub, neg, scale_u64,
    pointwise_mul_key, to_resi_u64_raw, barrett_mul and xpow."""
    N = 64
    assert tntt.TENSOR_PRIMES == jntt.TENSOR_PRIMES
    jp, tp = jntt.get_plan(N, primes), tntt.get_plan(N, primes, CPU)
    for name in ("xpow2", "xpow2_shoup"):
        _same(getattr(tp, name), getattr(jp, name))
    rs = np.random.default_rng(len(primes))
    a, b = _residues(rs, (3,), primes, N), _residues(rs, (3,), primes, N)
    a[0, :, :3] = 0
    ta, tb = to_tensor(a, CPU), to_tensor(b, CPU)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _same(tntt.sub(ta, tb, tp), jntt.sub(ja, jb, jp))
    _same(tntt.neg(ta, tp), jntt.neg(ja, jp))
    for c in (0, 3, (1 << 63) + 12345, M64 - 1):
        _same(tntt.scale_u64(ta, c, tp), jntt.scale_u64(ja, c, jp))
    c = np.uint64(M64 - 7)
    _same(tntt.scale_u64(ta, to_tensor(c, CPU), tp),
          jntt.scale_u64(ja, jnp.asarray(c), jp))
    bs = (b << np.uint64(32)) // np.array(primes, np.uint64)[:, None]
    _same(tntt.pointwise_mul_key(ta, tb, to_tensor(bs, CPU), tp),
          jntt.pointwise_mul_key(ja, jb, jnp.asarray(bs), jp))
    _same(tntt.barrett_mul(ta, tb, tp), jntt.barrett_mul(ja, jb, jp))
    x = _words(rs, (2, N))
    x[0, :4] = [0, 1, M64 - 1, 1 << 63]
    _same(tntt.to_resi_u64_raw(to_tensor(x, CPU), tp),
          jntt.to_resi_u64_raw(jnp.asarray(x), jp))
    e = rs.integers(0, 2 * N + 1, (2, 5), dtype=np.int32)
    e[0, :3] = [0, N, 2 * N]
    _same(tntt.xpow(torch.from_numpy(e), tp), jntt.xpow(jnp.asarray(e), jp))
    # X^a is diagonal in the NTT domain: xpow(1) times NTT(u) = NTT(X u)
    u = to_tensor(x, CPU)
    _same(tntt.pointwise_mul(tntt.to_ntt_u64(u, tp), tntt.xpow(
        torch.ones(2, dtype=torch.int64), tp), tp),
        tntt.to_ntt_u64(tpoly.mul_by_xai(u, 1), tp))


def test_barrett_mul_refuses_a_narrow_prime():
    narrow = (536608769, 536641537, 536690689)
    tp = tntt.get_plan(64, narrow, CPU)
    x = torch.ones(3, 64, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^30 / 1.75"):
        tntt.barrett_mul(x, x, tp)


def test_garner_u128_and_shifted_match_big_int_oracle():
    """Random values over the whole centred CRT range of TENSOR_PRIMES (and
    the range's edges of a centred top digit), reconstructed mod 2^128 and
    shifted by 0, 1, 20, 63 and 64, against Python ints and the TPU
    package."""
    N = 64
    primes = jntt.TENSOR_PRIMES
    jp, tp = jntt.get_plan(N, primes), tntt.get_plan(N, primes, CPU)
    M = math.prod(primes)
    rs = np.random.default_rng(128)
    vals = [int.from_bytes(rs.bytes(20), "little") % M for _ in range(N - 6)]
    vals += [0, 1, M - 1, M // 3, M - M // 3, M128 % M]
    r = np.array([[v % p for v in vals] for p in primes], np.uint64)
    lo, hi = tntt.garner_u128(to_tensor(r, CPU), tp)
    jlo, jhi = jntt.garner_u128(jnp.asarray(r), jp)
    _same(lo, jlo)
    _same(hi, jhi)
    half = (primes[-1] // 2 + 1) * math.prod(primes[:-1])
    want = [(v if v < half else v - M) % M128 for v in vals]
    got = [int(a) | (int(b) << 64)
           for a, b in zip(to_numpy(lo), to_numpy(hi))]
    assert got == want
    for s in (0, 1, 20, 63, 64):
        shifted = tntt.garner_shifted_u64(to_tensor(r, CPU), tp, s)
        _same(shifted, jntt.garner_shifted_u64(jnp.asarray(r), jp, s))
        assert [int(v) for v in to_numpy(shifted)] == \
            [(w >> s) % M64 for w in want]


# --- polynomial ---------------------------------------------------------------

def test_polynomial_products_match():
    """naive_negacyclic_mul, ntt_mul (5 primes), ntt_mul_small,
    ntt_mul_small_small and torus_scale_round, batched, against the TPU
    package and each other."""
    N = 64
    rs = np.random.default_rng(64)
    a, b = _words(rs, (3, N)), _words(rs, (3, N))
    a[0, :2] = [M64 - 1, 1 << 63]
    ta, tb = to_tensor(a, CPU), to_tensor(b, CPU)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    d = rs.integers(-256, 256, (3, N), dtype=np.int32)
    s1 = rs.integers(-3, 4, (2, N), dtype=np.int64)
    s2 = rs.integers(-20, 21, (2, N), dtype=np.int64)
    jplan_s = jntt.get_plan(N, jntt.DEFAULT_PRIMES)

    def jax_side(a, b, d, s1, s2):
        return (jpoly.naive_negacyclic_mul(a, b), jpoly.ntt_mul(a, b),
                jpoly.ntt_mul_small(d, b, jplan_s),
                jpoly.ntt_mul_small_small(s1, s2, 3, 20),
                [jpoly.torus_scale_round(a, s) for s in (1, 8, 31)])

    want = jax.jit(jax_side)(ja, jb, jnp.asarray(d), jnp.asarray(s1),
                             jnp.asarray(s2))
    naive = tpoly.naive_negacyclic_mul(ta, tb)
    _same(naive, want[0])
    prod = tpoly.ntt_mul(ta, tb)
    _same(prod, want[1])
    assert torch.equal(prod, naive)
    plan_s = tntt.get_plan(N, jntt.DEFAULT_PRIMES, CPU)
    _same(tpoly.ntt_mul_small(torch.from_numpy(d), tb, plan_s), want[2])
    got = tpoly.ntt_mul_small_small(torch.from_numpy(s1),
                                    torch.from_numpy(s2), 3, 20)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want[3]))
    for log_scale, w in zip((1, 8, 31), want[4]):
        _same(tpoly.torus_scale_round(ta, log_scale), w)


@pytest.mark.parametrize("bit_scale", [0, 1, 63, 64])
def test_full_mul_with_scale_matches_big_int_oracle(bit_scale):
    """The 128-bit product of unsigned representatives (top bits set in
    both operands), shifted, against Python ints and the TPU package."""
    N = 32
    rs = np.random.default_rng(bit_scale)
    a, b = _words(rs, (2, N)), _words(rs, (2, N))
    a[0, :3] = [M64 - 1, 1 << 63, 0]
    b[0, :2] = [M64 - 1, M64 - 1]
    got = tpoly.full_mul_with_scale(to_tensor(a, CPU), to_tensor(b, CPU),
                                    bit_scale)
    _same(got, jpoly.full_mul_with_scale(jnp.asarray(a), jnp.asarray(b),
                                         bit_scale))
    for row in range(2):
        want = [(v >> bit_scale) % M64 for v in _oracle_u128(a[row], b[row])]
        assert [int(v) for v in to_numpy(got[row])] == want


# --- torus and rng --------------------------------------------------------------

def test_torus_helpers_match():
    assert ttorus.TORUS_MASK == jtorus.TORUS_MASK == M64 - 1
    assert ttorus.SIGNED_DTYPE == torch.int64
    rs = np.random.default_rng(7)
    x = _words(rs, 4096)
    x[:6] = [0, 1, M64 - 1, 1 << 63, (1 << 63) - 1, M64 - (1 << 10) - 1]
    d = ttorus.torus2double(to_tensor(x, CPU))
    assert d.dtype == torch.float64
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(jtorus.torus2double(x)))
    for Bg_bit, l in ((9, 4), (8, 3), (10, 6)):
        dig = rs.integers(-(1 << (Bg_bit - 1)), 1 << (Bg_bit - 1),
                          (3, l, 64), dtype=np.int32)
        _same(ttorus.gadget_recompose(torch.from_numpy(dig), Bg_bit),
              jtorus.gadget_recompose(jnp.asarray(dig), Bg_bit))
        # recompose undoes decompose up to its rounding
        y = to_tensor(x[:64], CPU)
        back = ttorus.gadget_recompose(
            ttorus.gadget_decompose(y, Bg_bit, l), Bg_bit)
        err = (y - back).abs().max()
        assert int(err) <= 1 << (64 - l * Bg_bit - 1)


def test_rng_new_seed_and_split():
    """new_seed draws fresh OS entropy; split is a function of the parent's
    state, its children are distinct, on the parent's device, and do not
    replay the parent."""
    assert trng.new_seed().initial_seed() != trng.new_seed().initial_seed()
    kids = [trng.split(torch.Generator().manual_seed(5), 4) for _ in range(2)]
    seeds = [[g.initial_seed() for g in ks] for ks in kids]
    assert seeds[0] == seeds[1] and len(set(seeds[0])) == 4
    assert all(g.device == torch.device("cpu") for g in kids[0])
    parent = torch.Generator().manual_seed(5)
    trng.split(parent, 4)
    draws = {tuple(torch.randint(0, 1 << 30, (8,), generator=g).tolist())
             for g in kids[0] + [parent]}
    assert len(draws) == 5
    assert len(trng.split(torch.Generator().manual_seed(1))) == 2


# --- trlwe ----------------------------------------------------------------------

def _jax_key(p, seed):
    key = jtrlwe.new_binary_key(jax.random.PRNGKey(seed), p.N, p.k,
                                p.rlwe_sigma)
    return key, bridge.trlwe_key_from_numpy(np.asarray(key.s), key.sigma,
                                            key.s_bound, CPU)


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_trlwe_dft_ops_match(p):
    """to_dft (with and without companions), from_dft, dft_add, dft_sub
    and dft_phase on JAX-made ciphertexts, through the bridge both ways."""
    jkey, tkey = _jax_key(p, p.k)
    rs = np.random.default_rng(p.N + p.k)
    m = _words(rs, (3, p.N))
    c = jax.jit(jtrlwe.encrypt)(jnp.asarray(m), jkey,
                                jax.random.PRNGKey(11))
    c2 = jax.jit(jtrlwe.encrypt)(jnp.asarray(m[::-1].copy()), jkey,
                                 jax.random.PRNGKey(12))
    jplan = jkey.plan()
    tplan = tkey.plan()
    assert tplan.primes == jplan.primes

    def jax_side(c, c2):
        d = jtrlwe.to_dft(c, jplan, with_shoup=True)
        d2 = jtrlwe.to_dft(c2, jplan)
        return (d.v, d.vs, jtrlwe.dft_add(d, d2).v, jtrlwe.dft_sub(d, d2).v,
                jtrlwe.from_dft(d).a, jtrlwe.dft_phase(d, jkey))

    jv, jvs, jadd, jsub, jfa, jph = jax.jit(jax_side)(c, c2)
    tc = bridge.trlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)
    tc2 = bridge.trlwe_from_numpy(np.asarray(c2.a), np.asarray(c2.b), CPU)
    td = ttrlwe.to_dft(tc, tplan, with_shoup=True)
    assert td.k == p.k and td.N == p.N and td.primes == jplan.primes
    _same(td.v, jv)
    _same(td.vs, jvs)
    v, vs = bridge.trlwe_dft_to_numpy(td)
    back = bridge.trlwe_dft_from_numpy(v, vs, td.primes, CPU)
    assert torch.equal(back.v, td.v) and torch.equal(back.vs, td.vs)
    td2 = ttrlwe.to_dft(tc2, tplan)
    assert td2.vs is None
    _same(ttrlwe.dft_add(td, td2).v, jadd)
    _same(ttrlwe.dft_sub(td, td2).v, jsub)
    f = ttrlwe.from_dft(td)
    _same(f.a, jfa)
    assert torch.equal(f.a, tc.a) and torch.equal(f.b, tc.b)
    ph = ttrlwe.dft_phase(td, tkey)
    _same(ph, jph)
    assert torch.equal(ph, ttrlwe.phase(tc, tkey))


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_trlwe_linear_ops_and_extraction_match(p):
    """add, sub, neg, scale (per batch), mul_by_xai_minus_1 (per batch,
    0, N and 2N present) and the three multi-value extractions."""
    rs = np.random.default_rng(p.k)
    a, b = _words(rs, (4, p.k, p.N)), _words(rs, (4, p.N))
    a2, b2 = _words(rs, (4, p.k, p.N)), _words(rs, (4, p.N))
    jc, jc2 = jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)), \
        jtrlwe.TRLWE(a=jnp.asarray(a2), b=jnp.asarray(b2))
    tc, tc2 = bridge.trlwe_from_numpy(a, b, CPU), \
        bridge.trlwe_from_numpy(a2, b2, CPU)

    def same_c(got, want):
        _same(got.a, want.a)
        _same(got.b, want.b)

    same_c(ttrlwe.add(tc, tc2), jtrlwe.add(jc, jc2))
    same_c(ttrlwe.sub(tc, tc2), jtrlwe.sub(jc, jc2))
    same_c(ttrlwe.neg(tc), jtrlwe.neg(jc))
    w = np.array([0, 1, 7, M64 - 3], np.uint64)
    same_c(ttrlwe.scale(tc, to_tensor(w, CPU)), jtrlwe.scale(jc,
                                                             jnp.asarray(w)))
    same_c(ttrlwe.scale(tc, 5), jtrlwe.scale(jc, 5))
    e = np.array([0, p.N, 2 * p.N, 17], np.int32)
    same_c(ttrlwe.mul_by_xai_minus_1(tc, torch.from_numpy(e)),
           jtrlwe.mul_by_xai_minus_1(jc, jnp.asarray(e)))
    same_c(ttrlwe.mul_by_xai_minus_1(tc, 3), jtrlwe.mul_by_xai_minus_1(jc, 3))
    for amount in (2, 4, 5):
        got = ttrlwe.mv_extract_tlwe(tc, amount)
        want = jtrlwe.mv_extract_tlwe(jc, amount)
        assert len(got) == len(want) == amount
        for g, w_ in zip(got, want):
            same_c(g, w_)
        same_c(ttrlwe.mv_extract_tlwe_scaling(tc, amount),
               jtrlwe.mv_extract_tlwe_scaling(jc, amount))
        same_c(ttrlwe.mv_extract_tlwe_scaling_delta(tc, amount),
               jtrlwe.mv_extract_tlwe_scaling_delta(jc, amount))


@pytest.mark.parametrize("p", PARAMS, ids=lambda p: p.name)
def test_trlwe_key_generators_keep_their_definitions(p):
    """Each generator's weight (per polynomial or in total), values, 0 -> 1
    remap, range and s_bound; and a key of each encrypts and decrypts."""
    N, k, h = p.N, p.k, 10
    gen = torch.Generator().manual_seed(p.N * p.k)
    sig = p.rlwe_sigma

    def per_poly_weight(s):
        return (s != 0).sum(-1).tolist()

    key = ttrlwe.new_bounded_key(N, k, 8, sig, gen, CPU)
    assert key.s.shape == (k, N) and key.s_bound == 4
    assert set(key.s.unique().tolist()) <= set(range(-3, 5))
    assert len(key.s.unique()) == 8
    key = ttrlwe.new_ternary_key(N, k, h, sig, gen, CPU)
    assert per_poly_weight(key.s) == [h] * k and key.s_bound == 1
    for row in key.s:
        nz = row[row != 0]
        assert sorted(nz.tolist()) == sorted([1, -1] * (h // 2))
    key = ttrlwe.new_sparse_ternary_key(N, k, h + 1, sig, gen, CPU)
    assert int((key.s != 0).sum()) == h + 1 and key.s_bound == 1
    assert sorted(key.s[key.s != 0].tolist()) == [-1] * (h // 2) + \
        [1] * (h // 2 + 1)
    key = ttrlwe.new_sparse_binary_key(N, k, h, sig, gen, CPU)
    assert per_poly_weight(key.s) == [h] * k
    assert set(key.s.unique().tolist()) == {0, 1} and key.s_bound == 1
    key = ttrlwe.new_gaussian_key(N, k, 3.0, sig, gen, CPU)
    assert key.sigma == sig and key.s_bound == max(1, int(key.s.abs().max()))
    assert key.s.abs().max() < 30 and len(key.s.unique()) > 3
    key = ttrlwe.new_sparse_gaussian_key(N, k, h, 0.4, sig, gen, CPU)
    assert per_poly_weight(key.s) == [h] * k
    assert key.s_bound == max(1, int(key.s.abs().max()))
    assert 1 in key.s.tolist()[0] + key.s.tolist()[-1]    # the 0 -> 1 remap
    key = ttrlwe.new_sparse_generic_key(N, k, h, 4, sig, gen, CPU)
    assert per_poly_weight(key.s) == [h] * k and key.s_bound == 2
    assert set(key.s[key.s != 0].tolist()) <= {-1, 1, 2}
    for key in (ttrlwe.new_ternary_key(N, k, h, sig, gen, CPU),
                ttrlwe.new_sparse_gaussian_key(N, k, h, 3.0, sig, gen, CPU)):
        m = trng.uniform_torus(gen, (2, N), CPU)
        err = ttrlwe.phase(ttrlwe.encrypt(m, key, gen), key) - m
        assert int(err.abs().max()) < 1 << 30
        assert key.plan().primes == jtrlwe.TRLWEKey(
            s=jnp.asarray(key.s.numpy()), sigma=sig,
            s_bound=key.s_bound).plan().primes
