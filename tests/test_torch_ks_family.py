"""The port's key-switch family against the TPU package, bit for bit (no
tolerance), at TOY and TOY_K2 where the TPU function allows k = 2:

- every apply on key material carried across through `bridge`: the seeded TRLWE key switch and automorphism, the
  private KS pair, the RLWE private switch and `trgsw_from_gadget`, full
  packing, the CDKS21 trace, and the gather-style switches (packing1,
  private-SK, LUT packing) on dense tables (one call of K2's plain version
  each here) and on seeded ones (the streamed gather); `trgsw.ks_b_to_a`;
- the seeded tables' expansion, and the streamed apply equal to the dense
  apply on the expanded table;
- each of the port's keygens, by decryption: every switch of a fresh
  encryption lands within the TPU package's own test bounds
  (`tests/test_keyswitch.py`).

The applies' key material is random (words, canonical residues and seeds
in the layouts of the TPU package's keys: exactness does not depend on a
key's noise), so the JAX side is one jitted call per parameter set with no
keygen to compile; one test carries keys made by the TPU package's own
keygens.  The kernels are held to their plain versions on the card in
`test_torch_gpu.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import keyswitch as jks, params, tlwe as jtlwe, \
    torus as jtorus, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_tpu import ntt as jntt
from mosfhet_torch import bridge, keyswitch as tks, ntt as tntt, \
    polynomial as tpoly, rng as trng, tlwe as ttlwe, torus as ttorus, \
    trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

CPU = "cpu"
TB = 4          # LUT packing's torus base
GEN = 5         # the seeded automorphism's generator
B = 3           # ciphertexts per apply


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _same_trlwe(got, want_a, want_b):
    _same(got.a, want_a)
    _same(got.b, want_b)


def _residues(rs, shape, primes):
    """The NTT form [..., P, N] (uint64 residues) of random torus words
    [..., N], as a key's rows hold it: each row's coefficients centred
    below 2^63, so a sum of digit products stays in the plan's CRT range
    (the RLWE private switch reconstructs two partial sums)."""
    *lead, P, N = shape
    w = rs.integers(0, 1 << 64, tuple(lead) + (N,), dtype=np.uint64)
    plan = tntt.get_plan(N, primes, CPU)
    v = tntt.to_ntt_u64(torch.from_numpy(w.view(np.int64)), plan)
    return v.numpy().astype(np.uint64)


@functools.cache
def _case(name):
    """Key material of every kind for parameter set ``name`` (random words,
    residues and seeds, as the TPU package's keys hold them; the keygens
    are tested apart), random inputs, and every apply's jnp words from one
    jitted call."""
    p = params.get_params(name)
    k1 = p.k == 1
    t, bb, N, k = p.t, p.base_bit, p.N, p.k
    n, base_m1 = k * N, (1 << bb) - 1
    rs = np.random.default_rng(1800 + k)

    def words(*shape):
        return rs.integers(0, 1 << 64, shape, dtype=np.uint64)

    def seeds(*shape):
        return rs.integers(0, 1 << 32, shape + (2,),
                           dtype=np.uint64).astype(np.uint32)

    pr = {"ks": jks._ks_plan(N, bb, t, k * t).primes,
          "rlwe": jks._ks_plan(N, bb, t, (k + 1) * t).primes,
          "full": jks._ks_plan(N, bb, t, n * t).primes}
    P = {kind: len(v) for kind, v in pr.items()}
    keys = {"ks_seeded": (seeds(k, t), _residues(rs, (k, t, P["ks"], N),
                                                 pr["ks"])),
            "auto_seeded": (seeds(k, t), _residues(rs, (k, t, P["ks"], N),
                                                   pr["ks"])),
            "full": _residues(rs, (n, t, k + 1, P["full"], N), pr["full"]),
            "packing1": words(n, t, base_m1, k + 1, N),
            "lut": words(n, TB, t, base_m1, k + 1, N),
            "packing1_seeded": (seeds(n, t, base_m1),
                                words(n, t, base_m1, N)),
            "lut_seeded": (seeds(n, TB, t, base_m1),
                           words(n, TB, t, base_m1, N)),
            "gadget": [_residues(rs, (k + 1, t, k + 1, P["rlwe"], N),
                                 pr["rlwe"]) for _ in range(k)]}
    if k1:
        keys.update({
            "pair": [_residues(rs, (1, t, 2, P["ks"], N), pr["ks"])
                     for _ in range(2)],
            "priv_sk": words(n + 1, t, base_m1, 2, N),
            "priv_sk_seeded": (seeds(n + 1, t, base_m1),
                               words(n + 1, t, base_m1, N)),
            "cdks21": [_residues(rs, (1, t, 2, P["ks"], N), pr["ks"])
                       for _ in range(int(np.log2(N)))]})
    size = 5
    x = {"ra": words(B, k, N), "rb": words(B, N), "ta": words(B, n),
         "tb": words(B), "la": words(2, TB, n), "lb": words(2, TB),
         "ga": words(2, p.l, k, N), "gb": words(2, p.l, N),
         "fa": words(size, n), "fb": words(size)}

    def ks_key(v, kind):
        plan = jntt.get_plan(N, pr[kind])
        return jks.TRLWEKSKey(v=v, vs=jntt.make_shoup(v, plan.p[:, None]),
                              t=t, base_bit=bb, primes=pr[kind])

    def seeded_ks(sk):
        plan = jntt.get_plan(N, pr["ks"])
        return jks.SeededTRLWEKSKey(
            seeds=sk[0], b_v=sk[1], b_vs=jntt.make_shoup(sk[1],
                                                         plan.p[:, None]),
            k_out=k, t=t, base_bit=bb, primes=pr["ks"])

    def applies(keys, x):
        c = jtrlwe.TRLWE(a=x["ra"], b=x["rb"])
        tl = jtlwe.TLWE(a=x["ta"], b=x["tb"])
        lut = jtlwe.TLWE(a=x["la"], b=x["lb"])
        full = ks_key(keys["full"], "full")
        s_p1 = jks.SeededGenericKSKey(
            seeds=keys["packing1_seeded"][0], b=keys["packing1_seeded"][1],
            k=k, t=t, base_bit=bb, include_b=False)
        s_lut = jks.SeededLUTPackingKSKey(
            seeds=keys["lut_seeded"][0], b=keys["lut_seeded"][1], k=k, t=t,
            base_bit=bb, torus_base=TB)
        gadget_keys = [ks_key(v, "rlwe") for v in keys["gadget"]]
        out = {
            "ks_seeded": jks.trlwe_keyswitch(c, seeded_ks(keys["ks_seeded"])),
            "auto_seeded": jks.eval_automorphism(
                c, GEN, seeded_ks(keys["auto_seeded"])),
            "full": jks.full_packing_keyswitch(
                jtlwe.TLWE(a=x["fa"], b=x["fb"]), size,
                jks.FullPackingKSKey(v=full.v, vs=full.vs, t=t,
                                     base_bit=bb, primes=pr["full"])),
            "packing1": jks.packing1_keyswitch(tl, jks.GenericKSKey(
                table=keys["packing1"], t=t, base_bit=bb, include_b=False)),
            "packing1_seeded": jks.packing1_keyswitch(tl, s_p1),
            "lut": jks.lut_packing_keyswitch(lut, jks.LUTPackingKSKey(
                table=keys["lut"], t=t, base_bit=bb, torus_base=TB)),
            "lut_seeded": jks.lut_packing_keyswitch(lut, s_lut),
            "rlwe_priv": jks.rlwe_priv_keyswitch(c, gadget_keys[0])}
        gadget = [jtrlwe.TRLWE(a=x["ga"][:, i], b=x["gb"][:, i])
                  for i in range(p.l)]
        expanded = {"packing1": jks.expand_generic_ks_key(s_p1).table,
                    "lut": jks.expand_lut_packing_ks_key(s_lut).table}
        res = {name: (o.a, o.b) for name, o in out.items()}
        res["gadget"] = jks.trgsw_from_gadget(gadget, gadget_keys, p.l,
                                              p.Bg_bit).rows
        if k1:
            pair = [ks_key(v, "ks") for v in keys["pair"]]
            o = jks.priv_keyswitch_2(c, pair)
            res["pair"] = (o.a, o.b)
            s_sk = jks.SeededGenericKSKey(
                seeds=keys["priv_sk_seeded"][0],
                b=keys["priv_sk_seeded"][1], k=k, t=t, base_bit=bb,
                include_b=True)
            for kind, key in (("priv_sk", jks.GenericKSKey(
                    table=keys["priv_sk"], t=t, base_bit=bb,
                    include_b=True)), ("priv_sk_seeded", s_sk)):
                o = jks.priv_keyswitch(tl, key)
                res[kind] = (o.a, o.b)
            o = jks.packing1_keyswitch_cdks21(
                tl, [ks_key(v, "ks") for v in keys["cdks21"]])
            res["cdks21"] = (o.a, o.b)
            g = jtrgsw.TRGSW(rows=_trgsw_rows(x, jnp), l=p.l, Bg_bit=p.Bg_bit)
            res["ks_b_to_a"] = jtrgsw.ks_b_to_a(g, pair).rows
            expanded["priv_sk"] = jks.expand_generic_ks_key(s_sk).table
        return res, expanded

    res, expanded = jax.jit(applies)(keys, x)
    return p, pr, keys, x, size, res, expanded


def _trgsw_rows(x, xp=np):
    """A [2, 2l, 2, N] batch of random TRGSWs (k = 1): the gadget inputs'
    words, twice (``xp``: numpy, or jax.numpy while tracing)."""
    return xp.concatenate([xp.stack([x["ga"][:, :, 0], x["gb"]], axis=2)]
                          * 2, axis=1)


PARAMS = [params.TOY.name, params.TOY_K2.name]


def _seeded_ks(sk, p, primes):
    return bridge.seeded_trlwe_ks_key_from_numpy(sk[0], sk[1], p.k, p.t,
                                                 p.base_bit, primes, CPU)


@pytest.mark.parametrize("name", PARAMS)
def test_seeded_trlwe_switches_match_jnp(name):
    """The seeded key switch and automorphism: one K6 plain call each on
    the key assembled from its seeds, the jnp words; the key's bridge."""
    p, pr, keys, x, size, res, _ = _case(name)
    c = bridge.trlwe_from_numpy(x["ra"], x["rb"], CPU)
    calls = tpk.auto_keyswitch_stream_plain.calls
    s = _seeded_ks(keys["ks_seeded"], p, pr["ks"])
    _same_trlwe(tks.trlwe_keyswitch(c, s), *res["ks_seeded"])
    _same_trlwe(tks.eval_automorphism(
        c, GEN, _seeded_ks(keys["auto_seeded"], p, pr["ks"])),
        *res["auto_seeded"])
    assert tpk.auto_keyswitch_stream_plain.calls == calls + 2
    seeds, b_v = bridge.seeded_trlwe_ks_key_to_numpy(s)
    np.testing.assert_array_equal(seeds, keys["ks_seeded"][0])
    np.testing.assert_array_equal(b_v, keys["ks_seeded"][1])
    assert (s.k_in, s.N) == (p.k, p.N)


@pytest.mark.parametrize("name", PARAMS)
def test_rlwe_priv_and_trgsw_from_gadget_match_jnp(name):
    """`rlwe_priv_keyswitch` (two K6 plain calls) and `trgsw_from_gadget` on
    a batch of 2 x l gadget TRLWEs (two calls per key), the jnp words."""
    p, pr, keys, x, size, res, _ = _case(name)
    gk = bridge.trlwe_ks_keys_from_numpy(keys["gadget"], p.t, p.base_bit,
                                         pr["rlwe"], CPU)
    c = bridge.trlwe_from_numpy(x["ra"], x["rb"], CPU)
    calls = tpk.auto_keyswitch_stream_plain.calls
    _same_trlwe(tks.rlwe_priv_keyswitch(c, gk[0]), *res["rlwe_priv"])
    assert tpk.auto_keyswitch_stream_plain.calls == calls + 2
    gadget = [bridge.trlwe_from_numpy(x["ga"][:, i], x["gb"][:, i], CPU)
              for i in range(p.l)]
    g = tks.trgsw_from_gadget(gadget, gk, p.l, p.Bg_bit)
    assert (g.l, g.Bg_bit) == (p.l, p.Bg_bit)
    _same(g.rows, res["gadget"])
    assert tpk.auto_keyswitch_stream_plain.calls == calls + 2 + 2 * p.k
    for got, want in zip(bridge.trlwe_ks_keys_to_numpy(gk), keys["gadget"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PARAMS)
def test_full_packing_matches_jnp(name):
    p, pr, keys, x, size, res, _ = _case(name)
    plan = tntt.get_plan(p.N, pr["full"], CPU)
    v = keys["full"]
    vs = tntt.make_shoup(torch.from_numpy(v.view(np.int64)),
                         plan.p[:, None]).numpy()
    kt = bridge.full_packing_ks_key_from_numpy(v, vs, p.t, p.base_bit,
                                               pr["full"], CPU)
    _same_trlwe(tks.full_packing_keyswitch(
        bridge.tlwe_from_numpy(x["fa"], x["fb"], CPU), size, kt),
        *res["full"])
    got_v, got_vs = bridge.full_packing_ks_key_to_numpy(kt)
    np.testing.assert_array_equal(got_v, v)


@pytest.mark.parametrize("name", PARAMS)
def test_gather_switches_match_jnp(name):
    """packing1 and LUT packing (and at k = 1 the private-SK switch) on the
    dense tables, one K2 plain call each, and on the seeded tables through
    the streamed gather (no K2 call), each the jnp words; the port's
    expansion of each seeded table is the jnp's, and the streamed apply
    equals the dense apply on it."""
    p, pr, keys, x, size, res, expanded = _case(name)
    t, bb = p.t, p.base_bit
    tl = bridge.tlwe_from_numpy(x["ta"], x["tb"], CPU)
    lut = bridge.tlwe_from_numpy(x["la"], x["lb"], CPU)
    cases = [("packing1", tks.packing1_keyswitch, tl,
              bridge.generic_ks_key_from_numpy(keys["packing1"], t, bb,
                                               False, CPU),
              bridge.seeded_generic_ks_key_from_numpy(
                  *keys["packing1_seeded"], p.k, t, bb, False, CPU),
              tks.expand_generic_ks_key),
             ("lut", tks.lut_packing_keyswitch, lut,
              bridge.lut_packing_ks_key_from_numpy(keys["lut"], t, bb, TB,
                                                   CPU),
              bridge.seeded_lut_packing_ks_key_from_numpy(
                  *keys["lut_seeded"], p.k, t, bb, TB, CPU),
              tks.expand_lut_packing_ks_key)]
    if p.k == 1:
        cases.append(("priv_sk", tks.priv_keyswitch, tl,
                      bridge.generic_ks_key_from_numpy(keys["priv_sk"], t,
                                                       bb, True, CPU),
                      bridge.seeded_generic_ks_key_from_numpy(
                          *keys["priv_sk_seeded"], p.k, t, bb, True, CPU),
                      tks.expand_generic_ks_key))
    for kind, fn, c, dense, seeded, expand in cases:
        calls = tpk.tlwe_keyswitch_sum_plain.calls
        _same_trlwe(fn(c, dense), *res[kind])
        assert tpk.tlwe_keyswitch_sum_plain.calls == calls + 1, kind
        got = fn(c, seeded)
        assert tpk.tlwe_keyswitch_sum_plain.calls == calls + 1, kind
        _same_trlwe(got, *res[f"{kind}_seeded"])
        table = expand(seeded)
        _same(table.table, expanded[kind])
        want = fn(c, table)
        _same(got.a, to_numpy(want.a))
        _same(got.b, to_numpy(want.b))
        np.testing.assert_array_equal(bridge.ks_table_to_numpy(dense),
                                      keys[kind])
        for got_, want_ in zip(bridge.seeded_ks_table_to_numpy(seeded),
                               keys[f"{kind}_seeded"]):
            np.testing.assert_array_equal(got_, want_)


def test_k1_switches_match_jnp():
    """At TOY (the TPU functions need k = 1): `priv_keyswitch_2` (two K6
    plain calls), the CDKS21 trace (log N = 6) and `trgsw.ks_b_to_a` (two),
    the jnp words."""
    p, pr, keys, x, size, res, _ = _case(params.TOY.name)
    pair = bridge.priv_ks_key_pair_from_numpy(*keys["pair"], p.t,
                                              p.base_bit, pr["ks"], CPU)
    c = bridge.trlwe_from_numpy(x["ra"], x["rb"], CPU)
    calls = tpk.auto_keyswitch_stream_plain.calls
    _same_trlwe(tks.priv_keyswitch_2(c, pair), *res["pair"])
    assert tpk.auto_keyswitch_stream_plain.calls == calls + 2
    cd = bridge.trlwe_ks_keys_from_numpy(keys["cdks21"], p.t, p.base_bit,
                                         pr["ks"], CPU)
    _same_trlwe(tks.packing1_keyswitch_cdks21(
        bridge.tlwe_from_numpy(x["ta"], x["tb"], CPU), cd), *res["cdks21"])
    assert tpk.auto_keyswitch_stream_plain.calls == calls + 2 + 6
    g = ttrgsw.ks_b_to_a(bridge.trgsw_from_numpy(_trgsw_rows(x), p.l,
                                                 p.Bg_bit, CPU), pair)
    _same(g.rows, res["ks_b_to_a"])
    assert tpk.auto_keyswitch_stream_plain.calls == calls + 2 + 6 + 2


def test_jax_keygens_carry_across():
    """Keys made by the TPU package's own keygens (TOY): its seeded packing1
    table and private KS pair cross through `bridge`, and the port's
    streamed packing1 switch and `priv_keyswitch_2` give the jnp words,
    which decrypt."""
    p = params.TOY
    k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1818), 4)
    kr = jtrlwe.new_binary_key(k0, p.N, p.k, p.rlwe_sigma)
    kt = jtrlwe.extract_tlwe_key(kr)
    m = jtorus.int2torus(jnp.arange(3, dtype=jnp.uint64), 4)

    def jax_side(r1, r2, r3):
        sk = jks.new_packing1_ks_key_seeded(r1, kr, kt, p.t, p.base_bit)
        pair = jks.new_priv_ks_key_pair(r2, kr, kr, p.t, p.base_bit)
        c = jtlwe.encrypt(m, kt, r3)
        cr = jtrlwe.encrypt(jnp.tile(m[:1], p.N), kr, r3)
        o1 = jks.packing1_keyswitch(c, sk)
        o2 = jks.priv_keyswitch_2(cr, pair)
        return sk, pair, c, cr, o1, o2

    sk, pair, c, cr, o1, o2 = jax.jit(jax_side)(k1, k2, k3)
    sk_t = bridge.seeded_generic_ks_key_from_numpy(
        np.asarray(sk.seeds), np.asarray(sk.b), sk.k, sk.t, sk.base_bit,
        sk.include_b, CPU)
    got = tks.packing1_keyswitch(bridge.tlwe_from_numpy(
        np.asarray(c.a), np.asarray(c.b), CPU), sk_t)
    _same_trlwe(got, o1.a, o1.b)
    key_t = bridge.trlwe_key_from_numpy(np.asarray(kr.s), kr.sigma,
                                        kr.s_bound, CPU)
    assert _err(ttrlwe.phase(got, key_t)[:, 0],
                bridge.to_tensor(np.asarray(m), CPU)) <= 2.0**48
    pair_t = bridge.priv_ks_key_pair_from_numpy(
        np.asarray(pair[0].v), np.asarray(pair[1].v), p.t, p.base_bit,
        pair[0].primes, CPU)
    got = tks.priv_keyswitch_2(bridge.trlwe_from_numpy(
        np.asarray(cr.a), np.asarray(cr.b), CPU), pair_t)
    _same_trlwe(got, o2.a, o2.b)


def _err(ph, want):
    d = to_numpy(ph - want).view(np.int64)
    return float(np.abs(d.astype(np.float64)).max())


def test_port_keygens_decrypt():
    """The port's own keygens at TOY (a CPU generator): each switch of a
    fresh encryption decrypts within the TPU package's test bounds."""
    p = params.TOY
    gen = torch.Generator().manual_seed(1818)
    kr = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    kr2 = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    kt = ttrlwe.extract_tlwe_key(kr)
    t, bb = p.t, p.base_bit
    m = trng.uniform_torus(gen, (2, p.N), CPU)
    ms = trng.uniform_torus(gen, (TB,), CPU)
    c = ttrlwe.encrypt(m, kr, gen)
    cs = ttlwe.encrypt(ms, kt, gen)
    # TRLWE switches: seeded key, seeded automorphism, the private pair
    ksk = tks.new_trlwe_ks_key_seeded(kr, kr2, t, bb, gen, CPU)
    assert _err(ttrlwe.phase(tks.trlwe_keyswitch(
        ttrlwe.encrypt(m, kr2, gen), ksk), kr), m) <= 2.0**48
    auto = tks.new_automorphism_ks_keyset_seeded(kr, (GEN,), t, bb, gen, CPU)
    assert _err(ttrlwe.phase(tks.eval_automorphism(c, GEN, auto[GEN]), kr),
                tpoly.permute(m, GEN)) <= 2.0**48
    pair = tks.new_priv_ks_key_pair(kr, kr, t, bb, gen, CPU)
    want = -tpoly.ntt_mul_small(kr.s[0], ttrlwe.phase(c, kr), kr.plan())
    assert _err(ttrlwe.phase(tks.priv_keyswitch_2(c, pair), kr),
                want) <= 2.0**52
    # packing1 (dense, seeded), private-SK (dense, seeded), LUT (seeded)
    for key in (tks.new_packing1_ks_key(kr, kt, t, bb, gen, CPU),
                tks.new_packing1_ks_key_seeded(kr, kt, t, bb, gen, CPU)):
        out = tks.packing1_keyswitch(cs, key)
        assert _err(ttrlwe.phase(out, kr)[:, 0], ms) <= 2.0**48
    quarter = ttorus.int2torus(torch.ones(2, dtype=torch.int64), 2)
    c4 = ttlwe.encrypt(quarter, kt, gen)
    m_poly = torch.zeros((2, p.N), dtype=torch.int64)
    m_poly[:, 0] = quarter
    want = -tpoly.ntt_mul_small(kr.s[0], m_poly, kr.plan())
    for key in (tks.new_priv_sk_ks_key(kr, kt, t, bb, gen, CPU),
                tks.new_priv_sk_ks_key_seeded(kr, kt, t, bb, gen, CPU)):
        assert _err(ttrlwe.phase(tks.priv_keyswitch(c4, key), kr),
                    want) <= 2.0**50
    tb = 2          # the LUT tables' slots scale with the torus base
    for key in (tks.new_lut_packing_ks_key(kr, kt, t, bb, tb, gen, CPU),
                tks.new_lut_packing_ks_key_seeded(kr, kt, t, bb, tb, gen,
                                                  CPU)):
        out = tks.lut_packing_keyswitch(ttlwe.TLWE(a=cs.a[:tb], b=cs.b[:tb]),
                                        key)
        assert _err(ttrlwe.phase(out, kr), torch.repeat_interleave(
            ms[:tb], p.N // tb)) <= 2.0**50
    # full packing, the CDKS21 trace
    full = tks.new_full_packing_ks_key(kr, kt, t, bb, gen, CPU)
    out = tks.full_packing_keyswitch(cs, TB, full)
    assert _err(ttrlwe.phase(out, kr)[:TB], ms) <= 2.0**50
    cd = tks.new_cdks21_packing_keys(kr, kt, t, bb, gen, CPU)
    out = tks.packing1_keyswitch_cdks21(cs, cd)
    assert _err(ttrlwe.phase(out, kr)[:, 0], ms * p.N) <= 2.0**54
    # gadget -> RGSW: the assembled TRGSW(X^e) acts as X^e
    gk = ttrgsw.new_key(kr, p.l, p.Bg_bit)
    g_full = ttrgsw.monomial_encrypt(1, 6, gk, gen)
    gadget = [ttrlwe.from_stacked(g_full.rows[p.k * p.l + i])
              for i in range(p.l)]
    g = tks.trgsw_from_gadget(
        gadget, tks.new_gadget_to_rgsw_keys(kr, t, bb, gen, CPU), p.l,
        p.Bg_bit)
    assert int(ttrgsw.debug_decrypt_exp(g, gk)) == 6
    out = ttrgsw.external_product(c, ttrgsw.to_dft(g, gk.plan()))
    assert _err(ttrlwe.phase(out, kr), tpoly.mul_by_xai(m, 6)) <= 2.0**56


def test_refusals():
    """k != 1 where the reference's layout needs it, a key without the b
    row for `priv_keyswitch`, a mismatched RLWE private key."""
    p = params.TOY_K2
    gen = torch.Generator().manual_seed(3)
    kr = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    kt = ttrlwe.extract_tlwe_key(kr)
    with pytest.raises(ValueError, match="k_out = 1"):
        tks.new_priv_ks_key_pair(kr, kr, p.t, p.base_bit, gen, CPU)
    with pytest.raises(ValueError, match="k = 1"):
        tks.new_rl_key(kr, 2, 20, gen, CPU)
    with pytest.raises(ValueError, match="k_out = 1"):
        tks.new_priv_sk_ks_key(kr, kt, p.t, p.base_bit, gen, CPU)
    c = ttrlwe.encrypt(None, kr, gen)
    with pytest.raises(ValueError, match="k = 1"):
        tks.priv_keyswitch_2(c, (None, None))
    small = ttlwe.TLWEKey(s=kt.s[:8], sigma=kt.sigma)
    p1 = tks.new_packing1_ks_key(kr, small, 2, 4, gen, CPU)
    with pytest.raises(ValueError, match="b row"):
        tks.priv_keyswitch(ttlwe.encrypt(torch.zeros(1, dtype=torch.int64),
                                         small, gen), p1)
    k1 = ttrlwe.new_binary_key(p.N, 1, p.rlwe_sigma, gen, CPU)
    rk = tks.new_rlwe_priv_ks_key(k1, k1, -k1.s[0], 2, 4, gen, CPU)
    with pytest.raises(ValueError, match="does not switch"):
        tks.rlwe_priv_keyswitch(c, rk)
    g = ttrgsw.TRGSW(rows=torch.zeros((3 * p.l, 3, p.N), dtype=torch.int64),
                     l=p.l, Bg_bit=p.Bg_bit)
    with pytest.raises(ValueError, match="k = 1"):
        ttrgsw.ks_b_to_a(g, (None, None))
