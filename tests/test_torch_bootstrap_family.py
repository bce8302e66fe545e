"""The rest of the port's bootstrap against the TPU package's jnp path, bit
for bit (no tolerance), at TOY and at TOY_K2 where the TPU function allows
k = 2:

- the multi-value family: `multivalue_bootstrap_CLOT21`, phase 1, phase 2
  and phase 2 for many LUTs;
- the TRGSW-accumulator bootstrap: `blind_rotate_trgsw` (one K1 plain call
  on B (k+1)l rows) and its two phases;
- `public_mux` and `fdfb_ks21` in both forms (the many-LUT form needs l
  torus_base / 2 to divide N, which TOY_K2's l = 3 does not);
- k = 1 only: the circuit bootstrap v1-v3 and `fdfb_clot21`, `_2`.

The key material is random (canonical residues, words and Shoup
companions in the layouts of the TPU package's keys: exactness does not
depend on a key's noise), crossing through `bridge`, so the JAX side is one
jitted call per parameter set with no keygen to compile.  Each call's
plain-version counts are those the card's launches must be.  One test runs
the port's own keygens and decrypts within the TPU package's test bounds
(`tests/test_advanced.py`, `tests/test_bootstrap.py`)."""

import functools

import jax
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap as jbs, keyswitch as jks, ntt as jntt, \
    params, tlwe as jtlwe, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_torch import bootstrap as tbs, bridge, keyswitch as tks, \
    ntt as tntt, rng as trng, tlwe as ttlwe, torus as ttorus, \
    trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

CPU = "cpu"
B = 3            # ciphertexts per call
TB = 4           # torus base of the multi-value and TRGSW bootstraps
KS21_TB = 8      # fdfb_ks21's torus base (`tests/test_advanced.py:140`)
PREC = 4         # fdfb_clot21's precision
RL_T, RL_BIT = 2, 20
LUT = [1, 0, 3, 2]
LUTS = [[3, 0, 2, 1], [1, 1, 2, 3], [0, 3, 3, 0], [0, 0, 0, 0]]
KERNELS = ("blind_rotate_scan", "tlwe_keyswitch_sum",
           "ext_product_apply_scan", "auto_keyswitch_stream")


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _same_tlwe(got, want):
    _same(got.a, want[0])
    _same(got.b, want[1])


def _residues(rs, shape, primes):
    """The NTT form [..., P, N] (uint64) of random torus words [..., N]."""
    *lead, P, N = shape
    w = rs.integers(0, 1 << 64, tuple(lead) + (N,), dtype=np.uint64)
    v = tntt.to_ntt_u64(torch.from_numpy(w.view(np.int64)),
                        tntt.get_plan(N, primes, CPU))
    return v.numpy().astype(np.uint64)


def _calls():
    return {name: getattr(tpk, name + "_plain").calls for name in KERNELS}


def _counted(fn, want):
    """fn()'s result; the plain calls it made must be ``want`` (by kernel,
    the rest none): on the card, the launches."""
    before = _calls()
    out = fn()
    after = _calls()
    got = {name: after[name] - before[name] for name in KERNELS}
    assert got == {name: want.get(name, 0) for name in KERNELS}, got
    return out


@functools.cache
def _case(name):
    """Random key material and inputs for parameter set ``name``, and every
    function's jnp words from one jitted call."""
    p = params.get_params(name)
    k1 = p.k == 1
    k, N, l, t, bb = p.k, p.N, p.l, p.t, p.base_bit
    n_ext, base_m1, R = k * N, (1 << bb) - 1, (k + 1) * l
    rs = np.random.default_rng(1900 + k)

    def words(*shape):
        return rs.integers(0, 1 << 64, shape, dtype=np.uint64)

    pr = {"bk": jntt.primes_for_bound(jntt.external_product_bound(
        N, p.Bg_bit, l, k)), "ks": jks._ks_plan(N, bb, t, t).primes,
        "rl": jks._ks_plan(N, RL_BIT, RL_T, RL_T).primes}
    P = len(pr["bk"])
    keys = {"bk": _residues(rs, (p.n, R, k + 1, P, N), pr["bk"]),
            "packing1": words(n_ext, t, base_m1, k + 1, N)}
    if k1:
        keys.update({
            "priv_sk": words(n_ext + 1, t, base_m1, 2, N),
            "pair": [_residues(rs, (1, t, 2, len(pr["ks"]), N), pr["ks"])
                     for _ in range(2)],
            "rl": _residues(rs, (1, RL_T, 2, len(pr["rl"]), N), pr["rl"])})
    x = {"ca": words(B, p.n), "cb": words(B), "ta": words(k, N),
         "tb": words(N), "ta1": words(k, N), "tb1": words(N),
         "rows": words(B, R, k + 1, N), "ra": words(B, p.n),
         "tvp": words(2 * N), "tvv": words(2 * (1 << (PREC - 2))),
         "p0": words(B, N), "p1": words(B, N),
         "sel": _residues(rs, (B, l, k + 1, P, N), pr["bk"])}

    def applies(keys, x):
        plan = jntt.get_plan(N, pr["bk"])
        bk = jbs.BootstrapKey(
            v=keys["bk"], vs=jntt.make_shoup(keys["bk"], plan.p[:, None]),
            su=None, n=p.n, k=k, N=N, l=l, Bg_bit=p.Bg_bit, unfolding=1,
            primes=pr["bk"])
        c = jtlwe.TLWE(a=x["ca"], b=x["cb"])
        tv = jtrlwe.TRLWE(a=x["ta"], b=x["tb"])
        p1 = jks.GenericKSKey(table=keys["packing1"], t=t, base_bit=bb,
                              include_b=False)
        res = {"bk_vs": bk.vs}
        res["clot21"] = [(o.a, o.b) for o in jbs.multivalue_bootstrap_CLOT21(
            tv, c, bk, TB, 2)]
        rot = jbs.multivalue_bootstrap_phase1(c, bk, TB)
        res["phase1"] = [(r.a, r.b) for r in rot]
        o = jbs.multivalue_bootstrap_phase2(LUT, rot, TB, 2)
        res["phase2"] = (o.a, o.b)
        o = jbs.multivalue_bootstrap_phase2(LUTS[-1], rot, TB, 2)
        res["phase2_zero"] = (o.a, o.b)
        o = jbs.multivalue_bootstrap_phase2_many(LUTS, rot, TB, 2)
        res["phase2_many"] = (o.a, o.b)
        res["br_trgsw"] = jbs.blind_rotate_trgsw(
            jtrgsw.TRGSW(rows=x["rows"], l=l, Bg_bit=p.Bg_bit), x["ra"], bk,
            impl="jnp").rows
        g = jbs.functional_bootstrap_trgsw_phase1(c, bk, TB, l, p.Bg_bit)
        res["trgsw_g"] = (g.v, g.vs)
        o = jbs.functional_bootstrap_trgsw_phase2(g, tv)
        res["trgsw_out"] = (o.a, o.b)
        o = jbs.public_mux(x["p0"], x["p1"], x["sel"], l, p.Bg_bit, k, N,
                           pr["bk"])
        res["mux"] = (o.a, o.b)
        o = jbs.fdfb_ks21(x["tvp"], c, bk, p1, KS21_TB, use_many_lut=False)
        res["ks21_single"] = (o.a, o.b)
        if k1:
            o = jbs.fdfb_ks21(x["tvp"], c, bk, p1, KS21_TB)
            res["ks21_many"] = (o.a, o.b)
            sk = jks.GenericKSKey(table=keys["priv_sk"], t=t, base_bit=bb,
                                  include_b=True)
            ks_plan = jntt.get_plan(N, pr["ks"])
            pair = [jks.TRLWEKSKey(v=v, vs=jntt.make_shoup(
                v, ks_plan.p[:, None]), t=t, base_bit=bb, primes=pr["ks"])
                for v in keys["pair"]]
            rl_plan = jntt.get_plan(N, pr["rl"])
            rl = jks.TRLWEKSKey(v=keys["rl"], vs=jntt.make_shoup(
                keys["rl"], rl_plan.p[:, None]), t=RL_T, base_bit=RL_BIT,
                primes=pr["rl"])
            res["cb1"] = jbs.circuit_bootstrap(c, bk, sk, p1, l,
                                               p.Bg_bit).rows
            res["cb2"] = jbs.circuit_bootstrap_2(c, bk, sk, p1, l,
                                                 p.Bg_bit).rows
            res["cb3"] = jbs.circuit_bootstrap_3(c, bk, pair, p1, l,
                                                 p.Bg_bit).rows
            tv1 = jtrlwe.TRLWE(a=x["ta1"], b=x["tb1"])
            o = jbs.fdfb_clot21(tv, tv1, c, bk, p1, rl, PREC)
            res["clot21_fdfb"] = (o.a, o.b)
            o = jbs.fdfb_clot21_2(x["tvv"], c, bk, p1, rl, PREC)
            res["clot21_fdfb_2"] = (o.a, o.b)
        return res

    res = jax.jit(applies)(keys, x)
    port = {"bk": bridge.bootstrap_key_from_numpy(
        keys["bk"], np.asarray(res["bk_vs"]), p.n, k, N, l, p.Bg_bit,
        pr["bk"], CPU),
        "packing1": bridge.generic_ks_key_from_numpy(keys["packing1"], t, bb,
                                                     False, CPU),
        "c": bridge.tlwe_from_numpy(x["ca"], x["cb"], CPU),
        "tv": bridge.trlwe_from_numpy(x["ta"], x["tb"], CPU)}
    if k1:
        port.update({
            "priv_sk": bridge.generic_ks_key_from_numpy(keys["priv_sk"], t,
                                                        bb, True, CPU),
            "pair": bridge.priv_ks_key_pair_from_numpy(
                *keys["pair"], t, bb, pr["ks"], CPU),
            "rl": bridge.trlwe_ks_key_from_numpy(keys["rl"], RL_T, RL_BIT,
                                                 pr["rl"], CPU)})
    return p, pr, x, res, port


PARAMS = [params.TOY.name, params.TOY_K2.name]


@pytest.mark.parametrize("name", PARAMS)
def test_multivalue_family_matches_jnp(name):
    """CLOT21 (2 LUTs) and phase 1 are one K1 plain call each; phase 2
    (one LUT, the all-zero LUT) and phase 2 for 4 LUTs run no kernel."""
    p, pr, x, res, port = _case(name)
    bk, c, tv = port["bk"], port["c"], port["tv"]
    outs = _counted(lambda: tbs.multivalue_bootstrap_CLOT21(tv, c, bk, TB, 2),
                    {"blind_rotate_scan": 1})
    assert len(outs) == 2
    for got, want in zip(outs, res["clot21"]):
        _same_tlwe(got, want)
    rot = _counted(lambda: tbs.multivalue_bootstrap_phase1(c, bk, TB),
                   {"blind_rotate_scan": 1})
    assert len(rot) == TB + 1
    for got, want in zip(rot, res["phase1"]):
        _same_tlwe(got, want)
    _same_tlwe(_counted(lambda: tbs.multivalue_bootstrap_phase2(
        LUT, rot, TB, 2), {}), res["phase2"])
    _same_tlwe(tbs.multivalue_bootstrap_phase2(LUTS[-1], rot, TB, 2),
               res["phase2_zero"])
    many = _counted(lambda: tbs.multivalue_bootstrap_phase2_many(
        LUTS, rot, TB, 2), {})
    assert many.a.shape == (len(LUTS), B, p.k * p.N)
    _same_tlwe(many, res["phase2_many"])


@pytest.mark.parametrize("name", PARAMS)
def test_trgsw_bootstrap_matches_jnp(name):
    """`blind_rotate_trgsw` on B random TRGSWs (one K1 plain call on B (k+1)l
    rows), phase 1 (one K1 plain call; residues and Shoup companions) and
    phase 2 (one K3 plain call); the refusals of a foreign gadget and of
    an unfolded key."""
    p, pr, x, res, port = _case(name)
    bk, c, tv = port["bk"], port["c"], port["tv"]
    g_in = bridge.trgsw_from_numpy(x["rows"], p.l, p.Bg_bit, CPU)
    a = bridge.to_tensor(x["ra"], CPU)
    rows_before = tpk.blind_rotate_scan_plain.calls
    got = _counted(lambda: tbs.blind_rotate_trgsw(g_in, a, bk),
                   {"blind_rotate_scan": 1})
    assert tpk.blind_rotate_scan_plain.calls == rows_before + 1
    _same(got.rows, res["br_trgsw"])
    g = _counted(lambda: tbs.functional_bootstrap_trgsw_phase1(
        c, bk, TB, p.l, p.Bg_bit), {"blind_rotate_scan": 1})
    _same(g.v, res["trgsw_g"][0])
    _same(g.vs, res["trgsw_g"][1])
    _same_tlwe(_counted(lambda: tbs.functional_bootstrap_trgsw_phase2(g, tv),
                        {"ext_product_apply_scan": 1}), res["trgsw_out"])
    with pytest.raises(ValueError, match="gadget"):
        tbs.blind_rotate_trgsw(ttrgsw.TRGSW(rows=g_in.rows, l=p.l,
                                            Bg_bit=p.Bg_bit + 1), a, bk)
    unfolded = tbs.BootstrapKey(None, None, p.n, p.k, p.N, p.l, p.Bg_bit,
                                pr["bk"], su=torch.zeros(1), unfolding=2)
    with pytest.raises(ValueError, match="unfolding"):
        tbs.blind_rotate_trgsw(g_in, a, unfolded)


@pytest.mark.parametrize("name", PARAMS)
def test_public_mux_and_fdfb_ks21_match_jnp(name):
    """`public_mux` on random selector residues (no kernel); `fdfb_ks21` with
    one bootstrap per level (l + 1 K1 and l K2 plain calls) and, at k = 1,
    with the many-LUT sign bootstrap (2 K1, l K2)."""
    p, pr, x, res, port = _case(name)
    bk, c, ksk = port["bk"], port["c"], port["packing1"]
    out = _counted(lambda: tbs.public_mux(
        bridge.to_tensor(x["p0"], CPU), bridge.to_tensor(x["p1"], CPU),
        bridge.to_tensor(x["sel"], CPU), p.l, p.Bg_bit, p.k, p.N, pr["bk"]),
        {})
    _same_tlwe(out, res["mux"])
    tvp = bridge.to_tensor(x["tvp"], CPU)
    _same_tlwe(_counted(lambda: tbs.fdfb_ks21(tvp, c, bk, ksk, KS21_TB,
                                              use_many_lut=False),
                        {"blind_rotate_scan": p.l + 1,
                         "tlwe_keyswitch_sum": p.l}), res["ks21_single"])
    if p.k == 1:
        _same_tlwe(_counted(lambda: tbs.fdfb_ks21(tvp, c, bk, ksk, KS21_TB),
                            {"blind_rotate_scan": 2,
                             "tlwe_keyswitch_sum": p.l}), res["ks21_many"])
    with pytest.raises(ValueError, match="2N"):
        tbs.fdfb_ks21(tvp[:p.N], c, bk, ksk, KS21_TB, use_many_lut=False)


def test_circuit_bootstraps_match_jnp():
    """TOY: v1 (l K1 and 2l K2 plain calls), v2 (1 K1, 2l K2), v3 (1 K1, l
    K2, 2l K6); k = 2 raises ValueError."""
    p, pr, x, res, port = _case(params.TOY.name)
    bk, c = port["bk"], port["c"]
    sk, p1, pair = port["priv_sk"], port["packing1"], port["pair"]
    l, bg = p.l, p.Bg_bit
    for key, fn, kska, want in (
            ("cb1", tbs.circuit_bootstrap, sk,
             {"blind_rotate_scan": l, "tlwe_keyswitch_sum": 2 * l}),
            ("cb2", tbs.circuit_bootstrap_2, sk,
             {"blind_rotate_scan": 1, "tlwe_keyswitch_sum": 2 * l}),
            ("cb3", tbs.circuit_bootstrap_3, pair,
             {"blind_rotate_scan": 1, "tlwe_keyswitch_sum": l,
              "auto_keyswitch_stream": 2 * l})):
        g = _counted(lambda: fn(c, bk, kska, p1, l, bg), want)
        assert (g.l, g.Bg_bit) == (l, bg)
        _same(g.rows, res[key])
    bk2 = _case(params.TOY_K2.name)[4]["bk"]
    with pytest.raises(ValueError, match="k = 1"):
        tbs.circuit_bootstrap(c, bk2, sk, p1, l, bg)


def test_fdfb_clot21_match_jnp():
    """TOY: `fdfb_clot21` (3 K1, 2 K2 and 2 K6 plain calls) and
    `fdfb_clot21_2` (1 K1, 2 K2, 2 K6)."""
    p, pr, x, res, port = _case(params.TOY.name)
    bk, c, ksk, rl = port["bk"], port["c"], port["packing1"], port["rl"]
    tv0 = port["tv"]
    tv1 = bridge.trlwe_from_numpy(x["ta1"], x["tb1"], CPU)
    _same_tlwe(_counted(lambda: tbs.fdfb_clot21(tv0, tv1, c, bk, ksk, rl,
                                                PREC),
                        {"blind_rotate_scan": 3, "tlwe_keyswitch_sum": 2,
                         "auto_keyswitch_stream": 2}), res["clot21_fdfb"])
    tvv = bridge.to_tensor(x["tvv"], CPU)
    _same_tlwe(_counted(lambda: tbs.fdfb_clot21_2(tvv, c, bk, ksk, rl, PREC),
                        {"blind_rotate_scan": 1, "tlwe_keyswitch_sum": 2,
                         "auto_keyswitch_stream": 2}), res["clot21_fdfb_2"])


def _err(got, want):
    d = to_numpy(got - want).view(np.int64).astype(np.float64)
    return float(np.abs(d).max())


def _ks21_decrypts(p, gen, key_tlwe, key_out, bk, ksk, many):
    """`fdfb_ks21` (torus base 8) of the 8 messages of precision 3 on a
    random 8-entry LUT, within 2^58."""
    luts = trng.uniform_torus(gen, (8,), CPU)
    m8 = torch.arange(8)
    c8 = ttlwe.encrypt(ttorus.int2torus(m8, 3), key_tlwe, gen)
    tvp = torch.repeat_interleave(luts, (2 * p.N) // 8)
    out = tbs.fdfb_ks21(tvp, c8, bk, ksk, KS21_TB, use_many_lut=many)
    assert _err(ttlwe.phase(out, key_out), luts[m8]) <= 2.0**58, many


def _clot21_decrypts(p, gen, key_tlwe, key_out, bk, ksk, rlk, single):
    """`fdfb_clot21` (``single``: `fdfb_clot21_2`) at precision 4 of the 8
    messages of precision 3, within 2^(64 - precision - 1)."""
    vals = ttorus.int2torus(torch.arange(8) * 5 % (1 << PREC), PREC)
    m8 = torch.arange(8)
    c8 = ttlwe.encrypt(ttorus.int2torus(m8, 3), key_tlwe, gen)
    if single:
        out = tbs.fdfb_clot21_2(vals, c8, bk, ksk, rlk, PREC)
    else:
        out = tbs.fdfb_clot21(ttrlwe.torus_packing(vals[:4], p.k, p.N),
                              ttrlwe.torus_packing(vals[4:], p.k, p.N), c8,
                              bk, ksk, rlk, PREC)
    assert _err(ttlwe.phase(out, key_out), vals[m8]) <= 2.0**(64 - PREC - 1)


def test_port_keygens_decrypt():
    """The port alone at TOY: its keygens (bootstrap key, packing1 and
    private-SK tables, the private KS pair, the relinearization key), then
    every function decrypts within the TPU package's test bounds: the
    multi-value family and the TRGSW bootstrap 2^58-2^59, the circuit
    bootstrap v1-v3 used in an external product 2^59, `fdfb_ks21` (t=6)
    2^58, `fdfb_clot21`, `_2` 2^(64 - precision - 1).

    The single-rotation forms of the full-domain bootstraps (`fdfb_ks21`'s
    many-LUT form, `fdfb_clot21_2`) run at N = 256: at TOY's N = 64 their
    last LUT slot for a message next to 1/2 (m = 3 or 4 of 8) is read 2
    coefficients from the negacyclic wrap, within the rotation's rounding
    noise (the words are the TPU package's there, as the bit-exact tests
    show; the TPU tests pick messages away from that edge)."""
    p = params.TOY
    gen = torch.Generator().manual_seed(19)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    key_out = ttrlwe.extract_tlwe_key(key_trlwe)
    gk = ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = tbs.new_key(gk, key_tlwe, gen, CPU)
    t, bb = p.t, p.base_bit

    def enc(v):
        return ttlwe.encrypt(torch.as_tensor(v), key_tlwe, gen)

    luts = trng.uniform_torus(gen, (2 * TB,), CPU)
    # multi-value CLOT21: 2 LUTs of TB slots, message m / (2 TB)
    m = torch.arange(2 * TB) % TB
    outs = tbs.multivalue_bootstrap_CLOT21(
        ttrlwe.torus_packing_many_lut(luts, TB, 2, p.k, p.N),
        enc(ttorus.double2torus(m / (2 * TB))), bk, TB, 2)
    for j, o in enumerate(outs):
        assert _err(ttlwe.phase(o, key_out), luts[j * TB + m]) <= 2.0**58
    rot = tbs.multivalue_bootstrap_phase1(
        enc(ttorus.double2torus(m / (2 * TB))), bk, TB)
    for lv in LUTS:
        want = ttorus.double2torus(torch.tensor(lv)[m] / (2 * TB))
        o = tbs.multivalue_bootstrap_phase2(lv, rot, TB, 2)
        assert _err(ttlwe.phase(o, key_out), want) <= 2.0**58
    # TRGSW bootstrap, message m / 8 into the 4-slot LUT
    tv = ttrlwe.torus_packing(luts[:TB], p.k, p.N)
    g = tbs.functional_bootstrap_trgsw_phase1(
        enc(ttorus.double2torus(m / 8.0)), bk, TB, p.l, p.Bg_bit)
    out = tbs.functional_bootstrap_trgsw_phase2(g, tv)
    assert _err(ttlwe.phase(out, key_out), luts[m]) <= 2.0**59
    # circuit bootstraps of bits 0 and 1 used in a CMUX
    kska = tks.new_priv_sk_ks_key(key_trlwe, key_out, t, bb, gen, CPU)
    kskb = tks.new_packing1_ks_key(key_trlwe, key_out, t, bb, gen, CPU)
    pair = tks.new_priv_ks_key_pair(key_trlwe, key_trlwe, t, bb, gen, CPU)
    m0 = trng.uniform_torus(gen, (p.N,), CPU)
    ctrl = ttrlwe.encrypt(m0, key_trlwe, gen)
    bits = torch.tensor([0, 1])
    cb = enc(ttorus.double2torus(bits / 4.0))
    for fn, kska_ in ((tbs.circuit_bootstrap, kska),
                      (tbs.circuit_bootstrap_2, kska),
                      (tbs.circuit_bootstrap_3, pair)):
        gd = ttrgsw.to_dft(fn(cb, bk, kska_, kskb, p.l, p.Bg_bit), gk.plan())
        out = ttrgsw.external_product(ctrl, gd)
        want = m0 * bits[:, None]
        assert _err(ttrlwe.phase(out, key_trlwe), want) <= 2.0**59, fn
    # the full-domain bootstraps with a rotation per LUT, at TOY
    ksk6 = tks.new_packing1_ks_key(key_trlwe, key_out, 6, 4, gen, CPU)
    _ks21_decrypts(p, gen, key_tlwe, key_out, bk, ksk6, many=False)
    rlk = tks.new_rl_key(key_trlwe, RL_T, RL_BIT, gen, CPU)
    _clot21_decrypts(p, gen, key_tlwe, key_out, bk, kskb, rlk, single=False)
    # the single-rotation forms at N = 256
    p256 = params.TFHEParams(n=p.n, N=256, k=1, l=p.l, Bg_bit=p.Bg_bit,
                             t=6, base_bit=4, lwe_sigma=p.lwe_sigma,
                             rlwe_sigma=p.rlwe_sigma)
    kr = ttrlwe.new_binary_key(p256.N, 1, p.rlwe_sigma, gen, CPU)
    ko = ttrlwe.extract_tlwe_key(kr)
    bk = tbs.new_key(ttrgsw.new_key(kr, p.l, p.Bg_bit), key_tlwe, gen, CPU)
    ksk6 = tks.new_packing1_ks_key(kr, ko, 6, 4, gen, CPU)
    _ks21_decrypts(p256, gen, key_tlwe, ko, bk, ksk6, many=True)
    rlk = tks.new_rl_key(kr, RL_T, RL_BIT, gen, CPU)
    _clot21_decrypts(p256, gen, key_tlwe, ko, bk, ksk6, rlk, single=True)
