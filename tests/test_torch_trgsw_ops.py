"""The port's TRGSW matrix ops and the rest of `trgsw` against the TPU
package, bit for bit (no tolerance), at TOY and TOY_K2: the NTT-domain
products `external_product_dft`, `mul_trgsw_dft` and `mul_trgsw_dft2`,
`from_dft`, the exponent decrypt oracle, the registers and their add and
sub (the matrix ops `trgsw_mul` and `trgsw_reg_sub`), the linear ops and
the naive product.  Keys, TRGSWs and registers are made by the TPU package
and carried across through `bridge`; each pair of exponents is one row of a
batch, and the JAX side runs once per parameter set as one jitted call (its
pairwise products through `jax.vmap`).  `debug_decrypt_exp_dft` is one
external product: one call of the apply-scan kernel's plain version here,
one K3 launch on the card (`test_torch_gpu.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import params, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_torch import bridge, trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

CPU = "cpu"
B = 6


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.fixture(scope="module", params=[params.TOY, params.TOY_K2],
                ids=lambda p: p.name)
def case(request):
    """JAX keys, a batch of B exponent pairs (0, N and 2N-1 among them), two
    register pairs and random TRLWEs, and every JAX result the tests compare
    with, from one jitted call."""
    p = request.param
    N = p.N
    k0, k1 = jax.random.split(jax.random.PRNGKey(1700 + p.k))
    jkey = jtrlwe.new_binary_key(k0, N, p.k, p.rlwe_sigma)
    gk = jtrgsw.new_key(jkey, p.l, p.Bg_bit)
    plan = gk.plan()
    rs = np.random.default_rng(p.k)
    e1 = rs.integers(0, 2 * N, B, dtype=np.int32)
    e2 = rs.integers(0, 2 * N, B, dtype=np.int32)
    e1[:3], e2[:3] = [0, N, 2 * N - 1], [0, N - 1, 2 * N - 1]
    m1, m2 = np.array([9, 0, N + 3], np.int32), np.array([4, 5, 7], np.int32)
    keys = jax.random.split(k1, 2 * B + 2 * len(m1))
    a = rs.integers(0, 1 << 64, (B, p.k, N), dtype=np.uint64)
    b = rs.integers(0, 1 << 64, (B, N), dtype=np.uint64)
    xai = rs.integers(0, 2 * N + 1, B, dtype=np.int32)
    xai[:2] = [0, 2 * N]

    enc = jax.vmap(lambda e, rk: jtrgsw.monomial_encrypt(1, e, gk, rk).rows)
    reg = jax.vmap(lambda m, rk: jtrgsw.reg_encrypt(m, gk, rk))

    def jax_side(e1, e2, m1, m2, keys, a, b, xai):
        g1 = jtrgsw.TRGSW(rows=enc(e1, keys[:B]), l=p.l, Bg_bit=p.Bg_bit)
        g2 = jtrgsw.TRGSW(rows=enc(e2, keys[B:2 * B]), l=p.l,
                          Bg_bit=p.Bg_bit)
        d1, d2 = jtrgsw.to_dft(g1, plan), jtrgsw.to_dft(g2, plan)
        prod = jax.vmap(jtrgsw.mul_trgsw_dft)(g1, d2)
        r1 = reg(m1, keys[2 * B:2 * B + 3])
        r2 = reg(m2, keys[2 * B + 3:])
        rsub = jax.vmap(jtrgsw.reg_sub)(r1, r2)
        radd = jax.vmap(jtrgsw.reg_add)(r1, r2)
        c = jtrlwe.TRLWE(a=a, b=b)
        # every exponent decrypt of the DFT form in one batched call
        outs = (prod.v, rsub.positive.v, rsub.negative.v, radd.positive.v,
                radd.negative.v)
        exps = jtrgsw.debug_decrypt_exp_dft(jtrgsw._with_shoup(
            jtrgsw.TRGSWDFT(v=jnp.concatenate(outs), vs=None, l=p.l,
                            Bg_bit=p.Bg_bit, primes=plan.primes)), gk)
        exps = jnp.split(exps, np.cumsum([len(o) for o in outs])[:-1])
        d2_one = jtrgsw.TRGSWDFT(v=d2.v[0], vs=d2.vs[0], l=p.l,
                                 Bg_bit=p.Bg_bit, primes=d2.primes)
        return {
            "g1": g1.rows, "g2": g2.rows, "d2v": d2.v, "d2vs": d2.vs,
            "prod": prod.v, "back": jtrgsw.from_dft(prod).rows,
            "exp_prod": exps[0],
            "exp_g1": jtrgsw.debug_decrypt_exp(g1, gk),
            "r1": (r1.positive.v, r1.positive.vs, r1.negative.v,
                   r1.negative.vs),
            "r2": (r2.positive.v, r2.positive.vs, r2.negative.v,
                   r2.negative.vs),
            "rsub": (rsub.positive.v, rsub.positive.vs, rsub.negative.v,
                     rsub.negative.vs),
            "radd": (radd.positive.v, radd.positive.vs, radd.negative.v,
                     radd.negative.vs),
            "exp_rsub": exps[1:3], "exp_radd": exps[3:5],
            "epd_row": jtrgsw.external_product_dft(c, d2).v,
            "epd_one": jtrgsw.external_product_dft(c, d2_one).v,
            "ep_one": jtrgsw.external_product(c, d2_one).b,
            "naive": jtrgsw.naive_mul_trlwe(
                c, jtrgsw.TRGSW(rows=g1.rows[1], l=p.l, Bg_bit=p.Bg_bit)).b,
            "add": jtrgsw.add(g1, g2).rows, "sub": jtrgsw.sub(g1, g2).rows,
            "dft_add": jtrgsw.dft_add(d1, d2).v,
            "dft_sub": jtrgsw.dft_sub(d1, d2).v,
            "xai": jtrgsw.mul_by_xai(g1, xai).rows,
            "xai_m1": jtrgsw.mul_by_xai_minus_1(g1, xai).rows,
            "xai_3": jtrgsw.mul_by_xai(g1, 3).rows,
            "trivial": jtrgsw.noiseless_trivial(3, p.l, p.Bg_bit, p.k,
                                                N).rows,
        }

    want = jax.jit(jax_side)(e1, e2, m1, m2, keys, a, b, xai)
    want = jax.tree_util.tree_map(np.asarray, want)
    tkey = bridge.trlwe_key_from_numpy(np.asarray(jkey.s), jkey.sigma,
                                       jkey.s_bound, CPU)
    tgk = ttrgsw.new_key(tkey, p.l, p.Bg_bit)
    assert tgk.plan().primes == plan.primes
    return dict(p=p, tgk=tgk, e1=e1, e2=e2, m1=m1, m2=m2, a=a, b=b, xai=xai,
                want=want,
                g1=bridge.trgsw_from_numpy(want["g1"], p.l, p.Bg_bit, CPU),
                g2=bridge.trgsw_from_numpy(want["g2"], p.l, p.Bg_bit, CPU))


def test_trgsw_mul_matches(case):
    """The matrix op `trgsw_mul` row by row: to_dft, mul_trgsw_dft,
    mul_trgsw_dft2 (equal to mul_trgsw_dft), from_dft and both exponent
    decrypts, each exponent (e1 + e2) mod N; one plain apply-scan call per
    debug_decrypt_exp_dft."""
    p, tgk, w = case["p"], case["tgk"], case["want"]
    plan = tgk.plan()
    d2 = ttrgsw.to_dft(case["g2"], plan)
    _same(d2.v, w["d2v"])
    _same(d2.vs, w["d2vs"])
    prod = ttrgsw.mul_trgsw_dft(case["g1"], d2)
    assert prod.v.shape == (B, (p.k + 1) * p.l, p.k + 1, plan.P, p.N)
    assert prod.vs is None and prod.primes == plan.primes
    _same(prod.v, w["prod"])
    prod2 = ttrgsw.mul_trgsw_dft2(ttrgsw.to_dft(case["g1"], plan), d2)
    assert torch.equal(prod2.v, prod.v)
    back = ttrgsw.from_dft(prod)
    _same(back.rows, w["back"])
    calls = tpk.ext_product_apply_scan_plain.calls
    exps = ttrgsw.debug_decrypt_exp_dft(prod, tgk)
    assert tpk.ext_product_apply_scan_plain.calls == calls + 1
    assert exps.dtype == torch.int32
    np.testing.assert_array_equal(exps.numpy(), w["exp_prod"])
    np.testing.assert_array_equal(exps.numpy(),
                                  (case["e1"] + case["e2"]) % p.N)
    # the coefficient-form oracle reads row l, digit 0 of the b component
    # only at k = 1; at k = 2 it is a mask row and gives -1, in both packages
    exp1 = ttrgsw.debug_decrypt_exp(case["g1"], tgk)
    np.testing.assert_array_equal(exp1.numpy(), w["exp_g1"])
    want1 = case["e1"] % p.N if p.k == 1 else np.full(B, -1)
    np.testing.assert_array_equal(exp1.numpy(), want1)
    want_back = exps.numpy() if p.k == 1 else np.full(B, -1)
    np.testing.assert_array_equal(
        ttrgsw.debug_decrypt_exp(back, tgk).numpy(), want_back)
    # one TRGSW, not a batch: broadcast, still one plain apply-scan call
    one = ttrgsw.TRGSWDFT(v=prod.v[2], vs=None, l=p.l, Bg_bit=p.Bg_bit,
                          primes=prod.primes)
    calls = tpk.ext_product_apply_scan_plain.calls
    assert int(ttrgsw.debug_decrypt_exp_dft(one, tgk)) == int(exps[2])
    assert tpk.ext_product_apply_scan_plain.calls == calls + 1


def test_trgsw_reg_sub_and_add_match(case):
    """The matrix op `trgsw_reg_sub` and reg_add on registers the TPU
    package made (bridged both ways): every word of both halves with their
    Shoup companions, and each half's exponent."""
    p, tgk, w = case["p"], case["tgk"], case["want"]
    r1 = bridge.trgsw_reg_from_numpy(*w["r1"], p.l, p.Bg_bit,
                                     tgk.plan().primes, CPU)
    r2 = bridge.trgsw_reg_from_numpy(*w["r2"], p.l, p.Bg_bit,
                                     tgk.plan().primes, CPU)
    for got, want in zip(bridge.trgsw_reg_to_numpy(r1), w["r1"]):
        np.testing.assert_array_equal(got, want)
    m1, m2, N = case["m1"].astype(np.int64), case["m2"].astype(np.int64), p.N
    for name, fn, m in (("rsub", ttrgsw.reg_sub, m1 - m2),
                        ("radd", ttrgsw.reg_add, m1 + m2)):
        got = fn(r1, r2)
        for g, want in zip(bridge.trgsw_reg_to_numpy(got), w[name]):
            np.testing.assert_array_equal(g, want)
        pos = ttrgsw.debug_decrypt_exp_dft(got.positive, tgk).numpy()
        neg = ttrgsw.debug_decrypt_exp_dft(got.negative, tgk).numpy()
        np.testing.assert_array_equal(pos, w[f"exp_{name}"][0])
        np.testing.assert_array_equal(neg, w[f"exp_{name}"][1])
        np.testing.assert_array_equal(pos, m % (2 * N) % N)
        np.testing.assert_array_equal(neg, -m % (2 * N) % N)


def test_port_registers_decrypt(case):
    """The port's own reg_encrypt and encrypt on a JAX-made key: 9 and 4
    give 5 and N - 5 under reg_sub, 13 and N - 13 under reg_add."""
    p, tgk = case["p"], case["tgk"]
    gen = torch.Generator().manual_seed(p.N + p.k)
    r1, r2 = (ttrgsw.reg_encrypt(m, tgk, gen) for m in (9, 4))
    exp = ttrgsw.debug_decrypt_exp_dft
    assert r1.positive.vs is not None
    for r, want in ((ttrgsw.reg_sub(r1, r2), 5), (ttrgsw.reg_add(r1, r2), 13)):
        assert int(exp(r.positive, tgk)) == want
        assert int(exp(r.negative, tgk)) == p.N - want
    g = ttrgsw.encrypt(torch.tensor([1, 1]), tgk, gen)
    assert ttrgsw.debug_decrypt_exp_dft(ttrgsw.to_dft(g, tgk.plan()),
                                        tgk).tolist() == [0, 0]


def test_external_product_dft_matches(case):
    """external_product_dft with one TRGSW per row and with one broadcast,
    and its from_dft equal to external_product's words."""
    p, w, plan = case["p"], case["want"], case["tgk"].plan()
    c = bridge.trlwe_from_numpy(case["a"], case["b"], CPU)
    d2 = ttrgsw.to_dft(case["g2"], plan)
    row = ttrgsw.external_product_dft(c, d2)
    assert isinstance(row, ttrlwe.TRLWEDFT) and row.vs is None
    _same(row.v, w["epd_row"])
    one = ttrgsw.TRGSWDFT(v=d2.v[0], vs=d2.vs[0], l=p.l, Bg_bit=p.Bg_bit,
                          primes=d2.primes)
    got = ttrgsw.external_product_dft(c, one)
    _same(got.v, w["epd_one"])
    ep = ttrgsw.external_product(c, one)
    _same(ep.b, w["ep_one"])
    assert torch.equal(ttrlwe.from_dft(got).b, ep.b)
    with pytest.raises(ValueError, match="Shoup"):
        ttrgsw.external_product_dft(c, ttrgsw.TRGSWDFT(
            v=one.v, vs=None, l=p.l, Bg_bit=p.Bg_bit, primes=one.primes))


def test_naive_mul_trlwe_matches(case):
    """naive_mul_trlwe against the TPU package's words, and its phase
    within the decomposition's rounding of external_product's: unrounded
    and rounded digits recompose c to within 2^(64 - l Bg_bit), which the
    key's k N binary coefficients can add up, plus the digits' products
    with the rows' noise (far below 2^40)."""
    p, tgk, w = case["p"], case["tgk"], case["want"]
    c = bridge.trlwe_from_numpy(case["a"], case["b"], CPU)
    g = ttrgsw.TRGSW(rows=case["g1"].rows[1], l=p.l, Bg_bit=p.Bg_bit)
    naive = ttrgsw.naive_mul_trlwe(c, g)
    _same(naive.b, w["naive"])
    ep = ttrgsw.external_product(c, ttrgsw.to_dft(g, tgk.plan()))
    key = tgk.trlwe_key
    diff = ttrlwe.phase(naive, key) - ttrlwe.phase(ep, key)
    bound = (1 << (64 - p.l * p.Bg_bit)) * (p.k * p.N + 1) + (1 << 40)
    assert int(diff.abs().max()) < bound


def test_trgsw_linear_ops_match(case):
    """add, sub, dft_add, dft_sub, mul_by_xai and mul_by_xai_minus_1 (per
    TRGSW, 0 and 2N present, and one int) and noiseless_trivial."""
    p, w, plan = case["p"], case["want"], case["tgk"].plan()
    g1, g2 = case["g1"], case["g2"]
    _same(ttrgsw.add(g1, g2).rows, w["add"])
    _same(ttrgsw.sub(g1, g2).rows, w["sub"])
    d1, d2 = ttrgsw.to_dft(g1, plan), ttrgsw.to_dft(g2, plan)
    _same(ttrgsw.dft_add(d1, d2).v, w["dft_add"])
    _same(ttrgsw.dft_sub(d1, d2).v, w["dft_sub"])
    xai = torch.from_numpy(case["xai"])
    _same(ttrgsw.mul_by_xai(g1, xai).rows, w["xai"])
    _same(ttrgsw.mul_by_xai_minus_1(g1, xai).rows, w["xai_m1"])
    _same(ttrgsw.mul_by_xai(g1, 3).rows, w["xai_3"])
    triv = ttrgsw.noiseless_trivial(3, p.l, p.Bg_bit, p.k, p.N, CPU)
    _same(triv.rows, w["trivial"])
    assert ttrgsw._with_shoup(ttrgsw.TRGSWDFT(
        v=d1.v, vs=None, l=p.l, Bg_bit=p.Bg_bit,
        primes=d1.primes)).vs.equal(d1.vs)
