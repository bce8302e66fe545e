"""The port's applications against the TPU package, bit for bit, at TOY:

- `apps.leveled_lut`: the direct lookup (one K3 plain call) and the
  vertical-packing lookup of a 4N-entry LUT (two K3 plain calls for the
  CMUX tree, one K1 plain call of log2(N) steps), on inputs the TPU package
  encrypted; then the port's own encryptions, decrypted;
- `apps.ufhe`: the TPU package's keysets, context and encrypted integers
  carried across by `bridge` (and back, word for word), then every op of
  `tests/test_ufhe.py` on batches of integers: the jnp words (each JAX op
  jitted with the keysets as arguments) and every element decrypted to its
  cleartext result; the plain-version counts of add, sub, cmp and relu
  (on the card, the launches); the port's own keygens, decrypted.

The JAX side runs its jnp paths on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mosfhet_tpu import params, tlwe as jtlwe, trgsw as jtrgsw, \
    trlwe as jtrlwe, torus as jtorus
from mosfhet_tpu.apps import leveled_lut as jll, ufhe as jufhe
from mosfhet_torch import bridge, tlwe as ttlwe, torus as ttorus, \
    trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.apps import leveled_lut as tll, ufhe as tufhe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

CPU = "cpu"
P = params.TOY      # n=16, N=64, l=4, Bg_bit=9, t=8, base_bit=4
KEY = jax.random.PRNGKey(1919)
PREC = 4            # integer precision: 2 digits of base 4
VA, VB = [5, 11, 2], [7, 3, 2]
KERNELS = ("blind_rotate_scan", "tlwe_keyswitch_sum",
           "ext_product_apply_scan")


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _counted(fn, want):
    before = {k: getattr(tpk, k + "_plain").calls for k in KERNELS}
    out = fn()
    got = {k: getattr(tpk, k + "_plain").calls - before[k] for k in KERNELS}
    assert got == {k: want.get(k, 0) for k in KERNELS}, got
    return out


def _torus_err(got, want):
    d = to_numpy(got - want).view(np.int64).astype(np.float64)
    return float(np.abs(d).max())


# --- leveled LUT ---------------------------------------------------------------

@functools.cache
def _leveled():
    """The TPU package's keys, encrypted inputs and both lookups' words."""
    k0, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(99), 5)
    key_trlwe = jtrlwe.new_binary_key(k0, P.N, P.k, P.rlwe_sigma)
    gk = jtrgsw.new_key(key_trlwe, P.l, P.Bg_bit)
    size = P.log_N + 2                      # a 4N-entry LUT
    table = np.random.default_rng(3).integers(0, 16, 1 << size)
    values = (np.arange(P.N) * 7) % 128

    def make(k1, k2, k3, k4):
        enc_lut = jll.encrypt_lut(jnp.asarray(values), 7, key_trlwe, k1)
        enc_in = jll.encrypt_input(17, gk, k2)
        luts = jtrlwe.encrypt(jtorus.int2torus(jnp.asarray(table), 4)
                              .reshape(-1, P.N), key_trlwe, k3)
        enc_bits = jll.encrypt_input_bits(77, size, gk, k4)
        out = jll.eval_lut(enc_in, enc_lut)
        out_v = jll.eval_lut_vertical(enc_bits, size, luts)
        return enc_lut, enc_in, luts, enc_bits, out, out_v

    return (key_trlwe, gk, size, table, values,
            jax.jit(make)(k1, k2, k3, k4))


def test_leveled_lut_matches_jnp():
    """`eval_lut` (1 K3 plain call) of m = 17 and `eval_lut_vertical` of
    m = 77 over 4N entries (2 K3, 1 K1 plain calls) on the TPU package's
    encryptions, its words."""
    key_trlwe, gk, size, table, values, res = _leveled()
    enc_lut, enc_in, luts, enc_bits, out, out_v = res
    t_in = bridge.trgsw_dft_from_numpy(np.asarray(enc_in.v),
                                       np.asarray(enc_in.vs), P.l, P.Bg_bit,
                                       enc_in.primes, CPU)
    t_lut = bridge.trlwe_from_numpy(np.asarray(enc_lut.a),
                                    np.asarray(enc_lut.b), CPU)
    got = _counted(lambda: tll.eval_lut(t_in, t_lut),
                   {"ext_product_apply_scan": 1})
    _same(got.a, out.a)
    _same(got.b, out.b)
    t_bits = bridge.trgsw_dft_from_numpy(np.asarray(enc_bits.v),
                                         np.asarray(enc_bits.vs), P.l,
                                         P.Bg_bit, enc_bits.primes, CPU)
    t_luts = bridge.trlwe_from_numpy(np.asarray(luts.a), np.asarray(luts.b),
                                     CPU)
    got = _counted(lambda: tll.eval_lut_vertical(t_bits, size, t_luts),
                   {"ext_product_apply_scan": size - P.log_N,
                    "blind_rotate_scan": 1})
    _same(got.a, out_v.a)
    _same(got.b, out_v.b)


def test_leveled_lut_port_encryptions_decrypt():
    """The port's own encrypt_input, encrypt_lut and encrypt_input_bits
    (a torch.Generator) on the TPU package's ring key: every lookup
    decrypts within the TPU tests' bounds (2^57 direct, 2^58 vertical)."""
    key_trlwe, gk, size, table, values, _ = _leveled()
    kr = bridge.trlwe_key_from_numpy(np.asarray(key_trlwe.s),
                                     key_trlwe.sigma, key_trlwe.s_bound, CPU)
    tgk = ttrgsw.new_key(kr, P.l, P.Bg_bit)
    key_out = ttrlwe.extract_tlwe_key(kr)
    gen = torch.Generator().manual_seed(5)
    enc_lut = tll.encrypt_lut(torch.from_numpy(values), 7, kr, gen)
    for m in (0, 3, 17, 63):
        out = tll.eval_lut(tll.encrypt_input(m, tgk, gen), enc_lut)
        want = ttorus.int2torus(torch.tensor(int(values[m])), 7)
        assert _torus_err(ttlwe.phase(out, key_out), want) < 2.0**57, m
    luts = ttrlwe.encrypt(ttorus.int2torus(torch.from_numpy(table), 4)
                          .reshape(-1, P.N), kr, gen)
    for m in (0, 5, 77, 200, 255):
        bits = tll.encrypt_input_bits(m, size, tgk, gen)
        assert bits.v.shape[0] == size and bits.vs is not None
        out = tll.eval_lut_vertical(bits, size, luts)
        want = ttorus.int2torus(torch.tensor(int(table[m])), 4)
        assert _torus_err(ttlwe.phase(out, key_out), want) < 2.0**58, m


# --- ufhe ----------------------------------------------------------------------

@functools.cache
def _ufhe():
    """The TPU package's keysets and context at TOY, carried across."""
    k0, k1 = jax.random.split(KEY)
    priv = jax.jit(lambda k: jufhe.new_priv_keyset(k, P))(k0)
    pub = jax.jit(lambda k, pv: jufhe.new_public_keyset(k, pv,
                                                        torus_base=4))(
        k1, priv)
    ctx = jufhe.setup_context(pub)
    bk, ksk, pk = pub.bootstrap_key, pub.ks_key, pub.packing_key
    t_priv = bridge.ufhe_priv_keyset_from_numpy(
        np.asarray(priv.tlwe.s), np.asarray(priv.trlwe.s), P,
        priv.trlwe.s_bound, CPU)
    t_pub = bridge.ufhe_public_keyset_from_numpy(
        np.asarray(bk.v), np.asarray(bk.vs), np.asarray(ksk.a),
        np.asarray(ksk.b), np.asarray(pk.table), P, pk.torus_base, bk.primes,
        CPU)
    t_ctx = bridge.ufhe_context_from_numpy(
        t_pub, np.asarray(ctx.addsub_lut.a), np.asarray(ctx.addsub_lut.b),
        np.asarray(ctx.signextend_lut.a), np.asarray(ctx.signextend_lut.b),
        ctx.torus_base)
    return priv, ctx, t_priv, t_ctx


def _j_int(vals, prec, signed, seed, priv, ctx):
    """A batch of the TPU package's encrypted integers, digits [d, B]."""
    d = jufhe._n_digits(prec, ctx)
    lt = ctx.log_torus_base
    digs = np.stack([(np.asarray(vals) >> (i * lt)) & (ctx.torus_base - 1)
                     for i in range(d)])
    c = jax.jit(lambda dg, key, k, cx: jtlwe.encrypt(
        jufhe._digit_torus(dg, cx), key, k))(
        jnp.asarray(digs), priv.extracted, jax.random.fold_in(KEY, seed), ctx)
    return jufhe.Integer(digits=c, signed=signed)


def _t_int(c):
    return bridge.ufhe_integer_from_numpy(np.asarray(c.digits.a),
                                          np.asarray(c.digits.b), c.signed,
                                          CPU)


def _decrypt_batch(c, priv, ctx):
    """Every element of a batched port integer, as Python ints."""
    ph = ttlwe.phase(c.digits, priv.extracted)                 # [d, B]
    vals = (torch.round(ttorus.torus2double(ph) * (2 * ctx.torus_base))
            .to(torch.int64) % ctx.torus_base)
    out = torch.zeros(vals.shape[1:], dtype=torch.int64)
    for i in range(vals.shape[0] - 1, -1, -1):
        out = (out << ctx.log_torus_base) | vals[i]
    if c.signed:
        bits = ctx.log_torus_base * c.d
        out = torch.where(out >= 1 << (bits - 1), out - (1 << bits), out)
    return out.tolist()


def _same_int(got, want):
    _same(got.digits.a, want.digits.a)
    _same(got.digits.b, want.digits.b)
    assert got.signed == want.signed


def test_ufhe_bridge_round_trip_and_context():
    """Keysets, context and an integer across and back, word for word; the
    port's `setup_context` on the carried keyset gives the TPU package's
    test vectors; `decrypt_integer` of an unbatched integer."""
    priv, ctx, t_priv, t_ctx = _ufhe()
    s_tlwe, s_trlwe = bridge.ufhe_priv_keyset_to_numpy(t_priv)
    np.testing.assert_array_equal(s_tlwe, np.asarray(priv.tlwe.s))
    np.testing.assert_array_equal(s_trlwe, np.asarray(priv.trlwe.s))
    assert t_priv.extracted.sigma == priv.extracted.sigma
    back = bridge.ufhe_context_to_numpy(t_ctx)
    pub = ctx.keyset
    for got, want in ((back["addsub_b"], ctx.addsub_lut.b),
                      (back["signextend_b"], ctx.signextend_lut.b),
                      (back["keyset"]["bk_v"], pub.bootstrap_key.v),
                      (back["keyset"]["ks_a"], pub.ks_key.a),
                      (back["keyset"]["lut_table"], pub.packing_key.table)):
        np.testing.assert_array_equal(got, np.asarray(want))
    own = tufhe.setup_context(t_ctx.keyset)
    for got, want in ((own.addsub_lut, ctx.addsub_lut),
                      (own.signextend_lut, ctx.signextend_lut)):
        _same(got.a, want.a)
        _same(got.b, want.b)
    assert (own.mulmod, own.mulquo) == (ctx.mulmod, ctx.mulquo)
    c = jax.jit(lambda k, pv, cx: jufhe.encrypt_integer(
        k, 13, PREC, False, pv, cx))(jax.random.fold_in(KEY, 9), priv, ctx)
    tc = _t_int(c)
    a, b, signed = bridge.ufhe_integer_to_numpy(tc)
    np.testing.assert_array_equal(a, np.asarray(c.digits.a))
    np.testing.assert_array_equal(b, np.asarray(c.digits.b))
    assert tufhe.decrypt_integer(tc, t_priv, t_ctx) == 13
    three = _j_int([3], PREC, True, 8, priv, ctx)
    neg = tufhe.neg_integer(_t_int(three), t_ctx)
    _same_int(neg, jax.jit(jufhe.neg_integer)(three, ctx))
    assert _decrypt_batch(neg, t_priv, t_ctx) == [-3]


def _op_case(fn, j_args, want_vals, t_priv, t_ctx, want_counts=None):
    """fn on the TPU package's integers (jitted with the context as an
    argument) and on the port's: the same words, the cleartext results."""
    want = jax.jit(fn)(*j_args[:-1], j_args[-1])
    t_args = [_t_int(x) if isinstance(x, jufhe.Integer)
              else [_t_int(v) for v in x] if isinstance(x, list) else x
              for x in j_args[:-1]]
    if want_counts is None:
        got = fn(*t_args, t_ctx)
    else:
        got = _counted(lambda: fn(*t_args, t_ctx), want_counts)
    _same_int(got, want)
    assert _decrypt_batch(got, t_priv, t_ctx) == want_vals
    return got


def _either(j_fn, t_fn):
    """One callable for both packages, picked by the context's type."""
    return lambda *args: (j_fn if isinstance(args[-1], jufhe.Context)
                          else t_fn)(*args)


def test_ufhe_add_sub_match_jnp():
    """add (3 output digits: 3 K1 and 3 K2 plain calls) and sub (2 digits:
    2 and 2) on three pairs."""
    priv, ctx, t_priv, t_ctx = _ufhe()
    a = _j_int(VA, PREC, False, 1, priv, ctx)
    b = _j_int(VB, PREC, False, 2, priv, ctx)
    _op_case(_either(lambda a, b, c: jufhe.add_integer(a, b, 3, c),
                     lambda a, b, c: tufhe.add_integer(a, b, 3, c)),
             [a, b, ctx], [x + y for x, y in zip(VA, VB)], t_priv, t_ctx,
             {"blind_rotate_scan": 3, "tlwe_keyswitch_sum": 3})
    _op_case(_either(lambda a, b, c: jufhe.sub_integer(a, b, 2, c),
                     lambda a, b, c: tufhe.sub_integer(a, b, 2, c)),
             [a, b, ctx], [(x - y) % 16 for x, y in zip(VA, VB)], t_priv,
             t_ctx, {"blind_rotate_scan": 2, "tlwe_keyswitch_sum": 2})


def test_ufhe_mul_matches_jnp():
    """mul into 3 digits on three pairs (mod 64)."""
    priv, ctx, t_priv, t_ctx = _ufhe()
    a = _j_int(VA, PREC, False, 3, priv, ctx)
    b = _j_int(VB, PREC, False, 4, priv, ctx)
    _op_case(_either(lambda a, b, c: jufhe.mul_integer(a, b, 3, c),
                     lambda a, b, c: tufhe.mul_integer(a, b, 3, c)),
             [a, b, ctx], [x * y % 64 for x, y in zip(VA, VB)], t_priv,
             t_ctx)


def test_ufhe_cmp_and_relu_match_jnp():
    """cmp (2 digits: 2 K1 and 4 K2 plain calls) on (3, 9), (9, 9),
    (12, 9); relu (signed, 2 digits: 2 K1 and 2 K2) of 5 and -5."""
    priv, ctx, t_priv, t_ctx = _ufhe()
    a = _j_int([3, 9, 12], PREC, False, 10, priv, ctx)
    b = _j_int([9, 9, 9], PREC, False, 11, priv, ctx)
    _op_case(_either(jufhe.cmp_integer, tufhe.cmp_integer), [a, b, ctx],
             [0, 1, 2], t_priv, t_ctx,
             {"blind_rotate_scan": 2, "tlwe_keyswitch_sum": 4})
    r = _j_int([5, (-5) % 16], PREC, True, 12, priv, ctx)
    _op_case(_either(jufhe.relu_integer, tufhe.relu_integer), [r, ctx],
             [5, 0], t_priv, t_ctx,
             {"blind_rotate_scan": 2, "tlwe_keyswitch_sum": 2})


def test_ufhe_lut_and_mux_match_jnp():
    """lut_integer of a 16-entry LUT (2 output digits) at selectors 5 and
    14; mux_integer_array over 4 integers at selectors 2 and 1."""
    priv, ctx, t_priv, t_ctx = _ufhe()
    lut = [(3 * i + 1) % 16 for i in range(16)]
    sel = _j_int([5, 14], PREC, False, 40, priv, ctx)
    _op_case(_either(lambda s, c: jufhe.lut_integer(s, lut, 16, 2, c),
                     lambda s, c: tufhe.lut_integer(s, lut, 16, 2, c)),
             [sel, ctx], [lut[5], lut[14]], t_priv, t_ctx)
    vec = [_j_int([v, v], PREC, False, 50 + v, priv, ctx)
           for v in (9, 4, 7, 2)]
    sel1 = _j_int([2, 1], 2, False, 41, priv, ctx)
    _op_case(_either(lambda s, v, c: jufhe.mux_integer_array(s, v, 2, c),
                     lambda s, v, c: tufhe.mux_integer_array(s, v, 2, c)),
             [sel1, vec, ctx], [7, 4], t_priv, t_ctx)


def test_ufhe_port_keygens_decrypt():
    """The port's own keysets (a torch.Generator) at TOY: an integer
    encrypted by `encrypt_integer` decrypts; add and cmp of 7 and 6 give 13
    and 2; a cleartext integer and `extend_integer` keep their value."""
    gen = torch.Generator().manual_seed(31)
    priv = tufhe.new_priv_keyset(gen, P, CPU)
    pub = tufhe.new_public_keyset(gen, priv, torus_base=4, device=CPU)
    ctx = tufhe.setup_context(pub)
    assert pub.packing_key.table.shape == (P.k * P.N, 4, P.t,
                                           (1 << P.base_bit) - 1, 2, P.N)
    a = tufhe.encrypt_integer(gen, 7, PREC, False, priv, ctx)
    b = tufhe.encrypt_integer(gen, 6, PREC, False, priv, ctx)
    assert tufhe.decrypt_integer(a, priv, ctx) == 7
    assert tufhe.decrypt_integer(tufhe.add_integer(a, b, 3, ctx), priv,
                                 ctx) == 13
    assert tufhe.decrypt_integer(tufhe.cmp_integer(a, b, ctx), priv,
                                 ctx) == 2
    c = tufhe.cleartext_integer(9, PREC, False, ctx)
    assert tufhe.decrypt_integer(c, priv, ctx) == 9
    wide = tufhe.Integer(digits=ttlwe.TLWE(
        a=torch.cat([c.digits.a, c.digits.a]),
        b=torch.cat([c.digits.b, c.digits.b])), signed=False)
    assert tufhe.decrypt_integer(tufhe.extend_integer(wide, PREC, ctx),
                                 priv, ctx) == 9
    moved = priv.to(CPU)
    assert torch.equal(moved.trgsw.trlwe_key.s, priv.trlwe.s)
    assert tufhe.decrypt_integer(a, moved, ctx.to(CPU)) == 7
