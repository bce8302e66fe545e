"""The port's full-domain bootstrap "this work" (sign PBS, key switch, PBS)
against the TPU package's, bit for bit at TOY with key material made by the
TPU package; and end to end with the port's own keys."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mosfhet_tpu import bootstrap as jbs, params, rng as jrng, \
    tlwe as jtlwe, torus as jtorus, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_torch import bootstrap as tbs, bridge, rng as trng, \
    tlwe as ttlwe, torus as ttorus, trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk

KEY = jax.random.PRNGKey(4243)
CPU = "cpu"
PREC = 3


def _max_err(got, want):
    d = (to_numpy(got) - np.asarray(want, np.uint64)).view(np.int64)
    return np.abs(d.astype(np.float64)).max()


def test_fdfb_this_work_matches_jax():
    """All 8 messages of precision 3 in one batch, as the TPU package's
    test runs them one by one (`tests/test_advanced.py:124-137`)."""
    p = params.TOY
    kk = jax.random.split(KEY, 6)
    key_tlwe = jtlwe.new_binary_key(kk[0], p.n, p.lwe_sigma)
    key_trlwe = jtrlwe.new_binary_key(kk[1], p.N, p.k, p.rlwe_sigma)
    key_out = jtrlwe.extract_tlwe_key(key_trlwe)
    gk = jtrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = jax.jit(lambda rk: jbs.new_key(rk, gk, key_tlwe))(kk[2])
    tksk = jax.jit(lambda rk: jtlwe.new_ks_key(
        rk, key_tlwe, key_out, p.t, p.base_bit))(kk[3])
    luts = jrng.uniform_torus(kk[4], (8,))
    tv = jtrlwe.torus_packing_many_lut(luts, 4, 2, p.k, p.N)
    c = jax.jit(jtlwe.encrypt)(
        jtorus.int2torus(jnp.arange(8, dtype=jnp.uint64), PREC), key_tlwe,
        kk[5])
    want = jax.jit(lambda c_: jbs.fdfb_this_work(tv, c_, bk, tksk, PREC))(c)

    bk_t = bridge.bootstrap_key_from_numpy(
        np.asarray(bk.v), np.asarray(bk.vs), bk.n, bk.k, bk.N, bk.l,
        bk.Bg_bit, bk.primes, CPU)
    ksk_t = bridge.tlwe_ks_key_from_numpy(np.asarray(tksk.a),
                                          np.asarray(tksk.b), p.t, p.base_bit,
                                          CPU)
    tv_t = ttrlwe.torus_packing_many_lut(bridge.to_tensor(luts, CPU), 4, 2,
                                         p.k, p.N)
    c_t = bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)
    got = tbs.fdfb_this_work(tv_t, c_t, bk_t, ksk_t, PREC)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))
    ph = ttlwe.phase(got, bridge.tlwe_key_from_numpy(
        np.asarray(key_out.s), key_out.sigma, CPU))
    assert _max_err(ph, luts) <= 2.0**58


def test_port_keygen_fdfb_decrypts():
    """The port alone: its keygen, encryption of m = 0..7 at precision 3,
    `fdfb_this_work` on CPU tensors (two plain rotations and one plain
    select-sum, no kernel), every output within 2^58 of its LUT entry."""
    p = params.TOY
    gen = torch.Generator().manual_seed(17)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    key_out = ttrlwe.extract_tlwe_key(key_trlwe)
    bk = tbs.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe, gen,
                     CPU)
    ksk = ttlwe.new_ks_key(key_tlwe, key_out, p.t, p.base_bit, gen, CPU)
    luts = trng.uniform_torus(gen, (8,), CPU)
    tv = ttrlwe.torus_packing_many_lut(luts, 4, 2, p.k, p.N)
    m = torch.arange(16) % 8
    c = ttlwe.encrypt(ttorus.int2torus(m, PREC), key_tlwe, gen)
    counts = (tpk.blind_rotate_scan.launches, tpk.tlwe_keyswitch_sum.launches,
              tpk.blind_rotate_scan_plain.calls,
              tpk.tlwe_keyswitch_sum_plain.calls)
    out = tbs.fdfb_this_work(tv, c, bk, ksk, PREC)
    assert (tpk.blind_rotate_scan.launches, tpk.tlwe_keyswitch_sum.launches,
            tpk.blind_rotate_scan_plain.calls,
            tpk.tlwe_keyswitch_sum_plain.calls) == (
        counts[0], counts[1], counts[2] + 2, counts[3] + 1)
    assert out.a.shape == (16, p.k * p.N) and out.b.shape == (16,)
    assert _max_err(ttlwe.phase(out, key_out), to_numpy(luts[m])) <= 2.0**58
