"""The port's ciphertext products against the TPU package, bit for bit, at
TOY (k = 1; the relinearization gadget, t = 2 digits of 20 bits, needs the
64-bit torus): `tensor_prod` and `tensor_prod_fft` on random TRLWEs and a
random relinearization key (one K6 plain call each for the
relinearization), and `tlwe_mul` of 5 and 11 at precision 4 (the matrix
op's case, `benchmarks/full_matrix_tpu.py:324-339`) on keys made by the TPU
package (the same words; one K2 plain call for both packing switches) and
on the port's own keys, dense and seeded, each giving 5 x 11 mod 16 = 7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import keyswitch as jks, ntt as jntt, params, \
    product as jproduct, tlwe as jtlwe, torus as jtorus, trlwe as jtrlwe
from mosfhet_torch import bridge, keyswitch as tks, ntt as tntt, \
    product as tproduct, tlwe as ttlwe, torus as ttorus, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk

CPU = "cpu"
P = params.TOY
PREC = 4
RL_T, RL_BIT = 2, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread per worker keeps this file's many
    small ops off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want_a, want_b):
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want_a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want_b))


def test_tensor_products_match_jnp():
    """A [2] batch of random TRLWE pairs; the relinearization key's rows are
    the NTT form of random torus words under the 4 primes its gadget
    needs."""
    rs = np.random.default_rng(1818)
    primes = jks._ks_plan(P.N, RL_BIT, RL_T, RL_T).primes
    assert len(primes) == 4
    words = rs.integers(0, 1 << 64, (1, RL_T, 2, P.N), dtype=np.uint64)
    v = tntt.to_ntt_u64(torch.from_numpy(words.view(np.int64)),
                        tntt.get_plan(P.N, primes, CPU)).numpy()
    a1, a2 = (rs.integers(0, 1 << 64, (2, 1, P.N), dtype=np.uint64)
              for _ in range(2))
    b1, b2 = (rs.integers(0, 1 << 64, (2, P.N), dtype=np.uint64)
              for _ in range(2))

    def jax_side(v, a1, b1, a2, b2):
        plan = jntt.get_plan(P.N, primes)
        rl = jks.TRLWEKSKey(v=v, vs=jntt.make_shoup(v, plan.p[:, None]),
                            t=RL_T, base_bit=RL_BIT, primes=primes)
        c1, c2 = jtrlwe.TRLWE(a=a1, b=b1), jtrlwe.TRLWE(a=a2, b=b2)
        return [(o.a, o.b) for o in (jproduct.tensor_prod(c1, c2, PREC, rl),
                                     jproduct.tensor_prod_fft(c1, c2, PREC,
                                                              rl))]

    want = jax.jit(jax_side)(v.astype(np.uint64), a1, b1, a2, b2)
    rl = bridge.trlwe_ks_key_from_numpy(v, RL_T, RL_BIT, primes, CPU)
    c1 = bridge.trlwe_from_numpy(a1, b1, CPU)
    c2 = bridge.trlwe_from_numpy(a2, b2, CPU)
    for fn, (wa, wb) in zip((tproduct.tensor_prod, tproduct.tensor_prod_fft),
                            want):
        calls = tpk.auto_keyswitch_stream_plain.calls
        _same(fn(c1, c2, PREC, rl), wa, wb)
        assert tpk.auto_keyswitch_stream_plain.calls == calls + 1


def _decode(c, key):
    ph = ttlwe.phase(c, key)
    return int(ttorus.torus2int(ph, PREC)) % (1 << PREC)


def test_tlwe_mul_matches_jnp_and_gives_7():
    """The TPU package's keygens (packing1 table, relinearization key) and
    ciphertexts of 5 and 11, carried across: the port's `tlwe_mul` gives
    the jnp words, which decrypt to 7."""
    k0, k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(1819), 5)
    kr = jtrlwe.new_binary_key(k0, P.N, P.k, P.rlwe_sigma)
    kt = jtrlwe.extract_tlwe_key(kr)

    def jax_side(r1, r2, r3, r4):
        rlk = jks.new_rl_key(r1, kr, RL_T, RL_BIT)
        ksk = jks.new_packing1_ks_key(r2, kr, kt, P.t, P.base_bit)
        c1 = jtlwe.encrypt(jtorus.int2torus(jnp.uint64(5), PREC), kt, r3)
        c2 = jtlwe.encrypt(jtorus.int2torus(jnp.uint64(11), PREC), kt, r4)
        out = jproduct.tlwe_mul(c1, c2, PREC, ksk, rlk)
        return rlk.v, ksk.table, c1, c2, out

    rl_v, table, c1, c2, out = jax.jit(jax_side)(k1, k2, k3, k4)
    rlk = bridge.trlwe_ks_key_from_numpy(np.asarray(rl_v), RL_T, RL_BIT,
                                         jks._ks_plan(P.N, RL_BIT, RL_T,
                                                      RL_T).primes, CPU)
    ksk = bridge.generic_ks_key_from_numpy(np.asarray(table), P.t,
                                           P.base_bit, False, CPU)
    calls = (tpk.tlwe_keyswitch_sum_plain.calls,
             tpk.auto_keyswitch_stream_plain.calls)
    got = tproduct.tlwe_mul(
        bridge.tlwe_from_numpy(np.asarray(c1.a), np.asarray(c1.b), CPU),
        bridge.tlwe_from_numpy(np.asarray(c2.a), np.asarray(c2.b), CPU),
        PREC, ksk, rlk)
    assert (tpk.tlwe_keyswitch_sum_plain.calls,
            tpk.auto_keyswitch_stream_plain.calls) == (calls[0] + 1,
                                                       calls[1] + 1)
    _same(got, out.a, out.b)
    key = bridge.tlwe_key_from_numpy(np.asarray(kt.s), kt.sigma, CPU)
    assert _decode(got, key) == 7


def test_port_keys_tlwe_mul_gives_7():
    """The port's own keygens: `tlwe_mul` of 5 and 11 through a dense
    packing1 table and through a seeded one (the streamed gather), the two
    the same words, each 7; `tensor_prod` and `tensor_prod_fft` of TRLWEs
    decrypt to the negacyclic product of the messages within 2^56 (the TPU
    package's bound)."""
    gen = torch.Generator().manual_seed(1820)
    kr = ttrlwe.new_binary_key(P.N, P.k, P.rlwe_sigma, gen, CPU)
    kt = ttrlwe.extract_tlwe_key(kr)
    rlk = tks.new_rl_key(kr, RL_T, RL_BIT, gen, CPU)
    assert len(rlk.primes) == 4
    c1 = ttlwe.encrypt(ttorus.int2torus(torch.tensor(5), PREC), kt, gen)
    c2 = ttlwe.encrypt(ttorus.int2torus(torch.tensor(11), PREC), kt, gen)
    dense = tks.new_packing1_ks_key(kr, kt, P.t, P.base_bit, gen, CPU)
    seeded = tks.new_packing1_ks_key_seeded(kr, kt, P.t, P.base_bit, gen,
                                            CPU)
    outs = [tproduct.tlwe_mul(c1, c2, PREC, k, rlk)
            for k in (seeded, tks.expand_generic_ks_key(seeded), dense)]
    torch.testing.assert_close(outs[0].a, outs[1].a, rtol=0, atol=0)
    torch.testing.assert_close(outs[0].b, outs[1].b, rtol=0, atol=0)
    assert [_decode(o, kt) for o in outs] == [7, 7, 7]
    m1 = ttorus.int2torus(torch.arange(P.N) % 3, PREC)
    m2 = torch.zeros(P.N, dtype=torch.int64)
    m2[1] = ttorus.int2torus(torch.tensor(1), PREC)
    e1, e2 = ttrlwe.encrypt(m1, kr, gen), ttrlwe.encrypt(m2, kr, gen)
    # (m1 m2) at scale 2^PREC: m2 = X / 2^PREC shifts m1 by one slot
    want = ttorus.int2torus(torch.roll(torch.arange(P.N) % 3, 1) * torch.where(
        torch.arange(P.N) == 0, -1, 1), PREC)
    for fn in (tproduct.tensor_prod, tproduct.tensor_prod_fft):
        d = to_numpy(ttrlwe.phase(fn(e1, e2, PREC, rlk), kr) - want)
        assert np.abs(d.view(np.int64).astype(np.float64)).max() <= 2.0**56
