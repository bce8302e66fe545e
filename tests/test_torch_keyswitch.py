"""The port's TLWE key switch against the TPU package, bit for bit: the
table form (jnp path and the interpret-mode K2 kernel), the C library's own
output vector, the no-precomputation and int8-limb forms, the plain
select-sum against the TPU kernel, and the linear ops and LUT packings.
Key material is made by the TPU package and carried by `bridge`; the port's
own key generation is held to the noise bound."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import io as mio, tlwe as jtlwe, torus as jtorus, \
    trlwe as jtrlwe
from mosfhet_tpu.ops import pbs_kernel as jpk
from mosfhet_torch import bridge, tlwe as ttlwe, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

KEY = jax.random.PRNGKey(1618)
CPU = "cpu"
VEC = os.path.join(os.path.dirname(__file__), "vectors")


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want, np.uint64))


def _eq_tlwe(got, want):
    _eq(got.a, want.a)
    _eq(got.b, want.b)


def _jax_ks_case(seed, n_out, n_in, t, base_bit, batch, sigma=0.0):
    """TPU-package keys, KS table and ciphertexts, and their port copies."""
    kk = jax.random.split(jax.random.fold_in(KEY, seed), 4)
    out_key = jtlwe.new_binary_key(kk[0], n_out, sigma)
    in_key = jtlwe.new_binary_key(kk[1], n_in, sigma)
    ksk = jax.jit(lambda k: jtlwe.new_ks_key(k, out_key, in_key, t,
                                             base_bit))(kk[2])
    m = jtorus.double2torus(jnp.arange(batch) / 16.0)
    c = jax.jit(jtlwe.encrypt)(m, in_key, kk[3])
    tksk = bridge.tlwe_ks_key_from_numpy(np.asarray(ksk.a), np.asarray(ksk.b),
                                         t, base_bit, CPU)
    tc = bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)
    return ksk, c, tksk, tc


def test_keyswitch_matches_jnp_and_tpu_kernel_interpret():
    """TOY widths (n_in = kN = 64, t=8, base_bit=4), batch 5 (the TPU
    route pads it to 64)."""
    ksk, c, tksk, tc = _jax_ks_case(1, n_out=16, n_in=64, t=8, base_bit=4,
                                    batch=5)
    got = ttlwe.keyswitch(tc, tksk)
    for impl in ("jnp", "pallas_interpret"):
        _eq_tlwe(got, jax.jit(lambda c_: jtlwe.keyswitch(c_, ksk,
                                                         impl=impl))(c))
    # one unbatched ciphertext gives the same words
    one = ttlwe.keyswitch(ttlwe.TLWE(a=tc.a[3], b=tc.b[3]), tksk)
    assert torch.equal(one.a, got.a[3]) and torch.equal(one.b, got.b[3])


def test_keyswitch_matches_jnp_at_l2_widths():
    """TFHEpp-L2 key-switch widths (n_out=632, t=8, base_bit=4) with n_in
    cut from 2048 to 128 (a 78 MB table)."""
    ksk, c, tksk, tc = _jax_ks_case(2, n_out=632, n_in=128, t=8, base_bit=4,
                                    batch=3, sigma=2.0**-15)
    assert tuple(tksk.ab.shape) == (128, 8, 15, 633)
    want = jax.jit(lambda c_: jtlwe.keyswitch(c_, ksk, impl="jnp"))(c)
    _eq_tlwe(ttlwe.keyswitch(tc, tksk), want)


def test_plain_sum_matches_tpu_kernel_interpret():
    """`tlwe_keyswitch_sum_plain` against the TPU kernel on the same digits
    and table (split into u32 planes for it), digits 0 and base-1 present,
    two n_in chunks of the TPU grid."""
    B, n_in, t, base_m1, npad = 16, 32, 6, 15, 128
    rng = np.random.default_rng(21)
    dig = rng.integers(0, base_m1 + 1, (B, n_in, t), dtype=np.int32)
    dig[0, 0, 0], dig[-1, -1, -1] = 0, base_m1
    ab = rng.integers(0, 1 << 64, (n_in, t, base_m1, npad), dtype=np.uint64)
    planes = (jnp.asarray((ab & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
              jnp.asarray((ab >> np.uint64(32)).astype(np.uint32)))
    want = jpk.tlwe_keyswitch_sum(jnp.asarray(dig), planes, bt=8, chunk_i=16,
                                  interpret=True)
    got = tpk.tlwe_keyswitch_sum_plain(torch.from_numpy(dig),
                                       to_tensor(ab, CPU))
    _eq(got, want)


def test_keyswitch_matches_c_library_vector():
    """The C library's own key switch output (`tests/vectors/`, made by
    the reference with sigma = 0), word for word."""
    with open(os.path.join(VEC, "vec_trlwe_key.bin"), "rb") as f:
        rkey = mio.import_mosfhet_trlwe_key(f)
    with open(os.path.join(VEC, "vec_tlwe_key.bin"), "rb") as f:
        tkey = mio.import_mosfhet_tlwe_key(f)
    with open(os.path.join(VEC, "vec_tlwe_ks_key.bin"), "rb") as f:
        ksk = mio.import_mosfhet_tlwe_ks_key(f)
    with open(os.path.join(VEC, "vec_tlwe_big.bin"), "rb") as f:
        c_in = mio.import_mosfhet_tlwe(f, rkey.k * rkey.N)
    with open(os.path.join(VEC, "vec_tlwe_switched.bin"), "rb") as f:
        c_want = mio.import_mosfhet_tlwe(f, tkey.n)
    tksk = bridge.tlwe_ks_key_from_numpy(np.asarray(ksk.a), np.asarray(ksk.b),
                                         ksk.t, ksk.base_bit, CPU)
    got = ttlwe.keyswitch(bridge.tlwe_from_numpy(
        np.asarray(c_in.a), np.asarray(c_in.b), CPU), tksk)
    _eq_tlwe(got, c_want)


def test_no_precomp_and_int8_forms_match():
    """`keyswitch_no_precomp` and `keyswitch_mxu` against the TPU package's
    and against each other; the limb split equal too."""
    kk = jax.random.split(jax.random.PRNGKey(21), 4)
    out_key = jtlwe.new_binary_key(kk[0], 24, 2.0**-30)
    in_key = jtlwe.new_binary_key(kk[1], 300, 2.0**-30)
    ksk = jax.jit(lambda k: jtlwe.new_ks_key_no_precomp(
        k, out_key, in_key, 5, 3))(kk[2])
    pksk = jax.jit(jtlwe.prepare_ks_key_mxu)(ksk)
    c = jax.jit(jtlwe.encrypt)(jtorus.double2torus(jnp.arange(16) / 32.0),
                               in_key, kk[3])
    want = jax.jit(jtlwe.keyswitch_no_precomp)(c, ksk)
    tksk = bridge.tlwe_ks_key_m_from_numpy(np.asarray(ksk.a),
                                           np.asarray(ksk.b), 5, 3, CPU)
    tp = ttlwe.prepare_ks_key_mxu(tksk)
    np.testing.assert_array_equal(tp.a_nib.numpy(), np.asarray(pksk.a_nib))
    np.testing.assert_array_equal(tp.b_nib.numpy(), np.asarray(pksk.b_nib))
    tc = bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)
    got_np = ttlwe.keyswitch_no_precomp(tc, tksk)
    got_mxu = ttlwe.keyswitch_mxu(tc, tp)
    _eq_tlwe(got_np, want)
    _eq_tlwe(got_mxu, jax.jit(jtlwe.keyswitch_mxu)(c, pksk))
    assert torch.equal(got_np.a, got_mxu.a) and torch.equal(got_np.b,
                                                            got_mxu.b)


def test_linear_ops_and_lut_packings_match():
    rng = np.random.default_rng(31)
    w = lambda *shape: rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    a1, b1, a2, b2 = w(4, 9), w(4), w(4, 9), w(4)
    a1[0, 0], b2[1] = 0, (1 << 63)
    j1, j2 = jtlwe.TLWE(a=jnp.asarray(a1), b=jnp.asarray(b1)), \
        jtlwe.TLWE(a=jnp.asarray(a2), b=jnp.asarray(b2))
    t1, t2 = bridge.tlwe_from_numpy(a1, b1, CPU), \
        bridge.tlwe_from_numpy(a2, b2, CPU)
    _eq_tlwe(ttlwe.add(t1, t2), jtlwe.add(j1, j2))
    _eq_tlwe(ttlwe.sub(t1, t2), jtlwe.sub(j1, j2))
    _eq_tlwe(ttlwe.neg(t2), jtlwe.neg(j2))
    ws = np.array([0, 3, (1 << 64) - 5, 1 << 63], np.uint64)
    _eq_tlwe(ttlwe.scale(t1, to_tensor(ws, CPU)),
             jtlwe.scale(j1, jnp.asarray(ws)))
    _eq_tlwe(ttlwe.noiseless_trivial(to_tensor(b1, CPU), 9),
             jtlwe.noiseless_trivial(jnp.asarray(b1), 9))
    vals = w(8)
    for k, N in ((1, 64), (2, 64)):
        _eq(ttrlwe.torus_packing_many_lut(to_tensor(vals, CPU), 4, 2, k,
                                          N).stacked(),
            jtrlwe.torus_packing_many_lut(jnp.asarray(vals), 4, 2, k,
                                          N).stacked())
        ints = rng.integers(0, 8, 8)
        _eq(ttrlwe.lut_packing(torch.from_numpy(ints), 3, 3, k, N).stacked(),
            jtrlwe.lut_packing(jnp.asarray(ints, jnp.uint64), 3, 3, k,
                               N).stacked())
    with pytest.raises(ValueError, match="precision 2"):
        ttrlwe.lut_packing(torch.arange(8), 2, 3, 1, 64)


def test_port_ks_keygen_decrypts_within_noise():
    """The port's own key generation (PyTorch's generator: not the TPU
    package's stream) switched at TOY widths.  Noise: 480 table entries of
    sigma 2^-28 give ~2^-23.5 of the torus (2^40.5 in words), and the
    32-bit digit truncation adds at most 64 x 2^31 = 2^37; 2^45 is > 20
    sigma above that."""
    gen = torch.Generator().manual_seed(41)
    in_key = ttlwe.new_binary_key(64, 2.0**-28, gen, CPU)
    out_key = ttlwe.new_bounded_key(16, 4, 2.0**-28, gen, CPU)
    assert set(out_key.s.tolist()) <= {-1, 0, 1, 2}
    ksk = ttlwe.new_ks_key(out_key, in_key, 8, 4, gen, CPU)
    assert tuple(ksk.ab.shape) == (64, 8, 15, 17)
    assert ksk.a.untyped_storage().data_ptr() == \
        ksk.ab.untyped_storage().data_ptr()        # one table, two views
    ms = to_tensor(np.arange(8, dtype=np.uint64) << np.uint64(61), CPU)
    out = ttlwe.keyswitch(ttlwe.encrypt(ms, in_key, gen), ksk)
    err = to_numpy(ttlwe.phase(out, out_key) - ms).view(np.int64)
    assert np.abs(err.astype(np.float64)).max() < 2.0**45
    kskm = ttlwe.new_ks_key_no_precomp(out_key, in_key, 8, 4, gen, CPU)
    out = ttlwe.keyswitch_no_precomp(ttlwe.encrypt(ms, in_key, gen), kskm)
    err = to_numpy(ttlwe.phase(out, out_key) - ms).view(np.int64)
    assert np.abs(err.astype(np.float64)).max() < 2.0**45


def test_keyswitch_on_cpu_never_touches_the_kernel():
    gen = torch.Generator().manual_seed(43)
    in_key = ttlwe.new_binary_key(32, 0.0, gen, CPU)
    out_key = ttlwe.new_binary_key(8, 0.0, gen, CPU)
    ksk = ttlwe.new_ks_key(out_key, in_key, 4, 2, gen, CPU)
    launches = tpk.tlwe_keyswitch_sum.launches
    calls = tpk.tlwe_keyswitch_sum_plain.calls
    ttlwe.keyswitch(ttlwe.encrypt(torch.zeros(3, dtype=torch.int64), in_key,
                                  gen), ksk)
    assert tpk.tlwe_keyswitch_sum.launches == launches
    assert tpk.tlwe_keyswitch_sum_plain.calls == calls + 1


def test_ks_keygen_refuses_to_pick_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(1)
    in_key = ttlwe.new_binary_key(8, 0.0, gen, CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttlwe.new_ks_key(in_key, in_key, 2, 2, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttlwe.new_ks_key_no_precomp(in_key, in_key, 2, 2, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttlwe.new_bounded_key(8, 4, 0.0, gen)


def test_ks_key_bridge_round_trips():
    rng = np.random.default_rng(51)
    w = lambda *shape: rng.integers(0, 1 << 64, shape, dtype=np.uint64)
    a, b = w(3, 2, 7, 5), w(3, 2, 7)
    ksk = bridge.tlwe_ks_key_from_numpy(a, b, 2, 3, CPU)
    assert tuple(ksk.ab.shape) == (3, 2, 7, 6)
    for got, want in zip(bridge.tlwe_ks_key_to_numpy(ksk), (a, b)):
        np.testing.assert_array_equal(got, want)
    a, b = w(3, 2, 5), w(3, 2)
    for got, want in zip(bridge.tlwe_ks_key_m_to_numpy(
            bridge.tlwe_ks_key_m_from_numpy(a, b, 2, 3, CPU)), (a, b)):
        np.testing.assert_array_equal(got, want)
    an = rng.integers(0, 16, (16, 6, 5)).astype(np.int8)
    bn = rng.integers(0, 16, (16, 6)).astype(np.int8)
    pk = bridge.tlwe_ks_key_prepared_from_numpy(an, bn, 2, 3, CPU)
    assert pk.a_nib.dtype == torch.int8
    for got, want in zip(bridge.tlwe_ks_key_prepared_to_numpy(pk), (an, bn)):
        np.testing.assert_array_equal(got, want)
