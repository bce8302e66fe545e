"""The rotation-free blind rotation (``rot_ntt=True``) of the port against
the TPU package's ``MOSFHET_ROT_NTT=1`` jnp path, word for word: the twiddle
tables, the plain versions of K1, K1-step and K8a in their rotation-free
forms, the entry points (`blind_rotate`, `blind_rotate_stepwise`,
`functional_bootstrap`, `programmable_bootstrap`, `parallel.mesh.
pbs_on_mesh`), and the cases that raise.  The TPU package reads its switch
when a function is traced, so every JAX call here is a fresh `jax.jit`
traced after the variable is set.  TOY and TOY_K2 keys come from the TPU
package's keygen; the TFHEpp-L2 widths (N=2048, l=4, 3 primes) take random
key residues, with the rotation cut to 8 steps.  The 32-bit torus cases are
in the `test_torch_torus32.py` child.  No tolerance: every word must be
equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap as jbs, io as jio, ntt as jntt, params, \
    rng as jrng, tlwe as jtlwe, torus as jtorus, trgsw as jtrgsw, \
    trlwe as jtrlwe
from mosfhet_tpu.parallel import mesh as jmesh
from mosfhet_torch import bootstrap as tbs, bridge, io as tio, ntt as tntt, \
    rng as trng, tlwe as ttlwe, trgsw as ttrgsw, trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from mosfhet_torch.parallel import mesh as tmesh
from tests.test_torch_suite_env import port_test_env  # noqa: F401

CPU = "cpu"
KEY = jax.random.PRNGKey(8086)
L2 = params.TFHEPP_L2
L2_CUT = 8       # rotation steps at the L2 widths


@pytest.fixture
def rot_env(monkeypatch):
    """The TPU package's switch, for the JAX calls traced after it."""
    monkeypatch.setenv("MOSFHET_ROT_NTT", "1")
    assert jntt.rot_ntt_enabled()
    return monkeypatch


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))


@functools.cache
def _keys(name):
    """The TPU package's keys at TOY or TOY_K2 (one compiled keygen per
    set, once per file) and the port's bootstrap key carried by `bridge`;
    at L2 widths random canonical key residues for L2_CUT steps."""
    p = params.get_params(name)
    k0, k1, k2 = jax.random.split(jax.random.fold_in(KEY, p.k), 3)
    if name == L2.name:
        primes = jntt.primes_for_bound(jntt.external_product_bound(
            p.N, p.Bg_bit, p.l, p.k), p.N)
        rs = np.random.default_rng(2048)
        J, C = (p.k + 1) * p.l, p.k + 1
        pr = np.array(primes, np.uint64)[:, None]
        v = rs.integers(0, 1 << 62, (L2_CUT, J, C, len(primes), p.N),
                        dtype=np.uint64) % pr
        vs = (v << np.uint64(32)) // pr
        bk = jbs.BootstrapKey(v=jnp.asarray(v), vs=jnp.asarray(vs), su=None,
                              n=L2_CUT, k=p.k, N=p.N, l=p.l, Bg_bit=p.Bg_bit,
                              unfolding=1, primes=primes)
        key_tlwe = key_out = None
    else:
        key_tlwe = jtlwe.new_binary_key(k0, p.n, p.lwe_sigma)
        key_trlwe = jtrlwe.new_binary_key(k1, p.N, p.k, p.rlwe_sigma)
        key_out = jtrlwe.extract_tlwe_key(key_trlwe)
        gk = jtrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
        bk = jax.jit(lambda rk, s: jbs.new_key(
            rk, gk, jtlwe.TLWEKey(s=s, sigma=key_tlwe.sigma)))(k2, key_tlwe.s)
    bk_t = bridge.bootstrap_key_from_numpy(
        np.asarray(bk.v), np.asarray(bk.vs), bk.n, bk.k, bk.N, bk.l,
        bk.Bg_bit, bk.primes, CPU)
    return p, bk, bk_t, key_tlwe, key_out


def _rotation_inputs(p, n, B, seed):
    rs = np.random.default_rng(seed)
    a = rs.integers(0, 1 << 64, (B, p.k, p.N), dtype=np.uint64)
    b = rs.integers(0, 1 << 64, (B, p.N), dtype=np.uint64)
    mask = rs.integers(0, 1 << 64, (B, n), dtype=np.uint64)
    mask[0, :3] = [0, 1 << 63, (1 << 64) - 1]    # a = 0, N and 2N
    return ((jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
             jnp.asarray(mask)),
            (bridge.trlwe_from_numpy(a, b, CPU), bridge.to_tensor(mask, CPU)))


# --- the twiddle tables -------------------------------------------------------

@pytest.mark.parametrize("N", [64, 256])
def test_twiddle_table_equals_xpow(N):
    """zeta^a - 1 from the table lookup equals the TPU package's and the
    port's `ntt.xpow` less one, for every a in [0, 2N]."""
    primes = tntt.primes_for_bound(tntt.external_product_bound(N, 9, 3, 1))
    tp, jp = tntt.get_plan(N, primes, CPU), jntt.get_plan(N, primes)
    a = np.arange(2 * N + 1, dtype=np.int32)
    want = np.asarray(jax.jit(lambda x: jntt.xpow(x, jp))(jnp.asarray(a)))
    got = tntt.rot_twiddle(torch.from_numpy(a), tp)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64) - 1)
    assert torch.equal(got, tntt.xpow(torch.from_numpy(a), tp) - 1)


def test_twiddle_table_at_l2_edges():
    """At TFHEpp-L2 (N=2048, 3 primes), the edge exponents."""
    N = L2.N
    primes = tntt.primes_for_bound(tntt.external_product_bound(
        N, L2.Bg_bit, L2.l, L2.k))
    tp, jp = tntt.get_plan(N, primes, CPU), jntt.get_plan(N, primes)
    a = np.array([0, 1, N - 1, N, N + 1, 2 * N - 1, 2 * N], np.int32)
    want = np.asarray(jax.jit(lambda x: jntt.xpow(x, jp))(jnp.asarray(a)))
    got = tntt.rot_twiddle(torch.from_numpy(a), tp)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64) - 1)
    assert tp.rot_pow.shape == (tp.P, 2 * N) and tp.rot_exp.shape == (N,)
    kp = tpk.get_kernel_plan(N, primes, L2.l, L2.Bg_bit, L2.k, CPU)
    assert kp.rot_pow.dtype == torch.int32 and kp.rot_exp.dtype == torch.int32
    assert torch.equal(tpk.i32_as_u32(kp.rot_pow), tp.rot_pow)


# --- the plain versions of K1, K1-step and K8a ------------------------------

def _rotntt_jnp_scan(acc0, a_int, keyv, keyvs, bk):
    """The TPU package's rotation-free steps as `tests/test_rot_ntt.py`
    scans them."""
    plan = bk.plan()

    def step(acc, xs):
        v, vs, ai = xs
        return jbs._cmux_step_rotntt(acc, v, vs, ai, plan, bk.l, bk.Bg_bit,
                                     bk.k, bk.N), None
    return jax.jit(lambda *x: jax.lax.scan(step, x[0], x[1:])[0])(
        acc0, keyv, keyvs, a_int)


@pytest.mark.parametrize("name", ["TOY_K2", "TFHEPP_L2"])
def test_plain_kernels_rotntt_match_jnp_scan(name):
    """`blind_rotate_scan_plain`, n `pbs_step_plain` calls and, per step, the
    `partial_step_plain` of the shards finished by `finish_step_plain`, all
    with rot_ntt, give the TPU package's `_cmux_step_rotntt` scan; exponents
    0, N and 2N present.  The key's J rows split over 2 shards (3 where J is
    odd: TOY_K2's 9)."""
    p, bk, bk_t, _, _ = _keys(name)
    n, B = bk.n if name != "TOY_K2" else 6, 3
    rs = np.random.default_rng(77)
    acc0 = rs.integers(0, 1 << 64, (B, p.k + 1, p.N), dtype=np.uint64)
    a_np = rs.integers(0, 2 * p.N + 1, (n, B), dtype=np.int32)
    a_np[0, 0], a_np[1, 1], a_np[2, 2] = 0, p.N, 2 * p.N
    want = np.asarray(_rotntt_jnp_scan(
        jnp.asarray(acc0), jnp.asarray(a_np), bk.v[:n], bk.vs[:n], bk))
    kp = bk_t.kernel_plan()
    acc_t, a_t = bridge.to_tensor(acc0, CPU), torch.from_numpy(a_np)
    kv, kvs = bk_t.v32[:n], bk_t.vs32[:n]
    got = tpk.blind_rotate_scan(acc_t, a_t, kv, kvs, kp, rot_ntt=True)
    np.testing.assert_array_equal(to_numpy(got), want)
    classic = tpk.blind_rotate_scan(acc_t, a_t, kv, kvs, kp)
    assert not torch.equal(classic, got)
    acc_s, acc_p = acc_t.clone(), acc_t.clone()
    m = 2 if kp.J % 2 == 0 else 3
    jl = kp.J // m
    for i in range(n):
        tpk.pbs_step(acc_s, a_t[i], kv[i], kvs[i], kp, rot_ntt=True)
        parts = torch.stack([tpk.partial_step(
            acc_p, a_t[i], s * jl, kv[i, s * jl:(s + 1) * jl],
            kvs[i, s * jl:(s + 1) * jl], kp, rot_ntt=True)
            for s in range(m)])
        tpk.finish_step(acc_p, parts, kp)
    assert torch.equal(acc_s, got) and torch.equal(acc_p, got)


# --- the entry points ---------------------------------------------------------

@pytest.mark.parametrize("name", ["TOY", "TOY_K2", "TFHEPP_L2"])
def test_blind_rotate_rotntt_matches_jnp(name, rot_env):
    """`blind_rotate` and `blind_rotate_stepwise` with rot_ntt give the TPU
    package's jnp `blind_rotate` under MOSFHET_ROT_NTT=1 (one plain K1 call,
    n plain K1-step calls); without it the classic words, which the TPU
    package gives with the variable unset."""
    p, bk, bk_t, _, _ = _keys(name)
    (tv_j, m_j), (tv_t, m_t) = _rotation_inputs(p, bk.n, 3, 31)
    want = jax.jit(lambda tv, m: jbs.blind_rotate(tv, m, bk, impl="jnp"))(
        tv_j, m_j)
    calls = tpk.blind_rotate_scan_plain.calls
    got = tbs.blind_rotate(tv_t, m_t, bk_t, rot_ntt=True)
    assert tpk.blind_rotate_scan_plain.calls == calls + 1
    _eq(got, want)
    calls = tpk.pbs_step_plain.calls
    _eq(tbs.blind_rotate_stepwise(tv_t, m_t, bk_t, rot_ntt=True), want)
    assert tpk.pbs_step_plain.calls == calls + bk.n
    rot_env.setenv("MOSFHET_ROT_NTT", "0")
    classic = jax.jit(lambda tv, m: jbs.blind_rotate(tv, m, bk, impl="jnp"))(
        tv_j, m_j)
    _eq(tbs.blind_rotate(tv_t, m_t, bk_t), classic)
    assert not np.array_equal(np.asarray(classic.b), np.asarray(want.b))


def _lut_batch(p, key_tlwe, seed, B):
    """A random 4-slot LUT, its test vector and B ciphertexts of its slots
    (one compiled program), and their port copies."""
    def make(k_lut, k_enc, kt):
        luts = jrng.uniform_torus(k_lut, (4,))
        ms = jtorus.double2torus((jnp.arange(B) % 4) / 8.0)
        return (luts, jtrlwe.torus_packing(luts, p.k, p.N),
                jtlwe.encrypt(ms, kt, k_enc))

    luts, tv, cs = jax.jit(make)(jax.random.fold_in(KEY, seed),
                                 jax.random.fold_in(KEY, seed + 1), key_tlwe)
    return (luts, tv, cs, bridge.trlwe_from_numpy(
        np.asarray(tv.a), np.asarray(tv.b), CPU),
        bridge.tlwe_from_numpy(np.asarray(cs.a), np.asarray(cs.b), CPU))


@pytest.mark.parametrize("name", ["TOY", "TOY_K2"])
def test_functional_bootstrap_rotntt_matches_and_decrypts(name, rot_env):
    """`functional_bootstrap` and `programmable_bootstrap` with rot_ntt give
    the TPU package's words under MOSFHET_ROT_NTT=1, and decrypt within
    2^58 of the LUT (`tests/test_rot_ntt.py`'s bound)."""
    p, bk, bk_t, key_tlwe, key_out = _keys(name)
    luts, tv, cs, tv_t, cs_t = _lut_batch(p, key_tlwe, 3, 8)
    want = jax.jit(lambda c: jbs.functional_bootstrap(tv, c, bk, 4))(cs)
    got = tbs.functional_bootstrap(tv_t, cs_t, bk_t, 4, rot_ntt=True)
    _eq(got, want)
    ph = to_numpy(ttlwe.phase(got, bridge.tlwe_key_from_numpy(
        np.asarray(key_out.s), key_out.sigma, CPU)))
    err = (ph - np.asarray(luts)[np.arange(8) % 4]).view(np.int64)
    assert np.abs(err.astype(np.float64)).max() <= 2.0**58
    want = jax.jit(lambda c: jbs.programmable_bootstrap(tv, c, bk, 2, 3, 1))(
        cs)
    _eq(tbs.programmable_bootstrap(tv_t, cs_t, bk_t, 2, 3, 1, rot_ntt=True),
        want)


def test_functional_bootstrap_rotntt_at_l2_widths(rot_env):
    """TFHEpp-L2 widths, 8 steps, random key residues: the words of the
    TPU package's bootstrap on 2 random ciphertexts."""
    p, bk, bk_t, _, _ = _keys(L2.name)
    rs = np.random.default_rng(5)
    a = rs.integers(0, 1 << 64, (2, L2_CUT), dtype=np.uint64)
    b = rs.integers(0, 1 << 64, 2, dtype=np.uint64)
    lut = rs.integers(0, 1 << 64, (p.k + 1, p.N), dtype=np.uint64)
    tv = jtrlwe.TRLWE(a=jnp.asarray(lut[:p.k]), b=jnp.asarray(lut[p.k]))
    want = jax.jit(lambda c: jbs.functional_bootstrap(tv, c, bk, 4))(
        jtlwe.TLWE(a=jnp.asarray(a), b=jnp.asarray(b)))
    got = tbs.functional_bootstrap(
        bridge.trlwe_from_numpy(lut[:p.k], lut[p.k], CPU),
        bridge.tlwe_from_numpy(a, b, CPU), bk_t, 4, rot_ntt=True)
    _eq(got, want)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)])
def test_pbs_on_mesh_rotntt_matches_jnp(data, model, rot_env):
    """`pbs_on_mesh` with rot_ntt on a mesh of the CPU named twice gives the
    TPU package's jnp `pbs_on_mesh` under MOSFHET_ROT_NTT=1 on two of its
    CPU devices: model 2 through per-step rotation-free partials (K8a) and
    finishes (K8b), model 1 through one rotation per data shard (K1)."""
    p, bk, bk_t, key_tlwe, _ = _keys("TOY")
    _, tv1, cs, _, cs_t = _lut_batch(p, key_tlwe, 9, 4)
    # the TPU package's mesh shards the test vectors with the batch
    tv_a = np.broadcast_to(np.asarray(tv1.a).astype(np.uint64),
                           (4, p.k, p.N)).copy()
    tv_b = np.broadcast_to(np.asarray(tv1.b).astype(np.uint64),
                           (4, p.N)).copy()
    tv = jtrlwe.TRLWE(a=jnp.asarray(tv_a), b=jnp.asarray(tv_b))
    tv_t = bridge.trlwe_from_numpy(tv_a, tv_b, CPU)
    axis = "model" if model > 1 else None
    jm = jmesh.make_mesh(jax.devices()[:2], data=data, model=model)
    want = jmesh.pbs_on_mesh(jm, bk, 4, model_axis=axis, impl="jnp")(tv, cs)
    tm = tmesh.make_mesh([torch.device(CPU)] * 2, data=data, model=model)
    calls = (tpk.partial_step_plain.calls, tpk.finish_step_plain.calls,
             tpk.blind_rotate_scan_plain.calls)
    got = tmesh.pbs_on_mesh(tm, bk_t, 4, model_axis=axis, rot_ntt=True)(
        tv_t, cs_t)
    _eq(got, want)
    delta = tuple(c - c0 for c, c0 in zip(
        (tpk.partial_step_plain.calls, tpk.finish_step_plain.calls,
         tpk.blind_rotate_scan_plain.calls), calls))
    assert delta == ((p.n * 2, p.n, 0) if model == 2 else (0, 0, data))
    single = tbs.functional_bootstrap(tv_t, cs_t, bk_t, 4, rot_ntt=True)
    assert torch.equal(got.a, single.a) and torch.equal(got.b, single.b)


# --- what raises ----------------------------------------------------------------

def test_narrow_prime_keyset_loads_and_refuses_to_bootstrap(tmp_path,
                                                            monkeypatch):
    """A TOY keyset the TPU package makes with ``MOSFHET_NTT_PRIMES=narrow``
    (`ntt.NARROW_PRIMES`, below the Barrett window of every port kernel's
    MAC) loads through `io.load` with its primes, and every bootstrap of it
    raises ValueError, the rotation-free one included, where the TPU
    package falls back to the classic step; the rotation-free step's plain
    form refuses the prime set too."""
    p = params.TOY
    monkeypatch.setenv("MOSFHET_NTT_PRIMES", "narrow")
    k0, k1, k2 = jax.random.split(jax.random.fold_in(KEY, 99), 3)
    key_tlwe = jtlwe.new_binary_key(k0, p.n, p.lwe_sigma)
    key_trlwe = jtrlwe.new_binary_key(k1, p.N, p.k, p.rlwe_sigma)
    gk = jtrgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = jax.jit(lambda rk, s: jbs.new_key(
        rk, gk, jtlwe.TLWEKey(s=s, sigma=key_tlwe.sigma)))(k2, key_tlwe.s)
    assert bk.primes == jntt.NARROW_PRIMES
    jio.save(tmp_path / "bk", bk)
    bk_t = tio.load(tmp_path / "bk", device=CPU)
    assert bk_t.primes == jntt.NARROW_PRIMES
    np.testing.assert_array_equal(to_numpy(bk_t.v), np.asarray(bk.v))
    (_, _), (tv_t, m_t) = _rotation_inputs(p, p.n, 2, 3)
    c_t = ttlwe.TLWE(a=m_t, b=m_t[:, 0].clone())
    for rot in (False, True):
        with pytest.raises(ValueError, match=r"2\^30 / 1\.75"):
            tbs.functional_bootstrap(tv_t, c_t, bk_t, 4, rot_ntt=rot)
    plan = tntt.get_plan(p.N, jntt.NARROW_PRIMES, CPU)
    assert not plan.barrett_ok
    with pytest.raises(ValueError, match="Barrett"):
        tbs._cmux_step_rotntt(bk_t.v[0, 0].new_zeros((1, 2, p.N)),
                              bk_t.v[0], bk_t.vs[0],
                              torch.zeros(1, dtype=torch.int32), plan, p.l,
                              p.Bg_bit, p.k, p.N)
    with pytest.raises(ValueError, match="barrett_mul"):
        tpk.cmux_partial(torch.zeros((1, 2, p.N), dtype=torch.int64),
                         torch.zeros(1, dtype=torch.int32), 0, bk_t.v[0],
                         bk_t.vs[0], plan, p.l, p.Bg_bit, rot_ntt=True)


def test_unfolded_key_refuses_rotntt():
    """The unfolded rotation has no rotation-free step: asked for one, the
    bootstrap raises rather than run the classic step."""
    p = params.TOY
    gen = torch.Generator().manual_seed(4)
    key_tlwe = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
    key_trlwe = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    bk2 = tbs.new_key(ttrgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe,
                      gen, CPU, 2)
    tv = ttrlwe.torus_packing(trng.uniform_torus(gen, (4,), CPU), p.k, p.N)
    cs = ttlwe.encrypt(trng.uniform_torus(gen, (2,), CPU), key_tlwe, gen)
    with pytest.raises(ValueError, match="no rotation-free step"):
        tbs.functional_bootstrap(tv, cs, bk2, 4, rot_ntt=True)
    tbs.functional_bootstrap(tv, cs, bk2, 4)
