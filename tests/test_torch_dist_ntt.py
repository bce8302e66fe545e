"""The port's rotation-free CMUX step (`bootstrap._cmux_step_rotntt`) and
its coefficient-sharded NTT and blind rotation (`parallel.dist_ntt`)
against the TPU package's, word for word, on numpy-seeded inputs: the TPU
package on its 8-device CPU mesh (`tests/conftest.py`), the port on a mesh
of the CPU named D times (virtual shards, as on one card).  The JAX side is
jitted once per test.  Also: the MAC's sum is exact where a raw int64 sum
would wrap, and the N-sharded bootstrap decrypts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from mosfhet_tpu import bootstrap as jbs, params
from mosfhet_tpu.parallel import dist_ntt as jdist
from mosfhet_torch import bootstrap as tbs, ntt as tntt, polynomial, rng, \
    tlwe, torus, trgsw, trlwe
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.parallel import dist_ntt, mesh as tmesh
from tests.test_torch_suite_env import port_test_env  # noqa: F401

P = params.TOY
CPU = "cpu"
STEPS = 6


@functools.cache
def _keys():
    """The port's TOY keys (seeded) and the same bootstrap key in the TPU
    package's type."""
    gen = torch.Generator().manual_seed(2222)
    key_tlwe = tlwe.new_binary_key(P.n, P.lwe_sigma, gen, CPU)
    key_trlwe = trlwe.new_binary_key(P.N, P.k, P.rlwe_sigma, gen, CPU)
    bk = tbs.new_key(trgsw.new_key(key_trlwe, P.l, P.Bg_bit), key_tlwe, gen,
                     CPU)
    jbk = jbs.BootstrapKey(v=jnp.asarray(to_numpy(bk.v).astype(np.uint64)),
                           vs=jnp.asarray(to_numpy(bk.vs).astype(np.uint64)),
                           su=None, n=bk.n, k=bk.k, N=bk.N, l=bk.l,
                           Bg_bit=bk.Bg_bit, unfolding=1, primes=bk.primes)
    return gen, key_tlwe, key_trlwe, bk, jbk


def _rotation_inputs(seed, B=4):
    rs = np.random.default_rng(seed)
    acc0 = rs.integers(0, 1 << 64, (B, P.k + 1, P.N), dtype=np.uint64)
    a_int = rs.integers(0, 2 * P.N + 1, (B, STEPS), dtype=np.int32)
    a_int[0, 0], a_int[-1, -1], a_int[1, 1] = 0, 2 * P.N, P.N
    return acc0, a_int


def _rotntt_loop(acc0, a_int, bk, plan):
    acc = acc0
    for i in range(a_int.shape[1]):
        acc = tbs._cmux_step_rotntt(acc, bk.v[i], bk.vs[i], a_int[:, i], plan,
                                    bk.l, bk.Bg_bit, bk.k, bk.N)
    return acc


def _cpu_mesh(D):
    return tmesh.make_mesh([torch.device(CPU)] * D, data=D, model=1,
                           names=("x", "y"))


def _jax_mesh(D):
    return JMesh(np.array(jax.devices()[:D]).reshape(D), ("x",))


def test_cmux_step_rotntt_matches_tpu_package():
    """Six rotation-free steps at TOY: the port's loop against the TPU
    package's `lax.scan` of its step, with the key's own primes."""
    _, _, _, bk, jbk = _keys()
    acc0, a_int = _rotation_inputs(1)
    jplan = jbk.plan()

    @jax.jit
    def scan(acc, v, vs, a):
        def step(acc_st, xs):
            kv, kvs, ai = xs
            return jbs._cmux_step_rotntt(acc_st, kv, kvs, ai, jplan, P.l,
                                         P.Bg_bit, P.k, P.N), None
        return jax.lax.scan(step, acc, (v, vs, a.T))[0]

    want = scan(jnp.asarray(acc0), jbk.v[:STEPS], jbk.vs[:STEPS],
                jnp.asarray(a_int))
    got = _rotntt_loop(to_tensor(acc0, CPU), torch.from_numpy(a_int), bk,
                       bk.plan())
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_cmux_step_rotntt_refuses_a_plan_without_barrett():
    """A prime below 2^30 / 1.75 leaves `barrett_mul` inexact: the step
    raises, where the TPU package takes the classic step instead."""
    plan = tntt.get_plan(64, (786433,), CPU)          # 3 * 2^18 + 1
    assert not plan.barrett_ok
    acc = torch.zeros((1, 2, 64), dtype=torch.int64)
    key = torch.zeros((8, 2, 1, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="Barrett"):
        tbs._cmux_step_rotntt(acc, key, key, torch.zeros(1, dtype=torch.int32),
                              plan, 4, 9, 1, 64)


@pytest.mark.parametrize("D", [1, 2, 8])
def test_dist_ntt_mul_small_matches_tpu_package(D):
    """The exact negacyclic product at N=1024 with the coefficients over D
    shards: the port's words against the TPU package's on D of its CPU
    devices, and against the single-device `polynomial.ntt_mul_small`."""
    N = 1024
    rs = np.random.default_rng(70 + D)
    d = rs.integers(-256, 257, size=N)
    b = rs.integers(0, 1 << 64, size=N, dtype=np.uint64)
    jm = _jax_mesh(D)
    jrun = jdist.make_dist_ntt_mul_small(jm, N, axis="x", max_abs_digit=256)
    with jm:
        want = np.asarray(jrun(jnp.asarray(d), jnp.asarray(b)))
    run = dist_ntt.make_dist_ntt_mul_small(_cpu_mesh(D), N, axis="x",
                                           max_abs_digit=256)
    got = run(torch.from_numpy(d), to_tensor(b, CPU))
    np.testing.assert_array_equal(to_numpy(got), want)
    plan = tntt.get_plan(N, tntt.primes_for_bound(tntt.conv_bound(N, 256, 1)),
                         CPU)
    assert torch.equal(got, polynomial.ntt_mul_small(torch.from_numpy(d),
                                                     to_tensor(b, CPU), plan))


@functools.cache
def _jax_dist_rotate():
    """The TPU package's N-sharded rotation at TOY on its 8 devices, and its
    key spectra (`prep_key` jitted: eager it takes seconds of op-by-op
    compiles)."""
    jm = _jax_mesh(8)
    jprep, jrun = jdist.make_dist_blind_rotate(jm, P.N, P.k, P.l, P.Bg_bit,
                                               axis="x")
    return jm, jrun, jax.jit(jprep)(_keys()[4])


@pytest.mark.parametrize("D", [2, 8])
def test_full_forward_matches_tpu_package(D):
    """The serial emulation of the sharded transform on random residues of
    two batch rows at TOY's N, D shards."""
    primes = _keys()[3].primes
    pr = np.array(primes, np.uint64)[:, None]
    x = np.random.default_rng(D).integers(0, 1 << 62, (2, len(primes), P.N),
                                          dtype=np.uint64) % pr
    jplan = jdist.DistNTTPlan(P.N, D, primes)
    want = np.asarray(jax.jit(lambda v: jdist.full_forward(v, jplan))(
        jnp.asarray(x)))
    got = dist_ntt.full_forward(torch.from_numpy(x.astype(np.int64)),
                                dist_ntt.DistNTTPlan(P.N, D, primes))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


def test_dist_xpow2_tables_match_tpu_package():
    """The monomial tables X^(2^t) in the sharded ordering, 8 shards at
    TOY's N (the TPU package's call is eager; its op-by-op compiles are
    shared with `make_dist_blind_rotate`'s, which builds the same)."""
    _jax_dist_rotate()
    primes = _keys()[3].primes
    np.testing.assert_array_equal(
        dist_ntt.dist_xpow2_tables(dist_ntt.DistNTTPlan(P.N, 8, primes))
        .numpy().astype(np.uint64),
        np.asarray(jdist.dist_xpow2_tables(jdist.DistNTTPlan(P.N, 8,
                                                             primes))))


def test_dist_blind_rotate_matches_tpu_package_and_rotntt_loop():
    """The N-sharded blind rotation over 8 shards, 6 steps at TOY: the
    port's key spectra and words against the TPU package's on its 8-device
    mesh, and against the port's single-device rotation-free loop at the
    same primes (the key's own at TOY)."""
    _, _, _, bk, _ = _keys()
    acc0, a_int = _rotation_inputs(11)
    jm, jrun, kd_j = _jax_dist_rotate()
    with jm:
        want = np.asarray(jrun(jnp.asarray(acc0), jnp.asarray(a_int),
                               kd_j[:STEPS]))
    prep, run = dist_ntt.make_dist_blind_rotate(_cpu_mesh(8), P.N, P.k, P.l,
                                                P.Bg_bit, axis="x")
    kd = [k[:STEPS] for k in prep(bk)]
    np.testing.assert_array_equal(
        np.concatenate([to_numpy(k).astype(np.uint64) for k in kd], -1),
        np.asarray(kd_j[:STEPS]))
    got = run(to_tensor(acc0, CPU), torch.from_numpy(a_int), kd)
    np.testing.assert_array_equal(to_numpy(got), want)
    assert dist_ntt.DistNTTPlan(P.N, 8, bk.primes).primes == bk.primes
    loop = _rotntt_loop(to_tensor(acc0, CPU), torch.from_numpy(a_int), bk,
                        bk.plan())
    assert torch.equal(got, loop)


def test_mac_is_exact_with_every_residue_at_p_minus_1():
    """J = 9 products of (p-1)^2 sum past 2^63 in int64 at the largest
    prime; the MAC reduces each first and gives the exact sum mod p (Python
    integers)."""
    primes = tntt.DEFAULT_PRIMES
    Pn, B, J, C, N2 = len(primes), 2, 9, 2, 4
    p = torch.tensor(primes, dtype=torch.int64)
    pm1 = (p - 1).reshape(Pn, 1, 1, 1)
    spec = pm1.expand(Pn, B, J, N2).contiguous()
    key = pm1.expand(Pn, J, C, N2).contiguous()
    assert J * (max(primes) - 1) ** 2 > 2**63 - 1
    got = dist_ntt._mac(spec, key, p)
    want = [(J * (q - 1) ** 2) % q for q in primes]
    assert got.shape == (Pn, B, C, N2)
    assert [set(got[m].flatten().tolist()) for m in range(Pn)] == \
        [{w} for w in want]


def test_functional_bootstrap_n_sharded_decrypts():
    """The whole PBS with the rotation over 4 shards of the CPU: every LUT
    slot within 2^58."""
    gen, key_tlwe, key_trlwe, bk, _ = _keys()
    luts = rng.uniform_torus(gen, (4,), CPU)
    tv = trlwe.torus_packing(luts, P.k, P.N)
    slots = torch.arange(8) % 4
    cs = tlwe.encrypt(torus.double2torus(slots.to(torch.float64) / 8.0),
                      key_tlwe, gen)
    m = _cpu_mesh(4)
    prep, run = dist_ntt.make_dist_blind_rotate(m, P.N, P.k, P.l, P.Bg_bit)
    out = dist_ntt.functional_bootstrap_n_sharded(m, tv, cs, bk, prep(bk),
                                                  run, 4)
    err = (tlwe.phase(out, trlwe.extract_tlwe_key(key_trlwe)) - luts[slots]
           ).to(torch.float64).abs().max().item()
    assert err <= 2.0**58, f"phase error 2^{np.log2(err + 1):.1f}"
