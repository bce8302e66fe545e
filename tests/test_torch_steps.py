"""The one-step kernels and the v1 UBR phase 1 at the 64-bit torus, against
the TPU package, bit for bit.

K1-step (`pbs_step`) and K3-step (`ext_product_apply_step`) meet the TPU
kernels `_pbs_step_tiles` and `_apply_step_tiles`, and K5-v1
(`ubr_phase1_combine_v1`) the TPU kernel `ubr_phase1_combine` with its
group tiling (`tile_su_planes`, `tile_rot`, `merge_phase1_out`), all in
Pallas interpret mode and called directly: the TPU package reaches them
only under `MOSFHET_FUSED_SCAN=0` / `MOSFHET_UBR_V2=0`, which its jitted
callers read at trace time.  The port's entry points
`blind_rotate_stepwise`, `multivalue_bootstrap_UBR_phase2_stepwise` and
`multivalue_bootstrap_UBR_phase1_v1` meet the TPU package's jnp routes and
the port's fused forms, on random key material held the same by both
packages.  The CUDA kernels meet the same plain versions in
`test_torch_gpu.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap as jbs, params, tlwe as jtlwe, \
    trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_tpu.ops import pbs_kernel as jpk
from mosfhet_torch import bootstrap as tbs, bridge, ntt as tntt
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_gpu import as_i32, random_exponents, random_residues, \
    random_rotation_inputs

CPU = "cpu"
TOY = params.TOY                     # N=64, k=1, l=4, Bg_bit=9
L2 = params.TFHEPP_L2                # N=2048, k=1, l=4, Bg_bit=9
UB = dict(N=128, k=1, l=2, Bg_bit=10)   # the UBR tests' widths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: this file's torch ops are small, and idle
    threads spinning in each of the suite's workers slow the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digits(p):
    return (p.N, p.k, p.l, p.Bg_bit) if not isinstance(p, dict) else \
        (p["N"], p["k"], p["l"], p["Bg_bit"])


def _plans(N, k, l, Bg_bit, primes, bt):
    jkp = jpk.get_kernel_plan(N, tuple(primes), l, Bg_bit, k, bt=bt,
                              mxu=False, rot_ntt=False)
    return jkp, tpk.get_kernel_plan(N, primes, l, Bg_bit, k, CPU)


def _same(got, want):
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


# --- (a) K1-step -------------------------------------------------------------

@pytest.mark.parametrize("p,B,bt", [(TOY, 8, 8), (L2, 32, 32)],
                         ids=["toy", "l2"])
def test_pbs_step_plain_matches_tpu_step_kernel_interpret(p, B, bt):
    """One CMUX step of B random accumulators (words whose low half carries
    into the high one with the gadget offset present) with exponents 0, N
    and 2N among random ones; acc is updated in place, as the TPU kernel
    aliases it."""
    N, k, l, Bg_bit = _digits(p)
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, 1, B, seed=90 + N)
    a = a_int[0]
    a[:3] = [0, N, 2 * N]
    acc0[0, 0, :3] = [(1 << 64) - 1, 1 << 63, 0xFFFFFFFF]
    jkp, kp = _plans(N, k, l, Bg_bit, primes, bt)
    want = jpk.merge_limbs(jpk._pbs_step_tiles(
        jpk.split_limbs(jnp.asarray(acc0), jkp),
        jnp.asarray(a).reshape(B // bt, bt, 1), jnp.asarray(keyv[0]),
        jnp.asarray(keyvs[0]), jkp, interpret=True))
    acc = to_tensor(acc0, CPU)
    calls = tpk.pbs_step_plain.calls
    got = tpk.pbs_step(acc, torch.from_numpy(a), as_i32(keyv[0], CPU),
                       as_i32(keyvs[0], CPU), kp)
    assert tpk.pbs_step_plain.calls == calls + 1 and got is acc
    _same(got, want)


# --- (b) blind_rotate_stepwise ----------------------------------------------

@functools.cache
def _rotation_case(name, n, B):
    """Both packages' unfold=1 keys holding the same random residues (n
    steps), B random accumulators and B random masks."""
    p = {"toy": TOY, "toy_k2": params.TOY_K2, "l2": L2}[name]
    N, k, l, Bg_bit = _digits(p)
    primes, _, _, keyv, keyvs = random_rotation_inputs(N, k, l, Bg_bit, n, 1,
                                                       seed=95 + N + k)
    v, vs = keyv.astype(np.uint64), keyvs.astype(np.uint64)
    bk_j = jbs.BootstrapKey(v=jnp.asarray(v), vs=jnp.asarray(vs), su=None,
                            n=n, k=k, N=N, l=l, Bg_bit=Bg_bit, unfolding=1,
                            primes=tuple(primes))
    bk_t = bridge.bootstrap_key_from_numpy(v, vs, n, k, N, l, Bg_bit, primes,
                                           CPU)
    rng = np.random.default_rng(96 + N)
    a = rng.integers(0, 1 << 64, (B, k, N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (B, N), dtype=np.uint64)
    mask = rng.integers(0, 1 << 64, (B, n), dtype=np.uint64)
    mask[0, :2] = [0, (1 << 64) - 1]
    return bk_j, bk_t, a, b, mask


@pytest.mark.parametrize("name,n,B", [("toy", 5, 4), ("toy_k2", 5, 3),
                                      ("l2", 4, 2)])
def test_blind_rotate_stepwise_matches_jnp_and_blind_rotate(name, n, B):
    """n K1-step calls (plain here) and no K1: the TPU package's jnp
    rotation's words, and `blind_rotate`'s."""
    bk_j, bk_t, a, b, mask = _rotation_case(name, n, B)
    want = jax.jit(lambda tv, m: jbs.blind_rotate(tv, m, bk_j, impl="jnp"))(
        jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)), jnp.asarray(mask))
    tv = bridge.trlwe_from_numpy(a, b, CPU)
    m = to_tensor(mask, CPU)
    calls = (tpk.pbs_step_plain.calls, tpk.blind_rotate_scan_plain.calls)
    got = tbs.blind_rotate_stepwise(tv, m, bk_t)
    assert (tpk.pbs_step_plain.calls - calls[0],
            tpk.blind_rotate_scan_plain.calls - calls[1]) == (n, 0)
    _same(got.a, want.a)
    _same(got.b, want.b)
    fused = tbs.blind_rotate(tv, m, bk_t)
    assert torch.equal(got.a, fused.a) and torch.equal(got.b, fused.b)
    np.testing.assert_array_equal(to_numpy(tv.b), b)  # the input is kept


def test_blind_rotate_stepwise_refuses_an_unfolded_key():
    su = torch.zeros((2, 4, 4, 2, 64), dtype=torch.int64)
    bk = tbs.BootstrapKey(None, None, 4, 1, 64, 2, 10,
                          tntt.primes_for_bound(
                              tntt.external_product_bound(64, 10, 2, 1)),
                          su=su, unfolding=2)
    tv = bridge.trlwe_from_numpy(np.zeros((1, 64), np.uint64),
                                 np.zeros(64, np.uint64), CPU)
    with pytest.raises(ValueError, match="unfolding"):
        tbs.blind_rotate_stepwise(tv, torch.zeros((1, 4), dtype=torch.int64),
                                  bk)


# --- (c) K3-step -------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_ext_product_apply_step_plain_matches_tpu_step_kernel_interpret(
        per_row):
    """One replace-mode product of 16 random accumulators (two batch tiles
    of 8) with a random key: one for the batch, or one per row (the TPU's
    per-row tile [nb, J, C, P, BT, N])."""
    N, k, l, Bg_bit = _digits(UB)
    B, bt, C, J = 16, 8, k + 1, (k + 1) * l
    primes = tntt.primes_for_bound(tntt.external_product_bound(N, Bg_bit, l,
                                                               k))
    rng = np.random.default_rng(97 + per_row)
    acc0 = rng.integers(0, 1 << 64, (B, C, N), dtype=np.uint64)
    acc0[0, 0, :3] = [(1 << 64) - 1, 1 << 63, 0xFFFFFFFF]
    key = random_residues(rng, ((B,) if per_row else ()) + (J, C,
                                                             len(primes), N),
                          primes)
    jkp, kp = _plans(N, k, l, Bg_bit, primes, bt)
    key_j = (key.reshape(B // bt, bt, J, C, len(primes), N)
             .transpose(0, 2, 3, 4, 1, 5) if per_row else key)
    want = jpk.merge_limbs(jpk._apply_step_tiles(
        jpk.split_limbs(jnp.asarray(acc0), jkp), jnp.asarray(key_j), jkp,
        per_row, interpret=True))
    acc = to_tensor(acc0, CPU)
    calls = tpk.ext_product_apply_step_plain.calls
    got = tpk.ext_product_apply_step(acc, as_i32(key, CPU), kp, per_row)
    assert tpk.ext_product_apply_step_plain.calls == calls + 1
    assert got is acc
    _same(got, want)


# --- (d) the UBR phase-2 step form, (e) K5-v1 ---------------------------

@functools.cache
def _ubr_case(u):
    """Both packages' unfolded keys holding the same random key products
    (n=8, u), a random unbatched test-vector batch of 3 LUTs and 3 random
    ciphertexts."""
    N, k, l, Bg_bit = _digits(UB)
    n, C, J = 8, k + 1, (k + 1) * l
    rng = np.random.default_rng(98 + u)
    su = rng.integers(0, 1 << 64, (n // u, 1 << u, J, C, N), dtype=np.uint64)
    planes = np.stack([(su & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (su >> np.uint64(32)).astype(np.uint32)])
    primes = tntt.primes_for_bound(tntt.external_product_bound(N, Bg_bit, l,
                                                               k))
    bk_j = jbs.BootstrapKey(v=None, vs=None, su=jnp.asarray(planes), n=n,
                            k=k, N=N, l=l, Bg_bit=Bg_bit, unfolding=u,
                            primes=tuple(primes))
    bk_t = bridge.unfolded_bootstrap_key_from_numpy(
        planes, n, k, N, l, Bg_bit, primes, u, CPU)
    tv_a = rng.integers(0, 1 << 64, (3, k, N), dtype=np.uint64)
    tv_b = rng.integers(0, 1 << 64, (3, N), dtype=np.uint64)
    ca = rng.integers(0, 1 << 64, (3, n), dtype=np.uint64)
    cb = rng.integers(0, 1 << 64, (3,), dtype=np.uint64)
    return bk_j, bk_t, planes, (tv_a, tv_b), (ca, cb)


@pytest.mark.parametrize("cache", ["broadcast", "per_row"])
def test_ubr_phase2_stepwise_matches_phase2_and_jnp(cache):
    """One ciphertext's cache over 3 LUTs (broadcast), or one cache per
    ciphertext for 3 ciphertexts (per row): n/u K3-step calls (plain here)
    and no K3, the words of the port's and the TPU package's jnp phase 2."""
    bk_j, bk_t, _, (tv_a, tv_b), (ca, cb) = _ubr_case(2)
    if cache == "broadcast":
        ca, cb = ca[0], cb[0]
    tc = bridge.tlwe_from_numpy(ca, cb, CPU)
    ttv = bridge.trlwe_from_numpy(tv_a, tv_b, CPU)
    sa = tbs.multivalue_bootstrap_UBR_phase1(tc, bk_t)
    G = bk_t.su.shape[0]
    calls = (tpk.ext_product_apply_step_plain.calls,
             tpk.ext_product_apply_scan_plain.calls)
    got = tbs.multivalue_bootstrap_UBR_phase2_stepwise(ttv, tc, sa, bk_t, 4)
    assert (tpk.ext_product_apply_step_plain.calls - calls[0],
            tpk.ext_product_apply_scan_plain.calls - calls[1]) == (G, 0)
    fused = tbs.multivalue_bootstrap_UBR_phase2(ttv, tc, sa, bk_t, 4)
    assert torch.equal(got.a, fused.a) and torch.equal(got.b, fused.b)
    want = jax.jit(lambda tv_, c_, v_: jbs.multivalue_bootstrap_UBR_phase2(
        tv_, c_, jtrgsw.TRGSWDFT(v=v_, vs=None, l=bk_j.l, Bg_bit=bk_j.Bg_bit,
                                 primes=bk_j.primes), bk_j, 4, impl="jnp"))(
        jtrlwe.TRLWE(a=jnp.asarray(tv_a), b=jnp.asarray(tv_b)),
        jtlwe.TLWE(a=jnp.asarray(ca), b=jnp.asarray(cb)),
        jnp.asarray(to_numpy(sa.v)))
    _same(got.a, want.a)
    _same(got.b, want.b)


def test_ubr_phase1_v1_plain_matches_tpu_v1_kernel_interpret():
    """G groups, a number that is not a multiple of the TPU's group tile
    (8), so its padding is cut off by `merge_phase1_out`; exponents 0, N
    and 2N present."""
    N, k, l, Bg_bit = _digits(UB)
    u, G, B = 2, 3, 2
    M, C, J = 1 << u, k + 1, (k + 1) * l
    rng = np.random.default_rng(99)
    su = rng.integers(0, 1 << 64, (G, M, J, C, N), dtype=np.uint64)
    planes = jnp.asarray(np.stack(
        [(su & np.uint64(0xFFFFFFFF)).astype(np.uint32),
         (su >> np.uint64(32)).astype(np.uint32)]).reshape(2, G, M, J * C, N))
    rot = random_exponents(rng, B, G, M, N)
    primes = tntt.primes_for_bound(tntt.external_product_bound(N, Bg_bit, l,
                                                               k))
    jkp, kp = _plans(N, k, l, Bg_bit, primes, 8)
    want = jpk.merge_phase1_out(jpk.ubr_phase1_combine(
        jpk.tile_su_planes(planes, jkp), jpk.tile_rot(jnp.asarray(rot), jkp,
                                                      G),
        jkp, interpret=True), G)
    calls = tpk.ubr_phase1_combine_v1_plain.calls
    got = tpk.ubr_phase1_combine_v1(to_tensor(su, CPU), torch.from_numpy(rot),
                                    kp)
    assert tpk.ubr_phase1_combine_v1_plain.calls == calls + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_ubr_phase1_v1_entry_matches_phase1():
    """`multivalue_bootstrap_UBR_phase1_v1` of 3 ciphertexts: one K5-v1 call
    (plain here), no K5, the cache of `multivalue_bootstrap_UBR_phase1`."""
    _, bk_t, _, _, (ca, cb) = _ubr_case(2)
    tc = bridge.tlwe_from_numpy(ca, cb, CPU)
    calls = (tpk.ubr_phase1_combine_v1_plain.calls,
             tpk.ubr_phase1_combine_plain.calls)
    got = tbs.multivalue_bootstrap_UBR_phase1_v1(tc, bk_t)
    assert (tpk.ubr_phase1_combine_v1_plain.calls - calls[0],
            tpk.ubr_phase1_combine_plain.calls - calls[1]) == (1, 0)
    want = tbs.multivalue_bootstrap_UBR_phase1(tc, bk_t)
    assert got.vs is None and torch.equal(got.v, want.v)
