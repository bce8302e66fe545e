"""The port's sharded bootstraps (`mosfhet_torch.parallel.mesh`) against the
TPU package's, bit for bit, at TOY: the TPU package on its 8-device CPU mesh
(`tests/conftest.py`), the port on a mesh of the CPU named 8 times (virtual
shards, as on one card).  `pbs_on_mesh` at every (data, model) split of 8
devices, model 8 included (8 shards of J = 8 rows, where the TPU package's
u32 psum would wrap and it takes its jnp path); `unfolded_pbs_on_mesh` at
u=2 with model 1, 2 and 4; `ga_pbs_on_mesh` with model 1 and 2; the launch
counts of each route; the errors.  The kernels K8a and K8b themselves are in
`test_torch_tp_kernels.py` (against the TPU kernels) and
`test_torch_gpu.py` (on the card)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap as jbs, bootstrap_ga as jga, params, \
    tlwe as jtlwe, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_tpu.parallel import mesh as jmesh
from mosfhet_torch import bootstrap as tbs, bridge
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from mosfhet_torch.parallel import mesh as tmesh
from tests.test_torch_suite_env import port_test_env  # noqa: F401

P = params.TOY
KEY = jax.random.PRNGKey(5150)
CPU = "cpu"
B = 8


@functools.cache
def _jax_keys():
    """The TPU package's unfold=1, u=2 and GA keys at TOY, each generated
    as one compiled program, once for the whole file."""
    k0, k1, k2, k3, k4 = jax.random.split(KEY, 5)
    key_tlwe = jtlwe.new_binary_key(k0, P.n, P.lwe_sigma)
    key_trlwe = jtrlwe.new_binary_key(k1, P.N, P.k, P.rlwe_sigma)
    gk = jtrgsw.new_key(key_trlwe, P.l, P.Bg_bit)
    bk = jax.jit(lambda rk, s: jbs.new_key(
        rk, gk, jtlwe.TLWEKey(s=s, sigma=key_tlwe.sigma), 1))(k2, key_tlwe.s)
    bk2 = jax.jit(lambda rk, s: jbs.new_key(
        rk, gk, jtlwe.TLWEKey(s=s, sigma=key_tlwe.sigma), 2))(k3, key_tlwe.s)
    bkg = jax.jit(lambda rk, s: jga.new_key(
        rk, gk, jtlwe.TLWEKey(s=s, sigma=key_tlwe.sigma)))(k4, key_tlwe.s)
    return bk, bk2, bkg


@functools.cache
def _port_keys():
    bk, bk2, bkg = _jax_keys()
    return (bridge.bootstrap_key_from_numpy(
                np.asarray(bk.v), np.asarray(bk.vs), bk.n, bk.k, bk.N, bk.l,
                bk.Bg_bit, bk.primes, CPU),
            bridge.unfolded_bootstrap_key_from_numpy(
                np.asarray(bk2.su), bk2.n, bk2.k, bk2.N, bk2.l, bk2.Bg_bit,
                bk2.primes, bk2.unfolding, CPU),
            bridge.ga_bootstrap_key_from_numpy(
                np.asarray(bkg.s_v), np.asarray(bkg.s_vs),
                np.asarray(bkg.ak_v), np.asarray(bkg.inv2n), bkg.n, bkg.k,
                bkg.N, bkg.l, bkg.Bg_bit, bkg.ks_t, bkg.ks_base_bit,
                bkg.primes, bkg.ks_primes, CPU))


def _inputs(seed):
    """A batch of B random ciphertexts and a random 4-slot LUT, repeated
    over the batch (the TPU package's mesh shards the test vectors too)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 64, (B, P.n), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, B, dtype=np.uint64)
    lut = np.repeat(rng.integers(0, 1 << 64, 4, dtype=np.uint64), P.N // 4)
    tv_a = np.zeros((B, P.k, P.N), np.uint64)
    tv_b = np.broadcast_to(lut, (B, P.N)).copy()
    return ((jtrlwe.TRLWE(a=jnp.asarray(tv_a), b=jnp.asarray(tv_b)),
             jtlwe.TLWE(a=jnp.asarray(a), b=jnp.asarray(b))),
            (bridge.trlwe_from_numpy(tv_a, tv_b, CPU),
             bridge.tlwe_from_numpy(a, b, CPU)))


def _meshes(data, model):
    jm = jmesh.make_mesh(jax.devices(), data=data, model=model)
    tm = tmesh.make_mesh([torch.device(CPU)] * (data * model), data=data,
                         model=model)
    return jm, tm, ("model" if model > 1 else None)


def _eq(got, want):
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))


def _counts():
    return {f.__name__: getattr(f, "calls")
            for f in (tpk.partial_step_plain, tpk.finish_step_plain,
                      tpk.blind_rotate_scan_plain, tpk.unfolded_rotate_plain,
                      tpk.auto_keyswitch_stream_plain,
                      tpk.ga_scan_fused_plain)}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items() if v - before[k]}


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_pbs_on_mesh_matches_tpu_package(data, model):
    """Model 1: one rotation per data shard.  Model m > 1: per step m K8a
    partials per data shard and one K8b finish."""
    bk_j = _jax_keys()[0]
    bk_t = _port_keys()[0]
    (tv_j, c_j), (tv_t, c_t) = _inputs(10 * data + model)
    jm, tm, axis = _meshes(data, model)
    want = jmesh.pbs_on_mesh(jm, bk_j, 4, model_axis=axis)(tv_j, c_j)
    before = _counts()
    got = tmesh.pbs_on_mesh(tm, bk_t, 4, model_axis=axis)(tv_t, c_t)
    _eq(got, want)
    if model == 1:
        assert _delta(before) == {"blind_rotate_scan_plain": data}
    else:
        assert _delta(before) == {"partial_step_plain": P.n * data * model,
                                  "finish_step_plain": P.n * data}
    single = tbs.functional_bootstrap(tv_t, c_t, bk_t, 4)
    assert torch.equal(got.a, single.a) and torch.equal(got.b, single.b)


@pytest.mark.parametrize("model", [1, 2, 4])
def test_unfolded_pbs_on_mesh_matches_tpu_package(model):
    """u=2: the 4 key products of each group over 1, 2 or 4 shards."""
    bk_j = _jax_keys()[1]
    bk_t = _port_keys()[1]
    (tv_j, c_j), (tv_t, c_t) = _inputs(40 + model)
    jm, tm, axis = _meshes(8 // model, model)
    want = jmesh.unfolded_pbs_on_mesh(jm, bk_j, 4, model_axis=axis)(tv_j, c_j)
    before = _counts()
    got = tmesh.unfolded_pbs_on_mesh(tm, bk_t, 4, model_axis=axis)(tv_t, c_t)
    _eq(got, want)
    assert _delta(before) == ({"unfolded_rotate_plain": 8} if model == 1
                              else {})


@pytest.mark.parametrize("model", [1, 2])
def test_ga_pbs_on_mesh_matches_tpu_package(model):
    """Model 2 splits both the J=8 gadget rows and the k t = 4 keyset
    rows."""
    bkg_j = _jax_keys()[2]
    bkg_t = _port_keys()[2]
    (tv_j, c_j), (tv_t, c_t) = _inputs(50 + model)
    jm, tm, axis = _meshes(8 // model, model)
    want = jmesh.ga_pbs_on_mesh(jm, bkg_j, 4, model_axis=axis)(tv_j, c_j)
    before = _counts()
    got = tmesh.ga_pbs_on_mesh(tm, bkg_t, 4, model_axis=axis)(tv_t, c_t)
    _eq(got, want)
    assert _delta(before) == ({"auto_keyswitch_stream_plain": 8,
                               "ga_scan_fused_plain": 8} if model == 1
                              else {})


def test_mesh_layout():
    """Row-major (data, model) grid; the data axis may be either name."""
    devs = [torch.device(CPU)] * 6
    m = tmesh.make_mesh(devs, data=3, model=2)
    assert m.shape == {"data": 3, "model": 2}
    assert [len(r) for r in m.rows("data", "model")] == [2, 2, 2]
    assert [len(r) for r in m.rows("model", "data")] == [3, 3]
    assert [len(r) for r in m.rows("data", None)] == [1, 1, 1]
    assert tmesh.make_mesh(devs, model=3).shape == {"data": 2, "model": 3}
    with pytest.raises(ValueError):
        tmesh.make_mesh(devs, data=4, model=2)


def test_batch_must_split_over_data():
    bk_t = _port_keys()[0]
    _, (tv_t, c_t) = _inputs(60)
    tm = tmesh.make_mesh([torch.device(CPU)] * 3, data=3, model=1)
    with pytest.raises(ValueError, match="does not split evenly"):
        tmesh.pbs_on_mesh(tm, bk_t, 4, model_axis=None)(tv_t, c_t)


@pytest.mark.parametrize("entry", ["pbs", "unfolded"])
def test_key_rows_must_split_over_model(entry):
    """J = 8 gadget rows over 3 shards; 4 key products over 3 shards."""
    bk_t, bk2_t, _ = _port_keys()
    tm = tmesh.make_mesh([torch.device(CPU)] * 3, data=1, model=3)
    fn = tmesh.pbs_on_mesh if entry == "pbs" else tmesh.unfolded_pbs_on_mesh
    with pytest.raises(ValueError, match="do not split"):
        fn(tm, bk_t if entry == "pbs" else bk2_t, 4, model_axis="model")
