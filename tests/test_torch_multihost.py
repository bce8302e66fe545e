"""The port's multi-process bootstrap (`parallel.multihost`) and its
multi-device dry run (`parallel.dryrun`) on the CPU, at TOY.

One process: `initialize` is a no-op without a coordinator, and
`pbs_on_global_mesh` over `replicate`d keys and a `distribute_batch`ed
batch gives `pbs_on_mesh`'s words and the TPU package's
`functional_bootstrap`'s.  Two processes over gloo on localhost (this file
run as ``python -m tests.test_torch_multihost OUT_DIR`` with the
MOSFHET_COORDINATOR / MOSFHET_NUM_PROCESSES / MOSFHET_PROCESS_ID variables
set, one child per rank): process 0 makes the keys and replicates them,
each takes half the batch, once at model 1 and once on a (1, 2) mesh of its
own, and the gathered words equal the single-process bootstrap's.  The dry
run's five modes on 8 CPU devices decrypt."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mosfhet_torch import bootstrap as tbs, rng, tlwe, torus, trgsw, trlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk
from mosfhet_torch.params import TOY as P
from mosfhet_torch.parallel import dryrun, mesh as tmesh, multihost
from tests.test_torch_suite_env import port_test_env  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
B = 8
CHILD_TIMEOUT_S = 120


def _setup():
    """The port's TOY keys from a seed, a 4-slot LUT and B ciphertexts of
    every slot (CPU): (bk, tv, cs, key_out, luts, slots)."""
    gen = torch.Generator().manual_seed(4040)
    key_tlwe = tlwe.new_binary_key(P.n, P.lwe_sigma, gen, CPU)
    key_trlwe = trlwe.new_binary_key(P.N, P.k, P.rlwe_sigma, gen, CPU)
    bk = tbs.new_key(trgsw.new_key(key_trlwe, P.l, P.Bg_bit), key_tlwe, gen,
                     CPU)
    luts = rng.uniform_torus(gen, (4,), CPU)
    tv = trlwe.torus_packing(luts, P.k, P.N)
    slots = torch.arange(B) % 4
    cs = tlwe.encrypt(torus.double2torus(slots.to(torch.float64) / 8.0),
                      key_tlwe, gen)
    return bk, tv, cs, trlwe.extract_tlwe_key(key_trlwe), luts, slots


def _decrypt_err(out, key_out, luts, slots):
    return (tlwe.phase(out, key_out) - luts[slots]).to(
        torch.float64).abs().max().item()


def _plain_calls():
    return {f.__name__: f.calls for f in (
        tpk.blind_rotate_scan_plain, tpk.partial_step_plain,
        tpk.finish_step_plain)}


def test_initialize_without_coordinator_is_a_no_op(monkeypatch):
    monkeypatch.delenv("MOSFHET_COORDINATOR", raising=False)
    assert multihost.initialize() is False
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)


@pytest.mark.parametrize("model", [1, 2])
def test_pbs_on_global_mesh_one_process(model):
    """One process, a (2/model, model) mesh of the CPU: the words of
    `pbs_on_mesh` and of the TPU package's `functional_bootstrap` on the
    same key (jitted), decrypted within 2^58."""
    import jax
    import jax.numpy as jnp
    from mosfhet_tpu import bootstrap as jbs, tlwe as jtlwe, trlwe as jtrlwe

    bk, tv, cs, key_out, luts, slots = _setup()
    gm = multihost.make_global_mesh(model=model, devices=[CPU] * 2)
    assert gm.shape == {"data": 2 // model, "model": model}
    bk_r, tv_r = multihost.replicate((bk, tv), gm)
    c = multihost.distribute_batch(cs, gm)
    axis = "model" if model > 1 else None
    got = multihost.gather_results(
        multihost.pbs_on_global_mesh(gm, bk_r, 4, model_axis=axis)(tv_r, c))
    want = tmesh.pbs_on_mesh(gm, bk, 4, model_axis=axis)(tv, cs)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    jbk = jbs.BootstrapKey(v=jnp.asarray(to_numpy(bk.v).astype(np.uint64)),
                           vs=jnp.asarray(to_numpy(bk.vs).astype(np.uint64)),
                           su=None, n=bk.n, k=bk.k, N=bk.N, l=bk.l,
                           Bg_bit=bk.Bg_bit, unfolding=1, primes=bk.primes)
    jout = jax.jit(lambda t, c_, k_: jbs.functional_bootstrap(
        t, c_, k_, 4))(jtrlwe.TRLWE(a=jnp.asarray(to_numpy(tv.a)),
                                    b=jnp.asarray(to_numpy(tv.b))),
                       jtlwe.TLWE(a=jnp.asarray(to_numpy(cs.a)),
                                  b=jnp.asarray(to_numpy(cs.b))), jbk)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(jout.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(jout.b))
    assert _decrypt_err(got, key_out, luts, slots) <= 2.0**58


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo(tmp_path):
    """Two processes on localhost over gloo: process 0's keys replicated,
    each process's half of the batch bootstrapped on its own mesh (1 plain
    rotation at model 1; 2n partial and n finish steps on a (1, 2) mesh)
    and gathered in rank order: the single-process bootstrap's words.  A
    child that fails or outlives the join timeout fails the test."""
    env = dict(os.environ, MOSFHET_COORDINATOR=f"127.0.0.1:{_free_port()}",
               MOSFHET_NUM_PROCESSES="2", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_multihost", str(tmp_path)],
        cwd=ROOT, env=dict(env, MOSFHET_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    bk, tv, cs, key_out, luts, slots = _setup()
    want = tbs.functional_bootstrap(tv, cs, bk, 4)
    for model in (1, 2):
        got = np.load(tmp_path / f"model{model}.npz")
        np.testing.assert_array_equal(got["a"], to_numpy(want.a))
        np.testing.assert_array_equal(got["b"], to_numpy(want.b))
    assert _decrypt_err(want, key_out, luts, slots) <= 2.0**58
    for r in range(2):
        counts = json.loads((tmp_path / f"counts{r}.json").read_text())
        assert counts == {
            "1": {"blind_rotate_scan_plain": 1, "partial_step_plain": 0,
                  "finish_step_plain": 0},
            "2": {"blind_rotate_scan_plain": 0,
                  "partial_step_plain": 2 * P.n, "finish_step_plain": P.n}}


def test_dryrun_multichip_on_8_cpu_devices(capsys):
    """The dry run's five modes on 8 CPU devices, each within 2^58."""
    errs = dryrun.dryrun_multichip([torch.device(CPU)] * 8)
    assert set(errs) == {"data+model", "N-sharded", "unfolded", "ga"}
    assert all(e <= 58 for e in errs.values()), errs
    assert capsys.readouterr().out.startswith("dryrun_multichip OK: modes=[")


def _child(out_dir: str):
    """One rank of `test_two_processes_over_gloo`."""
    torch.set_num_threads(1)
    assert multihost.initialize()
    rank = multihost.process_index()
    out = Path(out_dir)
    gm = multihost.make_global_mesh(devices=[CPU])
    bk, tv, cs = multihost.replicate(_setup()[:3] if rank == 0 else None, gm)
    half = B // multihost.process_count()
    sl = slice(rank * half, (rank + 1) * half)
    c = multihost.distribute_batch(tlwe.TLWE(a=cs.a[sl], b=cs.b[sl]), gm)
    counts = {}
    for model in (1, 2):
        gm = multihost.make_global_mesh(model=model, devices=[CPU] * model)
        run = multihost.pbs_on_global_mesh(
            gm, bk, 4, model_axis="model" if model > 1 else None)
        before = _plain_calls()
        got = run(tv, c)
        counts[model] = {k: v - before[k] for k, v in _plain_calls().items()}
        got = multihost.gather_results(got)
        if rank == 0:
            np.savez(out / f"model{model}.npz", a=to_numpy(got.a),
                     b=to_numpy(got.b))
    (out / f"counts{rank}.json").write_text(json.dumps(counts))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1])
