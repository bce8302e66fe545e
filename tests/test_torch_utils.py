"""The port's profiling and roofline (`mosfhet_torch.utils`): each kernel's
bound at 132 SMs and 1,980 MHz is the bound column of PERF.md's kernel table
at its shapes; `count_fn` counts an elementwise function as the TPU
package's counter does, and a reduction by its input elements (where the
TPU package's counts none); `count_pbs` is K1's formula plus the counted
glue, whichever of K1 and its plain version ran; `measure` and `trace` on
the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from mosfhet_torch import keyswitch, ntt, params
from mosfhet_torch.ops import pbs_kernel as tpk
from mosfhet_torch.utils import profiling, roofline as rl
from tests.test_torch_suite_env import port_test_env  # noqa: F401

H100 = rl.Peaks(132, 1980.0)
CPU = "cpu"


def _kp(p, bits=64, primes=None):
    primes = primes or ntt.primes_for_bound(
        ntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    return tpk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, CPU, bits)


def _key_bytes(kp, n):
    """An unfold=1 key's residues and Shoup companions, u32 each."""
    return 2 * n * kp.J * kp.C * kp.P * kp.N * 4


L2 = params.TFHEPP_L2
L2_32 = params.TFHEParams(n=632, N=2048, k=1, l=3, Bg_bit=7, t=6, base_bit=4,
                          lwe_sigma=2.0**-15, rlwe_sigma=2.0**-25)


def _ga_plans():
    kp = _kp(L2)
    ks = keyswitch._ks_plan(L2.N, L2.Bg_bit, L2.l, L2.k * L2.l, CPU)
    return kp, tpk.get_kernel_plan(L2.N, ks.primes, L2.l, L2.Bg_bit, L2.k,
                                   CPU)


BOUNDS = {   # PERF.md section 6, "bound ms" (and its basis), at its shapes
    "K1 L2": (lambda: rl.rotation_work(
        _kp(L2), 632, 512, _key_bytes(_kp(L2), 632)), 25.554),
    "K1 SET_3": (lambda: rl.rotation_work(
        _kp(params.SET_3), 807, 512, _key_bytes(_kp(params.SET_3), 807)),
        34.603),
    "K1 L2_32": (lambda: rl.rotation_work(
        _kp(L2_32, 32, ntt.MASTER_PRIMES[-2:]), 632, 512,
        _key_bytes(_kp(L2_32, 32, ntt.MASTER_PRIMES[-2:]), 632)), 13.550),
    "K3 UBR phase 2": (lambda: rl.apply_scan_work(_kp(L2), 256, 79, False),
                       1.716),
    "K4 u=4": (lambda: rl.unfolded_work(_kp(L2), 512, 158, 16), 22.632),
    "K5 u=8 B=64": (lambda: rl.ubr_phase1_work(_kp(L2), 64, 79, 256), 5.740),
    "K7": (lambda: rl.ga_work(*_ga_plans(), torch.arange(
        632 * 512).reshape(632, 512) % 2048 * 2 + 1), 41.362),
    "K8a": (lambda: rl.partial_step_work(_kp(L2), 512, 4), 0.0169),
    "K8b": (lambda: rl.finish_step_work(_kp(L2), 512, 2), 0.0250, "bytes"),
    "K1-delta": (lambda: rl.cmux_delta_work(_kp(L2), 512), 0.0404),
}


@pytest.mark.parametrize("name", list(BOUNDS))
def test_bound_matches_perf_table(name):
    work, want, *by = BOUNDS[name]
    b = rl.bound(work(), H100)
    assert b["bound_by"] == (by[0] if by else "operations")
    digits = len(str(want).split(".")[1])
    assert round(b["bound_ms"], digits) == want, b["bound_ms"]


def test_peaks_int32_rate():
    assert H100.int32_per_s == pytest.approx(1.673e13, rel=1e-3)
    assert rl.H100_SXM == H100


def test_count_fn_elementwise_matches_tpu_counter():
    """Three elementwise ops on [4, 128]: one operation per output element
    in both counters (the TPU package's `vpu_ops` of the same jnp
    function)."""
    import jax.numpy as jnp
    from mosfhet_tpu.utils import roofline as jrl

    x = np.arange(512, dtype=np.int64).reshape(4, 128)
    y = x * 7 + 3
    f = lambda a, b: (a * b + a) ^ b                       # noqa: E731
    want = jrl.count_fn(f, jnp.asarray(x), jnp.asarray(y)).vpu_ops
    got = rl.count_fn(f, torch.from_numpy(x), torch.from_numpy(y))
    assert got.int32_ops == want == 3 * 512
    assert got.hbm_bytes == 3 * 3 * 512 * 8        # 2 reads, 1 write each


def test_count_fn_reduction_counts_its_input():
    """A sum over the last axis counts its 512 input elements; the TPU
    package's counter takes `reduce_sum` as free (0), which this port does
    not copy."""
    import jax.numpy as jnp
    from mosfhet_tpu.utils import roofline as jrl

    x = np.arange(512, dtype=np.int64).reshape(4, 128)
    assert jrl.count_fn(lambda a: a.sum(-1), jnp.asarray(x)).vpu_ops == 0
    assert rl.count_fn(lambda a: a.sum(-1),
                       torch.from_numpy(x)).int32_ops == 512


def test_kernel_wrapper_counts_its_formula_not_its_plain_ops():
    """K8b on CPU tensors runs its plain version; the count is K8b's
    formula alone (the wrapper looked up as ``pbs_kernel.finish_step`` when
    it is called, as every caller does)."""
    kp = _kp(params.TOY)
    rs = np.random.default_rng(3)
    acc = torch.from_numpy(rs.integers(0, 1 << 62, (5, kp.C, kp.N)))
    parts = torch.from_numpy(rs.integers(
        0, min(kp.primes), (2, 5, kp.C, kp.P, kp.N)).astype(np.int32))
    c = rl.count_fn(lambda: tpk.finish_step(acc, parts, kp))
    w = rl.finish_step_work(kp, 5, 2)
    assert (c.int32_ops, c.hbm_bytes) == (w["int32_ops"], w["bytes"])
    assert list(c.kernels) == ["finish_step"]
    assert c.kernels["finish_step"].launches == 1


def test_kernel_work_covers_every_wrapper_and_leaves_them_untouched():
    """`KERNEL_WORK` names each kernel wrapper of `ops/pbs_kernel` (those
    that count launches and have a plain version); `count_fn` swaps them
    only while it runs, also when the function raises."""
    wrappers = {name for name in dir(tpk)
                if hasattr(getattr(tpk, name), "launches")
                and hasattr(tpk, name + "_plain")}
    assert set(rl.KERNEL_WORK) == wrappers
    before = {name: getattr(tpk, name) for name in wrappers}

    def boom():
        raise ValueError("inside")

    with pytest.raises(ValueError, match="inside"):
        rl.count_fn(boom)
    assert {name: getattr(tpk, name) for name in wrappers} == before


def test_count_pbs_is_k1_formula_plus_glue():
    """`count_pbs(TOY, 8)`: one K1 whose count is its formula over the
    key's n steps and 8 ciphertexts, plus the counted glue around it (the
    test vector's rotation, the exponents, the extraction); per bootstrap;
    `report` reads it."""
    p, batch = params.TOY, 8
    c = rl.count_pbs(p, batch, device=CPU)
    kp = _kp(p)
    k1 = rl.rotation_work(kp, p.n, batch, _key_bytes(kp, p.n))
    assert list(c.kernels) == ["blind_rotate_scan"]
    assert c.kernels["blind_rotate_scan"].int32_ops == k1["int32_ops"] / batch
    assert c.kernels["blind_rotate_scan"].hbm_bytes == k1["bytes"] / batch
    glue = c.glue
    assert glue.int32_ops > 0 and glue.hbm_bytes > 0
    assert c.int32_ops == k1["int32_ops"] / batch + glue.int32_ops
    r = rl.report(c, 1e-3, H100)
    t = max(c.int32_ops / H100.int32_per_s,
            c.hbm_bytes / H100.hbm_bytes_per_s)
    assert r["sol_ms"] == pytest.approx(t * 1e3, rel=1e-12)
    assert r["mfu"] == pytest.approx(t / 1e-3, rel=1e-12)
    assert set(r) == {"mfu", "bound", "mfu_int32", "hbm_frac", "sol_ms",
                      "int32_gop", "hbm_mib"}


def test_measure_returns_its_four_keys():
    x = torch.arange(64)
    r = profiling.measure(lambda a: a * 3, x, reps=3, warmup=1)
    assert set(r) == {"mean_s", "std_s", "min_s", "reps"} and r["reps"] == 3
    assert 0 < r["min_s"] <= r["mean_s"]


def test_measure_synchronizes_every_card_whatever_fn_returns(monkeypatch):
    """A function that returns a key module (`bootstrap.BootstrapKey` and
    the key-switch keys are `nn.Module`s) is timed up to every card's
    synchronize: ``measure`` does not look for tensors in what it gets."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)

    class Key(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("v", torch.zeros(4))

    profiling.measure(Key, reps=3, warmup=1)
    assert synced == [0, 1] * 4


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.arange(4096)
    with profiling.trace(str(tmp_path)) as t:
        (x * 3 + 1).sum()
    assert os.path.exists(t.path) and t.device_events == []
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)


def test_trace_raises_on_a_trace_without_device_events(tmp_path,
                                                       monkeypatch):
    """With a card present, `trace` asks for CUDA activity; a trace that
    comes back holding no event of the card raises (a profiler that cannot
    see the card stands in for ``torch.profiler.profile``: a CPU build of
    torch cannot trace CUDA activity at all)."""
    asked = []

    class Blind:
        def __init__(self, activities):
            asked.extend(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [
                    {"ph": "X", "cat": "cpu_op", "name": "aten::mul",
                     "dur": 3.0}]}, f)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.profiler, "profile", Blind)
    with pytest.raises(RuntimeError, match="no device event"):
        with profiling.trace(str(tmp_path)):
            pass
    assert torch.profiler.ProfilerActivity.CUDA in asked
