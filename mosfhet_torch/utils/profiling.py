"""Timing and tracing helpers: the reference's MEASURE_TIME harness
(`test/benchmark.c:5-31`) for PyTorch, where a CUDA launch returns before
its work ends (so `measure` synchronizes every device) and a first call
builds the kernels.

    with profiling.trace("out/trace") as t:      # torch.profiler trace
        stats = profiling.measure(fn, *args)      # mean/std/min, print_bench
    t.device_events                               # the card's kernels
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time

import torch


def _block(out):
    """Wait for the work that produces ``out``: synchronize every CUDA
    device (whatever ``out`` is: a tensor, a tree, a key module; CPU results
    are ready on return)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    return out


def measure(fn, *args, reps: int = 10, warmup: int = 1, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` ``reps`` times after ``warmup`` untimed
    calls, each timed on the host's clock until every device is idle:
    {"mean_s", "std_s", "min_s", "reps"}, as the reference's `print_bench`
    (`benchmark.c:15-22`) prints mean +- stddev."""
    for _ in range(warmup):
        _block(fn(*args, **kwargs))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn(*args, **kwargs))
        ts.append(time.perf_counter() - t0)
    mean = sum(ts) / len(ts)
    var = sum((t - mean) ** 2 for t in ts) / len(ts)
    return {"mean_s": mean, "std_s": math.sqrt(var), "min_s": min(ts),
            "reps": reps}


# trace events the card itself ran (Kineto's categories)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """What `trace` recorded: ``path`` of the Chrome trace, and the card's
    events in it as {"name", "ms"} (empty without CUDA activity)."""

    def __init__(self):
        self.path = None
        self.device_events = []

    def device_ms(self, name_part: str) -> list:
        """Milliseconds of each device event whose name holds
        ``name_part``."""
        return [e["ms"] for e in self.device_events if name_part in e["name"]]


_traces = {"n": 0}


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block, written as a Chrome trace
    (chrome://tracing, Perfetto) under ``logdir``.  CPU activity always;
    CUDA activity when a card is present, and then a trace that holds no
    event of the card raises RuntimeError: it never hands back a trace that
    saw no device."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    _traces["n"] += 1
    out = Trace()
    with profile(activities=activities) as prof:
        yield out
        _block(None)
    out.path = os.path.join(logdir,
                            f"trace_{os.getpid()}_{_traces['n']}.json")
    prof.export_chrome_trace(out.path)
    with open(out.path) as f:
        events = json.load(f).get("traceEvents", [])
    out.device_events = [
        {"name": e["name"], "ms": e.get("dur", 0.0) / 1e3} for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if cuda and not out.device_events:
        raise RuntimeError(
            f"torch.profiler recorded no device event with CUDA activity "
            f"asked ({out.path}): the card's activity is not traced here")
