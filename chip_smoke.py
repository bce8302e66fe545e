#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mosfhet_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; any failure ends the script with a non-zero exit and no result line:

  1. card     CUDA present; the card's name and power limit (nvidia-smi).
  2. build    every kernel under mosfhet_torch/ops/csrc/ with nvcc, sm_90a.
  3. kernel   the blind-rotate kernel against its plain PyTorch version at
              full TFHEpp-L2 width on random inputs, a short rotation, with
              exponents 0 and 2N present: bit-exact.
  4. main     TFHEPP_L2 through the entry points a user calls: keygen,
              tlwe.encrypt of a batch of 512, bootstrap.functional_bootstrap
              with a random 4-slot LUT, tlwe.phase decrypt within 2^58.  The
              launch counts are zeroed just before and read just after: the
              rotation must have gone through the kernel, never the plain
              version.
  5. compare  the kernel and the plain version on the main path's own
              rotation inputs (all 512 ciphertexts): bit-exact, both timed.
  6. report   the kernels line, the card line, and the result line last.

Imports nothing but PyTorch, numpy and the port.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 512          # the TPU bench's accelerator default
REPS = 3             # timed repetitions of the warm bootstrap
SEED = 2024
DECRYPT_BOUND = 2.0**58
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
INT32_LANES_PER_SM = 64     # Hopper SM: 64 INT32 units (Hopper white paper)
SHOUP_MULTIPLIES = 3        # one Shoup product: mulhi + two 32-bit multiplies


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps):
    """Mean milliseconds per call on the card, by CUDA events; returns the
    last result too."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def signed_max_abs(x):
    """max |x| over int64 words read as signed torus differences."""
    return float(x.to(torch.float64).abs().max().item()) if x.numel() else 0.0


def rotation_bound_ms(kp, n, B, key_bytes, max_clock_mhz):
    """Least time the card needs for an n-step rotation of B ciphertexts:
    the larger of its integer multiplies over the INT32 rate and its bytes
    (key read once, accumulators in and out, exponents) over HBM."""
    J, C, P, N = kp.J, kp.C, kp.P, kp.N
    butterflies = (J * P + C * P) * (N // 2) * int(math.log2(N))
    mod_products = butterflies + J * C * P * N + C * N
    multiplies = SHOUP_MULTIPLIES * mod_products * n * B
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6
    nbytes = key_bytes + 2 * B * C * N * 8 + n * B * 4
    t_ops, t_bytes = multiplies / int_rate, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "multiplies": multiplies, "bytes": nbytes,
            "int32_per_s": int_rate, "mod_products_per_step": mod_products}


def main():
    # 1. card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mosfhet_torch import (bootstrap, ntt, params, rng, tlwe, torus,
                               trgsw, trlwe)
    from mosfhet_torch.ops import _build, pbs_kernel as pk

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    max_clock = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"# card: {card}; max SM clock {max_clock} MHz; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    # 2. build
    build_s = _build.build()
    log(f"# build: {build_s:.1f} s for {sorted(_build.build_log)}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")

    # 3. kernel vs plain at full width on random inputs
    p = params.TFHEPP_L2
    primes = ntt.primes_for_bound(
        ntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    kp = pk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, dev)
    n_short, b_short = 8, 4
    rs = np.random.default_rng(SEED)
    acc0 = torch.from_numpy(rs.integers(
        0, 1 << 64, (b_short, kp.C, p.N), dtype=np.uint64).view(np.int64)).to(dev)
    a_np = rs.integers(0, 2 * p.N + 1, (n_short, b_short), dtype=np.int32)
    a_np[0, 0], a_np[1, 1], a_np[-1, -1] = 0, 2 * p.N, p.N
    a_short = torch.from_numpy(a_np).to(dev)
    pr = np.array(primes, np.uint64)[:, None]
    kv = rs.integers(0, 1 << 62, (n_short, kp.J, kp.C, kp.P, p.N),
                     dtype=np.uint64) % pr
    kvs = (kv << np.uint64(32)) // pr
    kv32 = torch.from_numpy(kv.astype(np.uint32).view(np.int32)).to(dev)
    kvs32 = torch.from_numpy(kvs.astype(np.uint32).view(np.int32)).to(dev)
    got = pk.blind_rotate_scan(acc0, a_short, kv32, kvs32, kp)
    torch.cuda.synchronize()
    want = pk.blind_rotate_scan_plain(acc0, a_short, kv32, kvs32, kp)
    if not torch.equal(got, want):
        fail(f"kernel != plain at L2 widths, n={n_short}, B={b_short}: "
             f"{int((got != want).sum())} words differ")
    log(f"# kernel vs plain, L2 widths, n={n_short}, B={b_short}: bit-exact")

    # 4. main path
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    key_tlwe = tlwe.new_binary_key(p.n, p.lwe_sigma, gen, dev)
    key_trlwe = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    bk = bootstrap.new_key(trgsw.new_key(key_trlwe, p.l, p.Bg_bit), key_tlwe,
                           gen, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_bytes = (bk.v32.numel() + bk.vs32.numel()) * 4
    log(f"# keygen: {keygen_s:.3f} s; key {tuple(bk.v32.shape)} u32 x2 = "
        f"{key_bytes / 2**20:.1f} MiB")
    luts = rng.uniform_torus(gen, (4,), dev)
    tv = trlwe.torus_packing(luts, p.k, p.N)
    slots = torch.arange(BATCH, device=dev) % 4
    cs = tlwe.encrypt(torus.double2torus(slots.to(torch.float64) / 8.0),
                      key_tlwe, gen)

    pk.blind_rotate_scan.launches = 0
    pk.blind_rotate_scan_plain.calls = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bootstrap.functional_bootstrap(tv, cs, bk, 4)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pbs_ms, out2 = cuda_ms(
        lambda: bootstrap.functional_bootstrap(tv, cs, bk, 4), REPS)
    launches = pk.blind_rotate_scan.launches
    plain_calls = pk.blind_rotate_scan_plain.calls
    peak = torch.cuda.max_memory_allocated()
    if launches != 1 + REPS or plain_calls:
        fail(f"main path: {launches} kernel launches (want {1 + REPS}), "
             f"{plain_calls} plain calls (want 0)")
    if out.a.shape != (BATCH, p.k * p.N) or out.b.shape != (BATCH,):
        fail(f"output shapes {tuple(out.a.shape)}, {tuple(out.b.shape)}")
    if not (torch.equal(out.a, out2.a) and torch.equal(out.b, out2.b)):
        fail("repeated bootstraps of the same inputs differ")
    err = signed_max_abs(tlwe.phase(out, key_out) - luts[slots])
    if not err <= DECRYPT_BOUND:
        fail(f"decrypt: max error 2^{math.log2(err):.1f} > 2^58")
    log(f"# main path: first call {first_s:.3f} s; warm {pbs_ms:.3f} ms per "
        f"batch of {BATCH} = {BATCH / pbs_ms * 1e3:.2f} boot/s; decrypt OK "
        f"(max err 2^{math.log2(max(err, 1.0)):.1f}); peak "
        f"{peak / 2**30:.2f} GiB; blind_rotate_scan launches {launches}")

    # 5. the kernel and the plain version on the main path's own inputs
    acc_in, a_int, _ = bootstrap.blind_rotate_inputs(
        bootstrap.rotate_test_vector(tv, cs, bk, 4), cs.a, bk)
    bkp = bk.kernel_plan()
    kernel_ms, acc_k = cuda_ms(
        lambda: pk.blind_rotate_scan(acc_in, a_int, bk.v32, bk.vs32, bkp),
        REPS)
    plain_ms, acc_p = cuda_ms(
        lambda: pk.blind_rotate_scan_plain(acc_in, a_int, bk.v32, bk.vs32,
                                           bkp), 1)
    max_abs_err = signed_max_abs(acc_k - acc_p)
    if max_abs_err != 0.0:
        fail(f"kernel != plain on the main path's inputs "
             f"({int((acc_k != acc_p).sum())} words)")
    ext = trlwe.extract_tlwe(trlwe.from_stacked(acc_k), 0)
    if not (torch.equal(ext.a, out.a) and torch.equal(ext.b, out.b)):
        fail("main path output != extract of the kernel's rotation")
    plain2_ms, acc_p2 = cuda_ms(
        lambda: pk.blind_rotate_scan_plain(acc_in[:2].contiguous(),
                                           a_int[:, :2].contiguous(),
                                           bk.v32, bk.vs32, bkp), 1)
    if not torch.equal(acc_p2, acc_k[:2]):
        fail("plain rotation of the first 2 ciphertexts != kernel")
    bound = rotation_bound_ms(bkp, bk.n, BATCH, key_bytes, max_clock)
    log(f"# blind_rotate_scan at B={BATCH}, n={bk.n}: kernel {kernel_ms:.3f} "
        f"ms/launch, plain {plain_ms:.3f} ms (first 2 ciphertexts: "
        f"{plain2_ms:.3f} ms), bound {bound['bound_ms']:.3f} ms "
        f"({bound['bound_by']}: {bound['multiplies']:.4g} int32 multiplies at "
        f"{bound['int32_per_s']:.4g}/s, {bound['bytes']:.4g} B at "
        f"{HBM_BYTES_PER_S:.3g} B/s); bit-exact")

    # 6. report
    kernels = [{
        "name": "blind_rotate_scan", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/blind_rotate.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1404",
        "launches": launches, "max_abs_err": max_abs_err, "bit_exact": True,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
    }]
    log(json.dumps({"pbs": {
        "params": p.name, "batch": BATCH, "keygen_s": keygen_s,
        "first_call_s": first_s, "warm_ms": pbs_ms,
        "boot_per_s": BATCH / pbs_ms * 1e3, "peak_bytes": peak,
        "decrypt_max_err_log2": math.log2(max(err, 1.0)),
        "build_s": build_s, "plain_first2_ms": plain2_ms,
        "bound": bound}}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
