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
              version, and no key switch ran.
  5. compare  the kernel and the plain version on the main path's own
              rotation inputs (all 512 ciphertexts): bit-exact, both timed.
  6. ks       the key-switch kernel against its plain version at full
              TFHEpp-L2 key-switch widths (n_in=2048, t=8, base 16,
              n_out=632) on random digits (0 and 15 present) and a random
              table: bit-exact.
  7. gate     the L2 key-switch key made by the port's tlwe.new_ks_key on
              the card (timed); tlwe.keyswitch of phase 4's 512 outputs
              back to the LWE key: one kernel launch, no plain call, words
              equal to the plain version's, decrypt within 2^60; the kernel
              timed per launch beside its bound and the plain version.
  8. fdfb     bootstrap.fdfb_this_work at TFHEPP_L2, batch 512, precision
              3, every message m = i mod 8: counts zeroed just before, read
              just after (2 rotation launches and 1 key-switch launch per
              call, no plain call); decrypt within 2^58 of the LUT; the
              whole call with the plain versions on the first 2
              ciphertexts gives the same words.
  9. report   the fdfb and pbs lines, the card line, the kernels line, and
              the result line last.

Imports nothing but PyTorch, numpy and the port.
"""

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 512          # the TPU bench's accelerator default
REPS = 3             # timed repetitions of the warm bootstrap
KS_REPS = 10         # timed launches of the key-switch kernel
FDFB_PREC = 3        # the TPU bench suite's fdfb_this_work precision
SEED = 2024
DECRYPT_BOUND = 2.0**58
# Key-switch noise at L2: ~15,360 nonzero digits x (2^-15)^2 gives sigma
# ~2^-8.05 of the torus, ~2^56 in words; 2^60 is ~8 sigma.
KS_DECRYPT_BOUND = 2.0**60
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
INT32_LANES_PER_SM = 64     # Hopper SM: 64 INT32 units (Hopper white paper)
SHOUP_MULTIPLIES = 3        # one Shoup product: mulhi + two 32-bit multiplies
# No PyTorch call computes the key-switch select-sum on int64 CUDA tensors.
KS_LIBRARY_NOTE = ("none: torch.sparse.mm of the one-hot digits and the "
                   "table raises \"addmm_sparse_cuda\" not implemented for "
                   "'Long' (torch 2.11.0+cu128); embedding_bag takes "
                   "floating weights only")


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


def keyswitch_bound_ms(dig, ab, max_clock_mhz):
    """Least time the card needs for the select-sum on these digits: the
    larger of its u64 adds (one per nonzero digit and column, 2 INT32
    operations each) over the INT32 rate and its bytes (the distinct table
    rows the digits select, read once, the digits, the output) over HBM."""
    B, n_in, t = dig.shape
    base_m1, width = ab.shape[2], ab.shape[3]
    d = dig.to(torch.int64).reshape(B, n_in * t)
    nz = d != 0
    adds = int(nz.sum()) * width
    flat = torch.arange(n_in * t, device=d.device) * base_m1 + d - 1
    selected = torch.zeros(n_in * t * base_m1, dtype=torch.bool,
                           device=d.device)
    selected[flat[nz]] = True
    rows = int(selected.sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6
    nbytes = rows * width * 8 + dig.numel() * dig.element_size() + B * width * 8
    t_ops, t_bytes = 2 * adds / int_rate, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "u64_adds": adds, "int32_ops": 2 * adds, "bytes": nbytes,
            "rows_selected": rows, "int32_per_s": int_rate}


@contextlib.contextmanager
def plain_kernels(pk):
    """Route every kernel wrapper to its plain version for the duration, so
    an entry point runs its plain whole on CUDA tensors."""
    saved = pk.blind_rotate_scan, pk.tlwe_keyswitch_sum
    pk.blind_rotate_scan = pk.blind_rotate_scan_plain
    pk.tlwe_keyswitch_sum = pk.tlwe_keyswitch_sum_plain
    try:
        yield
    finally:
        pk.blind_rotate_scan, pk.tlwe_keyswitch_sum = saved


def zero_counts(pk):
    pk.blind_rotate_scan.launches = 0
    pk.blind_rotate_scan_plain.calls = 0
    pk.tlwe_keyswitch_sum.launches = 0
    pk.tlwe_keyswitch_sum_plain.calls = 0


def read_counts(pk):
    return {"blind_rotate_scan": pk.blind_rotate_scan.launches,
            "tlwe_keyswitch_sum": pk.tlwe_keyswitch_sum.launches,
            "blind_rotate_scan_plain": pk.blind_rotate_scan_plain.calls,
            "tlwe_keyswitch_sum_plain": pk.tlwe_keyswitch_sum_plain.calls}


def main():
    t_start = time.perf_counter()
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

    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bootstrap.functional_bootstrap(tv, cs, bk, 4)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pbs_ms, out2 = cuda_ms(
        lambda: bootstrap.functional_bootstrap(tv, cs, bk, 4), REPS)
    pbs_counts = read_counts(pk)
    launches = pbs_counts["blind_rotate_scan"]
    peak = torch.cuda.max_memory_allocated()
    if pbs_counts != {"blind_rotate_scan": 1 + REPS, "tlwe_keyswitch_sum": 0,
                      "blind_rotate_scan_plain": 0,
                      "tlwe_keyswitch_sum_plain": 0}:
        fail(f"main path: counts {pbs_counts} over {1 + REPS} calls (want 1 "
             f"rotation launch per call, no key switch, no plain call)")
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

    # 6. the key-switch kernel vs plain at full L2 widths, random inputs
    n_in, n_out, base_m1 = p.k * p.N, p.n, (1 << p.base_bit) - 1
    b_short = 4
    dig_np = rs.integers(0, base_m1 + 1, (b_short, n_in, p.t), dtype=np.int32)
    dig_np[0, 0, 0], dig_np[-1, -1, -1] = 0, base_m1
    ab_rand = torch.from_numpy(rs.integers(
        0, 1 << 64, (n_in, p.t, base_m1, n_out + 1),
        dtype=np.uint64).view(np.int64)).to(dev)
    d = torch.from_numpy(dig_np).to(dev)
    got = pk.tlwe_keyswitch_sum(d, ab_rand)
    torch.cuda.synchronize()
    want = pk.tlwe_keyswitch_sum_plain(d, ab_rand)
    if not torch.equal(got, want):
        fail(f"ks kernel != plain at L2 widths: "
             f"{int((got != want).sum())} words differ")
    del ab_rand
    log(f"# ks kernel vs plain, L2 widths, B={b_short}: bit-exact")

    # 7. gate: the port's own L2 key-switch key, then phase 4's outputs
    #    switched back to the LWE key
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ksk = tlwe.new_ks_key(key_tlwe, key_out, p.t, p.base_bit, gen, dev)
    torch.cuda.synchronize()
    ks_keygen_s = time.perf_counter() - t0
    ks_key_bytes = ksk.ab.numel() * 8
    log(f"# ks keygen: {ks_keygen_s:.3f} s; table {tuple(ksk.ab.shape)} "
        f"int64 = {ks_key_bytes} B")
    zero_counts(pk)
    ks_out = tlwe.keyswitch(out, ksk)
    torch.cuda.synchronize()
    gate_counts = read_counts(pk)
    if gate_counts != {"blind_rotate_scan": 0, "tlwe_keyswitch_sum": 1,
                       "blind_rotate_scan_plain": 0,
                       "tlwe_keyswitch_sum_plain": 0}:
        fail(f"gate: counts {gate_counts} (want 1 ks launch, no rotation, "
             f"no plain call)")
    ks_err = signed_max_abs(tlwe.phase(ks_out, key_tlwe) - luts[slots])
    if not ks_err <= KS_DECRYPT_BOUND:
        fail(f"gate decrypt: max error 2^{math.log2(ks_err):.1f} > 2^60")
    dig = tlwe.keyswitch_inputs(out, ksk)
    ks_ms, sub_k = cuda_ms(lambda: pk.tlwe_keyswitch_sum(dig, ksk.ab),
                           KS_REPS)
    ks_plain_ms, sub_p = cuda_ms(
        lambda: pk.tlwe_keyswitch_sum_plain(dig, ksk.ab), 1)
    ks_max_abs_err = signed_max_abs(sub_k - sub_p)
    if ks_max_abs_err != 0.0:
        fail(f"ks kernel != plain on the gate's inputs "
             f"({int((sub_k != sub_p).sum())} words)")
    if not (torch.equal(ks_out.a, -sub_k[:, :n_out])
            and torch.equal(ks_out.b, out.b - sub_k[:, n_out])):
        fail("gate output != (0, b) minus the kernel's select-sum")
    ks_bound = keyswitch_bound_ms(dig, ksk.ab, max_clock)
    log(f"# tlwe_keyswitch_sum at B={BATCH}: kernel {ks_ms:.3f} ms/launch "
        f"(mean of {KS_REPS}), plain {ks_plain_ms:.3f} ms, bound "
        f"{ks_bound['bound_ms']:.3f} ms ({ks_bound['bound_by']}: "
        f"{ks_bound['int32_ops']:.4g} int32 ops at "
        f"{ks_bound['int32_per_s']:.4g}/s, {ks_bound['bytes']:.4g} B at "
        f"{HBM_BYTES_PER_S:.3g} B/s); bit-exact; decrypt OK (max err "
        f"2^{math.log2(max(ks_err, 1.0)):.1f})")
    del dig, sub_k, sub_p

    # 8. fdfb_this_work main path
    luts8 = rng.uniform_torus(gen, (8,), dev)
    tv8 = trlwe.torus_packing_many_lut(luts8, 4, 2, p.k, p.N)
    m8 = torch.arange(BATCH, device=dev) % 8
    c8 = tlwe.encrypt(torus.int2torus(m8, FDFB_PREC), key_tlwe, gen)
    zero_counts(pk)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out8 = bootstrap.fdfb_this_work(tv8, c8, bk, ksk, FDFB_PREC)
    torch.cuda.synchronize()
    fdfb_first_s = time.perf_counter() - t0
    fdfb_ms, out8b = cuda_ms(
        lambda: bootstrap.fdfb_this_work(tv8, c8, bk, ksk, FDFB_PREC), REPS)
    fdfb_counts = read_counts(pk)
    fdfb_peak = torch.cuda.max_memory_allocated()
    calls = 1 + REPS
    if fdfb_counts != {"blind_rotate_scan": 2 * calls,
                       "tlwe_keyswitch_sum": calls,
                       "blind_rotate_scan_plain": 0,
                       "tlwe_keyswitch_sum_plain": 0}:
        fail(f"fdfb path: counts {fdfb_counts} over {calls} calls (want 2 "
             f"rotation and 1 key-switch launches per call, no plain call)")
    if out8.a.shape != (BATCH, p.k * p.N) or out8.b.shape != (BATCH,):
        fail(f"fdfb output shapes {tuple(out8.a.shape)}, "
             f"{tuple(out8.b.shape)}")
    if not (torch.equal(out8.a, out8b.a) and torch.equal(out8.b, out8b.b)):
        fail("repeated fdfb calls on the same inputs differ")
    fdfb_err = signed_max_abs(tlwe.phase(out8, key_out) - luts8[m8])
    if not fdfb_err <= DECRYPT_BOUND:
        fail(f"fdfb decrypt: max error 2^{math.log2(fdfb_err):.1f} > 2^58")
    c2 = tlwe.TLWE(a=c8.a[:2].contiguous(), b=c8.b[:2].contiguous())
    zero_counts(pk)
    with plain_kernels(pk):
        fdfb_plain2_ms, out_p = cuda_ms(
            lambda: bootstrap.fdfb_this_work(tv8, c2, bk, ksk, FDFB_PREC), 1)
    plain_counts = read_counts(pk)
    if plain_counts != {"blind_rotate_scan": 0, "tlwe_keyswitch_sum": 0,
                        "blind_rotate_scan_plain": 2,
                        "tlwe_keyswitch_sum_plain": 1}:
        fail(f"plain fdfb: counts {plain_counts}")
    if not (torch.equal(out_p.a, out8.a[:2]) and torch.equal(out_p.b,
                                                             out8.b[:2])):
        fail("plain fdfb of the first 2 ciphertexts != the kernel path")
    glue_ms = fdfb_ms - 2 * kernel_ms - ks_ms
    log(f"# fdfb_this_work: first call {fdfb_first_s:.3f} s; warm "
        f"{fdfb_ms:.3f} ms per batch of {BATCH} = "
        f"{BATCH / fdfb_ms * 1e3:.2f} fdfb/s (2 x rotation {kernel_ms:.3f} + "
        f"key switch {ks_ms:.3f} + glue {glue_ms:.3f} ms); decrypt OK (max "
        f"err 2^{math.log2(max(fdfb_err, 1.0)):.1f}); peak "
        f"{fdfb_peak / 2**30:.2f} GiB; counts {fdfb_counts}; plain whole "
        f"call on 2 ciphertexts {fdfb_plain2_ms:.3f} ms, bit-exact")

    # 9. report
    launches_by_path = {
        "blind_rotate_scan": {"pbs": launches,
                              "gate": gate_counts["blind_rotate_scan"],
                              "fdfb": fdfb_counts["blind_rotate_scan"]},
        "tlwe_keyswitch_sum": {"pbs": pbs_counts["tlwe_keyswitch_sum"],
                               "gate": gate_counts["tlwe_keyswitch_sum"],
                               "fdfb": fdfb_counts["tlwe_keyswitch_sum"]}}
    kernels = [{
        "name": "blind_rotate_scan", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/blind_rotate.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:1404",
        "launches": fdfb_counts["blind_rotate_scan"],
        "launches_by_path": launches_by_path["blind_rotate_scan"],
        "max_abs_err": max_abs_err, "bit_exact": True,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": None,
    }, {
        "name": "tlwe_keyswitch_sum", "route": "cuda",
        "source": "mosfhet_torch/ops/csrc/tlwe_keyswitch.cu",
        "replaces": "mosfhet_tpu/ops/pbs_kernel.py:2070",
        "launches": fdfb_counts["tlwe_keyswitch_sum"],
        "launches_by_path": launches_by_path["tlwe_keyswitch_sum"],
        "max_abs_err": ks_max_abs_err, "bit_exact": True,
        "ms": ks_ms, "plain_ms": ks_plain_ms,
        "bound_ms": ks_bound["bound_ms"], "bound_by": ks_bound["bound_by"],
        "library_ms": None, "library_note": KS_LIBRARY_NOTE,
    }]
    log(json.dumps({"pbs": {
        "params": p.name, "batch": BATCH, "keygen_s": keygen_s,
        "first_call_s": first_s, "warm_ms": pbs_ms,
        "boot_per_s": BATCH / pbs_ms * 1e3, "peak_bytes": peak,
        "decrypt_max_err_log2": math.log2(max(err, 1.0)),
        "build_s": build_s, "plain_first2_ms": plain2_ms,
        "bound": bound}}))
    log(json.dumps({"gate": {
        "ks_keygen_s": ks_keygen_s, "ks_key_bytes": ks_key_bytes,
        "decrypt_max_err_log2": math.log2(max(ks_err, 1.0)),
        "bound": ks_bound}}))
    log(json.dumps({"fdfb": {
        "params": p.name, "batch": BATCH, "precision": FDFB_PREC,
        "first_call_s": fdfb_first_s, "warm_ms": fdfb_ms,
        "fdfb_per_s": BATCH / fdfb_ms * 1e3, "peak_bytes": fdfb_peak,
        "decrypt_max_err_log2": math.log2(max(fdfb_err, 1.0)),
        "rotation_ms": kernel_ms, "keyswitch_ms": ks_ms, "glue_ms": glue_ms,
        "plain_first2_ms": fdfb_plain2_ms}}))
    log(f"# whole script: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
