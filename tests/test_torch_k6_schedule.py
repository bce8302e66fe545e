"""The GA step's external product (K1-delta, `mosfhet_torch/ops/csrc/
cmux_delta.cu`) and the automorphism key switch (K6, `csrc/auto_keyswitch.cu`)
on K1's schedule, rendered in plain numpy integer arithmetic and held bit
for bit to `pbs_kernel.cmux_delta_plain` and
`pbs_kernel.auto_keyswitch_stream_plain`.

Both blocks are pieces of K7's step, rendered by `render_spectra` of
`tests/test_torch_k7_schedule.py` on the K1 rendering's schedule helpers
(`tests/test_torch_k1_schedule.py`).  K1-delta is K3's product run once:
the block loads x into acc, the digits are read from acc, and Garner writes
the words to a distinct output.  K6 is K7's stages 2-3: the block loads x
into acc, the key switch's digits read psi_g(x) from acc through ginv, and
after one block barrier Garner writes (0, b') - INTT(.) to the output, b'
read from acc.  Every read and write of acc, and every write of the output,
is logged per thread and checked at each block barrier: no word is written
by one thread and read or written by another between two barriers.  Since
the output is distinct from acc, K6 reads b' after the barrier; written in
place, as K7 writes acc, that read is the hazard the log catches.  Cases:
TOY and TFHEpp-L2 widths, two ciphertexts; K6 with u64 and u32 words,
ginv 1 and 2N-1, one keyset entry for both ciphertexts or one each; and
K6-old, which launches K6's kernel with ginv 1 and entry b for row b, on
rows already permuted and keyset entries gathered per row.
Nothing on the port's path calls these renderings; the kernels themselves
meet the plain versions on the card (`test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_k1_schedule import schedule
from tests.test_torch_k7_schedule import (AccLog, garner_words, i32, keyset,
                                          permuted, render_spectra)


def _mask(bits):
    return np.uint64((1 << bits) - 1) if bits == 32 else np.uint64(2**64 - 1)


def _block(kp):
    """The block's schedule, its threads and each thread's row of
    `render_spectra`'s [T, 16] positions."""
    s = schedule(kp.N, kp.P)
    return s, s["NG"] * s["T"], np.arange(s["T"])[:, None]


def _load(log, C, N, threads, in_place):
    """The block's coalesced load of x into acc (thread t writes words t,
    t + threads, ...), then a block barrier; nothing where acc is x."""
    if not in_place:
        idx = np.arange(C * N)
        log.write(idx, idx % threads)
    log.barrier()


def render_cmux_delta(x, keyv, kp, in_place=False):
    """K1-delta's block on each ciphertext: x [B, C, N] u64 words (numpy
    uint64), keyv [J, C, P, N] u32 residues.  in_place: acc is x itself
    (the placement where acc does not fit).  Returns out."""
    N, C = kp.N, kp.C
    s, threads, t_of = _block(kp)
    out = np.empty_like(x)
    for b in range(x.shape[0]):
        log, out_log, acc = AccLog(C * N), AccLog(C * N), x[b]
        _load(log, C, N, threads, in_place)

        def read_acc(c, k, tid):
            log.read(c * N + k, tid + t_of)
            return acc[c][k]
        spec = render_spectra(read_acc, kp.J, keyv, kp, s, kp.P)
        log.barrier()
        out[b] = garner_words(spec, kp)
        idx = np.arange(C * N)
        out_log.write(idx, idx % threads)
        out_log.barrier()
        log.barrier()
    return out


def render_auto_keyswitch(x, ak, kidx, ginv, kp, out_in_acc=False,
                          in_place=False):
    """K6's block on each ciphertext: x [B, C, N] words (uint64 holding 64
    or 32 bits), ak [G, kt, C, P, N] u32 residues, kidx and ginv [B].
    out_in_acc: Garner writes acc, as K7 does (the hazard).  in_place: acc
    is x itself.  Returns out."""
    bits, N, C = kp.torus_bits, kp.N, kp.C
    mask = _mask(bits)
    s, threads, t_of = _block(kp)
    out = np.empty_like(x)
    for b in range(x.shape[0]):
        log, out_log, acc = AccLog(C * N), AccLog(C * N), x[b]
        gi = int(ginv[b])
        _load(log, C, N, threads, in_place)

        def read_perm(c, k, tid):
            v, i = permuted(acc[c], k, gi, N, mask)
            log.read(c * N + i, tid + t_of)
            return v
        spec = render_spectra(read_perm, (C - 1) * kp.l, ak[int(kidx[b])],
                              kp, s, kp.P)
        log.barrier()
        idx = np.arange(C * N)
        tid = idx % threads
        w = garner_words(spec, kp)
        top = idx >= (C - 1) * N                  # the b' positions
        bp, i = permuted(acc[C - 1], idx[top] - (C - 1) * N, gi, N, mask)
        log.read((C - 1) * N + i, tid[top])
        new = (np.uint64(0) - w) & mask
        new[C - 1] = (bp - w[C - 1]) & mask
        (log if out_in_acc else out_log).write(idx, tid)
        log.barrier()
        out_log.barrier()
        out[b] = new
    return out


def _words(x, bits):
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)
                            if bits == 32 else x.view(np.int64))


def _got(x, bits):
    return x.astype(np.uint32).view(np.int32) if bits == 32 else \
        x.view(np.int64)


# (N, l, Bg_bit, torus bits)
WIDTHS = {"toy": (64, 4, 9, 64), "l2": (2048, 4, 9, 64),
          "toy32": (64, 3, 7, 32), "l2_32": (2048, 3, 7, 32),
          "set3": (4096, 1, 22, 64)}


def _plan(name):
    N, l, Bg_bit, bits = WIDTHS[name]
    primes = ntt.MASTER_PRIMES[-2:] if bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, 1))
    return tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cpu", bits)


@pytest.mark.parametrize("name,in_place", [("toy", False), ("toy", True),
                                           ("l2", False)],
                         ids=["toy", "toy_in_place", "l2"])
def test_cmux_delta_rendering_matches_plain(name, in_place):
    """K1-delta's block on two ciphertexts, words whose offset carries into
    the high half and a key word at p - 1 of every prime present, against
    cmux_delta_plain (the key's Shoup companions, which the kernel does not
    read, given to the plain version)."""
    kp = _plan(name)
    N, C, J, P = kp.N, kp.C, kp.J, kp.P
    rng = np.random.default_rng(N + 11 * in_place)
    x = rng.integers(0, 1 << 64, (2, C, N), dtype=np.uint64)
    x[0, 0, :3] = [(1 << 64) - 1, 1 << 63, 0xFFFFFFFF]
    pr = np.array(kp.primes, np.uint64)[:, None]
    keyv = rng.integers(0, 1 << 62, (J, C, P, N), dtype=np.uint64) % pr
    keyv[0, 0, :, 0] = pr[:, 0] - np.uint64(1)
    keyvs = (keyv << np.uint64(32)) // pr
    got = render_cmux_delta(x, keyv, kp, in_place)
    want = tpk.cmux_delta_plain(_words(x, 64), i32(keyv), i32(keyvs), kp)
    np.testing.assert_array_equal(got.view(np.int64), want.numpy())


@pytest.mark.parametrize("name,entries", [
    ("toy", "distinct"), ("toy", "repeated"), ("toy32", "distinct"),
    ("toy32", "repeated"), ("l2", "distinct"), ("l2_32", "repeated")])
def test_auto_keyswitch_rendering_matches_plain(name, entries):
    """K6's block on two ciphertexts, one with ginv 1 (a TRLWE key switch)
    and one with 2N-1 (every coefficient negated but the first), both
    switched against one keyset entry or against the first and the last,
    against auto_keyswitch_stream_plain."""
    kp = _plan(name)
    N, C, bits = kp.N, kp.C, kp.torus_bits
    rng = np.random.default_rng(N + bits + len(entries))
    x = rng.integers(0, 1 << bits, (2, C, N), dtype=np.uint64)
    G = N
    ak, ak32 = keyset(rng, G, ((C - 1) * kp.l, C, kp.P, N), kp.primes, N)
    e = int(rng.integers(0, G))
    kidx = np.array([e, e] if entries == "repeated" else [0, G - 1],
                    np.int32)
    ginv = np.array([1, 2 * N - 1], np.int32)
    got = render_auto_keyswitch(x, ak, kidx, ginv, kp)
    want = tpk.auto_keyswitch_stream_plain(
        _words(x, bits), ak32, torch.from_numpy(kidx),
        torch.from_numpy(ginv), kp)
    np.testing.assert_array_equal(_got(got, bits), want.numpy())


@pytest.mark.parametrize("name", ["toy", "toy32", "l2", "l2_32"])
def test_auto_keyswitch_rendering_on_gathered_rows_matches_k6_old_plain(
        name):
    """K6-old is K6's block with keyset entry b for row b and ginv 1: on
    two rows already permuted, each with its own gathered keyset entry
    (the rows `auto_keyswitch_rows` takes from the keyset, so the route is
    the TPU package's `auto_keyswitch` through `test_torch_ga_stepwise`),
    the rendering against auto_keyswitch_plain."""
    kp = _plan(name)
    N, C, bits = kp.N, kp.C, kp.torus_bits
    rng = np.random.default_rng(N + bits + 3)
    perm = rng.integers(0, 1 << bits, (2, C, N), dtype=np.uint64)
    key_rows, key_rows32 = keyset(rng, 2, ((C - 1) * kp.l, C, kp.P, N),
                                  kp.primes, N)
    B = perm.shape[0]
    got = render_auto_keyswitch(perm, key_rows, np.arange(B, dtype=np.int32),
                                np.ones(B, np.int32), kp)
    want = tpk.auto_keyswitch_plain(_words(perm, bits), key_rows32, kp)
    np.testing.assert_array_equal(_got(got, bits), want.numpy())


def test_auto_keyswitch_reading_x_in_place_matches_plain():
    """Where acc is left out of shared memory the block reads x in place:
    the same words, and no write of x."""
    kp = _plan("toy")
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 64, (2, kp.C, kp.N), dtype=np.uint64)
    ak, ak32 = keyset(rng, 4, (kp.l, kp.C, kp.P, kp.N), kp.primes, kp.N)
    kidx, ginv = np.array([3, 1], np.int32), np.array([7, 1], np.int32)
    got = render_auto_keyswitch(x, ak, kidx, ginv, kp, in_place=True)
    want = tpk.auto_keyswitch_stream_plain(
        _words(x, 64), ak32, torch.from_numpy(kidx), torch.from_numpy(ginv),
        kp)
    np.testing.assert_array_equal(got.view(np.int64), want.numpy())


def test_writing_the_output_into_acc_is_a_hazard():
    """K6 reads b' from acc after the barrier before Garner, which is safe
    only because its output is distinct: Garner writing acc in place (as
    K7's does) would overwrite words other threads still read."""
    kp = _plan("toy")
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 64, (1, kp.C, kp.N), dtype=np.uint64)
    ak, _ = keyset(rng, 2, (kp.l, kp.C, kp.P, kp.N), kp.primes, kp.N)
    args = (x, ak, np.array([1]), np.array([2 * kp.N - 1]), kp)
    render_auto_keyswitch(*args)
    with pytest.raises(AssertionError, match="read by one thread"):
        render_auto_keyswitch(*args, out_in_acc=True)


@pytest.mark.parametrize("name,where", [("l2", "SSS"), ("l2_32", "SSS"),
                                        ("set3", "SSI")])
def test_buffers_match_the_rendered_blocks(name, where):
    """`kernel_buffers("cmux_delta")` and `("auto_keyswitch_stream")` size
    the rendered blocks, as K3's table: one exchange row per group, C*P
    spectra rows, acc [C][N] words, 108.5 KiB at TFHEpp-L2 and 67 KiB at
    L2_32 (two and three blocks per SM); at SET_3 (4 primes) acc is left
    out and the block reads x in place."""
    kp = _plan(name)
    s = schedule(kp.N, kp.P)
    want = [s["NG"] * s["SR"] * 4, kp.C * kp.P * s["SR"] * 4,
            kp.C * kp.N * kp.torus_bits // 8]
    budget = 232448 - 1024
    kernels = ["auto_keyswitch_stream"] + (["cmux_delta"] if
                                           kp.torus_bits == 64 else [])
    for kernel in kernels:
        assert [n for n, _, _ in tpk.kernel_buffers(kernel, kp)] == want
        layout, stride = tpk.kernel_layout(kernel, kp, budget)
        assert stride == 0
        assert "".join("S" if o >= 0 else "I" for o in layout[2:]) == where
        if name != "set3":
            assert layout[0] == {"l2": 111104, "l2_32": 68608}[name]
