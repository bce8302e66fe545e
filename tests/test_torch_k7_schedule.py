"""The GA blind-rotate kernel's step (K7, `mosfhet_torch/ops/csrc/ga_scan.cu`)
on K1's schedule, rendered in plain numpy integer arithmetic and held bit
for bit to `pbs_kernel.ga_scan_fused_plain`.

The rendering reuses the K1 rendering's schedule helpers
(`tests/test_torch_k1_schedule.py`: which thread owns which 16
coefficients in each pass, the passes, lazy residues, the Barrett MAC) and
adds what K7's step does on top of them: the block's groups sized by the
larger of the two plans' prime counts (a group with no prime of a plan idle,
or, below a warp per group, running the same passes without loads or stores),
the replace-mode external product read straight from acc, the Galois
permutation read through ginv by the key switch's digits, and the two
Garner phases.  Every read and write of acc is logged per thread and
checked at each block barrier: no word is written by one thread and read or
written by another between two barriers.  That is the rule of the key
switch's b' = psi_g(t)[C-1], which each thread reads into registers before
the barrier that precedes the Garner that overwrites acc.  Cases: TOY and
TFHEpp-L2 widths, two ciphertexts, u64 and u32 words, one and two steps,
generators 1 and 2N-1 present, and key-switch plans with more or fewer
primes than the bootstrap plan.  Nothing on the port's path calls this
rendering; the kernel itself meets the plain version on the card
(`test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.bootstrap_ga import inverse_mod_2n_table
from mosfhet_torch.ops import pbs_kernel as tpk
from mosfhet_torch.torus import gadget_offset
from tests.test_torch_k1_schedule import (KR, M32, forward_row, inverse_row,
                                          lazy2, mac_product, positions,
                                          schedule, shoup_lazy, slots,
                                          u32_tables, window)


class AccLog:
    """The block's reads and writes of acc [C][N] between two block
    barriers, by thread; `barrier` checks them and starts the next span."""

    def __init__(self, size):
        self.size, self.reads, self.writes = size, [], []

    def read(self, idx, tid):
        self.reads.append(np.broadcast_arrays(idx, tid))

    def write(self, idx, tid):
        self.writes.append(np.broadcast_arrays(idx, tid))

    def barrier(self):
        owner = np.full(self.size, -1)
        if self.writes:
            w_idx = np.concatenate([i.ravel() for i, _ in self.writes])
            w_tid = np.concatenate([t.ravel() for _, t in self.writes])
            assert len(np.unique(w_idx)) == len(w_idx), "a word written twice"
            owner[w_idx] = w_tid
        for idx, tid in self.reads:
            o = owner[idx]
            assert ((o == -1) | (o == tid)).all(), \
                "a word read by one thread and written by another between " \
                "two barriers"
        self.reads, self.writes = [], []


def digits_of(words, d, kp, bits):
    """Signed digit d of words (uint64 holding `bits` bits) plus the plan's
    gadget offset, as residues mod each prime later: int64."""
    offset = np.uint64(gadget_offset(kp.Bg_bit, kp.l, True, bits))
    w = words + offset
    if bits == 32:
        w &= M32
    shift = np.uint64(bits - (d + 1) * kp.Bg_bit)
    return ((w >> shift) & np.uint64((1 << kp.Bg_bit) - 1)).astype(
        np.int64) - (1 << (kp.Bg_bit - 1))


def render_spectra(word, R, key, kp, s, PM):
    """`product_spectra` for one block: per group g and prime pi of plan kp
    (g, g + NG, ...; below a warp per group a group with no prime runs the
    passes on prime 0 without loads or stores), the R digit rows of
    word(c, positions) [T, 16] through the forward NTT, the MAC against
    key [R][C][P][N] into the threads' window-0 slots, the inverse to
    natural order.  Returns the spectra [C][PM][SR]; word() logs its reads."""
    N, C, P, bits = kp.N, kp.C, kp.P, kp.torus_bits
    top, w0, slot0 = positions(s, window(s, s["np"] - 1)), positions(s, 0), \
        slots(s, 0)
    spec = np.zeros((C, PM, s["SR"]), np.uint64)
    rows = []
    for g in range(s["NG"]):
        tid = g * s["T"]
        done, pi = 0, g
        while pi < P or (s["T"] < 32 and pi == g):
            live = pi < P
            pr = pi if live else 0
            p = kp.primes[pr]
            tw, tws, itw, itws = u32_tables(kp.ntt, pr)
            buf = np.zeros(s["SR"], np.uint64)
            for j in range(R):
                cj, d = divmod(j, kp.l)
                dig = digits_of(word(cj, top, tid), d, kp, bits)
                x = np.where(dig < 0, dig + p, dig).astype(np.uint64)
                forward_row(x, s, buf, tw, tws, p)
                done += 1
                if not live:
                    continue
                for c in range(C):
                    mac = mac_product(x, key[j, c, pi][w0], p)
                    sl = spec[c, pi]
                    sl[slot0] = mac if j == 0 else lazy2(
                        (sl[slot0] + mac) & M32, np.uint64(2 * p))
            for c in range(C):
                y = spec[c, pr][slot0].copy()
                inverse_row(y, s, buf, itw, itws, p)
                done += 1
                if live:
                    spec[c, pi][top] = y
            pi += s["NG"]
        rows.append(done)
    if s["T"] < 32:
        # every exchange is a block barrier: every group runs as many rows
        assert s["NG"] == PM and len(set(rows)) == 1
    return spec


def garner_words(spec, kp):
    """`garner_rows` of every (c, k): the exact words mod 2^64 as uint64
    (the first Shoup product by 1/N ends canonical)."""
    C, N, plan = kp.C, kp.N, kp.ntt
    r = torch.zeros((C, kp.P, N), dtype=torch.int64)
    for pi, p in enumerate(kp.primes):
        v = shoup_lazy(spec[:, pi, :N], np.uint64(int(plan.n_inv[pi])),
                       np.uint64(int(plan.n_inv_shoup[pi])), np.uint64(p))
        r[:, pi] = torch.from_numpy(np.where(v >= p, v - p, v)
                                    .astype(np.int64))
    return ntt.garner_u64(r, plan).numpy().view(np.uint64)


def permuted(row, k, ginv, N, mask):
    """psi_g(row)[k] = +-row[(k ginv mod 2N) mod N] and the index read."""
    ic = (k * ginv) & (2 * N - 1)
    v = row[ic & (N - 1)]
    return np.where(ic & N, (np.uint64(0) - v) & mask, v), ic & (N - 1)


def render_ga_step(acc, gen, sv, ak, inv2n, kp, kp_ks, b_after=False):
    """One GA step of each ciphertext as K7's block runs it: acc [B, C, N]
    words (uint64 holding 64 or 32 bits), gen [B], sv [J, C, P, N] and ak
    [G, kt, C, PK, N] u32 residues.  b_after: read b' after the barrier
    that precedes the key switch's Garner (the hazard the kernel avoids).
    Returns the new acc."""
    bits, N, C = kp.torus_bits, kp.N, kp.C
    mask = np.uint64((1 << bits) - 1) if bits == 32 else np.uint64(2**64 - 1)
    PM = max(kp.P, kp_ks.P)
    s = schedule(N, PM)
    threads = s["NG"] * s["T"]
    keep = -(-N // threads)            # Garner positions per thread
    assert keep <= KR
    if N == 2048 and PM <= 3:          # the compile-time 384-thread shape
        assert keep == -(-KR // PM)
    t_of = np.arange(s["T"])[:, None]
    out = np.empty_like(acc)
    for b in range(acc.shape[0]):
        log = AccLog(C * N)
        kidx = (int(gen[b]) - 1) >> 1
        ginv = int(inv2n[kidx])

        # 1. t = BK (x) acc: digits straight from acc, Garner replaces acc
        def read_acc(c, k, tid):
            log.read(c * N + k, tid + t_of)
            return acc[b, c][k]
        spec = render_spectra(read_acc, C * kp.l, sv, kp, s, PM)
        log.barrier()
        t_words = garner_words(spec, kp) & mask
        idx = np.arange(C * N)
        log.write(idx, idx % threads)
        log.barrier()

        # 2-3. the key switch's digits read psi_g(t) through ginv
        def read_perm(c, k, tid):
            v, i = permuted(t_words[c], k, ginv, N, mask)
            log.read(c * N + i, tid + t_of)
            return v
        spec = render_spectra(read_perm, (C - 1) * kp_ks.l, ak[kidx], kp_ks,
                              s, PM)
        tid = np.arange(threads)[:, None]
        k = tid + np.arange(keep)[None, :] * threads     # [threads, keep]
        mine = k < N
        bp, i = permuted(t_words[C - 1], k[mine], ginv, N, mask)
        if not b_after:
            log.read((C - 1) * N + i, np.broadcast_to(tid, k.shape)[mine])
        log.barrier()
        if b_after:
            log.read((C - 1) * N + i, np.broadcast_to(tid, k.shape)[mine])
        w = garner_words(spec, kp_ks)
        new = (np.uint64(0) - w) & mask
        new[C - 1, k[mine]] = (bp - w[C - 1, k[mine]]) & mask
        for c in range(C):
            log.write(c * N + k[mine], np.broadcast_to(tid, k.shape)[mine])
        log.barrier()
        out[b] = new
    return out


def i32(x):
    """u32 values -> an int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.uint32)
                            .view(np.int32))


def keyset(rng, G, shape, primes, N):
    """[G, *shape] canonical residues, as a numpy array and an int32
    tensor.  Beyond TOY a whole keyset (G = N entries) would take hundreds
    of MB: there entry e is the window of one random array starting 16 e
    words in (residues below every prime), so every entry still differs."""
    if N <= 256:
        pr = np.array(primes, np.uint64)[None, None, None, :, None]
        ak = rng.integers(0, 1 << 62, (G, *shape), dtype=np.uint64) % pr
        return ak, i32(ak)
    size = int(np.prod(shape))
    flat = rng.integers(0, min(primes), size + 16 * G, dtype=np.uint64)
    strides = [16] + [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    ak = np.lib.stride_tricks.as_strided(flat, (G, *shape),
                                         [8 * st for st in strides])
    return ak, torch.as_strided(i32(flat), (G, *shape), strides)


# (N, l, Bg_bit, t, base_bit, P, PK, torus bits); P, PK None: the bound's
CASES = {
    "toy": (64, 4, 9, 4, 9, None, None, 64),
    "l2": (2048, 4, 9, 4, 9, None, None, 64),       # TFHEpp-L2's GA
    "toy32": (64, 3, 7, 3, 7, 2, 2, 32),
    "l2_32": (2048, 3, 7, 3, 7, 2, 2, 32),          # L2_32's GA
    "toy_pk4": (64, 4, 9, 4, 9, 3, 4, 64),          # KS with more primes
    "toy_p4": (64, 4, 9, 4, 9, 4, 3, 64),           # KS with fewer
    "toy32_pk3": (64, 3, 7, 3, 7, 2, 3, 32),
    "l2_pk4": (2048, 4, 9, 4, 9, 3, 4, 64),
}


def _primes(N, Bg_bit, l, count, bits):
    if count is not None:
        return ntt.MASTER_PRIMES[-count:]
    assert bits == 64
    return ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, 1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ga_step_rendering_matches_ga_scan_plain(name):
    """Two GA steps of two ciphertexts (generators 1 and 2N-1 in the first,
    2N-1 and a random one in the second) through the rendered block, against
    ga_scan_fused_plain over one and two steps."""
    N, l, Bg_bit, t, base_bit, P, PK, bits = CASES[name]
    k, C, n, B = 1, 2, 2, 2
    kp = tpk.get_kernel_plan(N, _primes(N, Bg_bit, l, P, bits), l, Bg_bit,
                             k, "cpu", bits)
    kp_ks = tpk.get_kernel_plan(N, _primes(N, base_bit, t, PK, bits), t,
                                base_bit, k, "cpu", bits)
    rng = np.random.default_rng(N + 7 * bits + len(name))
    acc0 = rng.integers(0, 1 << bits, (B, C, N), dtype=np.uint64)
    pr = np.array(kp.primes, np.uint64)[:, None]
    sv = rng.integers(0, 1 << 62, (n, kp.J, C, kp.P, N), dtype=np.uint64) % pr
    ak, ak32 = keyset(rng, N, (k * t, C, kp_ks.P, N), kp_ks.primes, N)
    gens = np.array([[1, 2 * N - 1],
                     [2 * N - 1, 2 * int(rng.integers(1, N - 1)) + 1]],
                    np.int32)
    inv2n = inverse_mod_2n_table(N)

    def words(x):
        return torch.from_numpy(x.astype(np.uint32).view(np.int32)
                                if bits == 32 else x.view(np.int64))

    got = acc0
    for steps in (1, 2):
        got = render_ga_step(got, gens[steps - 1], sv[steps - 1], ak, inv2n,
                             kp, kp_ks)
        want = tpk.ga_scan_fused_plain(
            words(acc0), torch.from_numpy(gens[:steps]), i32(sv[:steps]),
            torch.zeros(1), ak32, torch.from_numpy(inv2n), kp, kp_ks)
        np.testing.assert_array_equal(
            got.astype(np.uint32).view(np.int32) if bits == 32
            else got.view(np.int64), want.numpy())


def test_reading_b_after_the_barrier_is_a_hazard():
    """The log catches the hazard the kernel designs around: b' read after
    the barrier, while other threads overwrite acc with the new words."""
    N, l, Bg_bit = 64, 4, 9
    kp = tpk.get_kernel_plan(N, _primes(N, Bg_bit, l, None, 64), l, Bg_bit,
                             1, "cpu", 64)
    rng = np.random.default_rng(3)
    acc = rng.integers(0, 1 << 64, (1, 2, N), dtype=np.uint64)
    pr = np.array(kp.primes, np.uint64)[:, None]
    sv = rng.integers(0, 1 << 62, (kp.J, 2, kp.P, N), dtype=np.uint64) % pr
    ak, _ = keyset(rng, N, (l, 2, kp.P, N), kp.primes, N)
    args = (acc, np.array([5]), sv, ak, inverse_mod_2n_table(N), kp, kp)
    render_ga_step(*args)
    with pytest.raises(AssertionError, match="read by one thread"):
        render_ga_step(*args, b_after=True)


@pytest.mark.parametrize("N,l,Bg_bit,bits,P,PK", [
    (2048, 4, 9, 64, 3, 3), (2048, 3, 7, 32, 2, 2), (4096, 1, 22, 64, 4, 4),
    (2048, 4, 9, 64, 3, 4)], ids=["l2", "l2_32", "set3", "l2_pk4"])
def test_ga_buffers_match_the_rendered_block(N, l, Bg_bit, bits, P, PK):
    """`kernel_buffers("ga_scan")` sizes the rendered block: one exchange
    row per group of the larger plan's schedule, C*PM spectra rows, acc
    [C][N] words."""
    kp = tpk.get_kernel_plan(N, ntt.MASTER_PRIMES[-P:], l, Bg_bit, 1, "cpu",
                             bits)
    s = schedule(N, max(P, PK))
    (work, _, _), (spec, _, _), (acc, _, _) = tpk.kernel_buffers(
        "ga_scan", kp, P_ks=PK)
    assert (work, spec, acc) == (s["NG"] * s["SR"] * 4,
                                 kp.C * max(P, PK) * s["SR"] * 4,
                                 kp.C * N * bits // 8)
