"""The unfolded blind rotation (K4, `mosfhet_torch/ops/csrc/unfolded_rotate.cu`)
and the external-product apply scan (K3, `csrc/ext_product_apply.cu`) on
K1's schedule, rendered in plain numpy integer arithmetic and held bit for
bit to `pbs_kernel.unfolded_rotate_plain` and
`pbs_kernel.ext_product_apply_scan_plain`.

Both renderings reuse the K1 rendering's schedule helpers
(`tests/test_torch_k1_schedule.py`: which thread owns which 16 coefficients
in each pass, the passes, lazy residues, the Barrett MAC).  K3 is K7's
replace-mode product, rendered by `render_spectra` of
`tests/test_torch_k7_schedule.py`, then Garner replacing acc.  K4 adds what
its block does on top of them: per digit row the digit spectra held and
reduced to [0, p); per key row the combine once per block, the M rotated
key products summed mod 2^64 (2^32) and each position's centred residue
written, for each thread group's prime, into that group's exchange row at
the position's top-window slot; the forward passes from those slots; the
MAC with the digit operand below p; the inverse and Garner.  Every read and
write of acc is logged per thread and checked at each block barrier.
Cases: TOY and TFHEpp-L2 widths, u64 and u32 words, u = 1, 2 and 4 with
exponents 0, N and 2N present, a combined word whose residue is p - 1, K3
broadcast and per row with a key word at p - 1, and N=8192 with 4 primes,
where the block's two thread groups take the primes in two rounds.
Nothing on the port's path calls these renderings; the kernels themselves
meet the plain versions on the card (`test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_k1_schedule import (KQ, M32, forward_row, inverse_row,
                                          lazy2, mac_product, positions,
                                          schedule, shoup_lazy, slots,
                                          u32_tables, window)
from tests.test_torch_k7_schedule import (AccLog, digits_of, garner_words,
                                          render_spectra)
from tests.test_torch_suite_env import port_test_env  # noqa: F401


def shoup(a, w, ws, p):
    r = shoup_lazy(a, np.uint64(w), np.uint64(ws), np.uint64(p))
    return np.where(r >= p, r - np.uint64(p), r)


def centred_residue(x, m, kp):
    """`centred_residue` (ntt_common.cuh) of words x (uint64 holding
    kp.torus_bits bits) mod prime m, by the kernel's Shoup products on the
    plan's constants; checked against the signed value's remainder."""
    c = kp.host_consts
    P, p = kp.P, int(kp.primes[m])
    e = c[6 + 5 * P + 2 * P * P:]
    red1, c32, c32s, c64m = (int(e[i * P + m]) for i in (1, 2, 3, 4))
    p64 = np.uint64(p)
    lo = x & M32
    t0 = shoup(lo, 1, red1, p)
    if kp.torus_bits == 32:
        neg, sub = lo >> np.uint64(31), np.uint64(c32)
        s = t0
    else:
        hi = x >> np.uint64(32)
        neg, sub = hi >> np.uint64(31), np.uint64(c64m)
        s = t0 + shoup(hi, c32, c32s, p)
        s = np.where(s >= p64, s - p64, s)
    r = np.where(neg == 1, (s + p64 - sub) % p64, s)
    bits = kp.torus_bits
    neg_x = (x >> np.uint64(bits - 1)).astype(object)
    signed = x.astype(object) - neg_x * (1 << bits)
    assert ((signed % p).astype(np.uint64) == r).all()
    return r


def render_unfolded(acc, rot, su, kp, combines=None):
    """K4's block over the G groups of each ciphertext: acc [B, C, N] words
    (uint64 holding 64 or 32 bits), rot [B, G, M], su [G, M, J, C, N] words.
    Returns the new acc; ``combines`` (a list) collects the combined words of
    every key row, when given."""
    bits, N, C, P, l = kp.torus_bits, kp.N, kp.C, kp.P, kp.l
    J = C * l
    mask = np.uint64((1 << bits) - 1) if bits == 32 else np.uint64(2**64 - 1)
    s = schedule(N, P)
    NG, T = s["NG"], s["T"]
    threads = NG * T
    rounds = -(-P // NG)
    top, slot0 = positions(s, window(s, s["np"] - 1)), slots(s, 0)
    top_slots = slots(s, window(s, s["np"] - 1))
    t_of = np.arange(T)[:, None]
    k_all = np.arange(N)
    out = np.empty_like(acc)
    for b in range(acc.shape[0]):
        log, a = AccLog(C * N), acc[b].copy()
        for gi in range(su.shape[0]):
            work = np.zeros((NG, s["SR"]), np.uint64)
            spec = np.zeros((C, P, s["SR"]), np.uint64)
            for r in range(rounds):
                live = [g for g in range(NG) if g + r * NG < P]
                for j in range(J):
                    cj, d = divmod(j, l)
                    xd = {}
                    for g in live:
                        pi = g + r * NG
                        p = kp.primes[pi]
                        tw, tws, _, _ = u32_tables(kp.ntt, pi)
                        log.read(cj * N + top, g * T + t_of)
                        dig = digits_of(a[cj][top], d, kp, bits)
                        x = np.where(dig < 0, dig + p, dig).astype(np.uint64)
                        forward_row(x, s, work[g], tw, tws, p)
                        y = lazy2(x, np.uint64(2 * p))
                        xd[g] = np.minimum(y, (y - np.uint64(p)) & M32)
                        assert (xd[g] < p).all()
                    for c in range(C):
                        # the combine, between two block barriers: thread
                        # idx takes positions idx, idx + threads, ...
                        log.barrier()
                        x = np.zeros(N, np.uint64)
                        for m in range(su.shape[1]):
                            e = (k_all - int(rot[b, gi, m])) & (2 * N - 1)
                            v = su[gi, m, j, c][e & (N - 1)]
                            x = (x + np.where(e & N, (np.uint64(0) - v) & mask,
                                              v)) & mask
                        if combines is not None:
                            combines.append(x)
                        slot = k_all + (k_all >> KQ) if s["pad"] else k_all
                        assert sorted(slot) == sorted(top_slots.ravel())
                        for h in range(NG):
                            if h + r * NG < P:
                                work[h][slot] = centred_residue(x, h + r * NG,
                                                                kp)
                        log.barrier()
                        for g in live:
                            pi = g + r * NG
                            p = kp.primes[pi]
                            tw, tws, _, _ = u32_tables(kp.ntt, pi)
                            xk = work[g][top_slots].copy()
                            forward_row(xk, s, work[g], tw, tws, p)
                            mac = mac_product(xk, xd[g], p)
                            sl = spec[c, pi]
                            sl[slot0] = mac if j == 0 else lazy2(
                                (sl[slot0] + mac) & M32, np.uint64(2 * p))
                for g in live:
                    pi = g + r * NG
                    p = kp.primes[pi]
                    _, _, itw, itws = u32_tables(kp.ntt, pi)
                    for c in range(C):
                        y = spec[c, pi][slot0].copy()
                        inverse_row(y, s, work[g], itw, itws, p)
                        spec[c, pi][top] = y
            # Garner replacing acc, between two block barriers
            log.barrier()
            a = garner_words(spec, kp) & mask
            idx = np.arange(C * N)
            log.write(idx, idx % threads)
            log.barrier()
        out[b] = a
    return out


def render_apply(acc, sa, kp, per_row):
    """K3's block: G replace-mode products, each `render_spectra` (K7's
    stage 1) reading its digits from acc, then Garner replacing acc."""
    bits, N, C, P = kp.torus_bits, kp.N, kp.C, kp.P
    mask = np.uint64((1 << bits) - 1) if bits == 32 else np.uint64(2**64 - 1)
    s = schedule(N, P)
    threads = s["NG"] * s["T"]
    t_of = np.arange(s["T"])[:, None]
    out = np.empty_like(acc)
    for b in range(acc.shape[0]):
        log, a = AccLog(C * N), acc[b].copy()
        for g in range(sa.shape[0]):
            def read_acc(c, k, tid):
                log.read(c * N + k, tid + t_of)
                return a[c][k]
            spec = render_spectra(read_acc, kp.J, sa[g, b] if per_row
                                  else sa[g], kp, s, P)
            log.barrier()
            a = garner_words(spec, kp) & mask
            idx = np.arange(C * N)
            log.write(idx, idx % threads)
            log.barrier()
        out[b] = a
    return out


# (N, l, Bg_bit, torus bits)
WIDTHS = {"toy": (64, 4, 9, 64), "l2": (2048, 4, 9, 64),
          "toy32": (64, 3, 7, 32), "l2_32": (2048, 3, 7, 32),
          "n8192": (8192, 1, 22, 64)}


def _plan(name):
    N, l, Bg_bit, bits = WIDTHS[name]
    primes = ntt.MASTER_PRIMES[-2:] if bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, 1))
    return tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cpu", bits)


def _words(x, bits):
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)
                            if bits == 32 else x.view(np.int64))


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("name,u,G,B", [
    ("toy", 1, 2, 2), ("toy", 2, 2, 2), ("toy", 4, 2, 2),
    ("toy32", 1, 2, 2), ("toy32", 4, 2, 2),
    ("l2", 4, 2, 1), ("l2_32", 4, 2, 1), ("n8192", 1, 1, 1)])
def test_unfolded_rendering_matches_unfolded_rotate_plain(name, u, G, B):
    """K4's block over G groups, exponents 0, N and 2N present and one key
    row whose combined words are all +-(2^bits - 1) (residues p - 1 and 1),
    against unfolded_rotate_plain."""
    kp = _plan(name)
    N, C, J, bits, M = kp.N, kp.C, kp.J, kp.torus_bits, 1 << u
    if name == "n8192":       # two thread groups, four primes: two rounds
        s = schedule(N, kp.P)
        assert (kp.P, s["NG"]) == (4, 2)
    rng = np.random.default_rng(N + 7 * u + bits)
    acc = rng.integers(0, 1 << bits, (B, C, N), dtype=np.uint64)
    su = rng.integers(0, 1 << bits, (G, M, J, C, N), dtype=np.uint64)
    su[0, :, 0, 0] = 0
    su[0, 0, 0, 0] = (1 << bits) - 1
    rot = rng.integers(0, 2 * N + 1, (B, G, M), dtype=np.int32)
    rot[0, 0, 0], rot[-1, -1, -1], rot[0, -1, M // 2] = 0, 2 * N, N
    combines = []
    got = render_unfolded(acc, rot, su, kp, combines)
    assert ((combines[0] == np.uint64((1 << bits) - 1))
            | (combines[0] == 1)).all()
    want = tpk.unfolded_rotate_plain(_words(acc, bits), torch.from_numpy(rot),
                                     _words(su, bits), kp)
    np.testing.assert_array_equal(
        got.astype(np.uint32).view(np.int32) if bits == 32
        else got.view(np.int64), want.numpy())


@pytest.mark.parametrize("name,G,B", [
    ("toy", 3, 2), ("toy32", 3, 2), ("l2", 2, 1), ("l2_32", 2, 1),
    ("n8192", 1, 1)])
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_apply_rendering_matches_ext_product_apply_scan_plain(name, G, B,
                                                              per_row):
    """K3's block over G products, broadcast or one key per row, a key word
    at p - 1 of every prime, against ext_product_apply_scan_plain."""
    kp = _plan(name)
    N, C, J, P, bits = kp.N, kp.C, kp.J, kp.P, kp.torus_bits
    rng = np.random.default_rng(N + 3 * G + bits + per_row)
    acc = rng.integers(0, 1 << bits, (B, C, N), dtype=np.uint64)
    rows = (G, B) if per_row else (G,)
    pr = np.array(kp.primes, np.uint64)[:, None]
    sa = rng.integers(0, 1 << 62, rows + (J, C, P, N), dtype=np.uint64) % pr
    sa[(0,) * len(rows) + (0, 0, slice(None), 0)] = pr[:, 0] - np.uint64(1)
    got = render_apply(acc, sa, kp, per_row)
    want = tpk.ext_product_apply_scan_plain(_words(acc, bits), _i32(sa), kp,
                                            per_row)
    np.testing.assert_array_equal(
        got.astype(np.uint32).view(np.int32) if bits == 32
        else got.view(np.int64), want.numpy())


@pytest.mark.parametrize("name,B", [("toy", 2), ("toy32", 2), ("l2", 1),
                                    ("l2_32", 1)])
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_apply_rendering_at_one_product_matches_the_step_plain(name, B,
                                                               per_row):
    """K3-step is K3's block at G = 1: the rendering of one product,
    broadcast [J, C, P, N] or one key per row [B, J, C, P, N], a key word
    at p - 1 of every prime, against ext_product_apply_step_plain (acc
    replaced in place)."""
    kp = _plan(name)
    N, C, J, P, bits = kp.N, kp.C, kp.J, kp.P, kp.torus_bits
    rng = np.random.default_rng(N + 5 * B + bits + per_row)
    acc = rng.integers(0, 1 << bits, (B, C, N), dtype=np.uint64)
    rows = (B,) if per_row else ()
    pr = np.array(kp.primes, np.uint64)[:, None]
    key = rng.integers(0, 1 << 62, rows + (J, C, P, N), dtype=np.uint64) % pr
    key[(0,) * len(rows) + (0, 0, slice(None), 0)] = pr[:, 0] - np.uint64(1)
    got = render_apply(acc, key[None], kp, per_row)
    words = _words(acc, bits)
    want = tpk.ext_product_apply_step_plain(words, _i32(key), kp, per_row)
    assert want is words
    np.testing.assert_array_equal(
        got.astype(np.uint32).view(np.int32) if bits == 32
        else got.view(np.int64), want.numpy())


@pytest.mark.parametrize("name", ["l2", "l2_32", "toy", "n8192"])
def test_rendered_buffers_match_the_placement_tables(name):
    """`kernel_buffers` sizes the rendered blocks: K4's M exponents, one
    exchange row per thread group, C*P spectra rows and acc [C][N] words;
    K3's the same without the exponents.  K3-step launches K3's kernel at
    G = 1 and has no table of its own."""
    kp = _plan(name)
    s = schedule(kp.N, kp.P)
    work, spec = s["NG"] * s["SR"] * 4, kp.C * kp.P * s["SR"] * 4
    words = kp.C * kp.N * kp.torus_bits // 8
    M = 16
    assert [n for n, _, _ in tpk.kernel_buffers("unfolded_rotate", kp, M)] \
        == [M * 4, work, spec, words]
    assert [n for n, _, _ in tpk.kernel_buffers("ext_product_apply", kp)] \
        == [work, spec, words]
    with pytest.raises(ValueError, match="no buffer table"):
        tpk.kernel_buffers("ext_product_apply_step", kp)


def test_combine_writes_every_top_window_slot_once():
    """The combine's positions k, written at slot k + k / 16 (N >= 256) or
    k, are exactly the slots the forward passes start from, one per
    thread coefficient, at L2 and TOY widths."""
    for N, P in ((2048, 3), (2048, 2), (64, 3), (4096, 4)):
        s = schedule(N, P)
        k = np.arange(N)
        slot = k + (k >> KQ) if s["pad"] else k
        top_pos = positions(s, window(s, s["np"] - 1))
        top_slots = slots(s, window(s, s["np"] - 1))
        assert (slot[top_pos] == top_slots).all()
        assert len(np.unique(top_slots)) == N
