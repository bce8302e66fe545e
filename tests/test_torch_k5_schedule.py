"""UBR phase 1 (K5, `mosfhet_torch/ops/csrc/ubr_phase1.cu`) rendered in plain
numpy integer arithmetic and held bit for bit to
`pbs_kernel.ubr_phase1_combine_plain`.

The rendering follows the kernel's block: one block per key row (g, j, c)
and tile of ciphertexts (`pbs_kernel.ubr_phase1_tiling`), the row's M key
products staged through a ring of S whole rows (`ubr_phase1_schedule`: the
stage that row m - 1 used refilled with row m - 1 + S before row m is read,
and checked to hold row m when it is), group i of N/16 threads combining
ciphertext i's rotated words into each thread's 16 positions t + T v of
the top window (`add_rotated`: for X^a, a = hi N + rr, the positions below
rr read from one base and the rest from another, each run with its own
sign; every index checked inside the row), then per prime the centred
residues, the forward passes through the group's exchange row (which
reuses the ring), the reduction to [0, p) and the thread's 16 window-0
outputs written by four 16-byte stores; a group past B (the last tile's)
combines the last ciphertext's words and stores nothing.  It
reuses the K1 rendering's schedule helpers (`tests/test_torch_k1_schedule.py`)
and the K4 rendering's centred residue (`tests/test_torch_k4_schedule.py`),
as the kernel reuses K4's helpers.  Every output word is written exactly
once.  Cases: TOY and TFHEpp-L2 widths with G cut, u64 and u32 words, u = 1,
2, 4 and 8, B = 1, a tile less one, a full tile and a tile plus one (a
tile is 8 ciphertexts with u64 words and 2 with u32 words), with
exponents 0, N and 2N present and one key row whose combined words are
all +-(2^bits - 1) (residues p - 1 and 1).  Nothing on the port's path
calls this rendering; the kernel itself meets the plain version on the
card (`test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_k1_schedule import (KQ, KR, M32, forward_row, lazy2,
                                          positions, schedule, u32_tables,
                                          window)
from tests.test_torch_k4_schedule import _plan, _words, centred_residue
from tests.test_torch_suite_env import port_test_env  # noqa: F401

# An H100's dynamic shared memory per block: the opt-in 232,448 B less the
# kernels' static allowance (kStaticSmem, ntt_common.cuh)
H100_BUDGET = 232448 - 1024


def canonical4(x, p):
    """`canonical4` (rotate_sched.cuh): [0, 4p) -> [0, p)."""
    y = lazy2(x, np.uint64(2 * p))
    return np.minimum(y, (y - np.uint64(p)) & M32)


def render_phase1(su, rot, kp, budget=H100_BUDGET):
    """K5's launch: su [G, M, J, C, N] words (uint64 holding kp.torus_bits
    bits), rot [B, G, M].  Returns out [B, G, J, C, P, N] u32 residues and
    the schedule."""
    bits, N, P = kp.torus_bits, kp.N, kp.P
    G, M, J, C = su.shape[:4]
    B = rot.shape[0]
    mask = np.uint64((1 << bits) - 1) if bits == 32 else np.uint64(2**64 - 1)
    sc = tpk.ubr_phase1_schedule(kp, B, M, budget)
    TB, tiles, S = sc["tile"], sc["tiles"], sc["stages"]
    s = schedule(N, TB)
    T = s["T"]
    assert s["NG"] == TB and sc["threads"] == TB * T <= 1024
    # the exchange rows fit the ring they reuse
    assert TB * s["SR"] * 4 <= int(sc["layout"][3]) - int(sc["layout"][2])
    top = positions(s, window(s, s["np"] - 1))
    t_of = np.arange(T)[:, None]
    v_of = np.arange(KR)[None, :]
    # thread t owns positions t + T v at the top window; window 0 holds
    # positions 16 t .. 16 t + 15
    assert (top == t_of + T * v_of).all()
    assert (positions(s, 0) == np.arange(N).reshape(T, KR)).all()
    out = np.full((B, G, J, C, P, N), -1, np.int64)
    flat = out.reshape(-1)
    writes = np.zeros(flat.size, np.int64)
    for blk in range(G * J * C * tiles):
        row, tile = divmod(blk, tiles)
        g, jc = divmod(row, J * C)
        j, c = divmod(jc, C)
        rows = su[g, :, j, c]                                     # [M, N]
        ring = np.zeros((S, N), np.uint64)
        landed = [-1] * S       # the row a stage's TMA copy brought

        def copy(m):            # thread 0's TMA copy of row m
            ring[m % S], landed[m % S] = rows[m], m

        for m in range(min(S, M)):
            copy(m)
        x = np.zeros((TB, T, KR), np.uint64)
        groups = [tile * TB + i for i in range(TB)]
        rb = [min(b, B - 1) for b in groups]
        for m in range(M):
            # thread 0 refills the stage row m - 1 used (every warp has
            # read it) before row m is read; the stage read holds row m
            if m >= 1 and m - 1 + S < M:
                assert S == 1 or (m - 1) % S != m % S
                copy(m - 1 + S)
            stage = ring[m % S]
            assert landed[m % S] == m
            for i in range(TB):
                # `add_rotated`: a = hi N + rr; vs positions below rr read
                # from base t - rr + N, the rest from t - rr, each run's
                # sign fixed
                r = int(rot[rb[i], g, m])
                hi = r >= N
                rr = r - N if hi else r
                # K of the warp's last thread (below a warp per group, each
                # thread's own); position K below rr or not per thread
                t_last = t_of | 31 if T >= 32 else t_of
                k = np.where(rr > t_last, (rr - t_last + T - 1) // T, 0)
                assert ((k >= 0) & (k <= KR)).all()
                if T >= 32:     # one K per warp: the switch does not diverge
                    assert (k.reshape(-1, 32) == k.reshape(-1, 32)[:, :1]
                            ).all()
                below_k = t_of + T * k < rr
                below = (v_of < k) | ((v_of == k) & below_k)
                assert (below == (t_of + T * v_of < rr)).all()
                idx = np.where(below, t_of - rr + N, t_of - rr) + T * v_of
                assert ((idx >= 0) & (idx < N)).all()
                w = stage[idx]
                neg = below != hi
                x[i] = (x[i] + np.where(neg, (np.uint64(0) - w) & mask, w)
                        ) & mask
        work = np.zeros((TB, s["SR"]), np.uint64)
        for i, b in enumerate(groups):
            for pi in range(P):
                p = kp.primes[pi]
                tw, tws, _, _ = u32_tables(kp.ntt, pi)
                y = centred_residue(x[i], pi, kp)
                forward_row(y, s, work[i], tw, tws, p)
                y = canonical4(y, p)
                assert (y < p).all()
                if b >= B:
                    continue
                # four 16-byte stores per thread, each 16-byte aligned
                base = ((((b * G + g) * J + j) * C + c) * P + pi) * N
                idx = base + (t_of << KQ) + np.arange(KR)[None, :]
                assert (idx[:, ::4] * 4 % 16 == 0).all()
                flat[idx] = y.astype(np.int64)
                writes[idx] += 1
    assert (writes == 1).all(), "an output word written other than once"
    return out.astype(np.uint32), sc


CASES = [  # (width, u, G, B)
    ("toy", 1, 1, 1), ("toy", 2, 1, 7), ("toy", 4, 2, 1), ("toy", 8, 1, 2),
    ("toy32", 1, 1, 9), ("toy32", 2, 1, 2), ("toy32", 4, 1, 3),
    ("toy32", 8, 1, 1), ("l2", 8, 1, 1), ("l2_32", 4, 1, 1)]


@pytest.mark.parametrize("name,u,G,B", CASES,
                         ids=[f"{n}-u{u}-G{G}-B{B}" for n, u, G, B in CASES])
def test_phase1_rendering_matches_ubr_phase1_combine_plain(name, u, G, B):
    """K5's blocks over every key row and tile, exponents 0, N and 2N
    present and one key row whose combined words are all +-(2^bits - 1),
    against ubr_phase1_combine_plain."""
    kp = _plan(name)
    N, C, J, bits, M = kp.N, kp.C, kp.J, kp.torus_bits, 1 << u
    rng = np.random.default_rng(N + 11 * u + 3 * B + bits)
    su = rng.integers(0, 1 << bits, (G, M, J, C, N), dtype=np.uint64)
    su[0, :, 0, 0] = 0
    su[0, 0, 0, 0] = (1 << bits) - 1
    rot = rng.integers(0, 2 * N + 1, (B, G, M), dtype=np.int32)
    rot[0, 0, 0], rot[-1, -1, -1], rot[0, -1, M // 2] = 0, 2 * N, N
    got, _ = render_phase1(su, rot, kp)
    want = tpk.ubr_phase1_combine_plain(_words(su, bits),
                                        torch.from_numpy(rot), kp)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.view(np.int32), want.numpy())
    # the row of +-(2^bits - 1): every residue p - 1 or 1 before the NTT
    words = np.zeros(N, np.uint64)
    mask = (1 << bits) - 1
    for m in range(M):
        k = np.arange(N)
        e = (k - int(rot[0, 0, m])) & (2 * N - 1)
        v = su[0, m, 0, 0][e & (N - 1)].astype(object)
        words = (words.astype(object) + np.where(e & N, -v, v)) & mask
    assert set(words.tolist()) <= {1, mask}
    res = centred_residue(words.astype(np.uint64), 0, kp)
    assert set(res.tolist()) <= {1, kp.primes[0] - 1}


@pytest.mark.parametrize("bits,B,tile,tiles", [
    (64, 1, 1, 1), (64, 7, 7, 1), (64, 8, 8, 1), (64, 9, 5, 2),
    (64, 17, 6, 3), (64, 64, 8, 8), (64, 0, 1, 0), (32, 1, 1, 1),
    (32, 2, 2, 1), (32, 3, 2, 2), (32, 9, 2, 5), (32, 64, 2, 32),
    (32, 0, 1, 0)])
def test_tiling_spreads_the_batch_over_the_fewest_tiles(bits, B, tile,
                                                        tiles):
    """At N = 2048 (128 threads per ciphertext) a block takes at most 8
    ciphertexts with u64 words and 2 with u32 words; a batch takes the
    fewest tiles that allows, its ciphertexts spread evenly over them."""
    sc = tpk.ubr_phase1_tiling(B, 2048, bits)
    assert (sc["tile"], sc["tiles"], sc["threads"]) == (tile, tiles,
                                                       128 * tile)
    assert tile * tiles >= B and (tiles == 0 or (tile - 1) * tiles < B)


@pytest.mark.parametrize("bits,N,tile", [
    (64, 64, 8), (64, 2048, 8), (64, 4096, 4), (64, 8192, 2), (64, 16384, 1),
    (32, 2048, 2), (32, 16384, 1)])
def test_tiling_keeps_a_block_within_1024_threads(bits, N, tile):
    assert tpk.ubr_phase1_tiling(64, N, bits)["tile"] == tile


@pytest.mark.parametrize("name,N,P,bits,B,M,stages,smem", [
    ("l2 u=8, B=64", 2048, 3, 64, 64, 256, 4, 77824),
    ("l2 u=8, B=1", 2048, 3, 64, 1, 256, 4, 66560),
    ("l2_32 u=4, B=64", 2048, 2, 32, 64, 16, 4, 32896),
    ("set_3 widths, B=64", 4096, 4, 64, 64, 4, 4, 131136),
    ("N=8192, B=64", 8192, 4, 64, 64, 4, 2, 131104),
    ("N=16384, 4 primes", 16384, 4, 64, 1, 4, 1, 131088)])
def test_schedule_fills_the_ring_within_the_budget(name, N, P, bits, B, M,
                                                   stages, smem):
    """The ring takes as many key rows as fit of 4, 2 or 1, beside the
    tile's exponents (the tile's exchange rows reuse it); N = 16384 with
    u64 words fits one row, whatever the prime count (the primes share the
    exchange rows)."""
    primes = ntt.MASTER_PRIMES[-P:]
    kp = tpk.get_kernel_plan(N, primes, 1, 22 if N > 2048 else 9, 1, "cpu",
                             bits)
    sc = tpk.ubr_phase1_schedule(kp, B, M, H100_BUDGET)
    assert sc["stages"] == stages
    assert int(sc["layout"][0]) == smem <= H100_BUDGET
    assert (sc["layout"][2:] >= 0).all() and int(sc["layout"][1]) == 0


def test_schedule_raises_where_no_key_row_fits():
    """At L2 widths, one ciphertext and 256 exponents (1 KiB): the ring
    takes 4, 2, 1 rows of 16 KiB as the budget shrinks (3 would fit 60,000
    B; the kernel takes a power of two), and ValueError (the wrapper's,
    before any launch) where not one fits."""
    kp = _plan("l2")
    for budget, stages in ((70000, 4), (60000, 2), (40000, 2), (20000, 1)):
        sc = tpk.ubr_phase1_schedule(kp, 1, 256, budget)
        assert (sc["tile"], sc["stages"]) == (1, stages)
    with pytest.raises(ValueError, match="shared memory"):
        tpk.ubr_phase1_schedule(kp, 1, 256, 15000)


@pytest.mark.parametrize("name", ["l2", "l2_32", "toy"])
def test_rendered_buffers_match_the_placement_table(name):
    """`kernel_buffers("ubr_phase1")` sizes the rendered block: S rows of N
    words, which the tile's exchange rows reuse, and the tile's M
    exponents."""
    kp = _plan(name)
    tile, stages, M = 8, 4, 256
    s = schedule(kp.N, tile)
    assert [n for n, _, _ in tpk.kernel_buffers(
        "ubr_phase1", kp, M, tile=tile, stages=stages)] == [
        max(stages * kp.N * kp.torus_bits // 8, tile * s["SR"] * 4),
        tile * M * 4]
