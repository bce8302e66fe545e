"""The gadget-row split CMUX step (K8a `partial_step` and K8b `finish_step`,
`mosfhet_torch/ops/csrc/tp_step.cu`) on K1's schedule, rendered in plain
numpy integer arithmetic and held bit for bit to
`pbs_kernel.partial_step_plain` and `finish_step_plain`.

The rendering reuses the K1 rendering's schedule helpers
(`tests/test_torch_k1_schedule.py`: which thread owns which 16 coefficients
in each pass, the passes, lazy residues, the Barrett MAC) and adds what the
two kernels do around them.  K8a: each group's digit rows of the global key
rows [j0, j0 + j_local) read straight from acc, the forward NTT, the MAC
into the thread's own slots (the first row replacing), the slots reduced to
canonical residues and stored as 16 consecutive words per thread.  K8b:
each thread's 16 window-0 words of the m partials summed mod p (canonical
after each add), the inverse NTT from those registers to natural order in
the spectra rows, Garner.  Cases: TOY and TFHEpp-L2 widths at u64 words,
their 32-bit forms at u32 words; key-row slices [0, J/2), [J/2, J),
[3J/4, J) and one row; exponents 0, N and 2N present; m = 1, 2, 4 and 8
partials with a word at p - 1; a split step (two K8a and one K8b) against
`pbs_kernel.cmux_step`; the rendered buffers against `kernel_buffers`.
Nothing on the port's path calls this rendering; the kernels themselves
meet the plain versions on the card (`test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_k1_schedule import (M32, forward_row, inverse_row,
                                          lazy2, mac_product, positions,
                                          schedule, slots, u32_tables,
                                          window)
from tests.test_torch_k7_schedule import digits_of, garner_words, i32

# (N, l, Bg_bit, torus bits): TOY, TFHEpp-L2 and their 32-bit forms
WIDTHS = {"toy": (64, 4, 9, 64), "l2": (2048, 4, 9, 64),
          "toy32": (64, 3, 7, 32), "l2_32": (2048, 3, 7, 32)}


def _plan(N, l, Bg_bit, bits, k=1):
    primes = ntt.MASTER_PRIMES[-2:] if bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, k))
    return tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cpu", bits)


def render_partial(acc, a, j0, keyv, kp, sizes=None):
    """K8a's block on each ciphertext: acc [B, C, N] words (uint64 holding
    64 or 32 bits), a [B], keyv [j_local, C, P, N] u32 residues (the kernel
    reads no Shoup companion).  Returns the partial [B, C, P, N] (uint64
    holding canonical residues); ``sizes`` gets each buffer's bytes."""
    N, C, P, l = kp.N, kp.C, kp.P, kp.l
    s = schedule(N, P)
    top, w0, slot0 = positions(s, window(s, s["np"] - 1)), positions(s, 0), \
        slots(s, 0)
    # a thread's 16 stores are consecutive words, and the threads' stores
    # cover every word of a row once
    assert (w0 == np.arange(N).reshape(-1, 16)).all()
    out = np.zeros((acc.shape[0], C, P, N), np.uint64)
    for b in range(acc.shape[0]):
        for g in range(s["NG"]):
            buf = np.zeros(s["SR"], np.uint64)         # the exchange row
            mine = np.zeros((C, s["SR"]), np.uint64)   # the MAC slots
            for pi in range(g, P, s["NG"]):
                p = kp.primes[pi]
                tw, tws, _, _ = u32_tables(kp.ntt, pi)
                for jj in range(keyv.shape[0]):
                    cj, d = divmod(j0 + jj, l)
                    row = acc[b, cj]
                    m = (top - int(a[b])) & (2 * N - 1)
                    v = row[m & (N - 1)]
                    rot = np.where(m & N, np.uint64(0) - v, v)
                    dig = digits_of(rot - row[top], d, kp, kp.torus_bits)
                    x = np.where(dig < 0, dig + p, dig).astype(np.uint64)
                    forward_row(x, s, buf, tw, tws, p)
                    for c in range(C):
                        mac = mac_product(x, keyv[jj, c, pi][w0], p)
                        sl = mine[c]
                        sl[slot0] = mac if jj == 0 else lazy2(
                            (sl[slot0] + mac) & M32, np.uint64(2 * p))
                        assert (sl[slot0] < 2 * p).all()
                for c in range(C):
                    y = mine[c][slot0]
                    out[b, c, pi][w0] = np.minimum(y, (y - np.uint64(p))
                                                   & M32)
    if sizes is not None:
        sizes.update(work=s["NG"] * buf.nbytes // 2,
                     slots=s["NG"] * mine.nbytes // 2)   # as u32 words
    return out


def render_finish(acc, parts, kp, sizes=None):
    """K8b's block on each ciphertext: acc [B, C, N] words, parts [m, B, C,
    P, N] canonical residues.  Returns acc + Garner(INTT(sum mod p))."""
    N, C, P, bits = kp.N, kp.C, kp.P, kp.torus_bits
    mask = np.uint64((1 << bits) - 1) if bits == 32 else np.uint64(2**64 - 1)
    s = schedule(N, P)
    top, w0 = positions(s, window(s, s["np"] - 1)), positions(s, 0)
    out = np.empty_like(acc)
    for b in range(acc.shape[0]):
        rows = np.zeros((C, P, N), np.uint64)          # the spectra rows
        for g in range(s["NG"]):
            buf = np.zeros(s["SR"], np.uint64)
            for pi in range(g, P, s["NG"]):
                p = np.uint64(kp.primes[pi])
                _, _, itw, itws = u32_tables(kp.ntt, pi)
                for c in range(C):
                    x = parts[0, b, c, pi][w0].copy()
                    for sh in range(1, parts.shape[0]):
                        y = x + parts[sh, b, c, pi][w0]
                        x = np.where(y >= p, y - p, y)
                    assert (x < p).all()
                    inverse_row(x, s, buf, itw, itws, int(p))
                    rows[c, pi][top] = x
        # one block barrier, then Garner over the rows
        out[b] = (acc[b] + garner_words(rows, kp)) & mask
    if sizes is not None:
        sizes.update(work=s["NG"] * buf.nbytes // 2, rows=rows.nbytes // 2)
    return out


def _words(x, bits):
    """uint64 holding `bits`-bit words -> the port's int64 / int32 tensor."""
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)
                            if bits == 32 else x.view(np.int64))


def _inputs(name, B, seed):
    N, l, Bg_bit, bits = WIDTHS[name]
    kp = _plan(N, l, Bg_bit, bits)
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 1 << bits, (B, kp.C, N), dtype=np.uint64)
    a = rng.integers(0, 2 * N + 1, B)
    a[:3] = [0, N, 2 * N][:B]
    pr = np.array(kp.primes, np.uint64)[:, None]
    keyv = rng.integers(0, 1 << 62, (kp.J, kp.C, kp.P, N),
                        dtype=np.uint64) % pr
    return kp, rng, acc, a, keyv, (keyv << np.uint64(32)) // pr


def _slices(J):
    """(j0, j_local): the first and second half, the last quarter, one row."""
    return [(0, J // 2), (J // 2, J - J // 2), (3 * J // 4, J - 3 * J // 4),
            (1, 1)]


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_partial_rendering_matches_partial_step_plain(name):
    """K8a over four key-row slices of four ciphertexts (exponents 0, N, 2N
    and a random one) against partial_step_plain."""
    kp, _, acc, a, keyv, keyvs = _inputs(name, 4, 800 + len(name))
    for j0, jl in _slices(kp.J):
        got = render_partial(acc, a, j0, keyv[j0:j0 + jl], kp)
        want = tpk.partial_step_plain(
            _words(acc, kp.torus_bits), torch.from_numpy(a), j0,
            i32(keyv[j0:j0 + jl]), i32(keyvs[j0:j0 + jl]), kp)
        np.testing.assert_array_equal(got.astype(np.uint32).view(np.int32),
                                      want.numpy())


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_finish_rendering_matches_finish_step_plain(name):
    """K8b on m = 1, 2, 4 and 8 random partials of two ciphertexts, with
    every prime's top residue p - 1 at one word of every partial (the sum
    then reaches m (p - 1)), against finish_step_plain."""
    kp, rng, acc, _, _, _ = _inputs(name, 2, 810 + len(name))
    pr = np.array(kp.primes, np.uint64)[:, None]
    for m in (1, 2, 4, 8):
        parts = rng.integers(0, 1 << 62, (m, 2, kp.C, kp.P, kp.N),
                             dtype=np.uint64) % pr
        parts[:, 0, 0, :, 0] = pr[:, 0] - 1
        got = render_finish(acc, parts, kp)
        words = _words(acc, kp.torus_bits)
        want = tpk.finish_step_plain(words.clone(), i32(parts), kp)
        np.testing.assert_array_equal(_words(got, kp.torus_bits).numpy(),
                                      want.numpy())


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_split_step_rendering_matches_cmux_step(name):
    """Two K8a over the halves of the key rows and one K8b on their
    partials: the words of pbs_kernel.cmux_step (one K1 step)."""
    kp, _, acc, a, keyv, keyvs = _inputs(name, 3, 820 + len(name))
    half = kp.J // 2
    parts = np.stack([render_partial(acc, a, j0, keyv[j0:j0 + half], kp)
                      for j0 in (0, half)])
    got = render_finish(acc, parts, kp)
    want = tpk.cmux_step(_words(acc, kp.torus_bits), torch.from_numpy(
        keyv.astype(np.int64)), torch.from_numpy(keyvs.astype(np.int64)),
        torch.from_numpy(a), kp.ntt, kp.l, kp.Bg_bit)
    np.testing.assert_array_equal(_words(got, kp.torus_bits).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("N,l,Bg_bit,bits", [
    (2048, 4, 9, 64), (2048, 3, 7, 32), (4096, 1, 22, 64),
    (8192, 1, 22, 64)], ids=["l2", "l2_32", "set3", "n8192"])
def test_rendered_buffers_match_the_placement_tables(N, l, Bg_bit, bits):
    """`kernel_buffers("tp_step")` (K8a) and `("finish_step")` (K8b) size
    the rendered blocks: one exchange row per group; K8a one MAC row per
    group and component, K8b the C*P spectra rows, component 0's P rows
    first.  One ciphertext of zeros at a digit row's cost (one row)."""
    kp = _plan(N, l, Bg_bit, bits)
    zeros = np.zeros((1, kp.C, N), np.uint64)
    sizes_a, sizes_b = {}, {}
    render_partial(zeros, np.zeros(1, np.int64), 0,
                   np.zeros((1, kp.C, kp.P, N), np.uint64), kp, sizes_a)
    render_finish(zeros, np.zeros((1, 1, kp.C, kp.P, N), np.uint64), kp,
                  sizes_b)
    (work, _, _), (spec, _, _) = tpk.kernel_buffers("tp_step", kp)
    assert (work, spec) == (sizes_a["work"], sizes_a["slots"])
    (work, _, _), (row0, _, _), (rest, _, _) = tpk.kernel_buffers(
        "finish_step", kp)
    assert (work, row0 + rest) == (sizes_b["work"], sizes_b["rows"])
    assert row0 == kp.P * N * 4
