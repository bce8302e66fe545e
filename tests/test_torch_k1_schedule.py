"""The schedule of the blind-rotate kernel's step body (K1 and K1-step,
`mosfhet_torch/ops/csrc/blind_rotate.cu`), rendered in plain numpy integer
arithmetic and held bit for bit to the port's transforms.

The rendering mirrors the kernel's index arithmetic: which thread owns
which 16 coefficients of a row in each pass (`Sched`, `slots`), the passes
and their radix-2 stages, each stage's twiddle index and vector width, the
lazy residue ranges of the Harvey butterflies ([0, 4p) forward, [0, 2p) in
the MAC and the inverse), the MAC's Barrett product on the key's residues
alone, u32 wrap-around included, and where the exchanges need only a warp's
synchronisation.  It meets `mosfhet_torch.ntt`'s forward
and inverse NTTs at N = 64 ... 4096 with 2, 3 and 4 primes, and one whole
CMUX step meets `pbs_kernel.cmux_step` at TOY and TFHEpp-L2 widths (one
step, two ciphertexts) for u64 and u32 words.  Nothing on the port's path
calls this rendering; the kernel itself meets the plain version on the card
(`test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.ops import pbs_kernel as tpk
from mosfhet_torch.torus import gadget_offset

KQ, KR = 4, 16          # stages per pass, coefficients per thread
M32 = np.uint64(0xFFFFFFFF)


def schedule(N, P):
    """`make_sched`: the block of one row."""
    logN = N.bit_length() - 1
    logT = logN - KQ
    T = 1 << logT
    pad = logN >= 2 * KQ
    return {"logN": logN, "T": T, "NG": min(P, 1024 // T), "pad": pad,
            "SR": N + (T if pad else 0), "np": -(-logN // KQ)}


def window(s, e):
    return s["logN"] - KQ if e == s["np"] - 1 else e * KQ


def stage_bits(s, e):
    """The position bits [lo, hi] that pass e stages."""
    return e * KQ, s["logN"] - 1 if e == s["np"] - 1 else e * KQ + KQ - 1


def positions(s, w):
    """[T, 16]: the position of thread t's coefficient v at window w."""
    t = np.arange(s["T"])[:, None]
    v = np.arange(KR)[None, :]
    return (t & ((1 << w) - 1)) | (v << w) | ((t >> w) << (w + KQ))


def slots(s, w):
    """`slots`: first + v * stride, the row slot of thread t's coefficient
    v at window w."""
    t = np.arange(s["T"])
    pos = (t & ((1 << w) - 1)) | ((t >> w) << (w + KQ))
    if s["pad"]:
        first = pos + (pos >> KQ)
        stride = (1 << w) + ((1 << (w - KQ)) if w >= KQ else 0)
    else:
        first, stride = pos, 1 << w
    return first[:, None] + np.arange(KR)[None, :] * stride


def shoup_lazy(a, w, ws, p):
    """u32 a * w - mulhi(a, ws) * p, wrapping mod 2^32: [0, 2p)."""
    q = (a * ws) >> np.uint64(32)
    return (a * w - q * p) & M32


def lazy2(x, p2):
    return np.minimum(x, (x - p2) & M32)


def mac_product(x, k, p):
    """`mac_product`: x * k mod p in [0, 2p) for x < 4p, k < p, by the
    Barrett quotient of the plan's mup = floor(2^62 / p) - 2^32 (no Shoup
    companion); the unreduced remainder stays below 4p."""
    mup = np.uint64((1 << 62) // p - (1 << 32))
    p = np.uint64(p)
    z = x * k                                  # < 2^62
    zlo, zhi = z & M32, z >> np.uint64(32)
    t = ((zhi << np.uint64(2)) | (zlo >> np.uint64(30))) & M32
    q = (t + ((t * mup) >> np.uint64(32))) & M32
    r = (zlo - q * p) & M32
    assert (r < 4 * p).all()
    assert (r % p == z % p).all()
    return lazy2(r, 2 * p)


def run_stage(x, s, w, I, tw, tws, p, fwd):
    """One stage on value bit I of every thread's coefficients in place,
    with the kernel's twiddle index and vector load."""
    logN, b, NS = s["logN"], w + I, 1 << (KQ - 1 - I)
    t = np.arange(s["T"])
    base = (1 << (logN - 1 - b)) + ((t >> w) << (KQ - 1 - I))
    assert (base % NS == 0).all()          # the NS-word vector load aligns
    pos = positions(s, w)
    p, p2 = np.uint64(p), np.uint64(2 * p)
    for u in range(NS):
        W, Ws = tw[base + u], tws[base + u]
        for z in range(1 << I):
            v0 = (u << (I + 1)) | z
            v1 = v0 | (1 << I)
            # the merged-psi index of the pair, and its partner
            assert (pos[:, v1] == pos[:, v0] + (1 << b)).all()
            assert (base + u == (1 << (logN - 1 - b))
                    + (pos[:, v0] >> (b + 1))).all()
            X, Y = x[:, v0], x[:, v1]
            if fwd:
                assert (X < 2 * p2).all() and (Y < 2 * p2).all()
                a = lazy2(X, p2)
                m = shoup_lazy(Y, W, Ws, p)
                x[:, v0], x[:, v1] = (a + m) & M32, (a - m + p2) & M32
            else:
                assert (X < p2).all() and (Y < p2).all()
                d = (X - Y + p2) & M32
                x[:, v0] = lazy2((X + Y) & M32, p2)
                x[:, v1] = shoup_lazy(d, W, Ws, p)


def run_pass(x, s, e, tw, tws, p, fwd):
    w = window(s, e)
    lo, hi = stage_bits(s, e)
    order = range(KQ - 1, -1, -1) if fwd else range(KQ)
    for I in order:
        if lo <= w + I <= hi:
            run_stage(x, s, w, I, tw, tws, p, fwd)


def exchange(x, s, buf, frm, to, pre, local, last_read):
    """Through the group's row: checks that a thread overwrites only the
    slots it read at the last exchange (unless `pre` synchronised the
    group first) and that a `local` exchange stays inside each warp."""
    a, b = slots(s, frm), slots(s, to)
    if not pre:
        assert (a == last_read).all()
    if local and s["T"] >= 32:
        for wp in range(s["T"] // 32):
            rows = slice(32 * wp, 32 * wp + 32)
            assert set(a[rows].ravel()) == set(b[rows].ravel())
    buf[a] = x
    x[:] = buf[b]
    return b


def forward_row(x, s, buf, tw, tws, p):
    last = None
    for e in range(s["np"] - 1, -1, -1):
        run_pass(x, s, e, tw, tws, p, True)
        if e > 0:
            last = exchange(x, s, buf, window(s, e), window(s, e - 1),
                            e == s["np"] - 1, e == 1, last)
    assert (x < 4 * p).all()


def inverse_row(x, s, buf, tw, tws, p):
    last = None
    for e in range(s["np"]):
        run_pass(x, s, e, tw, tws, p, False)
        if e < s["np"] - 1:
            last = exchange(x, s, buf, window(s, e), window(s, e + 1), e == 0,
                            e == 0, last)
    assert (x < 2 * p).all()


def u32_tables(plan, m):
    return [getattr(plan, name)[m].numpy().astype(np.uint64) for name in
            ("psi_rev", "psi_rev_shoup", "ipsi_rev", "ipsi_rev_shoup")]


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_schedule_transforms_match_the_ntt(N, P):
    """Forward from the top window's positions to window 0 (bit-reversed),
    inverse back, every prime, against ntt.forward_ntt / inverse_ntt."""
    primes = ntt.MASTER_PRIMES[-P:]
    plan = ntt.get_plan(N, primes, "cpu")
    s = schedule(N, P)
    sc = tpk.rotation_schedule(N, P)
    assert (sc["threads_per_group"], sc["groups"], sc["row_stride"]) == (
        s["T"], s["NG"], s["SR"])
    # below a warp per group the exchanges synchronise the whole block, and
    # every group then runs one prime, so all reach the same barriers
    assert s["T"] >= 32 or s["NG"] == P
    top = positions(s, window(s, s["np"] - 1))
    w0 = positions(s, 0)
    # every window's slots are a bijection into the row
    for e in range(s["np"]):
        sl = slots(s, window(s, e))
        assert len(np.unique(sl)) == N and sl.max() < s["SR"]
        want = positions(s, window(s, e))
        assert (sl == (want + (want >> KQ) if s["pad"] else want)).all()
    assert (w0 == np.arange(N).reshape(-1, KR)).all()
    rng = np.random.default_rng(N + P)
    x_in = torch.from_numpy(rng.integers(0, 1 << 62, (P, N), dtype=np.uint64)
                            .astype(np.int64)) % plan.p[:, None]
    spec = ntt.forward_ntt(x_in, plan).numpy()
    back = ntt.inverse_ntt(ntt.forward_ntt(x_in, plan), plan).numpy()
    # the groups take primes g, g + NG, ...: each prime once
    assert sorted(pi for g in range(s["NG"])
                  for pi in range(g, P, s["NG"])) == list(range(P))
    for m, p in enumerate(primes):
        tw, tws, itw, itws = u32_tables(plan, m)
        buf = np.zeros(s["SR"], np.uint64)
        x = x_in[m].numpy().astype(np.uint64)[top]
        forward_row(x, s, buf, tw, tws, p)
        np.testing.assert_array_equal(x % np.uint64(p), spec[m][w0])
        y = (spec[m][w0]).astype(np.uint64)
        y = (y + np.uint64(p) * (w0 % 2).astype(np.uint64))  # lazy inputs
        inverse_row(y, s, buf, itw, itws, p)
        ninv = int(plan.n_inv[m])
        got = (y.astype(object) * ninv % p).astype(np.int64)
        np.testing.assert_array_equal(got, back[m][top])


def render_step(acc, a, keyv, kp):
    """One CMUX step as the kernel's block runs it: acc [B, C, N] words
    (numpy uint64 holding 64 or 32 bits), a [B], keyv [J, C, P, N] u32
    residues (the kernel reads no Shoup companion of the key); returns the
    new acc."""
    bits = kp.torus_bits
    mask = np.uint64((1 << bits) - 1) if bits == 32 else None
    plan, P, C, N, l, Bg = kp.ntt, kp.P, kp.C, kp.N, kp.l, kp.Bg_bit
    s = schedule(N, P)
    top, w0 = positions(s, window(s, s["np"] - 1)), positions(s, 0)
    slot0 = slots(s, 0)
    offset = np.uint64(gadget_offset(Bg, l, True, bits))
    half = 1 << (Bg - 1)
    out = acc.copy()
    for b in range(acc.shape[0]):
        spec = np.zeros((C, P, s["SR"]), np.uint64)
        for g in range(s["NG"]):
            for pi in range(g, P, s["NG"]):
                p = kp.primes[pi]
                tw, tws, itw, itws = u32_tables(plan, pi)
                buf = np.zeros(s["SR"], np.uint64)
                for j in range(C * l):
                    cj, d = divmod(j, l)
                    row = acc[b, cj]
                    m = (top - a[b]) & (2 * N - 1)
                    rot = np.where(m & N, -row[m & (N - 1)].astype(object),
                                   row[m & (N - 1)].astype(object))
                    word = (rot - row[top].astype(object) + int(offset)) \
                        % (1 << bits)
                    dig = ((word >> (bits - (d + 1) * Bg)) & ((1 << Bg) - 1)
                           ) - half
                    x = np.where(dig < 0, dig + p, dig).astype(np.uint64)
                    forward_row(x, s, buf, tw, tws, p)
                    for c in range(C):
                        mac = mac_product(x, keyv[j, c, pi][w0], p)
                        sl = spec[c, pi]
                        sl[slot0] = mac if j == 0 else lazy2(
                            (sl[slot0] + mac) & M32, np.uint64(2 * p))
                        assert (sl[slot0] < 2 * p).all()
                for c in range(C):
                    y = spec[c, pi][slot0].copy()
                    inverse_row(y, s, buf, itw, itws, p)
                    spec[c, pi][top] = y
        # Garner: the first Shoup product by 1/N ends canonical
        r = torch.zeros((C, P, N), dtype=torch.int64)
        for pi, p in enumerate(kp.primes):
            ninv, ninvs = int(plan.n_inv[pi]), int(plan.n_inv_shoup[pi])
            v = shoup_lazy(spec[:, pi, :N], np.uint64(ninv), np.uint64(ninvs),
                           np.uint64(p))
            r[:, pi] = torch.from_numpy(np.where(v >= p, v - p, v)
                                        .astype(np.int64))
        delta = ntt.garner_u64(r, plan).numpy().view(np.uint64)
        out[b] = acc[b] + delta if mask is None else (acc[b] + delta) & mask
    return out


@pytest.mark.parametrize("N,l,Bg_bit,bits", [
    (64, 4, 9, 64), (2048, 4, 9, 64),     # TOY, TFHEpp-L2
    (64, 3, 7, 32), (2048, 3, 7, 32)],    # P32, L2_32
    ids=["toy", "l2", "toy32", "l2_32"])
def test_schedule_step_matches_cmux_step(N, l, Bg_bit, bits):
    """One step of two ciphertexts (exponents 0 and 2N, N and a random
    one) through the rendered block, against pbs_kernel.cmux_step."""
    k = 1
    primes = ntt.MASTER_PRIMES[-2:] if bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, k))
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cpu", bits)
    rng = np.random.default_rng(N + bits)
    B, C, J, P = 2, k + 1, (k + 1) * l, len(primes)
    acc = rng.integers(0, 1 << bits, (B, C, N), dtype=np.uint64)
    pr = np.array(primes, np.uint64)[:, None]
    keyv = rng.integers(0, 1 << 62, (J, C, P, N), dtype=np.uint64) % pr
    keyvs = (keyv << np.uint64(32)) // pr
    dtype = torch.int32 if bits == 32 else torch.int64
    for a in ([0, 2 * N], [N, int(rng.integers(1, 2 * N))]):
        got = render_step(acc, np.array(a), keyv, kp)
        words = torch.from_numpy(acc.astype(np.uint32).view(np.int32)
                                 if bits == 32 else acc.view(np.int64))
        want = tpk.cmux_step(words, torch.from_numpy(keyv.astype(np.int64)),
                             torch.from_numpy(keyvs.astype(np.int64)),
                             torch.tensor(a), kp.ntt, l, Bg_bit)
        assert want.dtype == dtype
        np.testing.assert_array_equal(
            got.astype(np.uint32).view(np.int32) if bits == 32
            else got.view(np.int64), want.numpy())


@pytest.mark.parametrize("p", ntt.MASTER_PRIMES)
def test_mac_product_stays_below_4p(p):
    """The MAC's Barrett product at its extremes (x up to 4p - 1, the
    forward NTT's lazy range; k up to p - 1) and on random operands: exact
    mod p, the remainder below 4p before its one reduction."""
    rng = np.random.default_rng(p)
    x = np.concatenate([[4 * p - 1, 4 * p - 1, 0, p, 2 * p - 1],
                        rng.integers(0, 4 * p, 4096)]).astype(np.uint64)
    k = np.concatenate([[p - 1, 1, p - 1, p - 1, p - 1],
                        rng.integers(0, p, 4096)]).astype(np.uint64)
    m = mac_product(x, k, p)
    assert (m < 2 * p).all()
    assert (m % np.uint64(p) == (x * k) % np.uint64(p)).all()


def test_schedule_buffers_match_the_placement_table():
    """The rendered block's rows are what `kernel_buffers` sizes: one
    exchange row per group, C*P spectra rows, acc [C][N] words."""
    for N, l, Bg_bit, bits in ((2048, 4, 9, 64), (2048, 3, 7, 32),
                               (4096, 1, 22, 64), (8192, 1, 22, 64)):
        primes = ntt.MASTER_PRIMES[-2:] if bits == 32 else \
            ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, 1))
        kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cpu", bits)
        s = schedule(N, kp.P)
        (work, _, _), (spec, _, _), (acc, _, _) = tpk.kernel_buffers(
            "blind_rotate", kp)
        assert (work, spec, acc) == (s["NG"] * s["SR"] * 4,
                                     kp.C * kp.P * s["SR"] * 4,
                                     kp.C * N * bits // 8)
