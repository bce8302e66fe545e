"""The key switch's select-sum (K2, `mosfhet_torch/ops/csrc/tlwe_keyswitch.cu`)
rendered block by block in plain numpy integer arithmetic, in the kernel's
order, and held word for word to `pbs_kernel.tlwe_keyswitch_sum_plain`
(which `tests/test_torch_keyswitch.py` ties to the TPU kernel in interpret
mode).

A block owns a column slice (512 B of words: 64 u64 or 128 u32 columns), a
tile of 128 ciphertexts and part q of S of the row chunks; the S blocks of
one (slice, tile) are a cluster.  The rendering walks a block's chunks
through its ring of stages as the kernel does: the first stages filled
ahead, each chunk waited for on its stage's `full` phase, summed, released
on its `empty` phase, and the stage of the chunk before refilled with the
chunk `stages` on.  The stages start with garbage; a fill copies, for each
valid row segment of the chunk, the 16-byte granules around its slice's
valid columns (as the TMA copy takes them, bytes of the neighbouring
segments and of the memory around the table included, stale bytes
staying past them), and zero-fills the digits of rows past n_rows or
ciphertexts past B, so a byte the kernel must not read shows in the sums.
Warp w turns its digits into the byte where each selected segment's slice
starts (slot and shift) and sums ciphertexts 16w .. 16w+15, lane l columns
l + 32 m.  Then the S blocks' sums are reduced, block q adding the S sums
of its 1/S of the tile's words, each output word written once.  Cases: u64
and u32 words, base-1 of 3, 7 and 15, ragged B, width and rows, digits 0,
base, above base and negative, S = 1, 2, 3 and 5, tables at addresses 0,
4, 8 and 12 mod 16.  Nothing on the port's path calls this rendering; the
kernel itself meets the plain version on the card (`test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

WARPS = 8
PER_WARP = tpk.KS_TILE // WARPS
LANES = 32


def _words(bits):
    return np.uint64 if bits == 64 else np.uint32


class Ring:
    """A block's stages in shared memory, as bytes, and their mbarrier
    phases: fills[s] and empties[s] count the phases completed on stage
    s's `full` and `empty` barriers.  Stage s: slots [R][base-1] of
    KS_SLOT_BYTES, then digits [R][KS_DIGIT_PITCH] int32."""

    def __init__(self, rng, til, base_m1):
        self.til, self.base_m1 = til, base_m1
        self.sb = til["stage_bytes"]
        self.tb = til["chunk_rows"] * base_m1 * tpk.KS_SLOT_BYTES
        self.mem = rng.integers(0, 256, til["stages"] * self.sb,
                                dtype=np.uint8)
        self.chunk = [None] * til["stages"]
        self.fills = [0] * til["stages"]
        self.empties = [0] * til["stages"]

    def digits(self, s):
        R = self.til["chunk_rows"]
        off = s * self.sb + self.tb
        return self.mem[off:off + R * tpk.KS_DIGIT_PITCH * 4].view(
            np.int32).reshape(R, tpk.KS_DIGIT_PITCH)

    def fill(self, s, k, dig, table, R, b0, c0, wl):
        """Chunk k into stage s: thread x < rows (base-1) copies the 16-byte
        granules around segment x's slice, columns [c0, c0 + wl), into slot
        x (one TMA copy of the table's bytes; stale bytes stay past it);
        the tile's digits, zero past n_rows or B; then `full` completes."""
        B, n_rows = dig.shape
        row0 = k * R
        rows = min(R, n_rows - row0)
        for x in range(rows * self.base_m1):
            g = row0 * self.base_m1 + x
            start, shift = table.segment(g, c0)
            n = (shift + wl * table.w + 15) // 16 * 16
            slot = s * self.sb + x * tpk.KS_SLOT_BYTES
            assert (start - shift) % 16 == 0 and slot % 16 == 0
            # no byte outside the granules the table's own bytes touch
            assert table.base // 16 * 16 <= start - shift
            assert start - shift + n <= -(-table.end // 16) * 16
            assert n <= tpk.KS_SLOT_BYTES
            self.mem[slot:slot + n] = table.image[start - shift:
                                                  start - shift + n]
        d = self.digits(s)
        d[:, :tpk.KS_TILE] = 0
        nb = max(0, min(tpk.KS_TILE, B - b0))
        d[:rows, :nb] = dig[b0:b0 + nb, row0:row0 + rows].T
        self.chunk[s] = k
        self.fills[s] += 1


class Table:
    """The table's bytes in device memory at an address that is ``base``
    mod 16, amid other bytes (a copy may take the granules around it)."""

    def __init__(self, rng, ab, base):
        self.w = ab.itemsize
        self.base_m1, self.width = ab.shape[1], ab.shape[2]
        raw = ab.reshape(-1).view(np.uint8)
        self.image = rng.integers(0, 256, 32 + raw.size + 32, dtype=np.uint8)
        self.base = 16 + base
        self.end = self.base + raw.size
        self.image[self.base:self.end] = raw

    def segment(self, g, c0):
        """Where column c0 of segment g starts, and that byte mod 16."""
        start = self.base + (g * self.width + c0) * self.w
        return start, start % 16


def render_block(dig, table, til, bits, b0, c0, q, S, rng):
    """Block (slice at c0, tile at b0, part q of S): its sums [tile, slice]
    as the threads hold them."""
    B, n_rows = dig.shape
    base_m1, width = table.base_m1, table.width
    R, Wc, NS = til["chunk_rows"], til["slice"], til["stages"]
    wl = min(Wc, width - c0)
    chunks = -(-n_rows // R)
    k0, n = q * chunks // S, (q + 1) * chunks // S - q * chunks // S
    ring = Ring(rng, til, base_m1)
    for j in range(min(n, NS)):
        ring.fill(j, k0 + j, dig, table, R, b0, c0, wl)
    acc = np.zeros((WARPS, PER_WARP, Wc), _words(bits))
    for j in range(n):
        s = j % NS
        # the wait on full[s] at parity (j / NS) & 1 passes on this chunk's
        # fill, and no later fill has overwritten it
        assert ring.fills[s] == j // NS + 1 and ring.chunk[s] == k0 + j
        sd = ring.digits(s)
        row0 = (k0 + j) * R
        for w in range(WARPS):
            # the warp's digits turned in place into the byte where each
            # selected segment's slice starts (its slot and shift), -1 for
            # none
            mine = sd[:, w * PER_WARP:(w + 1) * PER_WARP]
            v = mine.astype(np.int64) - 1
            x = np.arange(R)[:, None] * base_m1 + v
            shift = (table.base + ((row0 * base_m1 + x) * width + c0)
                     * table.w) % 16
            mine[...] = np.where((v >= 0) & (v < base_m1),
                                 s * ring.sb + x * tpk.KS_SLOT_BYTES + shift,
                                 -1)
        for r in range(R):
            for w in range(WARPS):
                a = sd[r, w * PER_WARP:(w + 1) * PER_WARP]   # 4 x int4
                for i in np.flatnonzero(a >= 0):
                    # lane l's columns l + 32 m: words l + 32 m from a
                    # (u32: every load made, a word of none adds nothing)
                    words = ring.mem[a[i]:a[i] + Wc * table.w].view(
                        _words(bits))
                    acc[w, i] += words
        ring.empties[s] += 1
        if j >= 1 and j - 1 + NS < n:
            sp = (j - 1) % NS
            # the wait on empty[sp] at parity ((j - 1) / NS) & 1: every
            # thread has read chunk j - 1
            assert ring.empties[sp] == (j - 1) // NS + 1
            assert ring.chunk[sp] == k0 + j - 1
            ring.fill(sp, k0 + j - 1 + NS, dig, table, R, b0, c0, wl)
    # the sums, [warp * 16 + i][lane + 32 m] of the block's shared memory
    return acc.reshape(tpk.KS_TILE, Wc)


def render_keyswitch(dig, ab, bits, S, base=0, seed=0):
    """The whole launch: dig [B, n_rows] int32, ab [n_rows, base-1, width]
    words (uint64 or uint32) at an address ``base`` mod 16.  Returns out
    [B, width]."""
    B, n_rows = dig.shape
    base_m1, width = ab.shape[1], ab.shape[2]
    til = tpk.tlwe_keyswitch_tiling(base_m1, bits)
    T, Wc = til["tile"], til["slice"]
    rng = np.random.default_rng(seed)
    table = Table(rng, ab, base)
    out = np.zeros((B, width), _words(bits))
    written = np.zeros((B, width), np.int64)
    E = T * Wc
    for c0 in range(0, width, Wc):
        wl = min(Wc, width - c0)
        for b0 in range(0, B, T):
            parts = [render_block(dig, table, til, bits, b0, c0, q, S, rng)
                     .reshape(-1) for q in range(S)]
            # cluster barrier; block q adds the S sums of its share
            for q in range(S):
                e = np.arange(q * E // S, (q + 1) * E // S)
                i, c = e // Wc, e % Wc
                keep = (b0 + i < B) & (c < wl)
                e, i, c = e[keep], i[keep], c[keep]
                total = np.zeros(e.shape, _words(bits))
                for p in range(S):
                    total += parts[p][e]
                out[b0 + i, c0 + c] = total
                np.add.at(written, (b0 + i, c0 + c), 1)
    assert (written == 1).all()
    return out


def _case(B, n_in, t, base_m1, width, bits, seed):
    rng = np.random.default_rng(seed)
    dig = rng.integers(0, base_m1 + 1, (B, n_in, t), dtype=np.int32)
    dig[0, 0, 0], dig[-1, -1, -1] = 0, base_m1
    dig[0, -1, 0], dig[-1, 0, -1] = base_m1 + 1, -3   # select nothing
    ab = rng.integers(0, 1 << bits, (n_in, t, base_m1, width),
                      dtype=np.uint64).astype(_words(bits))
    return dig, ab


@pytest.mark.parametrize("bits", [64, 32], ids=["u64", "u32"])
@pytest.mark.parametrize("B,n_in,t,base_m1,width,S,base", [
    (130, 5, 8, 15, 70, 2, 0),    # two tiles, the second of 2; ragged slice
    (3, 7, 3, 7, 133, 3, 8),      # rows not a multiple of the chunk
    (1, 11, 5, 3, 9, 5, 4),       # one ciphertext, one narrow slice
    (129, 3, 2, 15, 1, 1, 12),    # width 1, one block per tile
])
def test_render_matches_plain(B, n_in, t, base_m1, width, S, base, bits):
    """Held to the plain version at tables whose address is 0, 4, 8 or 12
    mod 16 (a u64 table's is 0 or 8)."""
    base = base // (bits // 8) * (bits // 8)
    dig, ab = _case(B, n_in, t, base_m1, width, bits, seed=B + width + bits)
    got = render_keyswitch(dig.reshape(B, n_in * t),
                           ab.reshape(n_in * t, base_m1, width), bits, S,
                           base=base, seed=S)
    tab = torch.from_numpy(ab.view(np.int64 if bits == 64 else np.int32))
    want = tpk.tlwe_keyswitch_sum_plain(torch.from_numpy(dig), tab).numpy()
    assert want.dtype == (np.int64 if bits == 64 else np.int32)
    assert np.array_equal(got.view(want.dtype), want)


@pytest.mark.parametrize("bits", [64, 32])
@pytest.mark.parametrize("base_m1,rows", [(15, 4), (7, 8), (3, 16), (1, 32)])
def test_tiling(base_m1, rows, bits):
    """The chunk rows per base-1; a slice of 512 B; the ring and the
    block's sums fit twice in the 228 KiB of an H100 SM with 1 KiB reserved
    per block at base-1 up to 15 (two blocks per SM); the digit copies of
    one warp (consecutive rows of 32 / R ciphertexts) fall in at most R / 4
    ways of a bank."""
    til = tpk.tlwe_keyswitch_tiling(base_m1, bits)
    assert til["chunk_rows"] == rows and til["slice"] * bits // 8 == 512
    assert til["chunk_rows"] * base_m1 * 512 <= tpk.KS_STAGE_TABLE_BYTES
    assert til["stage_bytes"] % 16 == 0 and tpk.KS_SLOT_BYTES % 16 == 0
    assert til["smem"] >= tpk.KS_TILE * 512
    assert 2 * (til["smem"] + 1024) <= 228 * 1024
    for w in range(tpk.KS_TILE * rows // LANES):
        idx = np.arange(w * LANES, (w + 1) * LANES)
        r, i = idx % rows, idx // rows
        banks = (r * tpk.KS_DIGIT_PITCH + i) % 32
        assert np.bincount(banks).max() <= max(1, rows // 4)


def test_tiling_at_l2():
    """TFHEpp-L2 (base-1 15, width 633, B=512): 10 slices of 64 u64
    columns and 4 tiles, so the table leaves L2 4 times per call (4.98 GB),
    not once per ciphertext (42.5 GB); L2_32: 5 slices of 128 u32
    columns."""
    for bits, slices in ((64, 10), (32, 5)):
        til = tpk.tlwe_keyswitch_tiling(15, bits)
        assert -(-633 // til["slice"]) == slices
        assert til["smem"] == 3 * 4 * (15 * 528 + 4 * 136) == 101568
    table = 2048 * 8 * 15 * 633 * 8
    assert -(-512 // tpk.KS_TILE) * table == 4 * table < 42.5e9 / 5
