"""The hand-written CUDA kernels (blind rotation, key-switch select-sum,
external-product apply scan, unfolded rotation, UBR phase 1, automorphism
key switch, GA rotation, the gadget-row split CMUX step) against their
plain PyTorch versions, bit for bit, the int8 key switch through
`torch._int_mm`, and the sharded bootstrap on a mesh of one card (and of
every card, where there are several); the one-limb (32-bit torus) forms
of the blind rotation, the select-sum, the external-product apply scan,
the unfolded rotation, UBR phase 1, the split CMUX step, the automorphism
key switch and the GA rotation; the GA step's external product alone
(K1-delta) and the key switch on gathered keys (K6-old); the one-step
kernels K1-step and K3-step and the v1 UBR phase 1 (K5-v1) at both
widths, and their entry points' launch counts (the per-step GA forms'
among them); the key-switch family's launches (K2 on packing tables'
rows of (k+1)N words, the streamed seeded apply against K2 on the
expanded table, `priv_keyswitch_2` and `ks_b_to_a` as two K6 launches, the
relinearization's K6 at four primes); K1 on a TRGSW accumulator's rows
(`bootstrap.blind_rotate_trgsw`), K1 at UFHE_SET0's gadget (l=6) and K2 at
its base_bit=2; the kernels at N=4096 with 4 primes
(SET_3) and N=8192,
whose buffers do not all fit shared memory; and, for the kernels on K1's
schedule, ragged batches, residency and misaligned keys.
Needs a CUDA card: without one every test here skips.

This file imports nothing but PyTorch, numpy and the port, so it runs on a
machine that has no TPU-package dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.bridge import to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk


def random_rotation_inputs(N, k, l, Bg_bit, n, B, seed, primes=None,
                           torus_bits=64):
    """Random accumulators (u64 words, or u32 at torus_bits 32), exponents
    in [0, 2N] with 0 and 2N present, and random canonical key residues
    with their Shoup companions (u32).  primes: the 64-bit torus's for the
    digits, unless given."""
    C, J = k + 1, (k + 1) * l
    if primes is None:
        primes = ntt.primes_for_bound(
            ntt.external_product_bound(N, Bg_bit, l, k))
    rng = np.random.default_rng(seed)
    acc0 = rng.integers(0, 1 << torus_bits, size=(B, C, N), dtype=np.uint64)
    if torus_bits == 32:
        acc0 = acc0.astype(np.uint32)
    a_int = rng.integers(0, 2 * N + 1, size=(n, B), dtype=np.int32)
    a_int[0, 0], a_int[-1, -1] = 0, 2 * N
    p = np.array(primes, np.uint64)[:, None]
    keyv = rng.integers(0, 1 << 62, size=(n, J, C, len(primes), N),
                        dtype=np.uint64) % p
    keyvs = (keyv << np.uint64(32)) // p
    return primes, acc0, a_int, keyv.astype(np.uint32), keyvs.astype(np.uint32)


def as_i32(x_u32, device):
    """u32 array -> int32 tensor with the same bits."""
    return torch.from_numpy(x_u32.view(np.int32).copy()).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,n,B", [
    (2048, 1, 4, 9, 3, 5),     # TFHEpp-L2 widths
    (256, 2, 3, 8, 4, 3),      # k=2, TOY_K2-like digits
    (2048, 1, 1, 23, 2, 2),    # SET_2 digits: four primes
])
def test_cuda_kernel_matches_plain(N, k, l, Bg_bit, n, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=N)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int).cuda(),
            as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"), kp)
    launches = tpk.blind_rotate_scan.launches
    got = tpk.blind_rotate_scan(*args)
    torch.cuda.synchronize()
    assert tpk.blind_rotate_scan.launches == launches + 1
    want = tpk.blind_rotate_scan_plain(*args)
    assert torch.equal(got, want)


# The 32-bit torus (TORUS32): `benchmarks/bench_torus32.py`'s L2_32 digits
# and key switch, and its two primes (what ntt.primes_for_bound picks with
# MOSFHET_TORUS_BITS=32).
L2_32 = dict(N=2048, k=1, l=3, Bg_bit=7, t=6, base_bit=4, n=632)
PRIMES_32 = ntt.MASTER_PRIMES[-2:]


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,P,n,B", [
    (2048, 1, 3, 7, 2, 3, 5),   # L2_32 widths, n cut to 3
    (64, 1, 3, 7, 2, 4, 3),     # the TPU suite's P32
    (1024, 2, 2, 10, 3, 2, 3),  # k=2, three primes
])
def test_cuda_kernel_matches_plain_torus32(N, k, l, Bg_bit, P, n, B):
    """K1's one-limb form on u32 words (int32 tensors)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=N + 32, primes=ntt.MASTER_PRIMES[-P:],
        torus_bits=32)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda", 32)
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int).cuda(),
            as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"), kp)
    assert args[0].dtype == torch.int32
    launches = tpk.blind_rotate_scan.launches
    got = tpk.blind_rotate_scan(*args)
    torch.cuda.synchronize()
    assert tpk.blind_rotate_scan.launches == launches + 1
    want = tpk.blind_rotate_scan_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def random_ks_inputs(B, n_in, t, base_m1, width, seed):
    """Random digits in [0, base) with 0 and base-1 present, and a random
    u64 KS table [n_in, t, base-1, width] (as int64)."""
    rng = np.random.default_rng(seed)
    dig = rng.integers(0, base_m1 + 1, size=(B, n_in, t), dtype=np.int32)
    dig[0, 0, 0], dig[-1, -1, -1] = 0, base_m1
    ab = rng.integers(0, 1 << 64, size=(n_in, t, base_m1, width),
                      dtype=np.uint64)
    return dig, ab


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_in,t,base_m1,width", [
    (3, 2048, 8, 15, 633),     # TFHEpp-L2 key-switch widths
    (5, 64, 8, 15, 17),        # a ragged column block
    (2, 37, 5, 7, 300),        # SET_2-like digits, odd n_in
    (1, 1100, 4, 3, 5),        # more than one shared-memory tile of digits
    (1, 2048, 8, 15, 633),     # one ciphertext at L2 widths
    (130, 64, 8, 15, 633),     # B not a multiple of the 128-ciphertext tile
    (257, 37, 3, 15, 70),      # 111 rows: not a multiple of the 4-row chunk
    (5, 64, 8, 15, 1),         # width 1
    (512, 2048, 8, 15, 633),   # the gate's and fdfb's batch at L2
])
def test_cuda_keyswitch_sum_matches_plain(B, n_in, t, base_m1, width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dig, ab = random_ks_inputs(B, n_in, t, base_m1, width, seed=n_in + width)
    d = torch.from_numpy(dig).cuda()
    tab = to_tensor(ab, "cuda")
    launches = tpk.tlwe_keyswitch_sum.launches
    got = tpk.tlwe_keyswitch_sum(d, tab)
    torch.cuda.synchronize()
    assert tpk.tlwe_keyswitch_sum.launches == launches + 1
    assert torch.equal(got, tpk.tlwe_keyswitch_sum_plain(d, tab))


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_in,t,base_m1,width", [
    (3, 2048, 6, 15, 633),     # L2_32 key-switch widths
    (5, 64, 5, 15, 17),        # a ragged column block
    (1, 2048, 6, 15, 633),     # one ciphertext
    (130, 64, 6, 15, 633),     # B not a multiple of the tile
    (257, 37, 3, 7, 133),      # 111 rows in 8-row chunks; base 8
    (3, 37, 3, 3, 1),          # width 1; base 4
    (512, 2048, 6, 15, 633),   # the gate's and fdfb's batch at L2_32
])
def test_cuda_keyswitch_sum_matches_plain_torus32(B, n_in, t, base_m1, width):
    """K2's one-plane form: an int32 table of u32 words, sums mod 2^32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dig, ab = random_ks_inputs(B, n_in, t, base_m1, width, seed=n_in + 32)
    d = torch.from_numpy(dig).cuda()
    tab = to_tensor(ab.astype(np.uint32), "cuda")
    launches = tpk.tlwe_keyswitch_sum.launches
    got = tpk.tlwe_keyswitch_sum(d, tab)
    torch.cuda.synchronize()
    assert tpk.tlwe_keyswitch_sum.launches == launches + 1
    want = tpk.tlwe_keyswitch_sum_plain(d, tab)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,slices", [(64, 10), (32, 5)])
def test_cuda_keyswitch_schedule_at_l2(bits, slices):
    """K2's launch at B=512, L2 widths: the tiling of
    `tlwe_keyswitch_tiling`, 4 tiles of 128 ciphertexts, 64 u64 (128 u32)
    columns per slice, two blocks per SM, and a cluster of S blocks per
    (slice, tile) with the S that the launch promises: of the cluster sizes
    the runtime can hold, the one whose waves of clusters walk the fewest
    chunks, the epilogue counted.  The last wave may be partial: with u64
    words on an H100 the 40 clusters of 16 blocks ran in three waves of
    14, 14 and 12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n_rows = 2048 * (8 if bits == 64 else 6)
    got = tpk.tlwe_keyswitch_schedule(512, n_rows, 15, 633, bits)
    til = tpk.tlwe_keyswitch_tiling(15, bits)
    assert {k: got[k] for k in til} == til
    assert (got["tiles"], got["slices"], got["threads"]) == (4, slices, 256)
    assert got["blocks"] == 4 * slices * got["cluster"]
    assert got["blocks_per_sm"] == 2
    resident = got["clusters_by_size"]
    assert len(resident) == 16 and resident[0] >= 1
    chunks = -(-n_rows // got["chunk_rows"])
    pairs = got["tiles"] * got["slices"]

    def cost(S):
        waves = -(-pairs // resident[S - 1])
        return waves * (-(-chunks // S) + got["epilogue_chunks"])

    sizes = [S for S in range(1, 17)
             if resident[S - 1] > 0 and (S == 1 or S <= chunks)]
    assert got["cluster"] in sizes
    assert got["clusters_resident"] == resident[got["cluster"] - 1]
    assert cost(got["cluster"]) == min(cost(S) for S in sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,offset", [(64, 1), (32, 1), (32, 2), (32, 3)])
def test_cuda_keyswitch_sum_misaligned_table(bits, offset):
    """A table whose address is 4, 8 or 12 mod 16 (a view into a larger
    buffer): K2 copies the 16-byte granules around each slice and still
    gives the plain version's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, n_in, t, base_m1, width = 130, 37, 3, 15, 70
    dig, ab = random_ks_inputs(B, n_in, t, base_m1, width, seed=offset)
    flat = ab.reshape(-1) if bits == 64 else ab.reshape(-1).astype(np.uint32)
    buf = np.concatenate([flat[:offset], flat, flat[:3]])
    tab = to_tensor(buf, "cuda")[offset:offset + flat.size].view(ab.shape)
    assert tab.is_contiguous() and tab.data_ptr() % 16 == offset * bits // 8
    d = torch.from_numpy(dig).cuda()
    got = tpk.tlwe_keyswitch_sum(d, tab)
    torch.cuda.synchronize()
    assert torch.equal(got, tpk.tlwe_keyswitch_sum_plain(d, tab))


@pytest.mark.gpu
def test_cuda_keyswitch_sum_refuses_unplaceable_base():
    """base-1 = 200: one row's 200 segments three times over exceed a
    block's shared memory; ValueError before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dig, ab = random_ks_inputs(2, 3, 1, 200, 8, seed=200)
    launches = tpk.tlwe_keyswitch_sum.launches
    with pytest.raises(ValueError, match="shared memory"):
        tpk.tlwe_keyswitch_sum(torch.from_numpy(dig).cuda(),
                               to_tensor(ab, "cuda"))
    assert tpk.tlwe_keyswitch_sum.launches == launches


@pytest.mark.gpu
def test_cuda_int8_keyswitch_matches_no_precomp():
    """`keyswitch_mxu` through `torch._int_mm` (padded: batch 5 < 17,
    n_out 13 not a multiple of 8) equals `keyswitch_no_precomp`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mosfhet_torch import tlwe
    gen = torch.Generator(device="cuda").manual_seed(3)
    in_key = tlwe.new_binary_key(100, 2.0**-30, gen, "cuda")
    out_key = tlwe.new_binary_key(13, 2.0**-30, gen, "cuda")
    ksk = tlwe.new_ks_key_no_precomp(out_key, in_key, 5, 3, gen, "cuda")
    c = tlwe.encrypt(torch.arange(5, device="cuda") << 59, in_key, gen)
    want = tlwe.keyswitch_no_precomp(c, ksk)
    got = tlwe.keyswitch_mxu(c, tlwe.prepare_ks_key_mxu(ksk))
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)


def random_residues(rng, shape, primes):
    """Random canonical residues [..., P, N] of ``primes`` as u32."""
    p = np.array(primes, np.uint64)[:, None]
    return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64)
            % p).astype(np.uint32)


def random_exponents(rng, B, G, M, N):
    """Exponents [B, G, M] in [0, 2N] with 0, N and 2N present."""
    rot = rng.integers(0, 2 * N + 1, size=(B, G, M), dtype=np.int32)
    rot[0, 0, 0], rot[-1, -1, -1], rot[0, -1, M // 2] = 0, 2 * N, N
    return rot


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,G,B", [
    (2048, 1, 4, 9, 2, 5),     # TFHEpp-L2 widths
    (256, 2, 3, 8, 3, 3),      # k=2
    (2048, 1, 1, 23, 2, 7),    # SET_2 digits: four primes
])
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_cuda_ext_product_apply_matches_plain(N, k, l, Bg_bit, G, B, per_row):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    C, J = k + 1, (k + 1) * l
    primes = ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, k))
    rng = np.random.default_rng(N + G + per_row)
    acc0 = rng.integers(0, 1 << 64, size=(B, C, N), dtype=np.uint64)
    rows = (G, B) if per_row else (G,)
    sa = random_residues(rng, rows + (J, C, len(primes), N), primes)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), as_i32(sa, "cuda"), kp, per_row)
    launches = tpk.ext_product_apply_scan.launches
    got = tpk.ext_product_apply_scan(*args)
    torch.cuda.synchronize()
    assert tpk.ext_product_apply_scan.launches == launches + 1
    assert torch.equal(got, tpk.ext_product_apply_scan_plain(*args))


def random_unfolded_inputs(N, k, l, Bg_bit, u, G, B, seed):
    """Random accumulators, exponents and key products su [G, 2^u, J, C, N]
    (u64 words), on the card."""
    C, J, M = k + 1, (k + 1) * l, 1 << u
    primes = ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, k))
    rng = np.random.default_rng(seed)
    acc0 = rng.integers(0, 1 << 64, size=(B, C, N), dtype=np.uint64)
    su = rng.integers(0, 1 << 64, size=(G, M, J, C, N), dtype=np.uint64)
    rot = random_exponents(rng, B, G, M, N)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    return (to_tensor(acc0, "cuda"), torch.from_numpy(rot).cuda(),
            to_tensor(su, "cuda"), kp)


UNFOLDED_CASES = [
    (2048, 1, 4, 9, 2, 2, 3),     # TFHEpp-L2 widths, u = 2, 4, 8
    (2048, 1, 4, 9, 4, 2, 3),
    (2048, 1, 4, 9, 8, 1, 3),
    (256, 2, 3, 8, 3, 2, 2),      # k=2
    (2048, 1, 1, 23, 4, 2, 2),    # four primes
]


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,u,G,B", UNFOLDED_CASES)
def test_cuda_unfolded_rotate_matches_plain(N, k, l, Bg_bit, u, G, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    acc0, rot, su, kp = random_unfolded_inputs(N, k, l, Bg_bit, u, G, B,
                                               seed=N + u)
    launches = tpk.unfolded_rotate.launches
    got = tpk.unfolded_rotate(acc0, rot, su, kp)
    torch.cuda.synchronize()
    assert tpk.unfolded_rotate.launches == launches + 1
    assert torch.equal(got, tpk.unfolded_rotate_plain(acc0, rot, su, kp))


# K5 at batches, by word width: one ciphertext, a tile less one, a tile (8
# ciphertexts with u64 words, 2 with u32 at N = 2048), a tile plus one and
# 64, at TFHEpp-L2 widths (u64) and L2_32 widths (u32), u=4
UBR_BATCHES = {bits: sorted({1, tb - 1, tb, tb + 1, 64})
               for bits, tb in tpk.UBR_TILE.items()}
UBR_BATCH_CASES = [(2048, 1, 4, 9, 4, 1, B) for B in UBR_BATCHES[64]]


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,u,G,B",
                         UNFOLDED_CASES + UBR_BATCH_CASES)
def test_cuda_ubr_phase1_matches_plain(N, k, l, Bg_bit, u, G, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, rot, su, kp = random_unfolded_inputs(N, k, l, Bg_bit, u, G, B,
                                            seed=N + u + 1)
    launches = tpk.ubr_phase1_combine.launches
    got = tpk.ubr_phase1_combine(su, rot, kp)
    torch.cuda.synchronize()
    assert tpk.ubr_phase1_combine.launches == launches + 1
    assert torch.equal(got, tpk.ubr_phase1_combine_plain(su, rot, kp))


def random_ks_keyset(rng, N, k, t, base_bit, G):
    """Random keyset residues [G, k t, k+1, P, N] (u32) under the key-switch
    plan's primes, and those primes."""
    primes = ntt.primes_for_bound(ntt.conv_bound(N, 1 << (base_bit - 1),
                                                 k * t * t))
    return primes, random_residues(rng, (G, k * t, k + 1, len(primes), N),
                                   primes)


def auto_ks_args(N, k, t, base_bit, G, B, bits, seed):
    """K6's arguments: random words of the width (u32 words as int32 at
    bits 32), a random keyset of G entries under the key-switch plan's
    primes (L2_32's two at bits 32), kidx 0 and G-1 present, ginv random
    with 1 and 2N-1 present; the plan last."""
    rng = np.random.default_rng(seed)
    if bits == 32:
        primes = PRIMES_32
        ak = random_residues(rng, (G, k * t, k + 1, len(primes), N), primes)
    else:
        primes, ak = random_ks_keyset(rng, N, k, t, base_bit, G)
    x = rng.integers(0, 1 << bits, size=(B, k + 1, N), dtype=np.uint64)
    kidx = rng.integers(0, G, size=B, dtype=np.int32)
    kidx[0], kidx[-1] = 0, G - 1
    ginv = (rng.integers(0, N, size=B, dtype=np.int32) * 2 + 1)
    ginv[:2] = [1, 2 * N - 1][:B]
    kp = tpk.get_kernel_plan(N, primes, t, base_bit, k, "cuda", bits)
    words = (as_i32(x.astype(np.uint32), "cuda") if bits == 32
             else to_tensor(x, "cuda"))
    return (words, as_i32(ak, "cuda"), torch.from_numpy(kidx).cuda(),
            torch.from_numpy(ginv).cuda(), kp)


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,t,base_bit,G,B,bits", [
    (2048, 1, 4, 9, 16, 6, 64),     # TFHEpp-L2 widths, a cut keyset
    (256, 2, 3, 8, 5, 4, 64),       # k=2
    (128, 1, 2, 10, 128, 3, 64),    # the GA tests' widths, the whole keyset
    (2048, 1, 1, 23, 4, 3, 64),     # SET_2 digits: four primes
    (4096, 1, 1, 22, 4, 3, 64),     # SET_3 widths: x read in place
    (4096, 1, 1, 22, 64, 133, 64),  # SET_3, four primes, B past one wave
    # ragged batches around the resident blocks (264 at L2, 396 at L2_32)
    (2048, 1, 4, 9, 64, 1, 64), (2048, 1, 4, 9, 64, 263, 64),
    (2048, 1, 4, 9, 64, 265, 64), (2048, 1, 4, 9, 64, 529, 64),
    (2048, 1, 3, 7, 64, 1, 32), (2048, 1, 3, 7, 64, 263, 32),
    (2048, 1, 3, 7, 64, 265, 32), (2048, 1, 3, 7, 64, 529, 32),
    # the relinearization key (t=2, base_bit=20): four primes at N=2048
    (2048, 1, 2, 20, 1, 1, 64), (2048, 1, 2, 20, 1, 512, 64),
])
def test_cuda_auto_keyswitch_matches_plain(N, k, t, base_bit, G, B, bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = auto_ks_args(N, k, t, base_bit, G, B, bits, seed=N + G)
    launches = tpk.auto_keyswitch_stream.launches
    got = tpk.auto_keyswitch_stream(*args)
    torch.cuda.synchronize()
    assert tpk.auto_keyswitch_stream.launches == launches + 1
    assert got.dtype == args[0].dtype
    assert torch.equal(got, tpk.auto_keyswitch_stream_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,n,B", [
    (2048, 1, 4, 9, 3, 4),      # TFHEpp-L2 widths, n cut to 3
    (256, 2, 3, 8, 2, 3),       # k=2
    (128, 1, 2, 10, 4, 5),      # the GA tests' widths
    (256, 1, 1, 18, 2, 3),      # four primes for the product, three for KS
])
def test_cuda_ga_scan_matches_plain(N, k, l, Bg_bit, n, B):
    """The whole keyset (G = N), generators 1 and 2N-1 present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch.bootstrap_ga import inverse_mod_2n_table
    primes, acc0, _, sv, svs = random_rotation_inputs(N, k, l, Bg_bit, n, B,
                                                      seed=N + n)
    rng = np.random.default_rng(N + l)
    ks_primes, ak = random_ks_keyset(rng, N, k, l, Bg_bit, N)
    gens = rng.integers(0, N, size=(n, B), dtype=np.int32) * 2 + 1
    gens[0, 0], gens[-1, -1] = 1, 2 * N - 1
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    kp_ks = tpk.get_kernel_plan(N, ks_primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(gens).cuda(),
            as_i32(sv, "cuda"), as_i32(svs, "cuda"), as_i32(ak, "cuda"),
            torch.from_numpy(inverse_mod_2n_table(N)).cuda(), kp, kp_ks)
    launches = tpk.ga_scan_fused.launches
    got = tpk.ga_scan_fused(*args)
    torch.cuda.synchronize()
    assert tpk.ga_scan_fused.launches == launches + 1
    assert torch.equal(got, tpk.ga_scan_fused_plain(*args))


L2_SPLIT = (2048, 1, 4, 9)     # TFHEpp-L2 widths: J = 8 key rows


@pytest.mark.gpu
@pytest.mark.parametrize("j0,j_local", [(0, 4), (4, 4), (6, 2)],
                         ids=["m2_first", "m2_second", "m4_last"])
def test_cuda_partial_step_matches_plain(j0, j_local):
    """K8a over the global key rows [j0, j0 + j_local) of J = 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, k, l, Bg_bit = L2_SPLIT
    B = 5
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, 1, B, seed=90 + j0)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int[0]).cuda(), j0,
            as_i32(keyv[0, :j_local].copy(), "cuda"),
            as_i32(keyvs[0, :j_local].copy(), "cuda"), kp)
    launches = tpk.partial_step.launches
    got = tpk.partial_step(*args)
    torch.cuda.synchronize()
    assert tpk.partial_step.launches == launches + 1
    assert torch.equal(got, tpk.partial_step_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 8])
def test_cuda_finish_step_matches_plain(m):
    """K8b on the partials of m shards; the largest residues present, so
    the sum reaches m (p - 1) (beyond 2^32 at m = 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, k, l, Bg_bit = L2_SPLIT
    B = 5
    primes = ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, k))
    rng = np.random.default_rng(100 + m)
    acc0 = to_tensor(rng.integers(0, 1 << 64, size=(B, k + 1, N),
                                  dtype=np.uint64), "cuda")
    parts = random_residues(rng, (m, B, k + 1, len(primes), N), primes)
    parts[:, 0, 0, :, 0] = np.array(primes, np.uint32) - 1
    parts = as_i32(parts, "cuda")
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    want = tpk.finish_step_plain(acc0.clone(), parts, kp)
    acc = acc0.clone()
    launches = tpk.finish_step.launches
    got = tpk.finish_step(acc, parts, kp)
    torch.cuda.synchronize()
    assert tpk.finish_step.launches == launches + 1
    assert got is acc and torch.equal(got, want)


def _mesh_case(n, B, seed):
    """A random unfold=1 key at L2 widths with its depth cut to n, random
    ciphertexts and a random LUT, on the card."""
    from mosfhet_torch import bootstrap, trlwe
    from mosfhet_torch.tlwe import TLWE
    N, k, l, Bg_bit = L2_SPLIT
    primes, _, _, keyv, keyvs = random_rotation_inputs(N, k, l, Bg_bit, n, 1,
                                                       seed=seed)
    bk = bootstrap.BootstrapKey(as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"),
                                n, k, N, l, Bg_bit, primes)
    rng = np.random.default_rng(seed)
    c = TLWE(a=to_tensor(rng.integers(0, 1 << 64, size=(B, n),
                                      dtype=np.uint64), "cuda"),
             b=to_tensor(rng.integers(0, 1 << 64, size=B, dtype=np.uint64),
                         "cuda"))
    tv = trlwe.torus_packing(to_tensor(rng.integers(
        0, 1 << 64, size=4, dtype=np.uint64), "cuda"), k, N)
    return bk, tv, c


@pytest.mark.gpu
def test_cuda_pbs_on_mesh_one_card():
    """A (1, 2) mesh of the one card, n cut to 6: 12 K8a and 6 K8b
    launches, the words of the single-device bootstrap (K1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import bootstrap
    from mosfhet_torch.parallel import mesh
    n, B = 6, 4
    bk, tv, c = _mesh_case(n, B, seed=110)
    want = bootstrap.functional_bootstrap(tv, c, bk, 4)
    run = mesh.pbs_on_mesh(mesh.make_mesh([torch.device("cuda")] * 2,
                                          data=1, model=2), bk, 4)
    before = (tpk.partial_step.launches, tpk.finish_step.launches)
    got = run(tv, c)
    torch.cuda.synchronize()
    assert (tpk.partial_step.launches - before[0],
            tpk.finish_step.launches - before[1]) == (2 * n, n)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)


@pytest.mark.gpu
@pytest.mark.parametrize("split", ["data", "model"])
def test_cuda_pbs_on_mesh_across_cards(split):
    """Every card as one shard, of the batch or of the key's rows (a model
    size that divides J = 8): the words of the single-device bootstrap."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from mosfhet_torch import bootstrap
    from mosfhet_torch.parallel import mesh
    count = torch.cuda.device_count()
    n_dev = count if split == "data" else max(
        d for d in (2, 4, 8) if d <= count)
    n, B = 6, 2 * n_dev
    bk, tv, c = _mesh_case(n, B, seed=120)
    want = bootstrap.functional_bootstrap(tv, c, bk, 4)
    m = mesh.make_mesh([torch.device("cuda", i) for i in range(n_dev)],
                       model=1 if split == "data" else n_dev)
    got = mesh.pbs_on_mesh(m, bk, 4)(tv, c)
    torch.cuda.synchronize()
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)


# --- SET_3 (N=4096, 4 primes) and N=8192: buffers beyond shared memory ----

SET3 = (4096, 1, 1, 22)        # params.SET_3's bootstrap digits: P = 4


@pytest.mark.gpu
@pytest.mark.parametrize("N,n,B", [(4096, 2, 3), (8192, 2, 2)],
                         ids=["set3", "n8192"])
def test_cuda_kernel_matches_plain_beyond_shared_memory(N, n, B):
    """K1 with acc updated in place (SET_3) or its spectra in the global
    workspace (N=8192)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, k, l, Bg_bit = SET3
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=N + 3)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    assert kp.P == 4
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int).cuda(),
            as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"), kp)
    launches = tpk.blind_rotate_scan.launches
    got = tpk.blind_rotate_scan(*args)
    torch.cuda.synchronize()
    assert tpk.blind_rotate_scan.launches == launches + 1
    assert torch.equal(got, tpk.blind_rotate_scan_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_cuda_ext_product_apply_matches_plain_set3(per_row):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, k, l, Bg_bit = SET3
    G, B, C, J = 2, 3, k + 1, (k + 1) * l
    primes = ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, k))
    rng = np.random.default_rng(43 + per_row)
    acc0 = rng.integers(0, 1 << 64, size=(B, C, N), dtype=np.uint64)
    rows = (G, B) if per_row else (G,)
    sa = random_residues(rng, rows + (J, C, len(primes), N), primes)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), as_i32(sa, "cuda"), kp, per_row)
    launches = tpk.ext_product_apply_scan.launches
    got = tpk.ext_product_apply_scan(*args)
    torch.cuda.synchronize()
    assert tpk.ext_product_apply_scan.launches == launches + 1
    assert torch.equal(got, tpk.ext_product_apply_scan_plain(*args))


@pytest.mark.gpu
def test_cuda_unfolded_rotate_matches_plain_set3():
    """u=2: the spectra in the workspace, the key row and acc shared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    acc0, rot, su, kp = random_unfolded_inputs(*SET3, 2, 2, 3, seed=44)
    launches = tpk.unfolded_rotate.launches
    got = tpk.unfolded_rotate(acc0, rot, su, kp)
    torch.cuda.synchronize()
    assert tpk.unfolded_rotate.launches == launches + 1
    assert torch.equal(got, tpk.unfolded_rotate_plain(acc0, rot, su, kp))


@pytest.mark.gpu
def test_cuda_ga_scan_matches_plain_set3():
    """perm in the workspace, acc in place; a keyset of 8 entries (odd
    generators below 16, 1 and 15 present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch.bootstrap_ga import inverse_mod_2n_table
    N, k, l, Bg_bit = SET3
    n, B, G = 2, 3, 8
    primes, acc0, _, sv, svs = random_rotation_inputs(N, k, l, Bg_bit, n, B,
                                                      seed=45)
    rng = np.random.default_rng(46)
    ks_primes, ak = random_ks_keyset(rng, N, k, l, Bg_bit, G)
    gens = rng.integers(0, G, size=(n, B), dtype=np.int32) * 2 + 1
    gens[0, 0], gens[-1, -1] = 1, 2 * G - 1
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    kp_ks = tpk.get_kernel_plan(N, ks_primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(gens).cuda(),
            as_i32(sv, "cuda"), as_i32(svs, "cuda"), as_i32(ak, "cuda"),
            torch.from_numpy(inverse_mod_2n_table(N)).cuda(), kp, kp_ks)
    launches = tpk.ga_scan_fused.launches
    got = tpk.ga_scan_fused(*args)
    torch.cuda.synchronize()
    assert tpk.ga_scan_fused.launches == launches + 1
    assert torch.equal(got, tpk.ga_scan_fused_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("j0,j_local", [(0, 2), (1, 1)],
                         ids=["m1", "m2_second"])
def test_cuda_partial_step_matches_plain_set3(j0, j_local):
    """K8a with its rotation buffer in the workspace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, k, l, Bg_bit = SET3
    B = 3
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, 1, B, seed=47 + j0)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int[0]).cuda(), j0,
            as_i32(keyv[0, j0:j0 + j_local].copy(), "cuda"),
            as_i32(keyvs[0, j0:j0 + j_local].copy(), "cuda"), kp)
    launches = tpk.partial_step.launches
    got = tpk.partial_step(*args)
    torch.cuda.synchronize()
    assert tpk.partial_step.launches == launches + 1
    assert torch.equal(got, tpk.partial_step_plain(*args))


@pytest.mark.gpu
def test_cuda_unplaceable_shape_raises_before_launch():
    """N=32768 with 4 primes: a row's N/16 threads exceed a block (K1 takes
    N up to 16384), so the wrapper raises ValueError and launches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    N, k, l, Bg_bit = 32768, 1, 1, 22
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, 1, 1, seed=48)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    assert kp.P == 4
    launches = tpk.blind_rotate_scan.launches
    with pytest.raises(ValueError, match="16384"):
        tpk.blind_rotate_scan(to_tensor(acc0, "cuda"),
                              torch.from_numpy(a_int).cuda(),
                              as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"), kp)
    assert tpk.blind_rotate_scan.launches == launches


# --- K1 and K1-step on batches ragged against their residency -------------

# (N, l, Bg_bit, torus bits): TFHEpp-L2 (two blocks per SM, 264 on the
# card), L2_32 (three per SM, 396); SET_3 (one per SM, acc in place) and
# N=8192 (spectra in the workspace) with SET_3's digits
ROTATION_WIDTHS = {"l2": (2048, 4, 9, 64), "l2_32": (2048, 3, 7, 32),
                   "set3": (4096, 1, 22, 64), "n8192": (8192, 1, 22, 64)}


def _rotation_case(name, B, n, seed):
    N, l, Bg_bit, bits = ROTATION_WIDTHS[name]
    primes = PRIMES_32 if bits == 32 else None
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, 1, l, Bg_bit, n, B, seed, primes=primes, torus_bits=bits)
    a_int[0, :3] = [0, N, 2 * N][:B]
    a_int[-1, -3:] = [N, 0, 2 * N][-B:]
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cuda", bits)
    return kp, (to_tensor(acc0, "cuda"), torch.from_numpy(a_int).cuda(),
                as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 131, 133, 263, 265, 512, 513])
@pytest.mark.parametrize("name", ["l2", "l2_32"])
def test_cuda_rotation_ragged_batches_match_plain(name, B):
    """K1 over two steps and K1-step over each, exponents 0, N and 2N
    present, on batches around the card's resident blocks (132 SMs), the
    plain versions' words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, (acc, a, kv, ks) = _rotation_case(name, B, 2, seed=600 + B)
    launches = (tpk.blind_rotate_scan.launches, tpk.pbs_step.launches)
    got = tpk.blind_rotate_scan(acc, a, kv, ks, kp)
    steps = acc.clone()
    for i in range(2):
        tpk.pbs_step(steps, a[i], kv[i], ks[i], kp)
    torch.cuda.synchronize()
    assert (tpk.blind_rotate_scan.launches - launches[0],
            tpk.pbs_step.launches - launches[1]) == (1, 2)
    want = tpk.blind_rotate_scan_plain(acc, a, kv, ks, kp)
    assert got.dtype == acc.dtype and torch.equal(got, want)
    assert torch.equal(steps, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B", [("set3", 133), ("n8192", 5)])
def test_cuda_rotation_beyond_shared_memory_matches_plain(name, B):
    """K1 and K1-step at SET_3 (one block per SM, acc in place) and N=8192
    (spectra in the workspace), depth cut to two steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, (acc, a, kv, ks) = _rotation_case(name, B, 2, seed=610 + B)
    got = tpk.blind_rotate_scan(acc, a, kv, ks, kp)
    steps = acc.clone()
    for i in range(2):
        tpk.pbs_step(steps, a[i], kv[i], ks[i], kp)
    torch.cuda.synchronize()
    want = tpk.blind_rotate_scan_plain(acc, a, kv, ks, kp)
    assert torch.equal(got, want) and torch.equal(steps, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ROTATION_WIDTHS))
def test_cuda_rotation_residency(name):
    """The blocks the card keeps resident per SM: two at L2, three at
    L2_32, one at SET_3 and N=8192 (1,024 threads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, _ = _rotation_case(name, 1, 1, seed=620)
    want = {"l2": (2, 384), "l2_32": (3, 256), "set3": (1, 1024),
            "n8192": (1, 1024)}[name]
    for step in (False, True):
        assert tpk.rotation_residency(kp, kp.torus_bits, step) == want


@pytest.mark.gpu
def test_cuda_rotation_refuses_a_misaligned_key():
    """K1 reads key rows 16 bytes at a time: a key view that starts off a
    16-byte boundary raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, (acc, a, kv, ks) = _rotation_case("l2", 2, 1, seed=630)
    shifted = torch.empty(kv.numel() + 1, dtype=torch.int32,
                          device="cuda")[1:].view(kv.shape)
    shifted.copy_(kv)
    launches = tpk.blind_rotate_scan.launches
    with pytest.raises(ValueError, match="16-byte"):
        tpk.blind_rotate_scan(acc, a, shifted, ks, kp)
    assert tpk.blind_rotate_scan.launches == launches


# --- the one-limb (32-bit torus) forms of K3, K4, K5, K8a and K8b ----------

L2_32_DIGITS = (2048, 1, 3, 7)     # L2_32's bootstrap digits: J = 6, P = 2


def _words32(rng, *shape):
    """Random u32 torus words as an int32 tensor on the card."""
    return as_i32(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                  .astype(np.uint32), "cuda")


def _plan32():
    N, k, l, Bg_bit = L2_32_DIGITS
    return tpk.get_kernel_plan(N, PRIMES_32, l, Bg_bit, k, "cuda", 32)


@pytest.mark.gpu
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_cuda_ext_product_apply_matches_plain_torus32(per_row):
    """K3's one-limb form at L2_32 widths, G=2, B=5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = _plan32()
    G, B = 2, 5
    rng = np.random.default_rng(320 + per_row)
    rows = (G, B) if per_row else (G,)
    sa = random_residues(rng, rows + (kp.J, kp.C, kp.P, kp.N), PRIMES_32)
    args = (_words32(rng, B, kp.C, kp.N), as_i32(sa, "cuda"), kp, per_row)
    launches = tpk.ext_product_apply_scan.launches
    got = tpk.ext_product_apply_scan(*args)
    torch.cuda.synchronize()
    assert tpk.ext_product_apply_scan.launches == launches + 1
    want = tpk.ext_product_apply_scan_plain(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("u,G,B", [(2, 2, 3), (4, 2, 3)] + [
    (4, 1, B) for B in UBR_BATCHES[32]])
def test_cuda_unfolded_kernels_match_plain_torus32(u, G, B):
    """K4 and K5's one-limb forms at L2_32 widths: u32 key products summed
    mod 2^32, exponents 0, N and 2N present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = _plan32()
    M = 1 << u
    rng = np.random.default_rng(330 + u)
    acc0 = _words32(rng, B, kp.C, kp.N)
    su = _words32(rng, G, M, kp.J, kp.C, kp.N)
    rot = torch.from_numpy(random_exponents(rng, B, G, M, kp.N)).cuda()
    launches = (tpk.unfolded_rotate.launches, tpk.ubr_phase1_combine.launches)
    got4 = tpk.unfolded_rotate(acc0, rot, su, kp)
    got5 = tpk.ubr_phase1_combine(su, rot, kp)
    torch.cuda.synchronize()
    assert (tpk.unfolded_rotate.launches,
            tpk.ubr_phase1_combine.launches) == (launches[0] + 1,
                                                 launches[1] + 1)
    assert got4.dtype == torch.int32
    assert torch.equal(got4, tpk.unfolded_rotate_plain(acc0, rot, su, kp))
    assert torch.equal(got5, tpk.ubr_phase1_combine_plain(su, rot, kp))


@pytest.mark.gpu
@pytest.mark.parametrize("j0", [0, 3], ids=["first", "mid"])
def test_cuda_partial_step_matches_plain_torus32(j0):
    """K8a's one-limb form over rows [j0, j0 + 3) of L2_32's J = 6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, k, l, Bg_bit = L2_32_DIGITS
    B, jl = 5, 3
    _, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, 1, B, seed=340 + j0, primes=PRIMES_32,
        torus_bits=32)
    kp = _plan32()
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int[0]).cuda(), j0,
            as_i32(keyv[0, j0:j0 + jl].copy(), "cuda"),
            as_i32(keyvs[0, j0:j0 + jl].copy(), "cuda"), kp)
    launches = tpk.partial_step.launches
    got = tpk.partial_step(*args)
    torch.cuda.synchronize()
    assert tpk.partial_step.launches == launches + 1
    assert torch.equal(got, tpk.partial_step_plain(*args))


def _finish_case(kp, m, B, seed, torus_bits):
    """Random accumulators of the width and m random partials with the
    largest residues present, on the card."""
    rng = np.random.default_rng(seed)
    acc0 = rng.integers(0, 1 << torus_bits, size=(B, kp.C, kp.N),
                        dtype=np.uint64)
    acc0 = to_tensor(acc0.astype(np.uint32) if torus_bits == 32 else acc0,
                     "cuda")
    parts = random_residues(rng, (m, B, kp.C, kp.P, kp.N), kp.primes)
    parts[:, 0, 0, :, 0] = np.array(kp.primes, np.uint32) - 1
    return acc0, as_i32(parts, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 4])
def test_cuda_finish_step_matches_plain_torus32(m):
    """K8b's one-limb form at L2_32 widths on the partials of m shards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = _plan32()
    acc0, parts = _finish_case(kp, m, 5, 350 + m, 32)
    want = tpk.finish_step_plain(acc0.clone(), parts, kp)
    acc = acc0.clone()
    launches = tpk.finish_step.launches
    got = tpk.finish_step(acc, parts, kp)
    torch.cuda.synchronize()
    assert tpk.finish_step.launches == launches + 1
    assert got is acc and got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 4])
def test_cuda_finish_step_matches_plain_n8192(m):
    """K8b at N=8192 with 4 primes (64-bit torus): its 256 KiB of spectra
    exceed a block, so it runs one pass per component on 128 KiB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, k, l, Bg_bit = 8192, 1, 1, 22
    primes = ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, k))
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    assert kp.P == 4
    acc0, parts = _finish_case(kp, m, 4, 360 + m, 64)
    want = tpk.finish_step_plain(acc0.clone(), parts, kp)
    acc = acc0.clone()
    launches = tpk.finish_step.launches
    got = tpk.finish_step(acc, parts, kp)
    torch.cuda.synchronize()
    assert tpk.finish_step.launches == launches + 1
    assert got is acc and torch.equal(got, want)


# --- K6 and K7 one-limb; K1-delta and K6-old --------------------------------

# L2_32's GA key switch: t = l = 3 digits of base_bit = Bg_bit = 7 bits,
# whose k t^2 budget at the 32-bit torus takes the same 2 primes
L2_32_KS = (2048, 1, 3, 7)


def _ks_plan32():
    N, k, t, base_bit = L2_32_KS
    return tpk.get_kernel_plan(N, PRIMES_32, t, base_bit, k, "cuda", 32)


@pytest.mark.gpu
@pytest.mark.parametrize("ginv_mode", ["one", "minus_one", "random"])
def test_cuda_auto_keyswitch_matches_plain_torus32(ginv_mode):
    """K6's one-limb form at L2_32 widths on the whole 2048-entry keyset
    (kidx 0 and G-1 present): ginv 1 (a TRLWE key switch), 2N-1, or random
    per row; words 0x80000000 (negated to themselves) present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = _ks_plan32()
    N, G, B = kp.N, kp.N, 6
    rng = np.random.default_rng(370 + len(ginv_mode))
    ak = random_residues(rng, (G, kp.l, kp.C, kp.P, N), PRIMES_32)
    x = _words32(rng, B, kp.C, N)
    x[0, 0, :4] = torch.tensor([-(1 << 31), 0, -1, 1], dtype=torch.int32)
    kidx = rng.integers(0, G, size=B, dtype=np.int32)
    kidx[0], kidx[-1] = 0, G - 1
    ginv = {"one": np.ones(B, np.int32),
            "minus_one": np.full(B, 2 * N - 1, np.int32),
            "random": rng.integers(0, N, size=B, dtype=np.int32) * 2 + 1}[
        ginv_mode]
    args = (x, as_i32(ak, "cuda"), torch.from_numpy(kidx).cuda(),
            torch.from_numpy(ginv).cuda(), kp)
    launches = tpk.auto_keyswitch_stream.launches
    got = tpk.auto_keyswitch_stream(*args)
    torch.cuda.synchronize()
    assert tpk.auto_keyswitch_stream.launches == launches + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, tpk.auto_keyswitch_stream_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("gen_mode", ["one", "minus_one", "random"])
def test_cuda_ga_scan_matches_plain_torus32(gen_mode):
    """K7's one-limb form at L2_32 widths (P = 2 for the product and the
    key switch), n cut to 3, B=4, the whole keyset; every generator 1,
    every 2N-1, or random with both present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch.bootstrap_ga import inverse_mod_2n_table
    N, k, l, Bg_bit = L2_32_DIGITS
    n, B = 3, 4
    _, acc0, _, sv, svs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=380 + len(gen_mode), primes=PRIMES_32,
        torus_bits=32)
    kp, kp_ks = _plan32(), _ks_plan32()
    rng = np.random.default_rng(390 + len(gen_mode))
    ak = random_residues(rng, (N, kp_ks.l, kp.C, kp_ks.P, N), PRIMES_32)
    gens = {"one": np.ones((n, B), np.int32),
            "minus_one": np.full((n, B), 2 * N - 1, np.int32),
            "random": rng.integers(0, N, size=(n, B), dtype=np.int32) * 2
            + 1}[gen_mode]
    if gen_mode == "random":
        gens[0, 0], gens[-1, -1] = 1, 2 * N - 1
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(gens).cuda(),
            as_i32(sv, "cuda"), as_i32(svs, "cuda"), as_i32(ak, "cuda"),
            torch.from_numpy(inverse_mod_2n_table(N)).cuda(), kp, kp_ks)
    launches = tpk.ga_scan_fused.launches
    got = tpk.ga_scan_fused(*args)
    torch.cuda.synchronize()
    assert tpk.ga_scan_fused.launches == launches + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, tpk.ga_scan_fused_plain(*args))


def cmux_delta_args(N, l, Bg_bit, B, seed):
    """K1-delta's arguments (64-bit): one random TRGSW and its Shoup
    companions over B random rows, words with a carry from the offset into
    the high half present; the plan last."""
    primes, acc0, _, keyv, keyvs = random_rotation_inputs(
        N, 1, l, Bg_bit, 1, B, seed)
    acc0[0, 0, :3] = [(1 << 64) - 1, 1 << 63, 0xFFFFFFFF]
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cuda")
    return (to_tensor(acc0, "cuda"), as_i32(keyv[0], "cuda"),
            as_i32(keyvs[0], "cuda"), kp)


@pytest.mark.gpu
@pytest.mark.parametrize("N,l,Bg_bit,B", [
    (2048, 4, 9, 5),      # TFHEpp-L2 widths
    (4096, 1, 22, 3),     # SET_3 widths: 4 primes
    (8192, 1, 22, 2),     # 4 primes at N=8192: the spectra in the workspace
    # ragged batches around the resident blocks (two of 384 per SM: 264)
    (2048, 4, 9, 1), (2048, 4, 9, 263), (2048, 4, 9, 265), (2048, 4, 9, 529),
])
def test_cuda_cmux_delta_matches_plain(N, l, Bg_bit, B):
    """K1-delta against its plain version, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = cmux_delta_args(N, l, Bg_bit, B, seed=400 + N)
    launches = tpk.cmux_delta.launches
    got = tpk.cmux_delta(*args)
    torch.cuda.synchronize()
    assert tpk.cmux_delta.launches == launches + 1
    assert torch.equal(got, tpk.cmux_delta_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,t,base_bit,B,bits", [
    (2048, 1, 4, 9, 5, 64),         # TFHEpp-L2 widths (t=4, base_bit=9)
    (2048, 1, 3, 7, 5, 32),         # L2_32 widths (t=3, base_bit=7)
    (4096, 1, 1, 22, 133, 64),      # SET_3, four primes: perm read in place
    # ragged batches around the resident blocks (two of 384 per SM: 264)
    (2048, 1, 4, 9, 1, 64), (2048, 1, 4, 9, 263, 64),
    (2048, 1, 4, 9, 265, 64), (2048, 1, 4, 9, 529, 64),
])
def test_cuda_auto_keyswitch_gathered_matches_plain(N, k, t, base_bit, B,
                                                    bits):
    """K6-old: B permuted rows, one random keyset entry each, against its
    plain version, and K6's kernel on those rows as a keyset with entry b
    for row b and ginv 1, which K6-old launches: the same words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    perm, rows, _, _, kp = auto_ks_args(N, k, t, base_bit, B, B, bits,
                                        seed=410 + N + B + bits)
    args = (perm, rows, kp)
    launches = tpk.auto_keyswitch.launches
    got = tpk.auto_keyswitch(*args)
    torch.cuda.synchronize()
    assert tpk.auto_keyswitch.launches == launches + 1
    assert got.dtype == perm.dtype
    assert torch.equal(got, tpk.auto_keyswitch_plain(*args))
    ones = torch.ones(B, dtype=torch.int32, device="cuda")
    assert torch.equal(got, tpk.auto_keyswitch_stream(
        perm, rows, torch.arange(B, dtype=torch.int32, device="cuda"), ones,
        kp))


# --- K7 on K1's schedule: generators at their extremes, ragged batches ----

# (N, l, Bg_bit, torus bits) of the GA key at TFHEpp-L2 (two blocks per SM,
# 264 on the card) and at L2_32 (three per SM, 396); the key switch takes
# the bootstrap's digits (t = l, base_bit = Bg_bit)
GA_WIDTHS = {"l2": (2048, 4, 9, 64), "l2_32": (2048, 3, 7, 32)}


def _ga_case(name, B, n, gen_mode, seed):
    """K7's plans and arguments at GA_WIDTHS[name] on the whole keyset:
    generators all 1, all 2N-1, or random with both present."""
    from mosfhet_torch.bootstrap_ga import inverse_mod_2n_table
    N, l, Bg_bit, bits = GA_WIDTHS[name]
    primes, acc0, _, sv, svs = random_rotation_inputs(
        N, 1, l, Bg_bit, n, B, seed, primes=PRIMES_32 if bits == 32 else None,
        torus_bits=bits)
    rng = np.random.default_rng(seed + 1)
    if bits == 32:
        ks_primes = PRIMES_32
        ak = random_residues(rng, (N, l, 2, len(ks_primes), N), ks_primes)
    else:
        ks_primes, ak = random_ks_keyset(rng, N, 1, l, Bg_bit, N)
    gens = {"one": np.ones((n, B), np.int32),
            "minus_one": np.full((n, B), 2 * N - 1, np.int32),
            "random": rng.integers(0, N, size=(n, B), dtype=np.int32) * 2
            + 1}[gen_mode]
    if gen_mode == "random":
        gens[0, 0], gens[-1, -1] = 1, 2 * N - 1
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cuda", bits)
    kp_ks = tpk.get_kernel_plan(N, ks_primes, l, Bg_bit, 1, "cuda", bits)
    return kp, kp_ks, (to_tensor(acc0, "cuda"), torch.from_numpy(gens).cuda(),
                       as_i32(sv, "cuda"), as_i32(svs, "cuda"),
                       as_i32(ak, "cuda"),
                       torch.from_numpy(inverse_mod_2n_table(N)).cuda(), kp,
                       kp_ks)


@pytest.mark.gpu
@pytest.mark.parametrize("gen_mode", ["one", "minus_one"])
def test_cuda_ga_scan_matches_plain_at_extreme_generators(gen_mode):
    """K7 at TFHEpp-L2 widths, n cut to 2, B=5: every generator 1 (psi the
    identity, keyset entry 0) or every 2N-1 (every coefficient negated,
    entry N-1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, _, args = _ga_case("l2", 5, 2, gen_mode, seed=700 + len(gen_mode))
    launches = tpk.ga_scan_fused.launches
    got = tpk.ga_scan_fused(*args)
    torch.cuda.synchronize()
    assert tpk.ga_scan_fused.launches == launches + 1
    assert torch.equal(got, tpk.ga_scan_fused_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 263])
@pytest.mark.parametrize("name", sorted(GA_WIDTHS))
def test_cuda_ga_scan_ragged_batches_match_plain(name, B):
    """K7 over two steps on one ciphertext and on 263 (a partial last wave
    at two and at three blocks per SM), random generators with 1 and 2N-1
    present: the plain version's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, _, args = _ga_case(name, B, 2, "random", seed=710 + B)
    got = tpk.ga_scan_fused(*args)
    torch.cuda.synchronize()
    want = tpk.ga_scan_fused_plain(*args)
    assert got.dtype == args[0].dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GA_WIDTHS))
def test_cuda_ga_scan_residency(name):
    """The blocks of K7 the card keeps resident per SM: two of 384 threads
    at L2, three of 256 at L2_32, as K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, l, Bg_bit, bits = GA_WIDTHS[name]
    primes = PRIMES_32 if bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, 1))
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cuda", bits)
    want = {"l2": (2, 384), "l2_32": (3, 256)}[name]
    assert tpk.ga_scan_residency(kp, kp, bits) == want


# --- the one-step kernels K1-step, K3-step and the v1 phase 1 K5-v1 ---------

# (N, k, l, Bg_bit, B, torus bits): TFHEpp-L2; SET_3, whose buffers leave
# shared memory (acc stays in the caller's tensor); L2_32, the one-limb form
STEP_CASES = [(2048, 1, 4, 9, 5, 64), (4096, 1, 1, 22, 3, 64),
              (2048, 1, 3, 7, 5, 32)]
STEP_IDS = ["l2", "set3", "l2_32"]


def _step_plan(N, k, l, Bg_bit, torus_bits):
    primes = PRIMES_32 if torus_bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, k))
    return tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda", torus_bits)


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,B,torus_bits", STEP_CASES,
                         ids=STEP_IDS)
def test_cuda_pbs_step_matches_plain(N, k, l, Bg_bit, B, torus_bits):
    """K1-step: one CMUX step in place, exponents 0, N and 2N present; the
    plain version's words, and K1's over that one step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = _step_plan(N, k, l, Bg_bit, torus_bits)
    _, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, 1, B, seed=500 + N + torus_bits, primes=kp.primes,
        torus_bits=torus_bits)
    a_int[0, :3] = [0, N, 2 * N]
    acc = to_tensor(acc0, "cuda")
    a = torch.from_numpy(a_int[0]).cuda()
    kv, ks = as_i32(keyv[0], "cuda"), as_i32(keyvs[0], "cuda")
    launches = tpk.pbs_step.launches
    got = acc.clone()
    assert tpk.pbs_step(got, a, kv, ks, kp) is got
    torch.cuda.synchronize()
    assert tpk.pbs_step.launches == launches + 1
    assert torch.equal(got, tpk.pbs_step_plain(acc.clone(), a, kv, ks, kp))
    assert torch.equal(got, tpk.blind_rotate_scan(acc, a[None], kv[None],
                                                  ks[None], kp))


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,B,torus_bits", STEP_CASES + [
    # ragged batches around the resident blocks (two of 384 per SM: 264)
    (2048, 1, 4, 9, B, 64) for B in (1, 263, 265, 529)],
    ids=STEP_IDS + [f"l2_b{B}" for B in (1, 263, 265, 529)])
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_cuda_ext_product_apply_step_matches_plain(N, k, l, Bg_bit, B,
                                                   torus_bits, per_row):
    """K3-step: one replace-mode product in place; the plain version's
    words, and K3's with G = 1, whose kernel K3-step launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = _step_plan(N, k, l, Bg_bit, torus_bits)
    rng = np.random.default_rng(510 + N + torus_bits + per_row)
    acc = (_words32(rng, B, kp.C, N) if torus_bits == 32 else to_tensor(
        rng.integers(0, 1 << 64, size=(B, kp.C, N), dtype=np.uint64), "cuda"))
    key = as_i32(random_residues(
        rng, ((B,) if per_row else ()) + (kp.J, kp.C, kp.P, N), kp.primes),
        "cuda")
    launches = tpk.ext_product_apply_step.launches
    got = acc.clone()
    assert tpk.ext_product_apply_step(got, key, kp, per_row) is got
    torch.cuda.synchronize()
    assert tpk.ext_product_apply_step.launches == launches + 1
    assert torch.equal(got, tpk.ext_product_apply_step_plain(
        acc.clone(), key, kp, per_row))
    assert torch.equal(got, tpk.ext_product_apply_scan(acc, key[None], kp,
                                                       per_row))


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,u,G,B", UNFOLDED_CASES + [
    (4096, 1, 1, 22, 2, 3, 2)]       # SET_3 widths: 4 primes, 4 columns
    + UBR_BATCH_CASES)
def test_cuda_ubr_phase1_v1_matches_plain(N, k, l, Bg_bit, u, G, B):
    """K5-v1 on u64 key products: the plain version's words and K5's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, rot, su, kp = random_unfolded_inputs(N, k, l, Bg_bit, u, G, B,
                                            seed=N + u + 2)
    launches = tpk.ubr_phase1_combine_v1.launches
    got = tpk.ubr_phase1_combine_v1(su, rot, kp)
    torch.cuda.synchronize()
    assert tpk.ubr_phase1_combine_v1.launches == launches + 1
    assert torch.equal(got, tpk.ubr_phase1_combine_v1_plain(su, rot, kp))
    assert torch.equal(got, tpk.ubr_phase1_combine(su, rot, kp))


@pytest.mark.gpu
@pytest.mark.parametrize("u,G,B", [(2, 3, 2), (4, 2, 3)] + [
    (4, 1, B) for B in UBR_BATCHES[32]])
def test_cuda_ubr_phase1_v1_matches_plain_torus32(u, G, B):
    """K5-v1's one-limb form at L2_32 widths: u32 key products summed mod
    2^32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp = _plan32()
    M = 1 << u
    rng = np.random.default_rng(520 + u)
    su = _words32(rng, G, M, kp.J, kp.C, kp.N)
    rot = torch.from_numpy(random_exponents(rng, B, G, M, kp.N)).cuda()
    launches = tpk.ubr_phase1_combine_v1.launches
    got = tpk.ubr_phase1_combine_v1(su, rot, kp)
    torch.cuda.synchronize()
    assert tpk.ubr_phase1_combine_v1.launches == launches + 1
    assert torch.equal(got, tpk.ubr_phase1_combine_v1_plain(su, rot, kp))
    assert torch.equal(got, tpk.ubr_phase1_combine(su, rot, kp))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ubr_phase1_combine",
                                  "ubr_phase1_combine_v1"])
def test_cuda_ubr_phase1_row_limit(name, monkeypatch):
    """K5's block holds a ring of key rows, and one exchange row and the
    exponents per ciphertext of its tile, in shared memory: at N = 16384
    one u64 key row fits beside them whatever the prime count (the primes
    share the exchange row), so 2 and 4 primes give the plain version's
    words (and K5-v1's, K5's).  Where not one row fits (a card giving a
    block 120,000 B) the wrapper raises ValueError before any launch, as it
    does for a key that is not 16-byte aligned (TMA copies its rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, M = 16384, 4
    fn = getattr(tpk, name)
    other = (tpk.ubr_phase1_combine_v1 if name == "ubr_phase1_combine"
             else tpk.ubr_phase1_combine)
    rng = np.random.default_rng(530)
    su = to_tensor(rng.integers(0, 1 << 64, size=(1, M, 2, 2, N),
                                dtype=np.uint64), "cuda")
    rot = torch.from_numpy(random_exponents(rng, 1, 1, M, N)).cuda()
    kp4 = tpk.get_kernel_plan(N, ntt.primes_for_bound(
        ntt.external_product_bound(N, 22, 1, 1)), 1, 22, 1, "cuda")
    kp2 = tpk.get_kernel_plan(N, ntt.MASTER_PRIMES[-2:], 1, 22, 1, "cuda")
    assert kp4.P == 4
    for kp in (kp2, kp4):
        launches = fn.launches
        got = fn(su, rot, kp)
        torch.cuda.synchronize()
        assert fn.launches == launches + 1
        assert torch.equal(got, tpk.ubr_phase1_combine_plain(su, rot, kp))
        assert torch.equal(got, other(su, rot, kp))
    launches = fn.launches
    flat = torch.empty(su.numel() + 1, dtype=su.dtype, device="cuda")
    misaligned = flat[1:].view(su.shape)
    misaligned.copy_(su)
    with pytest.raises(ValueError, match="16-byte"):
        fn(misaligned, rot, kp2)
    monkeypatch.setattr(tpk, "_smem_budget", lambda name, index: 120000)
    with pytest.raises(ValueError, match="shared memory"):
        fn(su, rot, kp4)
    assert fn.launches == launches


def _launched(wrappers, call):
    """call()'s result (after a sync) and the launches it added to each
    wrapper."""
    before = [w.launches for w in wrappers]
    out = call()
    torch.cuda.synchronize()
    return out, tuple(w.launches - b for w, b in zip(wrappers, before))


@pytest.mark.gpu
def test_cuda_step_entry_points_launch_their_kernels():
    """At L2 widths, cut depth: `blind_rotate_stepwise` is n K1-step
    launches and no K1, `multivalue_bootstrap_UBR_phase1_v1` one K5-v1
    launch and no K5, `multivalue_bootstrap_UBR_phase2_stepwise` n/u
    K3-step launches and no K3, each giving its fused form's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import bootstrap, trlwe
    from mosfhet_torch.tlwe import TLWE
    n, B, u = 6, 4, 2
    bk, tv, c = _mesh_case(n, B, seed=530)
    got, counts = _launched((tpk.pbs_step, tpk.blind_rotate_scan),
                            lambda: bootstrap.blind_rotate_stepwise(tv, c.a,
                                                                    bk))
    assert counts == (n, 0)
    want = bootstrap.blind_rotate(tv, c.a, bk)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)

    N, k, l, Bg_bit = L2_SPLIT
    _, _, su, kp = random_unfolded_inputs(N, k, l, Bg_bit, u, n // u, 1,
                                          seed=531)
    bku = bootstrap.BootstrapKey(None, None, n, k, N, l, Bg_bit, kp.primes,
                                 su=su, unfolding=u)
    sa, counts = _launched(
        (tpk.ubr_phase1_combine_v1, tpk.ubr_phase1_combine),
        lambda: bootstrap.multivalue_bootstrap_UBR_phase1_v1(c, bku))
    assert counts == (1, 0)
    assert torch.equal(sa.v, bootstrap.multivalue_bootstrap_UBR_phase1(
        c, bku).v)
    one = TLWE(a=c.a[0], b=c.b[0])
    sa1 = bootstrap.multivalue_bootstrap_UBR_phase1(one, bku)
    tvs = trlwe.from_stacked(tv.stacked().expand(3, k + 1, N).contiguous())
    # one ciphertext's cache broadcast over 3 LUTs; one cache per row
    for ct, luts, cache in ((one, tvs, sa1), (c, tv, sa)):
        got, counts = _launched(
            (tpk.ext_product_apply_step, tpk.ext_product_apply_scan),
            lambda: bootstrap.multivalue_bootstrap_UBR_phase2_stepwise(
                luts, ct, cache, bku, 4))
        assert counts == (n // u, 0)
        want = bootstrap.multivalue_bootstrap_UBR_phase2(luts, ct, cache, bku,
                                                         4)
        assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)


# --- K8a and K8b on K1's schedule, at every placement ------------------------

def _tp_parts(kp, m, B, seed):
    """m random partials [m, B, C, P, N] with every prime's top residue
    p - 1 at one word of each (the sum reaches m (p - 1)), on the card."""
    rng = np.random.default_rng(seed)
    parts = random_residues(rng, (m, B, kp.C, kp.P, kp.N), kp.primes)
    parts[:, 0, 0, :, 0] = np.array(kp.primes, np.uint32) - 1
    return as_i32(parts, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(ROTATION_WIDTHS))
def test_cuda_tp_step_matches_plain_at_every_placement(name, m):
    """K8a over the first and the last of m shards' key rows (J // m rows
    each, at least one) and K8b on m partials, exponents 0, N and 2N
    present, at L2, L2_32, SET_3 and N=8192 (K8b one pass per component
    there): the plain versions' words, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B = 2 if name == "n8192" else 5
    kp, (acc, a, kv, ks) = _rotation_case(name, B, 1, seed=900 + m)
    jl = max(1, kp.J // m)
    for j0 in (0, kp.J - jl):
        args = (acc, a[0], j0, kv[0, j0:j0 + jl], ks[0, j0:j0 + jl], kp)
        got, counts = _launched((tpk.partial_step,),
                                lambda: tpk.partial_step(*args))
        assert counts == (1,)
        assert torch.equal(got, tpk.partial_step_plain(*args))
    parts = _tp_parts(kp, m, B, seed=910 + m)
    want = tpk.finish_step_plain(acc.clone(), parts, kp)
    got = acc.clone()
    out, counts = _launched((tpk.finish_step,),
                            lambda: tpk.finish_step(got, parts, kp))
    assert counts == (1,) and out is got and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["l2", "l2_32"])
def test_cuda_split_step_matches_k1_step(name):
    """Two K8a over the halves of the key rows and one K8b on their
    partials: one K1-step's words, exponents 0, N and 2N present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B = 7
    kp, (acc, a, kv, ks) = _rotation_case(name, B, 1, seed=920)
    half = kp.J // 2
    parts = torch.empty((2, B, kp.C, kp.P, kp.N), dtype=torch.int32,
                        device="cuda")
    for sh in range(2):
        rows = slice(sh * half, (sh + 1) * half)
        tpk.partial_step(acc, a[0], sh * half, kv[0, rows], ks[0, rows], kp,
                         out=parts[sh])
    got = tpk.finish_step(acc.clone(), parts, kp)
    want = tpk.pbs_step(acc.clone(), a[0], kv[0], ks[0], kp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ROTATION_WIDTHS))
def test_cuda_tp_step_residency(name):
    """The blocks of K8a and K8b the card keeps resident per SM, and their
    threads, as K1's: two of 384 threads at L2, three of 256 at L2_32, one
    of 1,024 at SET_3 and N=8192."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, _ = _rotation_case(name, 1, 1, seed=930)
    want = {"l2": {"partial_step": (2, 384), "finish_step": (2, 384)},
            "l2_32": {"partial_step": (3, 256), "finish_step": (3, 256)},
            "set3": {"partial_step": (1, 1024), "finish_step": (1, 1024)},
            "n8192": {"partial_step": (1, 1024),
                      "finish_step": (1, 1024)}}[name]
    for kernel, blocks_threads in want.items():
        assert tpk.tp_step_residency(kp, kp.torus_bits,
                                     kernel) == blocks_threads


@pytest.mark.gpu
def test_cuda_tp_step_refuses_misaligned_vectors():
    """K8a reads its key rows and writes its partial, K8b reads the
    partials, 16 bytes at a time: a view off a 16-byte boundary raises
    before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, (acc, a, kv, ks) = _rotation_case("l2", 2, 1, seed=940)

    def shifted(t):
        s = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return s[1:].view(t.shape).copy_(t)

    out = torch.empty((2, kp.C, kp.P, kp.N), dtype=torch.int32, device="cuda")
    parts = _tp_parts(kp, 2, 2, seed=941)
    launches = (tpk.partial_step.launches, tpk.finish_step.launches)
    for call in (lambda: tpk.partial_step(acc, a[0], 0, shifted(kv[0]),
                                          ks[0], kp),
                 lambda: tpk.partial_step(acc, a[0], 0, kv[0], ks[0], kp,
                                          out=shifted(out)),
                 lambda: tpk.finish_step(acc.clone(), shifted(parts), kp)):
        with pytest.raises(ValueError, match="16-byte"):
            call()
    assert (tpk.partial_step.launches, tpk.finish_step.launches) == launches


# --- K3 and K4 on K1's schedule ---------------------------------------------

def _apply_case(name, B, G, per_row, seed):
    """K3's plan and arguments at ROTATION_WIDTHS[name]: random words of
    the width, G random keys (broadcast or one per row)."""
    N, l, Bg_bit, bits = ROTATION_WIDTHS[name]
    primes = PRIMES_32 if bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, 1))
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cuda", bits)
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 1 << bits, size=(B, kp.C, N), dtype=np.uint64)
    rows = (G, B) if per_row else (G,)
    sa = random_residues(rng, rows + (kp.J, kp.C, kp.P, N), primes)
    # a word at p - 1 of every prime
    sa[(0,) * len(rows) + (0, 0, slice(None), 0)] = np.array(primes) - 1
    words = as_i32(acc.astype(np.uint32), "cuda") if bits == 32 else \
        to_tensor(acc, "cuda")
    return kp, (words, as_i32(sa, "cuda"), kp, per_row)


def _unfolded_case(name, B, G, u, seed):
    """K4's plan and arguments at ROTATION_WIDTHS[name]: random words and
    key products of the width, exponents 0, N and 2N present."""
    N, l, Bg_bit, bits = ROTATION_WIDTHS[name]
    primes = PRIMES_32 if bits == 32 else ntt.primes_for_bound(
        ntt.external_product_bound(N, Bg_bit, l, 1))
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, 1, "cuda", bits)
    rng = np.random.default_rng(seed)
    M = 1 << u

    def words(*shape):
        w = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
        return as_i32(w.astype(np.uint32), "cuda") if bits == 32 else \
            to_tensor(w, "cuda")

    acc = words(B, kp.C, N)
    su = words(G, M, kp.J, kp.C, N)
    rot = torch.from_numpy(random_exponents(rng, B, G, M, N)).cuda()
    return kp, (acc, rot, su, kp)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 131, 133, 265])
@pytest.mark.parametrize("name", ["l2", "l2_32"])
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_cuda_ext_product_apply_ragged_batches_match_plain(name, B, per_row):
    """K3 over G=3 products on batches around the card's resident blocks
    (two of 384 threads per SM at L2, three of 256 at L2_32), one launch,
    the plain version's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, args = _apply_case(name, B, 3, per_row, seed=1000 + B + per_row)
    launches = tpk.ext_product_apply_scan.launches
    got = tpk.ext_product_apply_scan(*args)
    torch.cuda.synchronize()
    assert tpk.ext_product_apply_scan.launches == launches + 1
    want = tpk.ext_product_apply_scan_plain(*args)
    assert got.dtype == args[0].dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 131, 133, 265])
@pytest.mark.parametrize("name", ["l2", "l2_32"])
def test_cuda_unfolded_rotate_ragged_batches_match_plain(name, B):
    """K4 at u=4 over G=2 groups on batches around the card's resident
    blocks, exponents 0, N and 2N present, one launch, the plain version's
    words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, args = _unfolded_case(name, B, 2, 4, seed=1100 + B)
    launches = tpk.unfolded_rotate.launches
    got = tpk.unfolded_rotate(*args)
    torch.cuda.synchronize()
    assert tpk.unfolded_rotate.launches == launches + 1
    want = tpk.unfolded_rotate_plain(*args)
    assert got.dtype == args[0].dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B", [("set3", 133), ("n8192", 5)])
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_cuda_ext_product_apply_beyond_shared_memory(name, B, per_row):
    """K3 at SET_3 (1,024 threads, acc in place) and N=8192 (spectra in the
    workspace), G=2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, args = _apply_case(name, B, 2, per_row, seed=1200 + B + per_row)
    got = tpk.ext_product_apply_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tpk.ext_product_apply_scan_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,u", [("set3", 133, 1), ("set3", 133, 2),
                                      ("set3", 133, 4), ("n8192", 3, 2)])
def test_cuda_unfolded_rotate_beyond_shared_memory(name, B, u):
    """K4 at SET_3 (1,024 threads, one block per SM, acc in place) and
    N=8192 (two groups of 512 threads take the 4 primes in two rounds, the
    spectra in the workspace), G=2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, args = _unfolded_case(name, B, 2, u, seed=1300 + u + B)
    got = tpk.unfolded_rotate(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, tpk.unfolded_rotate_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["l2", "l2_32", "set3"])
def test_cuda_apply_and_unfolded_residency(name):
    """K3's (so K3-step's) and K4's blocks per SM and threads, as K1's: two
    of 384 at L2, three of 256 at L2_32 (u=4: 16 exponents beside K1's
    buffers), one of 1,024 at SET_3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, _ = _apply_case(name, 1, 1, False, seed=1400)
    want = {"l2": (2, 384), "l2_32": (3, 256), "set3": (1, 1024)}[name]
    assert tpk.ext_product_apply_residency(kp, kp.torus_bits) == want
    assert tpk.unfolded_rotate_residency(kp, kp.torus_bits, 16) == want


@pytest.mark.gpu
def test_cuda_ext_product_apply_refuses_a_misaligned_key():
    """K3 and K3-step read their keys 16 bytes at a time: a view that
    starts off a 16-byte boundary raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    kp, (acc, sa, _, _) = _apply_case("l2", 2, 1, False, seed=1500)
    shifted = torch.empty(sa.numel() + 1, dtype=torch.int32,
                          device="cuda")[1:].view(sa.shape).copy_(sa)
    launches = (tpk.ext_product_apply_scan.launches,
                tpk.ext_product_apply_step.launches)
    with pytest.raises(ValueError, match="16-byte"):
        tpk.ext_product_apply_scan(acc, shifted, kp)
    with pytest.raises(ValueError, match="16-byte"):
        tpk.ext_product_apply_step(acc, shifted[0], kp)
    assert (tpk.ext_product_apply_scan.launches,
            tpk.ext_product_apply_step.launches) == launches


# --- K1-delta and K6 on K1's schedule ---------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", ["l2", "l2_32", "set3"])
def test_cuda_cmux_delta_and_auto_keyswitch_residency(name):
    """K1-delta's, K6's and K6-old's (K6's gathered instances) blocks per
    SM and threads, as K3's: two of 384 at L2, three of 256 at L2_32 (K6
    and K6-old; K1-delta is 64-bit only), one of 1,024 at SET_3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    want = {"l2": (2, 384), "l2_32": (3, 256), "set3": (1, 1024)}[name]
    N, l, Bg_bit, bits = ROTATION_WIDTHS[name]
    kp = auto_ks_args(N, 1, l, Bg_bit, 1, 1, bits, seed=1800)[-1]
    assert tpk.auto_keyswitch_residency(kp, bits) == want
    assert tpk.auto_keyswitch_residency(kp, bits, gathered=True) == want
    if bits == 64:
        kp = cmux_delta_args(N, l, Bg_bit, 1, seed=1801)[-1]
        assert tpk.cmux_delta_residency(kp) == want


@pytest.mark.gpu
def test_cuda_cmux_delta_and_auto_keyswitch_refuse_misaligned_keys():
    """K1-delta, K6 and K6-old read their keys 16 bytes at a time: a view
    that starts off a 16-byte boundary raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")

    def shifted(t):
        return torch.empty(t.numel() + 1, dtype=torch.int32,
                           device="cuda")[1:].view(t.shape).copy_(t)
    x, keyv, keyvs, kp = cmux_delta_args(2048, 4, 9, 2, seed=1900)
    w, ak, kidx, ginv, kp_ks = auto_ks_args(2048, 1, 4, 9, 64, 2, 64,
                                            seed=1901)
    launches = (tpk.cmux_delta.launches, tpk.auto_keyswitch_stream.launches,
                tpk.auto_keyswitch.launches)
    with pytest.raises(ValueError, match="16-byte"):
        tpk.cmux_delta(x, shifted(keyv), keyvs, kp)
    with pytest.raises(ValueError, match="16-byte"):
        tpk.auto_keyswitch_stream(w, shifted(ak), kidx, ginv, kp_ks)
    with pytest.raises(ValueError, match="16-byte"):
        tpk.auto_keyswitch(w, shifted(ak[:2]), kp_ks)
    assert (tpk.cmux_delta.launches, tpk.auto_keyswitch_stream.launches,
            tpk.auto_keyswitch.launches) == launches


@pytest.mark.gpu
def test_cuda_ga_step_forms_match_k7():
    """At TFHEpp-L2 widths with a random GA key cut to n=3 steps (the whole
    2048-entry keyset) and 5 ciphertexts: `blind_rotate_ga_stepwise` is n
    K1-delta and n+1 K6 launches, `blind_rotate_ga_gathered` n K1-delta
    and n+1 K6-old launches, each giving `blind_rotate_ga`'s words (one K6
    and one K7 launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import bootstrap_ga, trlwe
    N, k, l, Bg_bit = L2_SPLIT
    n, B = 3, 5
    primes, acc0, _, sv, svs = random_rotation_inputs(N, k, l, Bg_bit, n, B,
                                                      seed=2000)
    ks_primes = ntt.primes_for_bound(ntt.conv_bound(N, 1 << (Bg_bit - 1),
                                                    k * l * l))
    gen = torch.Generator(device="cuda").manual_seed(2001)
    pr = torch.tensor(ks_primes, dtype=torch.int64, device="cuda")[:, None]
    ak = tpk.u32_as_i32(torch.randint(
        0, 1 << 62, (N, k * l, k + 1, len(ks_primes), N), generator=gen,
        device="cuda") % pr)
    bk = bootstrap_ga.GABootstrapKey(
        as_i32(sv, "cuda"), as_i32(svs, "cuda"), ak,
        torch.from_numpy(bootstrap_ga.inverse_mod_2n_table(N)).cuda(), n, k,
        N, l, Bg_bit, l, Bg_bit, primes, ks_primes)
    tv = trlwe.from_stacked(to_tensor(acc0, "cuda"))
    rng = np.random.default_rng(2002)
    a = to_tensor(rng.integers(0, 1 << 64, size=(B, n), dtype=np.uint64),
                  "cuda")
    want, counts = _launched((tpk.auto_keyswitch_stream, tpk.ga_scan_fused),
                             lambda: bootstrap_ga.blind_rotate_ga(tv, a, bk))
    assert counts == (1, 1)
    for form, old in (("stepwise", 0), ("gathered", n + 1)):
        got, counts = _launched(
            (tpk.cmux_delta, tpk.auto_keyswitch_stream, tpk.auto_keyswitch),
            lambda: getattr(bootstrap_ga, f"blind_rotate_ga_{form}")(tv, a,
                                                                     bk))
        assert counts == (n, n + 1 - old, old)
        assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)


def _l2_trgsw_key(seed):
    """The port's TFHEpp-L2 TRGSW key (N=2048, l=4, Bg_bit=9), made on the
    CPU from a seed."""
    from mosfhet_torch import params, trgsw, trlwe
    p = params.TFHEPP_L2
    gen = torch.Generator().manual_seed(seed)
    key = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, "cpu")
    return p, gen, trgsw.new_key(key, p.l, p.Bg_bit)


def _key_on(gk, device):
    from mosfhet_torch import trgsw, trlwe
    return trgsw.new_key(trlwe.TRLWEKey(s=gk.trlwe_key.s.to(device),
                                        sigma=gk.trlwe_key.sigma,
                                        s_bound=gk.trlwe_key.s_bound),
                         gk.l, gk.Bg_bit)


def _dft_on(g, device):
    import dataclasses
    return dataclasses.replace(
        g, v=g.v.to(device), vs=None if g.vs is None else g.vs.to(device))


@pytest.mark.gpu
def test_cuda_trgsw_matrix_ops_match_cpu():
    """The matrix ops at L2 on the card: mul_trgsw_dft of 3 exponent pairs,
    reg_sub and reg_add of two registers (plain PyTorch, words equal to the
    same calls on CPU tensors) and debug_decrypt_exp_dft (one K3 launch per
    call, exponents equal to the CPU's and to e1 + e2, 5 and N - 5, 13 and
    N - 13)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import trgsw
    p, gen, gk = _l2_trgsw_key(17)
    plan = gk.plan()
    e1, e2 = torch.tensor([5, 2047, 4000]), torch.tensor([3, 1, 100])
    g1 = trgsw.monomial_encrypt(torch.ones(3, dtype=torch.int64), e1, gk, gen)
    d2 = trgsw.to_dft(trgsw.monomial_encrypt(
        torch.ones(3, dtype=torch.int64), e2, gk, gen), plan)
    r1, r2 = (trgsw.reg_encrypt(m, gk, gen) for m in (9, 4))
    gk_c = _key_on(gk, "cuda")
    prod = trgsw.mul_trgsw_dft(g1, d2)
    prod_c = trgsw.mul_trgsw_dft(trgsw.TRGSW(g1.rows.cuda(), p.l, p.Bg_bit),
                                 _dft_on(d2, "cuda"))
    assert torch.equal(prod_c.v.cpu(), prod.v)
    assert torch.equal(trgsw.from_dft(prod_c).rows.cpu(),
                       trgsw.from_dft(prod).rows)
    launches = tpk.ext_product_apply_scan.launches
    exps = trgsw.debug_decrypt_exp_dft(prod_c, gk_c)
    torch.cuda.synchronize()
    assert tpk.ext_product_apply_scan.launches == launches + 1
    assert torch.equal(exps.cpu(), trgsw.debug_decrypt_exp_dft(prod, gk))
    assert exps.tolist() == ((e1 + e2) % p.N).tolist()
    rc1, rc2 = (trgsw.TRGSWReg(_dft_on(r.positive, "cuda"),
                               _dft_on(r.negative, "cuda")) for r in (r1, r2))
    for fn, m in ((trgsw.reg_sub, 5), (trgsw.reg_add, 13)):
        got, want = fn(rc1, rc2), fn(r1, r2)
        for half, h_cpu, e in ((got.positive, want.positive, m),
                               (got.negative, want.negative, p.N - m)):
            assert torch.equal(half.v.cpu(), h_cpu.v)
            assert torch.equal(half.vs.cpu(), h_cpu.vs)
            launches = tpk.ext_product_apply_scan.launches
            assert int(trgsw.debug_decrypt_exp_dft(half, gk_c)) == e
            assert tpk.ext_product_apply_scan.launches == launches + 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 512])
def test_cuda_k3_on_debug_decrypt_inputs(B):
    """K3 against its plain version on debug_decrypt_exp_dft's per-row
    inputs at L2: the trivial TRLWE (0, 2^(64 - Bg_bit)) broadcast over B
    random NTT-form TRGSWs, one per row (with a residue at p - 1), as
    trgsw.external_product hands them over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import params
    p = params.TFHEPP_L2
    primes = ntt.primes_for_bound(
        ntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
    kp = tpk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, "cuda")
    rng = np.random.default_rng(B)
    sa = random_residues(rng, (1, B, kp.J, kp.C, kp.P, p.N), primes)
    sa[0, 0, 0, 0, :, 0] = np.array(primes) - 1
    x = torch.zeros(B, kp.C, p.N, dtype=torch.int64, device="cuda")
    x[:, -1, 0] = 1 << (64 - p.Bg_bit)
    sa32 = as_i32(sa, "cuda")
    launches = tpk.ext_product_apply_scan.launches
    got = tpk.ext_product_apply_scan(x, sa32, kp, True)
    torch.cuda.synchronize()
    assert tpk.ext_product_apply_scan.launches == launches + 1
    assert torch.equal(got, tpk.ext_product_apply_scan_plain(x, sa32, kp,
                                                             True))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 129])
@pytest.mark.parametrize("bits", [64, 32])
def test_cuda_keyswitch_sum_packing_rows_match_plain(bits, B):
    """K2 on a packing table's rows of (k+1)N = 4096 words (TFHEpp-L2's
    N=2048; a row is 64 of its 512-byte slices at 64 bits), 256 of the
    2048 rows (1 GB at 64 bits), t = 8 (6 at 32 bits), base-1 = 15, ragged
    B; its schedule query at that shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    R, t, base_m1, width = 256, 8 if bits == 64 else 6, 15, 4096
    dig, ab = random_ks_inputs(B, R, t, base_m1, width, seed=B + bits)
    d = torch.from_numpy(dig).cuda()
    tab = to_tensor(ab.astype(np.uint32) if bits == 32 else ab, "cuda")
    launches = tpk.tlwe_keyswitch_sum.launches
    got = tpk.tlwe_keyswitch_sum(d, tab)
    torch.cuda.synchronize()
    assert tpk.tlwe_keyswitch_sum.launches == launches + 1
    assert torch.equal(got, tpk.tlwe_keyswitch_sum_plain(d, tab))
    sched = tpk.tlwe_keyswitch_schedule(B, R * t, base_m1, width, bits)
    assert sched["slices"] == width * bits // 8 // 512
    assert sched["blocks_per_sm"] >= 1


def _l2_ring_key(gen):
    from mosfhet_torch import params, trlwe
    p = params.TFHEPP_L2
    return p, trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, "cuda")


@pytest.mark.gpu
def test_cuda_streamed_seeded_apply_matches_k2_on_expanded_table(
        monkeypatch):
    """`keyswitch.packing1_keyswitch` at N=2048 from a 64-coefficient TLWE
    key: the seeded table's streamed gather (no K2 launch) and one K2
    launch on its expansion give the same words, which the plain
    select-sum gives too and which decrypt within 2^48; likewise the
    private-SK switch (n+1 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import keyswitch, rng, tlwe, trlwe
    gen = torch.Generator(device="cuda").manual_seed(18)
    p, kr = _l2_ring_key(gen)
    in_key = tlwe.new_binary_key(64, p.rlwe_sigma, gen, "cuda")
    m = rng.uniform_torus(gen, (130,), "cuda")
    c = tlwe.encrypt(m, in_key, gen)
    for new, fn in ((keyswitch.new_packing1_ks_key_seeded,
                     keyswitch.packing1_keyswitch),
                    (keyswitch.new_priv_sk_ks_key_seeded,
                     keyswitch.priv_keyswitch)):
        sk = new(kr, in_key, p.t, p.base_bit, gen, "cuda")
        dense = keyswitch.expand_generic_ks_key(sk)
        launches = tpk.tlwe_keyswitch_sum.launches
        got_s = fn(c, sk)
        torch.cuda.synchronize()
        assert tpk.tlwe_keyswitch_sum.launches == launches
        got_d = fn(c, dense)
        torch.cuda.synchronize()
        assert tpk.tlwe_keyswitch_sum.launches == launches + 1
        assert torch.equal(got_s.a, got_d.a) and torch.equal(got_s.b, got_d.b)
        with monkeypatch.context() as mp:
            mp.setattr(tpk, "tlwe_keyswitch_sum",
                       tpk.tlwe_keyswitch_sum_plain)
            want = fn(c, dense)
        assert torch.equal(got_d.a, want.a) and torch.equal(got_d.b, want.b)
    got = keyswitch.packing1_keyswitch(c, keyswitch.expand_generic_ks_key(
        keyswitch.new_packing1_ks_key_seeded(kr, in_key, p.t, p.base_bit,
                                             gen, "cuda")))
    err = (trlwe.phase(got, kr)[:, 0] - m).to(torch.float64).abs().max()
    assert float(err) <= 2.0**48


@pytest.mark.gpu
def test_cuda_priv_keyswitch_2_is_two_k6_launches(monkeypatch):
    """At TFHEpp-L2 (t=8, base_bit=4, three primes): `priv_keyswitch_2` of
    5 TRLWEs is exactly 2 K6 launches and no plain call, the plain route's
    words, within 2^50 of -s m; `trgsw.ks_b_to_a` of one TRGSW is 2 more
    and decrypts to its exponent; `product.tensor_prod_fft` relinearizes in
    1 K6 launch at four primes, the plain route's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import keyswitch, polynomial, product, rng, trgsw, \
        trlwe
    gen = torch.Generator(device="cuda").manual_seed(19)
    p, kr = _l2_ring_key(gen)
    pair = keyswitch.new_priv_ks_key_pair(kr, kr, p.t, p.base_bit, gen,
                                          "cuda")
    assert len(pair[0].primes) == 3
    m = rng.uniform_torus(gen, (5, p.N), "cuda")
    c = trlwe.encrypt(m, kr, gen)
    gk = trgsw.new_key(kr, p.l, p.Bg_bit)
    g = trgsw.monomial_encrypt(1, 77, gk, gen)
    rlk = keyswitch.new_rl_key(kr, 2, 20, gen, "cuda")
    assert len(rlk.primes) == 4
    calls = [(keyswitch.priv_keyswitch_2, (c, pair), 2),
             (trgsw.ks_b_to_a, (g, pair), 2),
             (lambda c1, c2: product.tensor_prod_fft(c1, c2, 4, rlk),
              (trlwe.TRLWE(a=c.a[:2], b=c.b[:2]),
               trlwe.TRLWE(a=c.a[2:4], b=c.b[2:4])), 1)]
    outs = []
    for fn, args, n in calls:
        launches = tpk.auto_keyswitch_stream.launches
        plain = tpk.auto_keyswitch_stream_plain.calls
        got = fn(*args)
        torch.cuda.synchronize()
        assert tpk.auto_keyswitch_stream.launches == launches + n
        assert tpk.auto_keyswitch_stream_plain.calls == plain
        with monkeypatch.context() as mp:
            mp.setattr(tpk, "auto_keyswitch_stream",
                       tpk.auto_keyswitch_stream_plain)
            want = fn(*args)
        got_w = got.rows if hasattr(got, "rows") else got.stacked()
        want_w = want.rows if hasattr(want, "rows") else want.stacked()
        assert torch.equal(got_w, want_w)
        outs.append(got)
    want = -polynomial.ntt_mul_small(kr.s[0], m, kr.plan())
    err = (trlwe.phase(outs[0], kr) - want).to(torch.float64).abs().max()
    assert float(err) <= 2.0**50
    assert int(trgsw.debug_decrypt_exp(outs[1], gk)) == 77


@pytest.mark.gpu
@pytest.mark.parametrize("B,n", [(5, 3), (64, 2)])
def test_cuda_blind_rotate_trgsw_rows_match_plain(monkeypatch, B, n):
    """`bootstrap.blind_rotate_trgsw` at TFHEpp-L2 widths (rotation cut to n
    steps) on B random TRGSWs: one K1 launch on B (k+1)l rows, each
    ciphertext's exponents repeated over its rows, the plain route's
    words; then `functional_bootstrap_trgsw_phase1` and `_phase2` are one
    K1 and one K3 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import bootstrap, tlwe, trgsw, trlwe
    N, k, l, Bg_bit = 2048, 1, 4, 9
    primes, _, _, keyv, keyvs = random_rotation_inputs(N, k, l, Bg_bit, n, 1,
                                                       seed=19)
    bk = bootstrap.BootstrapKey(as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"),
                                n, k, N, l, Bg_bit, primes)
    rng = np.random.default_rng(B)
    R = (k + 1) * l
    g = trgsw.TRGSW(rows=to_tensor(rng.integers(
        0, 1 << 64, (B, R, k + 1, N), dtype=np.uint64), "cuda"), l=l,
        Bg_bit=Bg_bit)
    a = to_tensor(rng.integers(0, 1 << 64, (B, n), dtype=np.uint64), "cuda")
    launches = tpk.blind_rotate_scan.launches
    got = bootstrap.blind_rotate_trgsw(g, a, bk)
    torch.cuda.synchronize()
    assert tpk.blind_rotate_scan.launches == launches + 1
    with monkeypatch.context() as mp:
        mp.setattr(tpk, "blind_rotate_scan", tpk.blind_rotate_scan_plain)
        want = bootstrap.blind_rotate_trgsw(g, a, bk)
    assert torch.equal(got.rows, want.rows)
    c = tlwe.TLWE(a=a, b=a[:, 0])
    tv = trlwe.TRLWE(a=g.rows[0, 0, :1].clone(), b=g.rows[0, 0, 1].clone())
    counts = (tpk.blind_rotate_scan.launches,
              tpk.ext_product_apply_scan.launches)
    gd = bootstrap.functional_bootstrap_trgsw_phase1(c, bk, 4, l, Bg_bit)
    out = bootstrap.functional_bootstrap_trgsw_phase2(gd, tv)
    torch.cuda.synchronize()
    assert (tpk.blind_rotate_scan.launches,
            tpk.ext_product_apply_scan.launches) == (counts[0] + 1,
                                                     counts[1] + 1)
    assert out.a.shape == (B, k * N)


@pytest.mark.gpu
@pytest.mark.parametrize("n,B", [(3, 5), (2, 130)])
def test_cuda_kernel_matches_plain_at_ufhe_set0(n, B):
    """K1 at UFHE_SET0's gadget (l=6, Bg_bit=7: J = 12 rows), n cut."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    N, k, l, Bg_bit = 2048, 1, 6, 7
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=630 + B)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int).cuda(),
            as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"), kp)
    launches = tpk.blind_rotate_scan.launches
    got = tpk.blind_rotate_scan(*args)
    torch.cuda.synchronize()
    assert tpk.blind_rotate_scan.launches == launches + 1
    assert torch.equal(got, tpk.blind_rotate_scan_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_in,t,base_m1,width", [
    (64, 2048, 6, 3, 631),     # UFHE_SET0's key switch (base_bit=2)
    (3, 2048, 6, 3, 631),
    (64, 512, 6, 3, 4096),     # LUT packing rows of 2N words, rows cut
    (130, 96, 6, 3, 4096),
])
def test_cuda_keyswitch_sum_matches_plain_at_base_bit_2(B, n_in, t, base_m1,
                                                        width):
    """K2 with 3 values per digit (UFHE_SET0's base_bit=2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dig, ab = random_ks_inputs(B, n_in, t, base_m1, width, seed=n_in + B)
    d = torch.from_numpy(dig).cuda()
    tab = to_tensor(ab, "cuda")
    launches = tpk.tlwe_keyswitch_sum.launches
    got = tpk.tlwe_keyswitch_sum(d, tab)
    torch.cuda.synchronize()
    assert tpk.tlwe_keyswitch_sum.launches == launches + 1
    assert torch.equal(got, tpk.tlwe_keyswitch_sum_plain(d, tab))


@pytest.mark.gpu
def test_cuda_io_container_loads_to_card(tmp_path):
    """A keyset saved from the CPU loads onto the card by default (`io.load`
    with no device) and bootstraps and switches there through K1 and K2,
    with the CPU's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from mosfhet_torch import bootstrap, io, params, rng, tlwe, torus, trgsw, \
        trlwe
    p = params.TOY
    gen = torch.Generator().manual_seed(77)
    key_tlwe = tlwe.new_binary_key(p.n, p.lwe_sigma, gen, "cpu")
    key_trlwe = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, "cpu")
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    bk = bootstrap.new_key(trgsw.new_key(key_trlwe, p.l, p.Bg_bit),
                           key_tlwe, gen, "cpu")
    ksk = tlwe.new_ks_key(key_tlwe, key_out, p.t, p.base_bit, gen, "cpu")
    luts = rng.uniform_torus(gen, (4,), "cpu")
    tv = trlwe.torus_packing(luts, p.k, p.N)
    cs = tlwe.encrypt(torus.double2torus(
        (torch.arange(130) % 4).to(torch.float64) / 8.0), key_tlwe, gen)
    want = tlwe.keyswitch(bootstrap.functional_bootstrap(tv, cs, bk, 4), ksk)
    io.save(tmp_path / "keys.mtpu", {"bk": bk, "ksk": ksk, "tv": tv,
                                     "cs": cs})
    back = io.load(tmp_path / "keys.mtpu")
    assert back["bk"].device.type == "cuda" and back["ksk"].ab.is_cuda
    counts = (tpk.blind_rotate_scan.launches, tpk.tlwe_keyswitch_sum.launches)
    got = tlwe.keyswitch(bootstrap.functional_bootstrap(
        back["tv"], back["cs"], back["bk"], 4), back["ksk"])
    torch.cuda.synchronize()
    assert (tpk.blind_rotate_scan.launches,
            tpk.tlwe_keyswitch_sum.launches) == (counts[0] + 1, counts[1] + 1)
    assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(),
                                                            want.b)


@pytest.mark.gpu
def test_cuda_reference_unfolded_key_imports_to_card():
    """The reference's u=2 key and input (tests/vectors/vec2_*) imported
    onto the card bootstrap through K4 with the CPU import's words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import os

    from mosfhet_torch import bootstrap, io, torus, trlwe
    vec = os.path.join(os.path.dirname(__file__), "vectors")

    def run(device):
        with open(os.path.join(vec, "vec2_bootstrap_key.bin"), "rb") as f:
            bk = io.import_mosfhet_bootstrap_key(f, device=device)
        with open(os.path.join(vec, "vec2_input.bin"), "rb") as f:
            c = io.import_mosfhet_tlwe(f, 16, device=device)
        lut = torus.double2torus(torch.arange(4, dtype=torch.float64) / 8.0,
                                 bk.device)
        return bootstrap.functional_bootstrap(
            trlwe.torus_packing(lut, 1, 256), c, bk, 4)

    launches = tpk.unfolded_rotate.launches
    got = run(None)
    torch.cuda.synchronize()
    assert tpk.unfolded_rotate.launches == launches + 1
    want = run("cpu")
    assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(),
                                                            want.b)
