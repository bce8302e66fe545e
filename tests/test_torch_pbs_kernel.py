"""The blind-rotate kernel module's plain version against the TPU kernel
`blind_rotate_scan_fused`, run in Pallas interpret mode as the TPU
package's own tests run it on the CPU.  Bit-exact.  The CUDA kernel itself
is held against the plain version in `test_torch_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import ntt as jntt
from mosfhet_tpu.ops import pbs_kernel as jpk
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_gpu import as_i32, random_rotation_inputs
from tests.test_torch_suite_env import port_test_env  # noqa: F401


def test_plain_matches_fused_tpu_kernel_interpret():
    N, k, l, Bg_bit, n, B = 256, 1, 2, 9, 5, 32
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=78)
    assert primes == jntt.primes_for_bound(
        jntt.external_product_bound(N, Bg_bit, l, k))
    jkp = jpk.get_kernel_plan(N, primes, l, Bg_bit, k, bt=32, mxu=False)
    want = jpk.blind_rotate_scan_fused(
        jnp.asarray(acc0), jnp.asarray(a_int), jnp.asarray(keyv),
        jnp.asarray(keyvs), jkp, interpret=True)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cpu")
    got = tpk.blind_rotate_scan(
        to_tensor(acc0, "cpu"), torch.from_numpy(a_int),
        as_i32(keyv, "cpu"), as_i32(keyvs, "cpu"), kp)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_u32_bit_patterns_round_trip():
    x = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    y = tpk.u32_as_i32(x)
    assert y.dtype == torch.int32
    assert tpk.i32_as_u32(y).tolist() == x.tolist()


# --- where a kernel block's buffers live (`pbs_kernel.kernel_layout`) -------

H100_BUDGET = 232448 - 1024   # sm_90 opt-in shared memory less static data


def _where(layout):
    """Per buffer: S shared, W global workspace, I in place."""
    return "".join("S" if o >= 0 else "I" if o == -1 else "W"
                   for o in layout[2:])


def _plan(N, l, Bg_bit, torus_bits=64, k=1):
    if torus_bits == 32:      # the 32-bit torus's bound, as its plan takes it
        bound = 2 * N * (1 << (Bg_bit - 1)) * (1 << 31) * (k + 1) * l * 2
        primes = jntt.MASTER_PRIMES[-2:]
        assert jntt.primes_for_bound(bound) == primes
    else:
        primes = jntt.primes_for_bound(
            jntt.external_product_bound(N, Bg_bit, l, k))
    return tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cpu", torus_bits)


# (N, l, Bg_bit, torus bits): every registered set's bootstrap digits
ALL_SHARED = {"TFHEPP_L2": (2048, 4, 9, 64), "SET_1": (1024, 2, 8, 64),
              "SET_2": (2048, 1, 23, 64), "UFHE_SET0": (2048, 6, 7, 64),
              "L2_32": (2048, 3, 7, 32), "TOY": (64, 4, 9, 64)}


KERNELS = {"K1": ("blind_rotate", {}), "K3": ("ext_product_apply", {}),
           "K4": ("unfolded_rotate", {"M": 256}),
           "K6": ("auto_keyswitch_stream", {}), "K7": ("ga_scan", {"P_ks": 3}),
           "K8a": ("tp_step", {}), "K8b": ("finish_step", {}),
           "K1-step": ("pbs_step", {}),
           "K3-step": ("ext_product_apply", {}),
           "K1-delta": ("cmux_delta", {}),
           "K6-old": ("auto_keyswitch_stream", {})}
# the kernels with 32-bit forms
ONE_LIMB = ("K1", "K3", "K4", "K6", "K7", "K8a", "K8b", "K1-step", "K3-step",
            "K6-old")
# K3's buffer table: K1's exchange rows, spectra and acc (K1-delta and K6
# read their input in place where acc does not fit; K3-step and K6-old
# launch K3's and K6's kernels and take their tables)
K1_TABLE = ("blind_rotate", "pbs_step", "ga_scan", "ext_product_apply",
            "unfolded_rotate", "cmux_delta", "auto_keyswitch_stream")


@pytest.mark.parametrize("name,k_id", [
    (name, k_id) for name in sorted(ALL_SHARED) for k_id in KERNELS
    if ALL_SHARED[name][3] == 64 or k_id in ONE_LIMB])
def test_layout_keeps_every_buffer_shared_where_it_fits(name, k_id):
    """Every shape that fitted before buffers could move keeps them all in
    shared memory."""
    N, l, Bg_bit, bits = ALL_SHARED[name]
    kernel, kw = KERNELS[k_id]
    if kernel == "ga_scan" and bits == 32:
        kw = {"P_ks": 2}              # L2_32's GA key switch: 2 primes
    kp = _plan(N, l, Bg_bit, bits)
    layout, stride = tpk.kernel_layout(kernel, kp, H100_BUDGET, **kw)
    assert stride == 0 and set(_where(layout)) == {"S"}
    # K4 adds its M = 256 exponents (1 KiB) to K1's buffers
    extra = 1024 if kernel == "unfolded_rotate" else 0
    if name == "TFHEPP_L2" and kernel in K1_TABLE:
        assert layout[0] == 111104 + extra    # 108.5 KiB: two blocks per SM
    if name == "L2_32" and kernel in K1_TABLE:
        assert layout[0] == 68608 + extra     # 67 KiB: three blocks per SM


@pytest.mark.parametrize("kernel,kw,where,smem_kib", [
    ("blind_rotate", {}, "SSI", 204),
    ("ext_product_apply", {}, "SSI", 204),
    ("unfolded_rotate", {"M": 4}, "SSSI", 204),
    ("auto_keyswitch_stream", {}, "SSI", 204),
    ("ga_scan", {"P_ks": 4}, "SSI", 204),
    ("tp_step", {}, "SS", 204),
    ("finish_step", {}, "SSS", 196),
    ("pbs_step", {}, "SSI", 204),
    ("ext_product_apply", {}, "SSI", 204),
    ("cmux_delta", {}, "SSI", 204),
    ("auto_keyswitch_stream", {}, "SSI", 204)],
    ids=["K1", "K3", "K4", "K6", "K7", "K8a", "K8b", "K1-step", "K3-step",
         "K1-delta", "K6-old"])
def test_layout_at_set3_moves_the_u64_buffers(kernel, kw, where, smem_kib):
    """N=4096 with 4 primes (SET_3; the GA key's key-switch plan there has 4
    primes too) asks for up to 320 KiB: the NTT rows and spectra stay in
    shared memory, the u64 buffers leave it (K1 and K3, with no rotation
    buffer, K4, whose exchange rows carry its combined key rows, and K7,
    with no permutation buffer, keep their four exchange rows and spectra
    and update acc in place; K1-delta and K6 keep K3's and read their
    input in place; K3-step and K6-old launch K3's and K6's kernels and
    place their buffers as those do).  K8a (four exchange rows and its
    groups' MAC slots, acc read from the caller's tensor) and K8b (four
    exchange rows and all 8 spectra rows) keep everything in shared
    memory.  K1-step places K1's buffers and K3-step K3's: acc then stays
    in the caller's tensor between their launches."""
    kp = _plan(4096, 1, 22)
    assert kp.P == 4
    layout, stride = tpk.kernel_layout(kernel, kp, H100_BUDGET, **kw)
    assert _where(layout) == where
    assert layout[0] // 1024 == smem_kib
    assert stride == (0 if "W" not in where else
                      sum(-(-n // 256) * 256 for (n, _, _), w in zip(
                          tpk.kernel_buffers(kernel, kp, **kw), where)
                          if w == "W"))


def test_layout_at_n8192_keeps_only_the_ntt_rows():
    """K1 at N=8192 with 4 primes: two groups of 512 threads, their two
    exchange rows (68 KiB) and acc (128 KiB) in shared memory, the 272 KiB
    of spectra in the workspace."""
    kp = _plan(8192, 1, 22)
    layout, stride = tpk.kernel_layout("blind_rotate", kp, H100_BUDGET)
    assert _where(layout) == "SWS" and layout[0] == (68 + 128) * 1024
    assert stride == 272 * 1024


def test_layout_that_cannot_be_placed_raises():
    """At N=32768 a row's N/16 threads exceed a block: K1 takes N up to
    16384 (one group of 1,024 threads taking the primes in turn)."""
    kp = _plan(32768, 1, 22)
    with pytest.raises(ValueError, match="16384"):
        tpk.kernel_layout("blind_rotate", kp, H100_BUDGET)


def test_k8b_layout_at_n8192_runs_one_component_per_pass():
    """N=8192 with 4 primes: K8b's 256 KiB of spectra do not fit beside its
    two exchange rows (68 KiB), so one component's 128 KiB of rows is
    placed and the other components' rows are left out (the kernel then
    makes a pass per component); nothing lives in a workspace."""
    kp = _plan(8192, 1, 22)
    assert kp.P == 4
    layout, stride = tpk.kernel_layout("finish_step", kp, H100_BUDGET)
    assert _where(layout) == "SSI" and layout[0] == (68 + 128) * 1024
    assert stride == 0


def test_k8b_layout_at_l2_keeps_one_pass_in_contiguous_rows():
    """Where all C*P rows fit, the other components' rows follow component
    0's directly, so one pass reads them as one [C][P][N] block; the three
    exchange rows of K1's schedule (N + N/16 words each) come first."""
    kp = _plan(2048, 4, 9)
    layout, stride = tpk.kernel_layout("finish_step", kp, H100_BUDGET)
    row, work = kp.P * kp.N * 4, 3 * (2048 + 128) * 4
    assert list(layout) == [work + kp.C * row, 0, 0, work, work + row]
    assert stride == 0


def test_k8b_layout_that_cannot_be_placed_raises():
    """At N=16384 with 4 primes even one component's rows need 256 KiB
    (beside one exchange row of 68 KiB)."""
    kp = _plan(16384, 1, 22)
    with pytest.raises(ValueError, match="262144 B"):
        tpk.kernel_layout("finish_step", kp, H100_BUDGET)


@pytest.mark.parametrize("name", ["auto_keyswitch_stream", "ga_scan_fused",
                                  "cmux_delta"])
def test_kernels_without_a_32bit_form_refuse_int32_words(name):
    """K1-delta has no one-limb (32-bit torus) form, as the TPU kernel has
    none: `cmux_delta` raises NotImplementedError on int32 words instead of
    taking any route.  K6 and K7 have theirs: on int32 words they check the
    plan's width (a 64-bit plan is refused with ValueError), never raising
    NotImplementedError."""
    w = torch.zeros((1, 2, 64), dtype=torch.int32)
    kp64 = _plan(64, 3, 7, 64)
    args = {"auto_keyswitch_stream": (w, None, None, None, kp64),
            "ga_scan_fused": (w, None, None, None, None, None, kp64, kp64),
            "cmux_delta": (w, None, None, kp64)}[name]
    want = NotImplementedError if name == "cmux_delta" else ValueError
    with pytest.raises(want, match="32-bit"):
        getattr(tpk, name)(*args)


def _one_limb_args(name, kp, rng):
    """Small int32-word inputs of K3-K7, K6-old, K8a, K8b, K1-step, K3-step
    or K5-v1 at ``kp``'s widths (B=2, G=2, M=4, n=2; K6 and K7 use ``kp``
    as their key-switch plan too), and the shape and dtype of what comes
    back."""
    B, G, M, C, J, P, N = 2, 2, 4, kp.C, kp.J, kp.P, kp.N

    def w32(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, shape,
                                             dtype=np.uint64)
                                .astype(np.uint32).view(np.int32))

    def res(*shape):
        return torch.from_numpy((rng.integers(0, 1 << 62, shape,
                                              dtype=np.uint64)
                                 % np.array(kp.primes, np.uint64)[:, None])
                                .astype(np.int64))

    rot = torch.from_numpy(rng.integers(0, 2 * N + 1, (B, G, M),
                                        dtype=np.int32))
    a = torch.from_numpy(rng.integers(0, 2 * N + 1, B, dtype=np.int32))
    kv = res(J // 2, C, P, N)
    kvs = (kv << 32) // kp.ntt.p[:, None]
    Jk = (C - 1) * kp.l
    sv = res(2, J, C, P, N)
    odd = torch.tensor([1, 2 * G - 1], dtype=torch.int32)
    ga_inputs = (w32(B, C, N), odd.repeat(2, 1), tpk.u32_as_i32(sv),
                 tpk.u32_as_i32((sv << 32) // kp.ntt.p[:, None]),
                 tpk.u32_as_i32(res(G, Jk, C, P, N)),
                 torch.arange(N, dtype=torch.int32) * 2 + 1, kp, kp)
    kr = res(J, C, P, N)                     # one step's key rows
    return {
        "pbs_step": ((w32(B, C, N), a, tpk.u32_as_i32(kr),
                      tpk.u32_as_i32((kr << 32) // kp.ntt.p[:, None]), kp),
                     (B, C, N), torch.int32),
        "ext_product_apply_step": ((w32(B, C, N), tpk.u32_as_i32(kr), kp),
                                   (B, C, N), torch.int32),
        "ubr_phase1_combine_v1": ((w32(G, M, J, C, N), rot, kp),
                                  (B, G, J, C, P, N), torch.int32),
        "auto_keyswitch_stream": (
            (w32(B, C, N), tpk.u32_as_i32(res(G, Jk, C, P, N)), odd // G,
             odd, kp), (B, C, N), torch.int32),
        "auto_keyswitch": ((w32(B, C, N), tpk.u32_as_i32(res(B, Jk, C, P, N)),
                            kp), (B, C, N), torch.int32),
        "ga_scan_fused": (ga_inputs, (B, C, N), torch.int32),
        "ext_product_apply_scan": (
            (w32(B, C, N), tpk.u32_as_i32(res(G, J, C, P, N)), kp),
            (B, C, N), torch.int32),
        "unfolded_rotate": ((w32(B, C, N), rot, w32(G, M, J, C, N), kp),
                            (B, C, N), torch.int32),
        "ubr_phase1_combine": ((w32(G, M, J, C, N), rot, kp),
                               (B, G, J, C, P, N), torch.int32),
        "partial_step": ((w32(B, C, N), a, J // 2, tpk.u32_as_i32(kv),
                          tpk.u32_as_i32(kvs), kp), (B, C, P, N),
                         torch.int32),
        "finish_step": ((w32(B, C, N), tpk.u32_as_i32(res(2, B, C, P, N)),
                         kp), (B, C, N), torch.int32)}[name]


@pytest.mark.parametrize("name", ["ext_product_apply_scan", "unfolded_rotate",
                                  "ubr_phase1_combine", "partial_step",
                                  "finish_step", "auto_keyswitch_stream",
                                  "auto_keyswitch", "ga_scan_fused",
                                  "pbs_step", "ext_product_apply_step",
                                  "ubr_phase1_combine_v1"])
def test_one_limb_forms_take_int32_words(name):
    """K3-K7, K6-old, K8a, K8b, K1-step, K3-step and K5-v1 take the 32-bit
    torus's int32 words: on CPU
    tensors the plain version runs (one call) and gives the shape and
    dtype the kernel writes; a 64-bit plan, whose gadget offset is of the
    wrong width, is refused before any route."""
    kp = _plan(64, 3, 7, 32)
    args, shape, dtype = _one_limb_args(name, kp, np.random.default_rng(7))
    plain = getattr(tpk, name + "_plain")
    calls = plain.calls
    out = getattr(tpk, name)(*args)
    assert plain.calls == calls + 1
    assert tuple(out.shape) == shape and out.dtype == dtype
    kp64 = _plan(64, 3, 7, 64)
    with pytest.raises(ValueError, match="32-bit plan"):
        getattr(tpk, name)(*(kp64 if x is kp else x for x in args))
    assert plain.calls == calls + 1


def test_kernel_plan_width_must_match_the_words():
    """A 64-bit plan's gadget offset is wrong for u32 words: K1 refuses."""
    kp = _plan(64, 3, 7, 64)
    acc = torch.zeros((1, 2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit plan"):
        tpk._word_width("blind_rotate_scan", acc, kp)
    assert tpk._word_width("blind_rotate_scan", acc,
                           _plan(64, 3, 7, 32)) == 32
