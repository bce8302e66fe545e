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
           "K6": ("auto_keyswitch", {}), "K7": ("ga_scan", {"P_ks": 3}),
           "K8a": ("tp_step", {})}


@pytest.mark.parametrize("name,k_id", [
    (name, k_id) for name in sorted(ALL_SHARED) for k_id in KERNELS
    if ALL_SHARED[name][3] == 64 or k_id == "K1"])   # K1 alone has 32 bits
def test_layout_keeps_every_buffer_shared_where_it_fits(name, k_id):
    """Every shape that fitted before buffers could move keeps them all in
    shared memory."""
    N, l, Bg_bit, bits = ALL_SHARED[name]
    kernel, kw = KERNELS[k_id]
    kp = _plan(N, l, Bg_bit, bits)
    layout, stride = tpk.kernel_layout(kernel, kp, H100_BUDGET, **kw)
    assert stride == 0 and set(_where(layout)) == {"S"}
    if name == "TFHEPP_L2" and kernel == "blind_rotate":
        assert layout[0] == 136 * 1024          # PERF.md's 136 KiB
    if name == "L2_32" and kernel == "blind_rotate":
        assert layout[0] == 80 * 1024


@pytest.mark.parametrize("kernel,kw,where,smem_kib", [
    ("blind_rotate", {}, "SSWI", 192),
    ("ext_product_apply", {}, "SSI", 192),
    ("unfolded_rotate", {"M": 4}, "SSSWS", 192),
    ("auto_keyswitch", {}, "SSW", 192),
    ("ga_scan", {"P_ks": 4}, "SSWI", 192),
    ("tp_step", {}, "SSW", 192)], ids=["K1", "K3", "K4", "K6", "K7", "K8a"])
def test_layout_at_set3_moves_the_u64_buffers(kernel, kw, where, smem_kib):
    """N=4096 with 4 primes (SET_3; the GA key's key-switch plan there has 4
    primes too) asks for up to 320 KiB: the NTT rows and spectra stay in
    shared memory, the u64 buffers leave it (K4: the spectra leave, the key
    row and acc stay)."""
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
    kp = _plan(8192, 1, 22)
    layout, stride = tpk.kernel_layout("blind_rotate", kp, H100_BUDGET)
    assert _where(layout) == "SWWI" and layout[0] == 128 * 1024
    assert stride == (256 + 128) * 1024


def test_layout_that_cannot_be_placed_raises():
    """At N=16384 with 4 primes the NTT rows alone need 256 KiB."""
    kp = _plan(16384, 1, 22)
    with pytest.raises(ValueError, match="262144 B"):
        tpk.kernel_layout("blind_rotate", kp, H100_BUDGET)


@pytest.mark.parametrize("name", ["ext_product_apply_scan", "unfolded_rotate",
                                  "ubr_phase1_combine",
                                  "auto_keyswitch_stream", "ga_scan_fused",
                                  "partial_step", "finish_step"])
def test_kernels_without_a_32bit_form_refuse_int32_words(name):
    """Only K1 and K2 have their one-limb (32-bit torus) form yet: the other
    wrappers raise on int32 words instead of taking any route."""
    w = torch.zeros((1, 2, 64), dtype=torch.int32)
    args = {"ext_product_apply_scan": (w, None, None),
            "unfolded_rotate": (w, None, None, None),
            "ubr_phase1_combine": (w, None, None),
            "auto_keyswitch_stream": (w, None, None, None, None),
            "ga_scan_fused": (w, None, None, None, None, None, None, None),
            "partial_step": (w, None, 0, None, None, None),
            "finish_step": (w, None, None)}[name]
    with pytest.raises(NotImplementedError, match="32-bit torus"):
        getattr(tpk, name)(*args)


def test_kernel_plan_width_must_match_the_words():
    """A 64-bit plan's gadget offset is wrong for u32 words: K1 refuses."""
    kp = _plan(64, 3, 7, 64)
    acc = torch.zeros((1, 2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit plan"):
        tpk._word_width("blind_rotate_scan", acc, kp)
    assert tpk._word_width("blind_rotate_scan", acc,
                           _plan(64, 3, 7, 32)) == 32
