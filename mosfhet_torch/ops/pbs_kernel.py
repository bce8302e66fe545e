"""The device kernels of the bootstrap and the gate: for each, a plain
PyTorch version and the wrapper of its hand-written CUDA kernel.

The wrapper launches the kernel on CUDA tensors (and raises if it does not
build or launch) and takes the plain version, the same arithmetic in int64
PyTorch, only for CPU tensors.  The two give the same words.

1. The blind rotation: the whole n-step CMUX chain

       acc += BK_i (x) ((X^{a_i} - 1) * acc)        for i = 0 .. n-1

   in ONE launch of ``csrc/blind_rotate.cu``.  Layouts (as the TPU
   package's kernel takes them):
     acc0        [B, k+1, N]               int64 (u64 torus words)
     a_int       [n, B]                    int32 rotation exponents in [0, 2N]
     keyv, keyvs [n, (k+1)l, k+1, P, N]    int32 holding u32 bits: the
                                           NTT-form bootstrap key and its
                                           Shoup companions (can exceed 2^31)

2. The TLWE key switch's select-sum (``csrc/tlwe_keyswitch.cu``):

       out[b] = sum over (i, j) with d[b, i, j] != 0 of ab[i, j, d - 1]
     dig  [B, n_in, t]                 int32 digits in [0, base)
     ab   [n_in, t, base-1, n_out+1]   int64: KS table, mask words then b
     out  [B, n_out+1]                 int64, the subtrahend of (0, b)
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import ntt as _ntt
from .. import polynomial as _poly
from ..torus import gadget_decompose, gadget_offset, to_i64
from . import _build

U32_MASK = 0xFFFFFFFF


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 holding u32 bits -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & U32_MASK


class PBSKernelPlan:
    """Tables and constants of one (N, primes, l, Bg_bit, k) configuration
    on one device: the NTT tables as u32-in-int32 tensors [P, N], and the
    primes, Garner constants and gadget offset as the int64 host array the
    kernel's C entry reads."""

    def __init__(self, N: int, primes, l: int, Bg_bit: int, k: int, device):
        primes = tuple(int(p) for p in primes)
        if not all((1 << 28) < p < (1 << 30) for p in primes):
            raise ValueError("the kernel needs primes in (2^28, 2^30)")
        self.N, self.primes, self.l, self.Bg_bit, self.k = \
            N, primes, l, Bg_bit, k
        self.P, self.C, self.J = len(primes), k + 1, (k + 1) * l
        self.ntt = _ntt.get_plan(N, primes, device)
        self.fwd_tw = u32_as_i32(self.ntt.psi_rev)
        self.fwd_tws = u32_as_i32(self.ntt.psi_rev_shoup)
        self.inv_tw = u32_as_i32(self.ntt.ipsi_rev)
        self.inv_tws = u32_as_i32(self.ntt.ipsi_rev_shoup)
        P = self.P
        gw = np.zeros((P, P), np.int64)
        gws = np.zeros((P, P), np.int64)
        cinv = np.zeros(P, np.int64)
        cinvs = np.zeros(P, np.int64)
        for m in range(P):
            for j, (w, ws) in enumerate(self.ntt.garner_w[m]):
                gw[m, j], gws[m, j] = w, ws
            if m:
                cinv[m], cinvs[m] = self.ntt.garner_cinv[m]
        self.offset = gadget_offset(Bg_bit, l, rounded=True)
        self.host_consts = np.concatenate([
            np.array([N, k, l, Bg_bit, P, to_i64(self.offset)], np.int64),
            np.array(primes, np.int64),
            self.ntt.n_inv.cpu().numpy(), self.ntt.n_inv_shoup.cpu().numpy(),
            cinv, cinvs, gw.reshape(-1), gws.reshape(-1)])


@functools.lru_cache(maxsize=None)
def _get_kernel_plan(N, primes, l, Bg_bit, k, device: str) -> PBSKernelPlan:
    return PBSKernelPlan(N, primes, l, Bg_bit, k, device)


def get_kernel_plan(N: int, primes, l: int, Bg_bit: int, k: int,
                    device) -> PBSKernelPlan:
    return _get_kernel_plan(N, tuple(primes), l, Bg_bit, k,
                            str(torch.device(device)))


# --- plain version -------------------------------------------------------------

def cmux_step(acc, keyv, keyvs, a, plan: _ntt.NTTPlan, l: int, Bg_bit: int):
    """acc += BK_i (x) (X^{a} * acc - acc), one CMUX (`bootstrap.c:113-118`).
    acc [B, C, N] int64; a [B]; keyv/keyvs [J, C, P, N] int64 canonical."""
    B, C, N = acc.shape
    rot = _poly.mul_by_xai(acc, a.unsqueeze(-1)) - acc
    digits = gadget_decompose(rot, Bg_bit, l).reshape(B, C * l, N)
    spec = _ntt.to_ntt_small(digits, plan)                     # [B, J, P, N]
    acc_ntt = _ntt.pointwise_mul_acc_key(spec.unsqueeze(2), keyv, keyvs,
                                         plan, dim=1)          # [B, C, P, N]
    return acc + _ntt.from_ntt_u64(acc_ntt, plan)


def blind_rotate_scan_plain(acc0, a_int, keyv, keyvs, kp: PBSKernelPlan):
    """The n-step CMUX chain in int64 PyTorch, on any device."""
    blind_rotate_scan_plain.calls += 1
    acc = acc0
    for i in range(a_int.shape[0]):
        acc = cmux_step(acc, i32_as_u32(keyv[i]), i32_as_u32(keyvs[i]),
                        a_int[i], kp.ntt, kp.l, kp.Bg_bit)
    return acc


blind_rotate_scan_plain.calls = 0


# --- CUDA kernel wrapper -------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("blind_rotate")
    lib.blind_rotate_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.blind_rotate_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def blind_rotate_scan(acc0, a_int, keyv, keyvs, kp: PBSKernelPlan):
    """The n-step CMUX chain.  CUDA tensors: one launch of the kernel, and an
    error raised if it does not build or launch.  CPU tensors: the plain
    version.  Returns the new accumulator [B, C, N] int64."""
    dev = acc0.device
    if dev.type == "cpu":
        return blind_rotate_scan_plain(acc0, a_int, keyv, keyvs, kp)
    if dev.type != "cuda":
        raise ValueError(f"blind_rotate_scan runs on cuda or cpu, not {dev}")
    B, C, N = acc0.shape
    n = a_int.shape[0]
    key_shape = (n, kp.J, kp.C, kp.P, kp.N)
    _check("acc0", acc0, torch.int64, (B, kp.C, kp.N), dev)
    _check("a_int", a_int, torch.int32, (n, B), dev)
    _check("keyv", keyv, torch.int32, key_shape, dev)
    _check("keyvs", keyvs, torch.int32, key_shape, dev)
    _check("plan tables", kp.fwd_tw, torch.int32, (kp.P, kp.N), dev)
    lib = _lib()
    acc = acc0.clone()
    err = lib.blind_rotate_launch(
        acc.data_ptr(), a_int.data_ptr(), keyv.data_ptr(), keyvs.data_ptr(),
        kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(), kp.inv_tw.data_ptr(),
        kp.inv_tws.data_ptr(), kp.host_consts.ctypes.data, B, n,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("blind_rotate kernel launch failed: "
                           + lib.cuda_error_string(err).decode())
    blind_rotate_scan.launches += 1
    return acc


blind_rotate_scan.launches = 0


# --- the key switch's select-sum -------------------------------------------

def tlwe_keyswitch_sum_plain(dig, ab):
    """The select-sum as a gather in int64 PyTorch, on any device, over n_in
    in chunks that keep the [B, chunk, t, n_out+1] gather near 64 MB.  A
    digit outside [1, base) selects nothing, as in the kernels."""
    tlwe_keyswitch_sum_plain.calls += 1
    B, n_in, t = dig.shape
    base_m1, width = ab.shape[2], ab.shape[3]
    out = torch.zeros((B, width), dtype=torch.int64, device=ab.device)
    chunk = min(n_in, max(1, (64 << 20) // max(1, B * t * width * 8)))
    for i0 in range(0, n_in, chunk):
        d = dig[:, i0:i0 + chunk].to(torch.int64)            # [B, c, t]
        c = d.shape[1]
        rows = ab[i0:i0 + chunk].reshape(c * t * base_m1, width)
        pos = (torch.arange(c, device=d.device)[:, None] * t
               + torch.arange(t, device=d.device)) * base_m1
        nz = (d > 0) & (d <= base_m1)
        g = rows[pos + (d - 1).clamp(0, base_m1 - 1)]        # [B, c, t, width]
        out += torch.where(nz[..., None], g, 0).sum((1, 2))
    return out


tlwe_keyswitch_sum_plain.calls = 0


@functools.cache
def _ks_lib() -> ctypes.CDLL:
    lib = _build.load("tlwe_keyswitch")
    lib.tlwe_keyswitch_sum_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tlwe_keyswitch_sum_launch.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def tlwe_keyswitch_sum(dig, ab):
    """The select-sum.  CUDA tensors: one launch of the kernel, and an error
    raised if it does not build or launch.  CPU tensors: the plain version.
    Returns [B, n_out+1] int64."""
    dev = ab.device
    if dev.type == "cpu":
        return tlwe_keyswitch_sum_plain(dig, ab)
    if dev.type != "cuda":
        raise ValueError(f"tlwe_keyswitch_sum runs on cuda or cpu, not {dev}")
    if ab.dim() != 4 or dig.dim() != 3:
        raise ValueError(f"want dig [B, n_in, t] and ab [n_in, t, base-1, "
                         f"n_out+1], got {tuple(dig.shape)}, {tuple(ab.shape)}")
    n_in, t, base_m1, width = ab.shape
    B = dig.shape[0]
    _check("dig", dig, torch.int32, (B, n_in, t), dev)
    _check("ab", ab, torch.int64, (n_in, t, base_m1, width), dev)
    out = torch.empty((B, width), dtype=torch.int64, device=dev)
    if B == 0 or width == 0:
        return out
    lib = _ks_lib()
    err = lib.tlwe_keyswitch_sum_launch(
        dig.data_ptr(), ab.data_ptr(), out.data_ptr(), B, n_in * t, base_m1,
        width, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("tlwe_keyswitch kernel launch failed: "
                           + lib.cuda_error_string(err).decode())
    tlwe_keyswitch_sum.launches += 1
    return out


tlwe_keyswitch_sum.launches = 0
