"""The device kernels of the bootstrap and the gate: for each, a plain
PyTorch version and the wrapper of its hand-written CUDA kernel.

The wrapper launches the kernel on CUDA tensors (and raises if it does not
build or launch) and takes the plain version, the same arithmetic in int64
PyTorch, only for CPU tensors.  The two give the same words.

1. The blind rotation: the whole n-step CMUX chain

       acc += BK_i (x) ((X^{a_i} - 1) * acc)        for i = 0 .. n-1

   in ONE launch of ``csrc/blind_rotate.cu``.  Layouts (as the TPU
   package's kernel takes them):
     acc0        [B, k+1, N]               int64 (u64 torus words) or int32
                                           (u32 words, the 32-bit torus)
     a_int       [n, B]                    int32 rotation exponents in [0, 2N]
     keyv, keyvs [n, (k+1)l, k+1, P, N]    int32 holding u32 bits: the
                                           NTT-form bootstrap key and its
                                           Shoup companions (can exceed 2^31)

   K1-step (``pbs_step``, a second entry of the same source) is one of the
   n steps per launch, acc updated in place: a [B], keyv/keyvs [(k+1)l,
   k+1, P, N], the step's rows.

2. The TLWE key switch's select-sum (``csrc/tlwe_keyswitch.cu``):

       out[b] = sum over (i, j) with d[b, i, j] != 0 of ab[i, j, d - 1]
     dig  [B, n_in, t]                 int32 digits in [0, base)
     ab   [n_in, t, base-1, n_out+1]   KS table, mask words then b: int64
                                       (sum mod 2^64) or int32 (mod 2^32)
     out  [B, n_out+1]                 the subtrahend of (0, b), ab's dtype

   A block sums a tile of 128 ciphertexts over a 512-byte slice of table
   columns, its rows staged in shared memory chunk by chunk; a cluster of
   blocks splits the rows of one slice and tile and adds its sums through
   distributed shared memory (`tlwe_keyswitch_tiling`,
   `tlwe_keyswitch_schedule`).

   K1-K8b take the word width from the dtype of their torus words: int64
   runs the two-limb (64-bit) form, int32 the one-limb (32-bit) form, in the
   same kernel source.  K1-delta is 64-bit only, as the TPU kernel is: its
   wrapper raises NotImplementedError on int32 words.

3. The external-product apply scan (``csrc/ext_product_apply.cu``): G
   replace-mode external products with runtime keys,

       acc <- SA_g (x) acc                          for g = 0 .. G-1
     acc0  [B, k+1, N]                    int64 or int32 words
     sa32  [G, (k+1)l, k+1, P, N]         int32 holding u32 canonical
           or [G, B, (k+1)l, k+1, P, N]   NTT residues (one key per row)

   K3-step (``ext_product_apply_step``, a second entry of the same source)
   is one of the G products per launch, acc updated in place, with one
   step's key [(k+1)l, k+1, P, N] or [B, (k+1)l, k+1, P, N]: the same
   kernel at G = 1.

4. The unfolded blind rotation (``csrc/unfolded_rotate.cu``): for each
   group g the key products rotated and summed mod 2^64 (or 2^32), then
   one replace-mode external product,

       acc <- (sum_m X^{rot[b,g,m]} SU[g,m]) (x) acc    for g = 0 .. G-1
     acc0  [B, k+1, N]                    int64 or int32 words
     rot   [B, G, M]                      int32 exponents in [0, 2N]
     su    [G, M, (k+1)l, k+1, N]         acc0's dtype, M = 2^u

5. UBR phase 1 (``csrc/ubr_phase1.cu``): the same combination per (b, g)
   in NTT form, without the product,

       out[b, g] = NTT(sum_m X^{rot[b,g,m]} SU[g,m])
     out   [B, G, (k+1)l, k+1, P, N]      int32 holding u32 canonical residues

   one block per key row (g, j, c) and tile of ciphertexts
   (`ubr_phase1_tiling`), the row's M key products staged through a ring
   in shared memory once per tile (`ubr_phase1_schedule`).  K5-v1
   (``ubr_phase1_combine_v1``, the TPU package's first phase-1 entry) is
   one launch of the same kernel on the same operands.

6. The automorphism key switch (``csrc/auto_keyswitch.cu``): per row the
   Galois permutation psi_g (X -> X^g, given by ginv = g^-1 mod 2N), then
   the TRLWE key switch against the keyset entry the row selects,

       out[b] = (0, b') - sum_j dec_j(a') (x) AK[kidx[b]],  (a', b') = psi_g(x[b])
     x     [B, k+1, N]                     int64 or int32 words
     ak32  [G, k t, k+1, P, N]             int32 holding u32 canonical residues
     kidx  [B], ginv [B]                   int32 (ginv = 1: no permutation)

   and its older form K6-old (``auto_keyswitch``, a second entry of the same
   source), on an input already permuted and keys gathered per row: the
   same kernel, in instances that take ginv 1 and keyset entry b for row b,
     perm      [B, k+1, N]                 int64 or int32 words
     key_rows  [B, k t, k+1, P, N]         int32: row b's keyset entry

7. The GA blind rotation (``csrc/ga_scan.cu``): n steps of an external
   product, a Galois permutation and an automorphism key switch,

       acc <- AK[(g_i - 1)/2] o psi_{g_i} (BK_i (x) acc)    for i = 0 .. n-1
     gens  [n, B]                          int32 odd generators g_i
     sv32, svs32 [n, (k+1)l, k+1, P, N]    int32: TRGSW(X^{s_i}) and Shoup
     inv2n [N]                             int32: g^-1 mod 2N at (g - 1)/2

   Its first stage alone is K1-delta (``csrc/cmux_delta.cu``, ``cmux_delta``):
   one replace-mode external product BK (x) x with one static TRGSW,
     x, out      [B, k+1, N]               int64 (the 64-bit torus only)
     keyv, keyvs [(k+1)l, k+1, P, N]       int32: the TRGSW and its Shoup
                                           companions (checked, not read)

8. The gadget-row split of one CMUX step (``csrc/tp_step.cu``), for a
   bootstrap key whose J = (k+1)l rows are sharded over devices
   (``parallel.mesh``).  The partial (K8a) over the global key rows
   [j0, j0 + j_local),

       part = sum_{j in rows} NTT(dec_j(X^{a} acc - acc)) * BK_i[j]
     acc         [B, k+1, N]               int64 or int32 words (read only)
     a           [B]                       int32, this step's exponents
     keyv, keyvs [j_local, k+1, P, N]      int32 with u32 bits: the rows
     part        [B, k+1, P, N]            int32 holding u32 canonical residues

   and the finish (K8b) on the m partials of all shards,

       acc += INTT(sum_s part_s mod p)      (acc updated in place)
     parts       [m, B, k+1, P, N]         int32, each canonical

   K8b reduces the m partials itself (canonical after every add), so the
   sum is exact for any m; the TPU's u32 psum needed m * max(p) < 2^32.

The runtime-key kernels (3-7) multiply two residues with a 32-bit Barrett
product, and reduce u64 (or u32) words to the residues of their centred
(signed) representatives, as ``ntt.to_resi_u64`` does: the plain versions use
``ntt.pointwise_mul_acc_generic`` and ``ntt.to_ntt_u64``, and both end in
canonical residues, so the words agree.

Where a block's buffers live (K1, K1-delta, K3, K4, K6, K6-old, K7, K8a,
K8b).  Each kernel runs one block per ciphertext over a handful of buffers:
the digit row's NTT rows, the spectra, the accumulator and a rotation or
permutation buffer.  `_place` fills dynamic shared memory with them in
order of traffic, up to the card's opt-in limit per block (read from the
CUDA runtime); a buffer that does not fit lives in a global workspace the
wrapper allocates (B slices, one per block), and the accumulator in the
caller's tensor, updated in place.  Every shape of TFHEpp-L2, SET_1, SET_2
and UFHE_SET0 keeps all of them in shared memory; N=4096 with 4 primes
(SET_3) moves the u64 buffers out, N=8192 the spectra too.  The NTT rows
must stay in shared memory: a shape whose NTT rows alone exceed the limit
raises ValueError before any launch.  (K5's block holds a ring of up to
4 key rows, which its tile's exchange rows reuse, and the tile's
exponents, all in shared memory: one key row at N = 16384 with u64
words; K5 and K5-v1 raise ValueError where not one fits.)  K1, K1-step,
K3 and K4 hold no rotation buffer and one exchange row per group of N/16
threads (`rotation_schedule`) instead of the P NTT rows: 108.5 KiB at
TFHEpp-L2 (two blocks per SM; K4 adds its group's 2^u exponents), 67 KiB
at L2_32 (three); SET_3 keeps their spectra in shared memory and acc in
place, N=8192 their spectra in the workspace.  N above 16384 raises
ValueError (a block of N/16 threads).  K1-delta and K6 hold K3's buffers
(K6 on its key-switch plan's primes): where acc leaves shared memory they
read their input in place.  K3-step and K6-old are K3's and K6's kernels and hold
theirs.  K8a and K8b (redesigned on K1's schedule) hold the same
exchange rows.  K8a adds its groups' MAC slots and reads acc from the
caller's tensor: 76.5 KiB at TFHEpp-L2, all in shared memory at every
registered shape.  K8b adds the C*P spectra rows where they fit, else one
component's P rows, and then runs once per component (N=8192 with 4
primes).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import ntt as _ntt
from .. import polynomial as _poly
from ..torus import (TORUS_BITS, gadget_decompose, gadget_offset, to_signed,
                     word_bits, wrap)
from . import _build

U32_MASK = 0xFFFFFFFF
# The Barrett product of two runtime residues (``csrc/ntt_common.cuh``)
# needs floor(2^62 / p) in [2^32, 2^33) and a quotient error below 3.
BARRETT_MIN_PRIME = int((1 << 30) / 1.75)


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 holding u32 bits -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & U32_MASK


class PBSKernelPlan:
    """Tables and constants of one (N, primes, l, Bg_bit, k, torus_bits)
    configuration on one device: the NTT tables as u32-in-int32 tensors
    [P, N], and the primes, Garner constants and gadget offset (of the
    torus_bits width) as the int64 host array the kernel's C entry reads."""

    def __init__(self, N: int, primes, l: int, Bg_bit: int, k: int, device,
                 torus_bits: int = 64):
        primes = tuple(int(p) for p in primes)
        if not all(BARRETT_MIN_PRIME < p < (1 << 30) for p in primes):
            raise ValueError("the kernels need primes in (2^30 / 1.75, 2^30)")
        if torus_bits not in (32, 64) or l * Bg_bit >= torus_bits:
            raise ValueError(f"no {l} x {Bg_bit}-bit gadget on a "
                             f"{torus_bits}-bit torus")
        self.N, self.primes, self.l, self.Bg_bit, self.k = \
            N, primes, l, Bg_bit, k
        self.torus_bits = torus_bits
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
        self.offset = gadget_offset(Bg_bit, l, rounded=True, bits=torus_bits)
        self.host_consts = np.concatenate([
            np.array([N, k, l, Bg_bit, P, to_signed(self.offset, 64)],
                     np.int64),
            np.array(primes, np.int64),
            self.ntt.n_inv.cpu().numpy(), self.ntt.n_inv_shoup.cpu().numpy(),
            cinv, cinvs, gw.reshape(-1), gws.reshape(-1),
            # runtime-key products and the centred u64 reduction
            np.array([(1 << 62) // p - (1 << 32) for p in primes], np.int64),
            np.array([(1 << 32) // p for p in primes], np.int64),
            np.array([(1 << 32) % p for p in primes], np.int64),
            np.array([((1 << 32) % p << 32) // p for p in primes], np.int64),
            np.array([(1 << 64) % p for p in primes], np.int64)])


@functools.lru_cache(maxsize=None)
def _get_kernel_plan(N, primes, l, Bg_bit, k, device: str,
                     torus_bits: int) -> PBSKernelPlan:
    return PBSKernelPlan(N, primes, l, Bg_bit, k, device, torus_bits)


def get_kernel_plan(N: int, primes, l: int, Bg_bit: int, k: int, device,
                    torus_bits: int = TORUS_BITS) -> PBSKernelPlan:
    """The cached plan; ``torus_bits`` (default: the module's width) must
    match the words the kernel is given."""
    return _get_kernel_plan(N, tuple(primes), l, Bg_bit, k,
                            str(torch.device(device)), torus_bits)


# --- plain version -------------------------------------------------------------

def cmux_partial(acc, a, j0: int, keyv, keyvs, plan: _ntt.NTTPlan, l: int,
                 Bg_bit: int):
    """The NTT-domain external product of key rows [j0, j0 + len(keyv)) with
    the matching digit rows of X^{a} * acc - acc: canonical residues
    [B, C, P, N] int64.  acc [B, C, N] int64; a [B]; keyv/keyvs
    [len, C, P, N] int64 canonical.  Row j is component j // l, digit j % l
    of the whole decomposition."""
    B, C, N = acc.shape
    rot = _poly.mul_by_xai(acc, a.unsqueeze(-1)) - acc
    digits = gadget_decompose(rot, Bg_bit, l).reshape(B, C * l, N)
    spec = _ntt.to_ntt_small(digits[:, j0:j0 + keyv.shape[0]],
                             plan)                             # [B, j, P, N]
    return _ntt.pointwise_mul_acc_key(spec.unsqueeze(2), keyv, keyvs,
                                      plan, dim=1)             # [B, C, P, N]


def cmux_step(acc, keyv, keyvs, a, plan: _ntt.NTTPlan, l: int, Bg_bit: int):
    """acc += BK_i (x) (X^{a} * acc - acc), one CMUX (`bootstrap.c:113-118`).
    acc [B, C, N] int64 or int32 words; a [B]; keyv/keyvs [J, C, P, N]
    int64 canonical."""
    return acc + _ntt.from_ntt_u64(
        cmux_partial(acc, a, 0, keyv, keyvs, plan, l, Bg_bit), plan,
        acc.dtype)


def blind_rotate_scan_plain(acc0, a_int, keyv, keyvs, kp: PBSKernelPlan):
    """The n-step CMUX chain in PyTorch, on any device, at the width of
    acc0's words (int64: mod 2^64, int32: mod 2^32)."""
    blind_rotate_scan_plain.calls += 1
    acc = acc0
    for i in range(a_int.shape[0]):
        acc = cmux_step(acc, i32_as_u32(keyv[i]), i32_as_u32(keyvs[i]),
                        a_int[i], kp.ntt, kp.l, kp.Bg_bit)
    return acc


blind_rotate_scan_plain.calls = 0


# --- CUDA kernel wrapper -------------------------------------------------------

@functools.cache
def _kernel_lib(name: str, entry: str, n_ptr: int, n_int: int):
    """The built library of ``csrc/<name>.cu`` with the argument types of its
    C entry: ``n_ptr`` pointers, ``n_int`` ints, then the stream."""
    lib = _build.load(name)
    getattr(lib, entry).argtypes = [ctypes.c_void_p] * n_ptr + [
        ctypes.c_int] * n_int + [ctypes.c_void_p]
    getattr(lib, entry).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


_CUDA_ERROR_INVALID_VALUE = 1


def _launch(name: str, entry: str, n_ptr: int, n_int: int, dev, *args,
            refused: str | None = None):
    """Call the C entry, which launches on ``dev``'s current stream and
    returns `cudaGetLastError()`; raise on anything but success: ValueError
    with the message ``refused`` where it is given and the entry returns
    cudaErrorInvalidValue (an entry that refuses a shape before any launch),
    else RuntimeError.  ``dev`` is made the current device for the call: the
    CUDA runtime launches into the current device, and a tensor on another
    card (a mesh shard) needs its own."""
    lib = _kernel_lib(name, entry, n_ptr, n_int)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, _stream(dev))
    if err:
        why = lib.cuda_error_string(err).decode()
        if refused is not None and err == _CUDA_ERROR_INVALID_VALUE:
            raise ValueError(f"{refused} ({why})")
        raise RuntimeError(f"{name} kernel launch failed: {why}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_plan(kp: PBSKernelPlan, dev):
    _check("plan tables", kp.fwd_tw, torch.int32, (kp.P, kp.N), dev)


def _word_width(name: str, words, kp: PBSKernelPlan) -> int:
    """The torus width of ``words`` (int64: 64, int32: 32), which must be
    the plan's: the gadget offset in its constants is of that width."""
    bits = word_bits(words)
    if bits != kp.torus_bits:
        raise ValueError(f"{name}: {words.dtype} words need a "
                         f"{bits}-bit plan, got {kp.torus_bits}")
    return bits


def _one_limb_primes(name: str, bits: int, kp: PBSKernelPlan):
    """K3-K8b's one-limb forms are built for 2 or 3 primes (`dispatch_pw`,
    ntt_common.cuh; a 32-bit plan takes 2 at every registered width): any
    other prime count raises before a launch."""
    if bits == 32 and kp.P not in (2, 3):
        raise ValueError(f"{name}: the one-limb form takes 2 or 3 primes, "
                         f"not {kp.P}")


def _u64_only(name: str, words):
    """K1-delta and the per-step GA forms built on it have no one-limb
    form (nor does the TPU kernel, pbs_kernel.py:3204): they refuse 32-bit
    torus words."""
    if words.dtype == torch.int32:
        raise NotImplementedError(
            f"{name}: 64-bit torus only; the 32-bit torus (int32 words) has "
            "no form of this kernel")


@functools.cache
def _smem_budget(name: str, index: int) -> int:
    """Dynamic shared memory one block of ``csrc/<name>.cu`` may ask for on
    card ``index``: the opt-in limit per block less the kernels' static
    shared data (the C entry `smem_budget`, ntt_common.cuh)."""
    lib = _build.load(name)
    lib.smem_budget.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.smem_budget.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = lib.smem_budget(index, ctypes.byref(out))
    if err:
        raise RuntimeError(f"{name}: cudaDeviceGetAttribute failed ({err})")
    return out.value


IN_PLACE = "in place"     # a buffer that lives in the caller's tensor
WORKSPACE = "workspace"   # a buffer that may live in the global workspace
SHARED_ONLY = "shared"    # a buffer that must be in shared memory
PASSES = "passes"         # a buffer the kernel does without, in passes


def _align(n: int, a: int = 16) -> int:
    return -(-n // a) * a


def _place(what: str, bufs, budget: int):
    """The placement of a block's buffers.  ``bufs``: (nbytes, home, rank)
    per buffer in the kernel's order (its enum), ``home`` one of
    SHARED_ONLY, WORKSPACE, IN_PLACE, PASSES; in order of rank (the
    buffer's traffic, busiest first) each takes shared memory if it still
    fits, the SHARED_ONLY ones (a kernel's digit NTT rows) first of all.
    Returns (layout, stride): the int64 host array the kernel reads (shared
    bytes, workspace stride, one offset per buffer: >= 0 shared, -1 in place
    (or, for PASSES, left out), -2 - o at workspace byte o) and the
    workspace bytes per block.  Raises ValueError, naming the shape and its
    bytes, when a SHARED_ONLY buffer does not fit."""
    smem, stride, offs = 0, 0, [0] * len(bufs)
    for i in sorted(range(len(bufs)),
                    key=lambda i: (bufs[i][1] != SHARED_ONLY, bufs[i][2])):
        nbytes, home, _ = bufs[i]
        if smem + _align(nbytes) <= budget:
            offs[i] = smem
            smem += _align(nbytes)
        elif home == SHARED_ONLY:
            raise ValueError(
                f"{what}: its NTT rows need {nbytes} B of shared memory "
                f"beside {smem} B already placed; this card gives a block "
                f"{budget} B")
        elif home in (IN_PLACE, PASSES):
            offs[i] = -1
        else:
            offs[i] = -2 - stride
            stride += _align(nbytes, 256)
    return np.array([smem, stride] + offs, np.int64), stride


ROTATION_VALUES = 16     # coefficients a K1 thread owns (kR, blind_rotate.cu)
ROTATION_MAX_THREADS = 1024


def rotation_schedule(N: int, P: int) -> dict:
    """K1's and K1-step's block at (N, P), as `make_sched` in
    ``csrc/blind_rotate.cu`` computes it: groups of N/16 threads, one per
    prime while P groups fit 1,024 threads (else a group takes several
    primes in turn), each with one exchange row of ``row_stride`` u32 words
    (N + N/16 from N = 256: a pad word after every 16).  N must be a power
    of two in [16, 16384]; anything else raises ValueError."""
    if N & (N - 1) or not 16 <= N <= 16384:
        raise ValueError(f"blind_rotate: N={N} is not a power of two in "
                         f"[16, 16384] (N/16 threads per prime, at most "
                         f"{ROTATION_MAX_THREADS} in a block)")
    T = N // ROTATION_VALUES
    groups = min(P, ROTATION_MAX_THREADS // T)
    return {"threads_per_group": T, "groups": groups,
            "row_stride": N + (T if N >= 256 else 0)}


def kernel_buffers(kernel: str, kp: PBSKernelPlan, M: int = 1,
                   P_ks: int = 0, tile: int = 1, stages: int = 1):
    """(nbytes, home, rank) of each of a block's buffers in ``kernel``
    (the source's name), in the order of its enum.  K1, K1-step and K3
    ("blind_rotate", "pbs_step", "ext_product_apply") hold one exchange row
    per group of their schedule (`rotation_schedule`), the spectra and the
    accumulator; so does K7 ("ga_scan"), on the schedule of its larger
    plan's primes, and K4 ("unfolded_rotate"), whose exchange rows also
    carry the combined key rows, after its group's M exponents.  K1-delta
    ("cmux_delta") and K6 ("auto_keyswitch_stream", on its key-switch plan
    ``kp``) hold K3's: their acc holds the input, which they read in place
    where it does not fit.  rank orders them by traffic: the NTTs' rows
    (work) are the busiest, then the spectra's multiply-accumulates and
    inverse NTTs; the accumulator and the exponents or rotation/permutation
    buffer, read and written once or twice per step, come last.  K8a
    ("tp_step") holds its schedule's exchange rows and each group's MAC
    slots, one row per component (a group keeps only the prime it is on);
    acc is read from the caller's tensor.  K8b ("finish_step", in tp_step.cu) holds the
    exchange rows, component 0's P spectra rows and, right after them
    where they fit, the other components' rows; left out, it runs once per
    component.  The one-step kernel "pbs_step" (K1-step) holds K1's
    buffers; K3-step and K6-old launch K3's and K6's kernels and take
    their tables.  K5 ("ubr_phase1") holds a ring of ``stages`` key rows
    of N words, which one exchange row per ciphertext of its ``tile``
    reuses after the adds, and their M exponents, all in shared memory.
    M: K4's and K5's 2^u; P_ks: K7's key-switch prime count."""
    C, P, N = kp.C, kp.P, kp.N
    row, spec, words = P * N * 4, C * P * N * 4, C * N * kp.torus_bits // 8
    if kernel in ("blind_rotate", "pbs_step", "ext_product_apply",
                  "cmux_delta", "auto_keyswitch_stream"):
        sc = rotation_schedule(N, P)               # work, spec, acc
        return [(sc["groups"] * sc["row_stride"] * 4, SHARED_ONLY, 0),
                (C * P * sc["row_stride"] * 4, WORKSPACE, 1),
                (words, IN_PLACE, 2)]
    if kernel == "unfolded_rotate":    # rots, work, spec, acc
        sc = rotation_schedule(N, P)
        return [(M * 4, WORKSPACE, 0),
                (sc["groups"] * sc["row_stride"] * 4, SHARED_ONLY, 0),
                (C * P * sc["row_stride"] * 4, WORKSPACE, 1),
                (words, IN_PLACE, 2)]
    if kernel == "ubr_phase1":         # ring (then work), rots
        sc = rotation_schedule(N, P)
        ring = stages * N * kp.torus_bits // 8
        return [(max(ring, tile * sc["row_stride"] * 4), SHARED_ONLY, 0),
                (tile * M * 4, SHARED_ONLY, 1)]
    if kernel == "ga_scan":            # work, spec, acc
        PM = max(P, P_ks)
        sc = rotation_schedule(N, PM)
        return [(sc["groups"] * sc["row_stride"] * 4, SHARED_ONLY, 0),
                (C * PM * sc["row_stride"] * 4, WORKSPACE, 1),
                (words, IN_PLACE, 2)]
    if kernel == "tp_step":            # K8a: work, its MAC slots
        sc = rotation_schedule(N, P)
        return [(sc["groups"] * sc["row_stride"] * 4, SHARED_ONLY, 0),
                (sc["groups"] * C * sc["row_stride"] * 4, WORKSPACE, 1)]
    if kernel == "finish_step":        # K8b: work, component 0's rows, the
        sc = rotation_schedule(N, P)   # rest
        return [(sc["groups"] * sc["row_stride"] * 4, SHARED_ONLY, 0),
                (row, SHARED_ONLY, 1), (spec - row, PASSES, 2)]
    raise ValueError(f"no buffer table for {kernel}")


@functools.lru_cache(maxsize=None)
def kernel_layout(kernel: str, kp: PBSKernelPlan, budget: int, M: int = 1,
                  P_ks: int = 0, tile: int = 1, stages: int = 1):
    """`_place` of ``kernel``'s buffers at ``kp``'s shape for a block that
    may have ``budget`` bytes of dynamic shared memory, once per shape (a
    wrapper asks at every launch; the arrays are read only)."""
    return _place(f"{kernel} at N={kp.N}, k={kp.k}, P={kp.P}, M={M}, "
                  f"P_ks={P_ks}, tile={tile}, stages={stages}",
                  kernel_buffers(kernel, kp, M, P_ks, tile, stages),
                  budget)


def _layout(kernel: str, kp: PBSKernelPlan, B: int, dev, source=None, **kw):
    """The placement on card ``dev`` and its workspace for B blocks (None
    when nothing lives there).  ``source``: the kernel's csrc file, when
    it is not ``kernel``."""
    budget = _smem_budget(source or kernel, _index(dev))
    layout, stride = kernel_layout(kernel, kp, budget, **kw)
    ws = None if stride == 0 else torch.empty(B * stride, dtype=torch.uint8,
                                              device=dev)
    return layout, ws


def _check_aligned(name, t):
    """K1's, K1-step's, K1-delta's, K3's, K3-step's, K6's, K6-old's, K7's
    and K8a's key rows, K8a's partial and K8b's partials are read or
    written 16 bytes at a time (the keys' Shoup companions are not read:
    the kernels' MACs take Barrett products); K5's key products come by
    TMA bulk copies, which want 16-byte aligned addresses."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads it in 16-byte vectors; "
                         f"its data pointer is not 16-byte aligned")


def _residency(name: str, entry: str, n_ptr: int, n_int: int, query: str,
               dev, ptrs, ints) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) from the C entry
    ``query`` of ``csrc/<name>.cu`` (pointers, ints, then the two outputs),
    which asks the CUDA runtime's
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on card ``dev``."""
    lib = _kernel_lib(name, entry, n_ptr, n_int)
    fn = getattr(lib, query)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(
        ints) + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fn(*ptrs, *ints, ctypes.byref(blocks), ctypes.byref(threads))
    if err:
        raise RuntimeError(f"{name} residency query failed: "
                           + lib.cuda_error_string(err).decode())
    return blocks.value, threads.value


def rotation_residency(kp: PBSKernelPlan, bits: int, step: bool = False,
                       dev=None) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K1, or K1-step
    with ``step``, on card ``dev`` at ``kp``'s shape, its placement and the
    word width ``bits`` (the C entry `blind_rotate_residency`)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    layout, _ = kernel_layout("pbs_step" if step else "blind_rotate", kp,
                              _smem_budget("blind_rotate", _index(dev)))
    return _residency("blind_rotate", "blind_rotate_launch", 11, 3,
                      "blind_rotate_residency", dev,
                      [kp.host_consts.ctypes.data, layout.ctypes.data],
                      [bits, int(step)])


def ga_scan_residency(kp: PBSKernelPlan, kp_ks: PBSKernelPlan, bits: int,
                      dev=None) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K7 on card ``dev``
    at the two plans' shape, its placement and the word width ``bits``
    (the C entry `ga_scan_residency`)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    layout, _ = kernel_layout("ga_scan", kp,
                              _smem_budget("ga_scan", _index(dev)),
                              P_ks=kp_ks.P)
    return _residency("ga_scan", "ga_scan_launch", 18, 3,
                      "ga_scan_residency", dev,
                      [kp.host_consts.ctypes.data,
                       kp_ks.host_consts.ctypes.data, layout.ctypes.data],
                      [bits])


def tp_step_residency(kp: PBSKernelPlan, bits: int, kernel: str,
                      dev=None) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K8a (``kernel``
    "partial_step") or K8b ("finish_step") on card ``dev`` at ``kp``'s
    shape, its placement and the word width ``bits`` (the C entry
    `tp_step_residency`)."""
    finish = {"partial_step": 0, "finish_step": 1}[kernel]
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    layout, _ = kernel_layout("finish_step" if finish else "tp_step", kp,
                              _smem_budget("tp_step", _index(dev)))
    return _residency("tp_step", "partial_step_launch", 10, 4,
                      "tp_step_residency", dev,
                      [kp.host_consts.ctypes.data, layout.ctypes.data],
                      [bits, finish])


def ext_product_apply_residency(kp: PBSKernelPlan, bits: int,
                                dev=None) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K3, and so of
    K3-step, on card ``dev`` at ``kp``'s shape, its placement and the word
    width ``bits`` (the C entry `ext_product_apply_residency`)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    layout, _ = kernel_layout("ext_product_apply", kp,
                              _smem_budget("ext_product_apply", _index(dev)))
    return _residency("ext_product_apply", "ext_product_apply_launch", 9, 4,
                      "ext_product_apply_residency", dev,
                      [kp.host_consts.ctypes.data, layout.ctypes.data],
                      [bits])


def cmux_delta_residency(kp: PBSKernelPlan, dev=None) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K1-delta on card
    ``dev`` at ``kp``'s shape and its placement (the C entry
    `cmux_delta_residency`; u64 words only)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    layout, _ = kernel_layout("cmux_delta", kp,
                              _smem_budget("cmux_delta", _index(dev)))
    return _residency("cmux_delta", "cmux_delta_launch", 11, 1,
                      "cmux_delta_residency", dev,
                      [kp.host_consts.ctypes.data, layout.ctypes.data], [])


def auto_keyswitch_residency(kp: PBSKernelPlan, bits: int,
                             dev=None, gathered: bool = False
                             ) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K6, or of K6-old
    (K6's kernel in its gathered instances) with ``gathered``, on card
    ``dev`` at the key-switch plan ``kp``'s shape, its placement and the
    word width ``bits`` (the C entry `auto_keyswitch_residency`)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    layout, _ = kernel_layout("auto_keyswitch_stream", kp,
                              _smem_budget("auto_keyswitch", _index(dev)))
    return _residency("auto_keyswitch", "auto_keyswitch_launch", 12, 2,
                      "auto_keyswitch_residency", dev,
                      [kp.host_consts.ctypes.data, layout.ctypes.data],
                      [bits, int(gathered)])


def unfolded_rotate_residency(kp: PBSKernelPlan, bits: int, M: int,
                              dev=None) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K4 on card ``dev``
    at ``kp``'s shape, its placement for M = 2^u exponents and the word
    width ``bits`` (the C entry `unfolded_rotate_residency`)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    layout, _ = kernel_layout("unfolded_rotate", kp,
                              _smem_budget("unfolded_rotate", _index(dev)),
                              M=M)
    return _residency("unfolded_rotate", "unfolded_rotate_launch", 10, 4,
                      "unfolded_rotate_residency", dev,
                      [kp.host_consts.ctypes.data, layout.ctypes.data],
                      [bits])


# ciphertexts per K5 block, at most, by word width: u64 words add in
# shared-memory loads and two-word adds, which a tile of 8 shares best;
# with u32 words the NTTs weigh as much as the adds and smaller blocks,
# more of them per SM, overlap them better (PERF.md, K5)
UBR_TILE = {64: 8, 32: 2}
UBR_STAGES = (4, 2, 1)   # key rows K5's ring may hold (ubr_phase1.cu)


def ubr_phase1_tiling(B: int, N: int, bits: int) -> dict:
    """K5's tiles for B ciphertexts at row length N and ``bits``-bit words:
    at most UBR_TILE[bits] ciphertexts per block (and groups of N/16
    threads within 1,024), as few tiles as that allows and ciphertexts
    spread evenly over them, so a batch of 9 takes two tiles of 5 at u64.
    ``tiles`` blocks share each key row."""
    T = rotation_schedule(N, 1)["threads_per_group"]
    cap = min(UBR_TILE[bits], ROTATION_MAX_THREADS // T)
    tiles = -(-B // cap)
    tile = -(-B // tiles) if tiles else 1
    return {"tile": tile, "tiles": tiles, "threads": tile * T}


def ubr_phase1_schedule(kp: PBSKernelPlan, B: int, M: int,
                        budget: int) -> dict:
    """K5's block for B ciphertexts and M = 2^u exponents at ``kp``'s shape,
    on a card that gives a block ``budget`` bytes of dynamic shared memory:
    the tiling (`ubr_phase1_tiling`), the most key rows of UBR_STAGES its
    ring holds beside the tile's exponents (the tile's exchange rows reuse
    the ring), and that placement (`kernel_layout`).  Raises ValueError
    where not one row fits."""
    tiling = ubr_phase1_tiling(B, kp.N, kp.torus_bits)
    for stages in UBR_STAGES:
        try:
            layout, _ = kernel_layout("ubr_phase1", kp, budget, M=M,
                                      tile=tiling["tile"], stages=stages)
        except ValueError:
            if stages == 1:
                raise
            continue
        return dict(tiling, stages=stages, layout=layout)


def ubr_phase1_residency(kp: PBSKernelPlan, bits: int, B: int, M: int,
                         dev=None) -> tuple[int, int]:
    """(blocks resident on one SM, threads per block) of K5, and so of
    K5-v1, on card ``dev`` at ``kp``'s shape, its schedule for B
    ciphertexts and M exponents and the word width ``bits`` (the C entry
    `ubr_phase1_residency`)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    sc = ubr_phase1_schedule(kp, B, M,
                             _smem_budget("ubr_phase1", _index(dev)))
    return _residency("ubr_phase1", "ubr_phase1_launch", 7, 6,
                      "ubr_phase1_residency", dev,
                      [kp.host_consts.ctypes.data, sc["layout"].ctypes.data],
                      [sc["tile"], sc["stages"], bits])


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def blind_rotate_scan(acc0, a_int, keyv, keyvs, kp: PBSKernelPlan):
    """The n-step CMUX chain.  CUDA tensors: one launch of the kernel (its
    one-limb form for int32 words, its two-limb form for int64), and an
    error raised if it does not build or launch.  CPU tensors: the plain
    version.  Returns the new accumulator [B, C, N] of acc0's dtype."""
    dev = acc0.device
    if dev.type == "cpu":
        return blind_rotate_scan_plain(acc0, a_int, keyv, keyvs, kp)
    if dev.type != "cuda":
        raise ValueError(f"blind_rotate_scan runs on cuda or cpu, not {dev}")
    bits = _word_width("blind_rotate_scan", acc0, kp)
    B, C, N = acc0.shape
    n = a_int.shape[0]
    key_shape = (n, kp.J, kp.C, kp.P, kp.N)
    _check("acc0", acc0, acc0.dtype, (B, kp.C, kp.N), dev)
    _check("a_int", a_int, torch.int32, (n, B), dev)
    _check("keyv", keyv, torch.int32, key_shape, dev)
    _check("keyvs", keyvs, torch.int32, key_shape, dev)
    _check_aligned("keyv", keyv)
    _check_plan(kp, dev)
    layout, ws = _layout("blind_rotate", kp, B, dev)
    acc = acc0.clone()
    _launch("blind_rotate", "blind_rotate_launch", 11, 3, dev,
            acc.data_ptr(), a_int.data_ptr(), keyv.data_ptr(),
            keyvs.data_ptr(), kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(),
            kp.inv_tw.data_ptr(), kp.inv_tws.data_ptr(), _ptr(ws),
            kp.host_consts.ctypes.data, layout.ctypes.data, B, n, bits)
    blind_rotate_scan.launches += 1
    return acc


blind_rotate_scan.launches = 0


def pbs_step_plain(acc, a, keyv, keyvs, kp: PBSKernelPlan):
    """K1-step in int64 PyTorch, on any device, at the width of acc's
    words: one CMUX step, ``acc`` updated in place and returned."""
    pbs_step_plain.calls += 1
    return acc.copy_(cmux_step(acc, i32_as_u32(keyv), i32_as_u32(keyvs), a,
                               kp.ntt, kp.l, kp.Bg_bit))


pbs_step_plain.calls = 0


def pbs_step(acc, a, keyv, keyvs, kp: PBSKernelPlan):
    """One CMUX step, acc += BK_i (x) (X^{a} acc - acc), in place (the TPU
    kernel `_pbs_step_tiles` aliases acc to its output): acc [B, C, N]
    int64 or int32 words, a [B] int32 in [0, 2N], keyv/keyvs [J, C, P, N]
    int32, the step's key rows.  CUDA tensors: one launch of the kernel
    (its one-limb form for int32 words), and an error raised if it does
    not build or launch.  CPU tensors: the plain version.  Returns acc."""
    bits = _word_width("pbs_step", acc, kp)
    dev = acc.device
    if dev.type == "cpu":
        return pbs_step_plain(acc, a, keyv, keyvs, kp)
    if dev.type != "cuda":
        raise ValueError(f"pbs_step runs on cuda or cpu, not {dev}")
    B = acc.shape[0]
    row = (kp.J, kp.C, kp.P, kp.N)
    _check("acc", acc, acc.dtype, (B, kp.C, kp.N), dev)
    _check("a", a, torch.int32, (B,), dev)
    _check("keyv", keyv, torch.int32, row, dev)
    _check("keyvs", keyvs, torch.int32, row, dev)
    _check_aligned("keyv", keyv)
    _check_plan(kp, dev)
    if B == 0:
        return acc
    layout, ws = _layout("pbs_step", kp, B, dev, source="blind_rotate")
    _launch("blind_rotate", "pbs_step_launch", 11, 2, dev,
            acc.data_ptr(), a.data_ptr(), keyv.data_ptr(), keyvs.data_ptr(),
            kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(),
            kp.inv_tw.data_ptr(), kp.inv_tws.data_ptr(), _ptr(ws),
            kp.host_consts.ctypes.data, layout.ctypes.data, B, bits)
    pbs_step.launches += 1
    return acc


pbs_step.launches = 0


# --- the key switch's select-sum -------------------------------------------

def tlwe_keyswitch_sum_plain(dig, ab):
    """The select-sum as a gather in PyTorch, on any device, over n_in in
    chunks that keep the [B, chunk, t, n_out+1] gather near 64 MB.  A digit
    outside [1, base) selects nothing, as in the kernels.  The sum is exact
    in int64 and ends in ab's words: mod 2^64, or mod 2^32 for an int32
    table."""
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
    return wrap(out, ab.dtype)


tlwe_keyswitch_sum_plain.calls = 0

# K2's tiling (``csrc/tlwe_keyswitch.cu``), mirrored here for the numpy
# rendering of its schedule (the kernel's entry refuses what does not fit,
# and `tlwe_keyswitch_schedule` reports the tiling it launches with, which
# the card's tests hold to this mirror): a block sums KS_TILE ciphertexts
# over a slice of KS_SLICE_BYTES of table words per row segment (64 u64 or
# 128 u32 columns), walking its rows in chunks through a ring of KS_STAGES
# chunks in shared memory; a chunk holds the largest power of two of rows,
# up to KS_MAX_CHUNK_ROWS, whose (base-1) slices fit KS_STAGE_TABLE_BYTES,
# each in a slot of KS_SLOT_BYTES (a slice and the 16-byte granules around
# it), then the tile's digits, KS_DIGIT_PITCH ints per row.
KS_TILE = 128
KS_STAGES = 3
KS_SLICE_BYTES = 512
KS_SLOT_BYTES = KS_SLICE_BYTES + 16
KS_STAGE_TABLE_BYTES = 32768
KS_MAX_CHUNK_ROWS = 32
KS_DIGIT_PITCH = KS_TILE + 8


def tlwe_keyswitch_tiling(base_m1: int, bits: int) -> dict:
    """K2's block shape for base-1 and the word width: ciphertexts per
    block (tile), columns per slice, rows per chunk, stages, bytes per stage
    and dynamic shared bytes per block (the ring, or the block's sums where
    those are larger), as the kernel's `tiling` computes them."""
    seg = base_m1 * KS_SLICE_BYTES
    rows = 1
    while 2 * rows <= KS_MAX_CHUNK_ROWS and 2 * rows * seg \
            <= KS_STAGE_TABLE_BYTES:
        rows *= 2
    stage = rows * (base_m1 * KS_SLOT_BYTES + 4 * KS_DIGIT_PITCH)
    return {"tile": KS_TILE, "slice": KS_SLICE_BYTES * 8 // bits,
            "chunk_rows": rows, "stages": KS_STAGES, "stage_bytes": stage,
            "smem": max(KS_STAGES * stage, KS_TILE * KS_SLICE_BYTES)}


KS_SCHEDULE_KEYS = ("tile", "slice", "chunk_rows", "stages", "stage_bytes",
                    "smem", "tiles", "slices", "cluster", "blocks",
                    "clusters_resident", "blocks_per_sm", "threads",
                    "epilogue_chunks")


def tlwe_keyswitch_schedule(B: int, n_rows: int, base_m1: int, width: int,
                            bits: int, dev=None) -> dict:
    """K2's launch for this shape on card ``dev`` (the C entry
    `tlwe_keyswitch_schedule`): its tiling, the tiles of ciphertexts and
    column slices, the cluster size S (blocks splitting the rows of one
    slice and tile) the launch picks from the CUDA runtime's cluster
    occupancy, the blocks, the clusters and blocks resident at once
    (per card and per SM), the threads per block, the epilogue's weight in
    chunks by which S is chosen, and ``clusters_by_size``: the clusters of
    S = 1..16 blocks the runtime can hold at once, from which S was
    chosen."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    lib = _kernel_lib("tlwe_keyswitch", "tlwe_keyswitch_sum_launch", 3, 5)
    fn = lib.tlwe_keyswitch_schedule
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n, max_cluster = len(KS_SCHEDULE_KEYS), 16
    out = (ctypes.c_int * (n + max_cluster))()
    with torch.cuda.device(dev):
        err = fn(B, n_rows, base_m1, width, bits, out)
    if err:
        raise RuntimeError("tlwe_keyswitch schedule query failed: "
                           + lib.cuda_error_string(err).decode())
    return dict(zip(KS_SCHEDULE_KEYS, out), clusters_by_size=list(out[n:]))


def tlwe_keyswitch_sum(dig, ab):
    """The select-sum.  CUDA tensors: one launch of the kernel (its one-plane
    form for an int32 table, mod 2^32), and an error raised if it does not
    build or launch, or (ValueError, before any launch) if a ring of its
    chunks does not fit a block's shared memory (base-1 above about 145).
    CPU tensors: the plain version.  Returns [B, n_out+1] words of ab's
    dtype."""
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
    bits = word_bits(ab)
    _check("ab", ab, ab.dtype, (n_in, t, base_m1, width), dev)
    out = torch.empty((B, width), dtype=ab.dtype, device=dev)
    if B == 0 or width == 0:
        return out
    _launch("tlwe_keyswitch", "tlwe_keyswitch_sum_launch", 3, 5, dev,
            dig.data_ptr(), ab.data_ptr(), out.data_ptr(), B, n_in * t,
            base_m1, width, bits,
            refused=f"tlwe_keyswitch_sum: shape refused before any launch "
                    f"(B={B}, base-1={base_m1}, width={width}): a ring of "
                    "its chunks must fit a block's shared memory (base-1 up "
                    "to about 145)")
    tlwe_keyswitch_sum.launches += 1
    return out


tlwe_keyswitch_sum.launches = 0


# --- the external-product apply scan (K3) -----------------------------------

def ext_product_replace(acc, key, plan: _ntt.NTTPlan, l: int, Bg_bit: int):
    """key (x) acc in replace mode (`trgsw_mul_trlwe_DFT`,
    `trgsw.c:385-423`): acc [B, C, N] int64 or int32 words; key [J, C, P,
    N] (one TRGSW for the batch) or [B, J, C, P, N] (one per row), canonical
    int64 residues.  Returns [B, C, N] of acc's dtype."""
    B, C, N = acc.shape
    digits = gadget_decompose(acc, Bg_bit, l).reshape(B, C * l, N)
    spec = _ntt.to_ntt_small(digits, plan)                     # [B, J, P, N]
    acc_ntt = _ntt.pointwise_mul_acc_generic(spec.unsqueeze(2), key, plan,
                                             dim=1)            # [B, C, P, N]
    return _ntt.from_ntt_u64(acc_ntt, plan, acc.dtype)


def ext_product_apply_scan_plain(acc0, sa32, kp: PBSKernelPlan,
                                 per_row: bool = False):
    """The G replace-mode external products in int64 PyTorch, on any
    device, at the width of acc0's words.  A per-row step key [B, J, C, P,
    N] and a broadcast one [J, C, P, N] take the same code."""
    ext_product_apply_scan_plain.calls += 1
    acc = acc0
    for g in range(sa32.shape[0]):
        acc = ext_product_replace(acc, i32_as_u32(sa32[g]), kp.ntt, kp.l,
                                  kp.Bg_bit)
    return acc


ext_product_apply_scan_plain.calls = 0


def ext_product_apply_scan(acc0, sa32, kp: PBSKernelPlan,
                           per_row: bool = False):
    """acc <- SA_g (x) acc for g = 0 .. G-1.  CUDA tensors: one launch of
    the kernel whatever G and B are (its one-limb form for int32 words),
    and an error raised if it does not build or launch.  CPU tensors: the
    plain version.  Returns [B, C, N] of acc0's dtype."""
    bits = _word_width("ext_product_apply_scan", acc0, kp)
    dev = acc0.device
    if dev.type == "cpu":
        return ext_product_apply_scan_plain(acc0, sa32, kp, per_row)
    if dev.type != "cuda":
        raise ValueError(f"ext_product_apply_scan runs on cuda or cpu, "
                         f"not {dev}")
    _one_limb_primes("ext_product_apply_scan", bits, kp)
    B = acc0.shape[0]
    G = sa32.shape[0]
    row = (kp.J, kp.C, kp.P, kp.N)
    _check("acc0", acc0, acc0.dtype, (B, kp.C, kp.N), dev)
    _check("sa32", sa32, torch.int32, (G, B) + row if per_row else (G,) + row,
           dev)
    _check_aligned("sa32", sa32)
    _check_plan(kp, dev)
    acc = acc0.clone()
    if B == 0 or G == 0:
        return acc
    layout, ws = _layout("ext_product_apply", kp, B, dev)
    _launch("ext_product_apply", "ext_product_apply_launch", 9, 4, dev,
            acc.data_ptr(), sa32.data_ptr(), kp.fwd_tw.data_ptr(),
            kp.fwd_tws.data_ptr(), kp.inv_tw.data_ptr(),
            kp.inv_tws.data_ptr(), _ptr(ws), kp.host_consts.ctypes.data,
            layout.ctypes.data, B, G, int(per_row), bits)
    ext_product_apply_scan.launches += 1
    return acc


ext_product_apply_scan.launches = 0


def ext_product_apply_step_plain(acc, key32, kp: PBSKernelPlan,
                                 per_row: bool = False):
    """K3-step in int64 PyTorch, on any device, at the width of acc's
    words: one replace-mode external product, ``acc`` updated in place and
    returned.  A per-row key [B, J, C, P, N] and a broadcast one [J, C, P,
    N] take the same code."""
    ext_product_apply_step_plain.calls += 1
    return acc.copy_(ext_product_replace(acc, i32_as_u32(key32), kp.ntt,
                                         kp.l, kp.Bg_bit))


ext_product_apply_step_plain.calls = 0


def ext_product_apply_step(acc, key32, kp: PBSKernelPlan,
                           per_row: bool = False):
    """acc <- SA (x) acc, one product, in place (the TPU kernel
    `_apply_step_tiles` aliases acc to its output): key32 [J, C, P, N]
    int32 broadcast over the batch, or [B, J, C, P, N] with per_row.  CUDA
    tensors: one launch of K3's kernel at G = 1 (its one-limb form for
    int32 words), and an error raised if it does not build or launch; the
    kernel reads ``key32`` 16 bytes at a time, so a view off that alignment
    raises ValueError.  CPU tensors: the plain version.  Returns acc."""
    bits = _word_width("ext_product_apply_step", acc, kp)
    dev = acc.device
    if dev.type == "cpu":
        return ext_product_apply_step_plain(acc, key32, kp, per_row)
    if dev.type != "cuda":
        raise ValueError(f"ext_product_apply_step runs on cuda or cpu, "
                         f"not {dev}")
    _one_limb_primes("ext_product_apply_step", bits, kp)
    B = acc.shape[0]
    row = (kp.J, kp.C, kp.P, kp.N)
    _check("acc", acc, acc.dtype, (B, kp.C, kp.N), dev)
    _check("key32", key32, torch.int32, (B,) + row if per_row else row, dev)
    _check_aligned("key32", key32)
    _check_plan(kp, dev)
    if B == 0:
        return acc
    layout, ws = _layout("ext_product_apply", kp, B, dev)
    _launch("ext_product_apply", "ext_product_apply_step_launch", 9, 3, dev,
            acc.data_ptr(), key32.data_ptr(), kp.fwd_tw.data_ptr(),
            kp.fwd_tws.data_ptr(), kp.inv_tw.data_ptr(),
            kp.inv_tws.data_ptr(), _ptr(ws), kp.host_consts.ctypes.data,
            layout.ctypes.data, B, int(per_row), bits)
    ext_product_apply_step.launches += 1
    return acc


ext_product_apply_step.launches = 0


# --- the unfolded blind rotation (K4) and UBR phase 1 (K5) -----------------

def combine_rotated(su_g, rot_g):
    """sum_m X^{rot_g[:, m]} * su_g[m] mod 2^64 (int64 words) or 2^32
    (int32): su_g [M, J, C, N], rot_g [B, M] -> [B, J, C, N] of su_g's
    dtype (`bootstrap.c:128-146`)."""
    comb = None
    for m in range(su_g.shape[0]):
        t = _poly.mul_by_xai(su_g[m], rot_g[:, m, None, None])
        comb = t if comb is None else comb + t
    return comb


def unfolded_rotate_plain(acc0, rot, su, kp: PBSKernelPlan):
    """The unfolded blind rotation in int64 PyTorch, on any device, at the
    width of the words: per group, the combined TRGSW in NTT form, then a
    replace-mode external product (`blind_rotate_unfolded`,
    `bootstrap.c:124-148`)."""
    unfolded_rotate_plain.calls += 1
    acc = acc0
    for g in range(su.shape[0]):
        key = _ntt.to_ntt_u64(combine_rotated(su[g], rot[:, g]), kp.ntt)
        acc = ext_product_replace(acc, key, kp.ntt, kp.l, kp.Bg_bit)
    return acc


unfolded_rotate_plain.calls = 0


def _check_unfolded(rot, su, kp: PBSKernelPlan, B: int, dev, dtype):
    G, M = su.shape[0], su.shape[1]
    _check("rot", rot, torch.int32, (B, G, M), dev)
    _check("su", su, dtype, (G, M, kp.J, kp.C, kp.N), dev)
    _check_plan(kp, dev)
    return G, M


def unfolded_rotate(acc0, rot, su, kp: PBSKernelPlan):
    """The unfolded blind rotation.  CUDA tensors: one launch of the kernel
    for all G groups (its one-limb form for int32 words), and an error
    raised if it does not build or launch.  CPU tensors: the plain version.
    Returns [B, C, N] of acc0's dtype."""
    bits = _word_width("unfolded_rotate", acc0, kp)
    dev = acc0.device
    if dev.type == "cpu":
        return unfolded_rotate_plain(acc0, rot, su, kp)
    if dev.type != "cuda":
        raise ValueError(f"unfolded_rotate runs on cuda or cpu, not {dev}")
    _one_limb_primes("unfolded_rotate", bits, kp)
    B = acc0.shape[0]
    _check("acc0", acc0, acc0.dtype, (B, kp.C, kp.N), dev)
    G, M = _check_unfolded(rot, su, kp, B, dev, acc0.dtype)
    acc = acc0.clone()
    if B == 0 or G == 0:
        return acc
    layout, ws = _layout("unfolded_rotate", kp, B, dev, M=M)
    _launch("unfolded_rotate", "unfolded_rotate_launch", 10, 4, dev,
            acc.data_ptr(), rot.data_ptr(), su.data_ptr(),
            kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(),
            kp.inv_tw.data_ptr(), kp.inv_tws.data_ptr(), _ptr(ws),
            kp.host_consts.ctypes.data, layout.ctypes.data, B, G, M, bits)
    unfolded_rotate.launches += 1
    return acc


unfolded_rotate.launches = 0


def _combined_ntt(su, rot, kp: PBSKernelPlan):
    """Per (b, g) the combined TRGSW in NTT form
    (`multivalue_bootstrap_UBR_phase1`, `bootstrap.c:151-175`): [B, G, J,
    C, P, N] int32 holding u32 canonical residues."""
    out = [_ntt.to_ntt_u64(combine_rotated(su[g], rot[:, g]), kp.ntt)
           for g in range(su.shape[0])]
    return u32_as_i32(torch.stack(out, dim=1))


def ubr_phase1_combine_plain(su, rot, kp: PBSKernelPlan):
    """UBR phase 1 in int64 PyTorch, on any device, at the width of su's
    words (`_combined_ntt`)."""
    ubr_phase1_combine_plain.calls += 1
    return _combined_ntt(su, rot, kp)


ubr_phase1_combine_plain.calls = 0


def _ubr_phase1(fn, plain, su, rot, kp: PBSKernelPlan):
    """K5's launch for wrapper ``fn`` (K5 or K5-v1: the same C entry
    `ubr_phase1_launch`, each counting its own launches); CPU tensors go to
    ``plain``.  K5's block holds its ring of key rows, its tile's exchange
    rows and exponents in shared memory (`ubr_phase1_schedule`): a shape
    where not one key row fits beside them raises ValueError before any
    launch, as does a key whose data pointer is not 16-byte aligned (the
    rows come by TMA bulk copies)."""
    name = fn.__name__
    bits = _word_width(name, su, kp)
    dev = su.device
    if dev.type == "cpu":
        return plain(su, rot, kp)
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    _one_limb_primes(name, bits, kp)
    B = rot.shape[0]
    G, M = _check_unfolded(rot, su, kp, B, dev, su.dtype)
    sc = ubr_phase1_schedule(kp, max(B, 1), M,
                             _smem_budget("ubr_phase1", _index(dev)))
    _check_aligned(f"{name} su", su)
    out = torch.empty((B, G, kp.J, kp.C, kp.P, kp.N), dtype=torch.int32,
                      device=dev)
    if B == 0 or G == 0:
        return out
    _launch("ubr_phase1", "ubr_phase1_launch", 7, 6, dev, su.data_ptr(),
            rot.data_ptr(), out.data_ptr(), kp.fwd_tw.data_ptr(),
            kp.fwd_tws.data_ptr(), kp.host_consts.ctypes.data,
            sc["layout"].ctypes.data, B, G, M, sc["tile"], sc["stages"], bits)
    fn.launches += 1
    return out


def ubr_phase1_combine(su, rot, kp: PBSKernelPlan):
    """UBR phase 1.  CUDA tensors: one launch of the kernel for all (b, g)
    (its one-limb form for int32 key products), and an error raised if it
    does not build or launch (ValueError, before any launch, where a row
    does not fit a block's shared memory).  CPU tensors: the plain version.
    Returns [B, G, J, C, P, N] int32 (u32 residues)."""
    return _ubr_phase1(ubr_phase1_combine, ubr_phase1_combine_plain, su, rot,
                       kp)


ubr_phase1_combine.launches = 0


def ubr_phase1_combine_v1_plain(su, rot, kp: PBSKernelPlan):
    """K5-v1 in int64 PyTorch, on any device: K5's function
    (`_combined_ntt`), the same words."""
    ubr_phase1_combine_v1_plain.calls += 1
    return _combined_ntt(su, rot, kp)


ubr_phase1_combine_v1_plain.calls = 0


def ubr_phase1_combine_v1(su, rot, kp: PBSKernelPlan):
    """UBR phase 1 through the TPU package's first entry
    (`ubr_phase1_combine`).  CUDA tensors: one launch of K5's kernel (its
    one-limb form for int32 key products), and an error raised if it does
    not build or launch (ValueError, before any launch, where a row does
    not fit a block's shared memory).  CPU tensors: the plain version.
    Returns [B, G, J, C, P, N] int32 (u32 residues), K5's words."""
    return _ubr_phase1(ubr_phase1_combine_v1, ubr_phase1_combine_v1_plain,
                       su, rot, kp)


ubr_phase1_combine_v1.launches = 0


# --- the automorphism key switch (K6, K6-old) and the GA rotation (K7) -----

def _keyswitch_rows(perm, key, kp: PBSKernelPlan):
    """(0, b) - sum_j dec_j(a) (x) key[b] per row of perm = (a, b), in int64
    PyTorch at the width of perm's words, under the key-switch plan ``kp``
    (t = kp.l digits of kp.Bg_bit bits, row c t + j the j-th digit of mask
    component c; `trlwe_keyswitch`, `keyswitch.c:162-193`).  perm [B, C, N];
    key [B, (C-1)t, C, P, N] canonical int64 residues."""
    B, C, N = perm.shape
    k = C - 1
    digits = gadget_decompose(perm[:, :k], kp.Bg_bit, kp.l)
    spec = _ntt.to_ntt_small(digits.reshape(B, k * kp.l, N),
                             kp.ntt)                           # [B, kt, P, N]
    acc = _ntt.pointwise_mul_acc_generic(spec.unsqueeze(2), key, kp.ntt, dim=1)
    # in int64, then wrapped once: a u32 word negated or summed in int32
    # would not be a wrap of the exact value in every case
    out = -_ntt.garner_u64(_ntt.inverse_ntt(acc, kp.ntt), kp.ntt)
    out[:, k] += perm[:, k].to(torch.int64)
    return wrap(out, perm.dtype)


def auto_keyswitch_rows(x, ak32, kidx, ginv, kp: PBSKernelPlan):
    """K6's arithmetic in int64 PyTorch, at the width of x's words: per
    row, (a', b') = psi(x[b]) with psi given by ginv[b], then the key switch
    against keyset entry kidx[b] (`_keyswitch_rows`).  x [B, C, N] int64 or
    int32; ak32 [G, (C-1)t, C, P, N]; kidx, ginv [B]."""
    perm = _poly.permute_by_inverse(x, ginv.to(torch.int64)[:, None])
    return _keyswitch_rows(perm, i32_as_u32(ak32[kidx.to(torch.int64)]), kp)


def auto_keyswitch_stream_plain(x, ak32, kidx, ginv, kp: PBSKernelPlan):
    """The automorphism key switch in int64 PyTorch, on any device, at the
    width of x's words."""
    auto_keyswitch_stream_plain.calls += 1
    return auto_keyswitch_rows(x, ak32, kidx, ginv, kp)


auto_keyswitch_stream_plain.calls = 0


def auto_keyswitch_stream(x, ak32, kidx, ginv, kp: PBSKernelPlan):
    """The automorphism key switch (TRLWE key switch when ginv is 1).  CUDA
    tensors: one launch of the kernel (its one-limb form for int32 words),
    and an error raised if it does not build or launch.  CPU tensors: the
    plain version.  ``kidx`` must lie in [0, G): the kernel reads the
    entries it names without a check (one on the device would cost a sync
    per call).  The kernel reads ``ak32`` 16 bytes at a time: a view off
    that alignment raises ValueError.  Returns [B, C, N] of x's dtype."""
    bits = _word_width("auto_keyswitch_stream", x, kp)
    dev = x.device
    if dev.type == "cpu":
        return auto_keyswitch_stream_plain(x, ak32, kidx, ginv, kp)
    if dev.type != "cuda":
        raise ValueError(f"auto_keyswitch_stream runs on cuda or cpu, "
                         f"not {dev}")
    _one_limb_primes("auto_keyswitch_stream", bits, kp)
    B, G = x.shape[0], ak32.shape[0]
    _check("x", x, x.dtype, (B, kp.C, kp.N), dev)
    _check("ak32", ak32, torch.int32,
           (G, (kp.C - 1) * kp.l, kp.C, kp.P, kp.N), dev)
    _check("kidx", kidx, torch.int32, (B,), dev)
    _check("ginv", ginv, torch.int32, (B,), dev)
    _check_aligned("ak32", ak32)
    _check_plan(kp, dev)
    out = torch.empty_like(x)
    if B == 0:
        return out
    layout, ws = _layout("auto_keyswitch_stream", kp, B, dev,
                         source="auto_keyswitch")
    _launch("auto_keyswitch", "auto_keyswitch_launch", 12, 2, dev,
            x.data_ptr(), ak32.data_ptr(), kidx.data_ptr(), ginv.data_ptr(),
            out.data_ptr(), kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(),
            kp.inv_tw.data_ptr(), kp.inv_tws.data_ptr(), _ptr(ws),
            kp.host_consts.ctypes.data, layout.ctypes.data, B, bits)
    auto_keyswitch_stream.launches += 1
    return out


auto_keyswitch_stream.launches = 0


def auto_keyswitch_plain(perm, key_rows, kp: PBSKernelPlan):
    """K6-old in int64 PyTorch, on any device, at the width of perm's words:
    the key switch of each (already permuted) row against its own gathered
    keyset entry."""
    auto_keyswitch_plain.calls += 1
    return _keyswitch_rows(perm, i32_as_u32(key_rows), kp)


auto_keyswitch_plain.calls = 0


def auto_keyswitch(perm, key_rows, kp: PBSKernelPlan):
    """The automorphism key switch with per-row gathered keys (K6-old, the
    TPU package's `auto_keyswitch`): perm [B, C, N] already permuted,
    key_rows [B, (C-1)t, C, P, N] int32 (u32 residues), row b's keyset
    entry.  CUDA tensors: one launch of K6's kernel in its gathered
    instances, entry b for row b and ginv 1 (its one-limb form for int32
    words), and an error raised if it does not build or launch; the kernel
    reads ``key_rows`` 16 bytes at a time, so a view off that alignment
    raises ValueError.  CPU tensors: the plain version.  Returns [B, C, N]
    of perm's dtype."""
    bits = _word_width("auto_keyswitch", perm, kp)
    dev = perm.device
    if dev.type == "cpu":
        return auto_keyswitch_plain(perm, key_rows, kp)
    if dev.type != "cuda":
        raise ValueError(f"auto_keyswitch runs on cuda or cpu, not {dev}")
    _one_limb_primes("auto_keyswitch", bits, kp)
    B = perm.shape[0]
    _check("perm", perm, perm.dtype, (B, kp.C, kp.N), dev)
    _check("key_rows", key_rows, torch.int32,
           (B, (kp.C - 1) * kp.l, kp.C, kp.P, kp.N), dev)
    _check_aligned("key_rows", key_rows)
    _check_plan(kp, dev)
    out = torch.empty_like(perm)
    if B == 0:
        return out
    layout, ws = _layout("auto_keyswitch_stream", kp, B, dev,
                         source="auto_keyswitch")
    _launch("auto_keyswitch", "auto_keyswitch_rows_launch", 10, 2, dev,
            perm.data_ptr(), key_rows.data_ptr(), out.data_ptr(),
            kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(),
            kp.inv_tw.data_ptr(), kp.inv_tws.data_ptr(), _ptr(ws),
            kp.host_consts.ctypes.data, layout.ctypes.data, B, bits)
    auto_keyswitch.launches += 1
    return out


auto_keyswitch.launches = 0


def cmux_delta_plain(x, keyv, keyvs, kp: PBSKernelPlan):
    """K1-delta in int64 PyTorch, on any device: the replace-mode external
    product of the one TRGSW (keyv, Shoup companions keyvs; [J, C, P, N]
    int32) with each row of x [B, C, N]."""
    cmux_delta_plain.calls += 1
    B, C, N = x.shape
    digits = gadget_decompose(x, kp.Bg_bit, kp.l).reshape(B, C * kp.l, N)
    spec = _ntt.to_ntt_small(digits, kp.ntt)                   # [B, J, P, N]
    acc = _ntt.pointwise_mul_acc_key(spec.unsqueeze(2), i32_as_u32(keyv),
                                     i32_as_u32(keyvs), kp.ntt, dim=1)
    return _ntt.from_ntt_u64(acc, kp.ntt, x.dtype)


cmux_delta_plain.calls = 0


def cmux_delta(x, keyv, keyvs, kp: PBSKernelPlan):
    """BK (x) x, one external product with a static TRGSW over a batch (the
    TPU package's `cmux_delta`): the GA step's first half.  64-bit torus
    only (int32 words raise NotImplementedError, as the TPU kernel asserts
    two limbs).  CUDA tensors: one launch of the kernel, and an error
    raised if it does not build or launch.  CPU tensors: the plain
    version.  The kernel reads ``keyv`` 16 bytes at a time (a view off that
    alignment raises ValueError) and never ``keyvs``.  Returns [B, C, N]
    int64."""
    _u64_only("cmux_delta", x)
    _word_width("cmux_delta", x, kp)
    dev = x.device
    if dev.type == "cpu":
        return cmux_delta_plain(x, keyv, keyvs, kp)
    if dev.type != "cuda":
        raise ValueError(f"cmux_delta runs on cuda or cpu, not {dev}")
    B = x.shape[0]
    row = (kp.J, kp.C, kp.P, kp.N)
    _check("x", x, torch.int64, (B, kp.C, kp.N), dev)
    _check("keyv", keyv, torch.int32, row, dev)
    _check("keyvs", keyvs, torch.int32, row, dev)
    _check_aligned("keyv", keyv)
    _check_plan(kp, dev)
    out = torch.empty_like(x)
    if B == 0:
        return out
    layout, ws = _layout("cmux_delta", kp, B, dev)
    _launch("cmux_delta", "cmux_delta_launch", 11, 1, dev,
            x.data_ptr(), keyv.data_ptr(), keyvs.data_ptr(), out.data_ptr(),
            kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(),
            kp.inv_tw.data_ptr(), kp.inv_tws.data_ptr(), _ptr(ws),
            kp.host_consts.ctypes.data, layout.ctypes.data, B)
    cmux_delta.launches += 1
    return out


cmux_delta.launches = 0


def ga_scan_fused_plain(acc0, gens, sv32, svs32, ak32, inv2n,
                        kp: PBSKernelPlan, kp_ks: PBSKernelPlan):
    """The GA rotation in int64 PyTorch, on any device, at the width of
    acc0's words: per step the replace-mode external product with
    TRGSW(X^{s_i}), then the Galois permutation and automorphism key switch
    of ``gens[i]`` (`blind_rotate_ga`, `bootstrap_ga.c:39-60`).  The Shoup
    companions ``svs32`` are not read: the product ends canonical either
    way."""
    ga_scan_fused_plain.calls += 1
    acc = acc0
    inv = inv2n.to(torch.int64)
    for i in range(gens.shape[0]):
        t = ext_product_replace(acc, i32_as_u32(sv32[i]), kp.ntt, kp.l,
                                kp.Bg_bit)
        kidx = (gens[i].to(torch.int64) - 1) >> 1
        acc = auto_keyswitch_rows(t, ak32, kidx, inv[kidx], kp_ks)
    return acc


ga_scan_fused_plain.calls = 0


def ga_scan_fused(acc0, gens, sv32, svs32, ak32, inv2n, kp: PBSKernelPlan,
                  kp_ks: PBSKernelPlan):
    """The whole GA rotation.  CUDA tensors: one launch of the kernel (its
    one-limb form for int32 words; both plans must be of their width), and
    an error raised if it does not build or launch.  CPU tensors: the plain
    version.  ``gens`` must be odd in [1, 2 min(G, N)): (g - 1)/2 indexes
    the keyset and ``inv2n`` unchecked, as in `auto_keyswitch_stream`.  The
    kernel reads ``sv32`` and ``ak32`` 16 bytes at a time (a view off that
    alignment raises ValueError) and never ``svs32``.  Returns [B, C, N] of
    acc0's dtype."""
    bits = _word_width("ga_scan_fused", acc0, kp)
    _word_width("ga_scan_fused", acc0, kp_ks)
    dev = acc0.device
    if dev.type == "cpu":
        return ga_scan_fused_plain(acc0, gens, sv32, svs32, ak32, inv2n, kp,
                                   kp_ks)
    if dev.type != "cuda":
        raise ValueError(f"ga_scan_fused runs on cuda or cpu, not {dev}")
    if (kp_ks.N, kp_ks.C) != (kp.N, kp.C):
        raise ValueError("the two plans must share N and k")
    _one_limb_primes("ga_scan_fused", bits, kp)
    _one_limb_primes("ga_scan_fused", bits, kp_ks)
    B, n, G = acc0.shape[0], gens.shape[0], ak32.shape[0]
    key_shape = (n, kp.J, kp.C, kp.P, kp.N)
    _check("acc0", acc0, acc0.dtype, (B, kp.C, kp.N), dev)
    _check("gens", gens, torch.int32, (n, B), dev)
    _check("sv32", sv32, torch.int32, key_shape, dev)
    _check("svs32", svs32, torch.int32, key_shape, dev)
    _check("ak32", ak32, torch.int32,
           (G, (kp.C - 1) * kp_ks.l, kp.C, kp_ks.P, kp.N), dev)
    _check("inv2n", inv2n, torch.int32, (kp.N,), dev)
    _check_aligned("sv32", sv32)
    _check_aligned("ak32", ak32)
    _check_plan(kp, dev)
    _check_plan(kp_ks, dev)
    acc = acc0.clone()
    if B == 0 or n == 0:
        return acc
    layout, ws = _layout("ga_scan", kp, B, dev, P_ks=kp_ks.P)
    _launch("ga_scan", "ga_scan_launch", 18, 3, dev,
            acc.data_ptr(), gens.data_ptr(), sv32.data_ptr(),
            svs32.data_ptr(), ak32.data_ptr(), inv2n.data_ptr(),
            kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(),
            kp.inv_tw.data_ptr(), kp.inv_tws.data_ptr(),
            kp_ks.fwd_tw.data_ptr(), kp_ks.fwd_tws.data_ptr(),
            kp_ks.inv_tw.data_ptr(), kp_ks.inv_tws.data_ptr(), _ptr(ws),
            kp.host_consts.ctypes.data, kp_ks.host_consts.ctypes.data,
            layout.ctypes.data, B, n, bits)
    ga_scan_fused.launches += 1
    return acc


ga_scan_fused.launches = 0


# --- the gadget-row split CMUX step (K8a, K8b) ------------------------------

def partial_step_plain(acc, a, j0: int, keyv, keyvs, kp: PBSKernelPlan):
    """K8a in int64 PyTorch, on any device, at the width of acc's words:
    `cmux_partial` over the global key rows [j0, j0 + j_local).  Returns
    [B, C, P, N] int32 (u32 canonical residues)."""
    partial_step_plain.calls += 1
    return u32_as_i32(cmux_partial(acc, a, j0, i32_as_u32(keyv),
                                   i32_as_u32(keyvs), kp.ntt, kp.l,
                                   kp.Bg_bit))


partial_step_plain.calls = 0


def partial_step(acc, a, j0: int, keyv, keyvs, kp: PBSKernelPlan, out=None):
    """The partial of one CMUX step over key rows [j0, j0 + j_local).  CUDA
    tensors: one launch of the kernel (its one-limb form for int32 words),
    written into ``out`` [B, C, P, N] int32 when given (a slot of the
    buffer `finish_step` reads), and an error raised if it does not build
    or launch.  CPU tensors: the plain version.  Returns the partial."""
    bits = _word_width("partial_step", acc, kp)
    dev = acc.device
    if dev.type == "cpu":
        part = partial_step_plain(acc, a, j0, keyv, keyvs, kp)
        return part if out is None else out.copy_(part)
    if dev.type != "cuda":
        raise ValueError(f"partial_step runs on cuda or cpu, not {dev}")
    _one_limb_primes("partial_step", bits, kp)
    B, j_local = acc.shape[0], keyv.shape[0]
    if not (0 <= j0 and 1 <= j_local and j0 + j_local <= kp.J):
        raise ValueError(f"key rows [{j0}, {j0 + j_local}) outside "
                         f"[0, {kp.J})")
    row = (j_local, kp.C, kp.P, kp.N)
    _check("acc", acc, acc.dtype, (B, kp.C, kp.N), dev)
    _check("a", a, torch.int32, (B,), dev)
    _check("keyv", keyv, torch.int32, row, dev)
    _check("keyvs", keyvs, torch.int32, row, dev)
    _check_plan(kp, dev)
    if out is None:
        out = torch.empty((B, kp.C, kp.P, kp.N), dtype=torch.int32,
                          device=dev)
    _check("out", out, torch.int32, (B, kp.C, kp.P, kp.N), dev)
    _check_aligned("keyv", keyv)
    _check_aligned("out", out)
    if B == 0:
        return out
    layout, ws = _layout("tp_step", kp, B, dev)
    _launch("tp_step", "partial_step_launch", 10, 4, dev,
            acc.data_ptr(), a.data_ptr(), keyv.data_ptr(), keyvs.data_ptr(),
            kp.fwd_tw.data_ptr(), kp.fwd_tws.data_ptr(), out.data_ptr(),
            _ptr(ws), kp.host_consts.ctypes.data, layout.ctypes.data, B, j0,
            j_local, bits)
    partial_step.launches += 1
    return out


partial_step.launches = 0


def finish_step_plain(acc, parts, kp: PBSKernelPlan):
    """K8b in int64 PyTorch, on any device, at the width of acc's words:
    acc += INTT(sum of the m partials mod p), the tail of `cmux_step`.
    ``acc`` is updated in place and returned."""
    finish_step_plain.calls += 1
    s = torch.remainder(i32_as_u32(parts).sum(dim=0), kp.ntt.p[:, None])
    return acc.add_(_ntt.from_ntt_u64(s, kp.ntt, acc.dtype))


finish_step_plain.calls = 0


def finish_step(acc, parts, kp: PBSKernelPlan):
    """The finish of one CMUX step on the partials ``parts`` [m, B, C, P, N]
    of all m shards: their sum mod p, inverse NTT, Garner, and acc += that,
    in place (the TPU kernel aliases acc to its output).  CUDA tensors: one
    launch of the kernel (its one-limb form for int32 words; one pass per
    component where the C*P spectra exceed shared memory), and an error
    raised if it does not build or launch.  CPU tensors: the plain version.
    Returns acc."""
    bits = _word_width("finish_step", acc, kp)
    dev = acc.device
    if dev.type == "cpu":
        return finish_step_plain(acc, parts, kp)
    if dev.type != "cuda":
        raise ValueError(f"finish_step runs on cuda or cpu, not {dev}")
    _one_limb_primes("finish_step", bits, kp)
    B, m = acc.shape[0], parts.shape[0]
    _check("acc", acc, acc.dtype, (B, kp.C, kp.N), dev)
    _check("parts", parts, torch.int32, (m, B, kp.C, kp.P, kp.N), dev)
    _check_aligned("parts", parts)
    _check_plan(kp, dev)
    if m < 1:
        raise ValueError("finish_step needs at least one partial")
    layout, _ = _layout("finish_step", kp, B, dev, source="tp_step")
    if B == 0:
        return acc
    _launch("tp_step", "finish_step_launch", 6, 3, dev,
            acc.data_ptr(), parts.data_ptr(), kp.inv_tw.data_ptr(),
            kp.inv_tws.data_ptr(), kp.host_consts.ctypes.data,
            layout.ctypes.data, B, m, bits)
    finish_step.launches += 1
    return acc


finish_step.launches = 0
