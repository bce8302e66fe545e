"""TRLWE -> TRLWE key switching and automorphism keysets
(`src/keyswitch.c:12-37,162-193,500-524`, `trlwe.c:775-781`).

The dense digit-decomposed key switch and the Galois automorphisms built
on it, the part of the family that the GA bootstrap needs.  Both run as
one launch of the automorphism key-switch kernel (K6,
``ops/csrc/auto_keyswitch.cu``) on CUDA tensors and its plain version on
CPU tensors: a key-switch key is a keyset of one entry, selected by index
0 with no permutation; `eval_automorphism` passes the generator's inverse
and the kernel permutes as it loads.

Both torus widths: under ``MOSFHET_TORUS_BITS=32`` the keys encrypt the
32-bit gadget values with the 32-bit key-switch plan, and the switches run
K6's one-limb form on int32 words.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from . import ntt as _ntt
from . import polynomial as _poly
from . import trlwe as _trlwe
from ._device import default_device
from .ops import pbs_kernel as _pk
from .trgsw import _gadget_values
from .trlwe import TRLWE, TRLWEKey, from_stacked


class TRLWEKSKey(nn.Module):
    """NTT-form encryptions of s_in[i] 2^(TORUS_BITS - (j+1) base_bit) under
    the output key (`trlwe_new_KS_key`): ``v32`` [k_in, t, k_out+1, P, N]
    int32 holding u32 canonical residues (the kernel multiplies runtime keys
    by Barrett, so no Shoup companions are kept); ``v`` gives the int64
    values."""

    def __init__(self, v32: torch.Tensor, t: int, base_bit: int, primes):
        super().__init__()
        self.register_buffer("v32", v32)
        self.t, self.base_bit = t, base_bit
        self.primes = tuple(int(p) for p in primes)

    @property
    def v(self):
        return _pk.i32_as_u32(self.v32)

    @property
    def k_in(self) -> int:
        return self.v32.shape[0]

    @property
    def N(self) -> int:
        return self.v32.shape[-1]

    def kernel_plan(self) -> _pk.PBSKernelPlan:
        """K6's plan: the key switch's t and base_bit as its l and Bg_bit."""
        return _pk.get_kernel_plan(self.N, self.primes, self.t, self.base_bit,
                                   self.v32.shape[2] - 1, self.v32.device)


def _ks_plan(N: int, base_bit: int, t: int, k_in: int, device) -> _ntt.NTTPlan:
    bound = _ntt.conv_bound(N, 1 << (base_bit - 1), k_in * t)
    return _ntt.get_plan(N, _ntt.primes_for_bound(bound), device)


def _encrypt_batch_to_dft(ms, out_key: TRLWEKey, generator: torch.Generator,
                          plan: _ntt.NTTPlan):
    """Encrypt a [..., N] batch of messages; return the stacked NTT form
    [..., k+1, P, N] as int64 residues."""
    c = _trlwe.encrypt(ms, out_key, generator)
    return _ntt.to_ntt_u64(c.stacked(), plan)


def new_trlwe_ks_key(out_key: TRLWEKey, in_key: TRLWEKey, t: int,
                     base_bit: int, generator: torch.Generator,
                     device=None) -> TRLWEKSKey:
    """(`trlwe_new_KS_key`, `keyswitch.c:12-37`), at the module's torus
    width.  Computed where the keys live, returned on ``device``."""
    dev = default_device(device)
    plan = _ks_plan(out_key.N, base_bit, t, in_key.k * t, out_key.s.device)
    ms = in_key.s[:, None, :] * _gadget_values(t, base_bit,
                                               in_key.s.device)[:, None]
    v = _encrypt_batch_to_dft(ms, out_key, generator, plan)
    return TRLWEKSKey(_pk.u32_as_i32(v), t, base_bit, plan.primes).to(dev)


def _switch(c: TRLWE, ksk: TRLWEKSKey, ginv: int) -> TRLWE:
    """One K6 launch over the flattened batch of ``c``: permute by ginv,
    then switch with the key's one entry."""
    k, N = c.k, c.N
    if ksk.v32.shape[:3] != (k, ksk.t, k + 1):
        raise ValueError(f"a key [k_in, t, k_out+1] = {tuple(ksk.v32.shape[:3])}"
                         f" does not switch a k={k} TRLWE to k={k}")
    st = c.stacked()
    batch = tuple(st.shape[:-2])
    B = math.prod(batch)
    x = st.reshape(B, k + 1, N).contiguous()
    entry = ksk.v32.reshape((1, k * ksk.t) + tuple(ksk.v32.shape[2:]))
    kidx = torch.zeros(B, dtype=torch.int32, device=x.device)
    out = _pk.auto_keyswitch_stream(x, entry, kidx, torch.full_like(kidx, ginv),
                                    ksk.kernel_plan())
    return from_stacked(out.reshape(batch + (k + 1, N)))


def trlwe_keyswitch(c: TRLWE, ksk: TRLWEKSKey) -> TRLWE:
    """(`trlwe_keyswitch`, `keyswitch.c:162-193`):
    out = (0, b) - sum_{i,j} dec_j(a_i) (x) KS[i][j], for a dense key with
    k_in = k_out.  On CUDA tensors one K6 launch, on CPU tensors its plain
    version."""
    return _switch(c, ksk, 1)


def eval_automorphism(c: TRLWE, gen: int, ksk: TRLWEKSKey) -> TRLWE:
    """x^i -> x^(gen i), then the key switch back (`trlwe_eval_automorphism`,
    `trlwe.c:775-781`): ``trlwe_keyswitch(trlwe.permute(c, gen), ksk)``, as
    one K6 launch that permutes as it loads."""
    if gen % 2 != 1:
        raise ValueError(f"an automorphism needs an odd generator, got {gen}")
    return _switch(c, ksk, pow(int(gen), -1, 2 * c.N))


def new_automorphism_ks_keyset(key: TRLWEKey, gens, t: int, base_bit: int,
                               generator: torch.Generator,
                               device=None) -> dict:
    """KS keys for the permuted keys s(X^gen) -> s
    (`trlwe_new_automorphism_KS_keyset`, `keyswitch.c:500-524`).  Returns
    {gen: TRLWEKSKey}."""
    out = {}
    for gen in gens:
        key2 = TRLWEKey(s=_poly.permute(key.s, int(gen)), sigma=key.sigma,
                        s_bound=key.s_bound)
        out[int(gen)] = new_trlwe_ks_key(key, key2, t, base_bit, generator,
                                         device)
    return out


def all_odd_gens(N: int):
    return tuple(range(1, 2 * N, 2))
