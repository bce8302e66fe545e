"""numpy <-> port converters for keys and ciphertexts.

Key material made elsewhere (the TPU package, a file) crosses as numpy
arrays: u64 torus words and residues as ``uint64`` (or their ``int64``
view), u32 torus words (the 32-bit torus) as ``uint32`` (or ``int32``),
secret keys as ``int64``.  Residues cross as ``uint64`` at either width.
Threefry seeds cross as ``uint32`` key words [..., 2] and are held as
int64 values in [0, 2^32).
This module imports no other framework; the caller hands over plain arrays
of the objects' fields.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import default_device
from .bootstrap import BootstrapKey
from .bootstrap_ga import GABootstrapKey
from .keyswitch import (FullPackingKSKey, GenericKSKey, LUTPackingKSKey,
                        SeededGenericKSKey, SeededLUTPackingKSKey,
                        SeededTRLWEKSKey, TRLWEKSKey)
from .seeded import MosfhetSeededTRLWE, SeededTRLWE
from .ops.pbs_kernel import i32_as_u32, u32_as_i32
from .tlwe import TLWE, TLWEKey, TLWEKSKey, TLWEKSKeyM, TLWEKSKeyPrepared
from .trgsw import TRGSW, TRGSWDFT, TRGSWReg
from .trlwe import TRLWE, TRLWEDFT, TRLWEKey


def to_tensor(x, device=None) -> torch.Tensor:
    """u32 or int32 array -> int32 tensor, any other integer array (u64,
    int64) -> int64 tensor, with the same bits (a copy, so read-only inputs
    are fine)."""
    x = np.asarray(x)
    if x.dtype in (np.uint32, np.int32):
        x = np.array(x.view(np.int32))
    else:
        if x.dtype == np.uint64:
            x = x.view(np.int64)
        x = np.array(x, dtype=np.int64)
    return torch.from_numpy(x).to(default_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor of torus words -> unsigned array: int64 to uint64, int32 to
    uint32."""
    x = t.detach().cpu().numpy()
    return x.view(np.uint32 if x.dtype == np.int32 else np.uint64)


def tlwe_key_from_numpy(s, sigma: float, device=None) -> TLWEKey:
    return TLWEKey(s=to_tensor(s, device), sigma=sigma)


def trlwe_key_from_numpy(s, sigma: float, s_bound: int,
                         device=None) -> TRLWEKey:
    return TRLWEKey(s=to_tensor(s, device), sigma=sigma, s_bound=s_bound)


def key_to_numpy(key) -> np.ndarray:
    """Secret key coefficients (TLWEKey or TRLWEKey) as int64."""
    return key.s.cpu().numpy()


def tlwe_from_numpy(a, b, device=None) -> TLWE:
    return TLWE(a=to_tensor(a, device), b=to_tensor(b, device))


def tlwe_to_numpy(c: TLWE):
    return to_numpy(c.a), to_numpy(c.b)


def trlwe_from_numpy(a, b, device=None) -> TRLWE:
    return TRLWE(a=to_tensor(a, device), b=to_tensor(b, device))


def trlwe_to_numpy(c: TRLWE):
    return to_numpy(c.a), to_numpy(c.b)


def trlwe_dft_from_numpy(v, vs, primes, device=None) -> TRLWEDFT:
    """An NTT-form TRLWE from its residues [..., k+1, P, N] and Shoup
    companions (or None)."""
    return TRLWEDFT(v=to_tensor(v, device),
                    vs=None if vs is None else to_tensor(vs, device),
                    primes=tuple(int(p) for p in primes))


def trlwe_dft_to_numpy(c: TRLWEDFT):
    return to_numpy(c.v), None if c.vs is None else to_numpy(c.vs)


def trgsw_from_numpy(rows, l: int, Bg_bit: int, device=None) -> TRGSW:
    return TRGSW(rows=to_tensor(rows, device), l=l, Bg_bit=Bg_bit)


def trgsw_to_numpy(g: TRGSW) -> np.ndarray:
    return to_numpy(g.rows)


def trgsw_dft_from_numpy(v, vs, l: int, Bg_bit: int, primes,
                         device=None) -> TRGSWDFT:
    """An NTT-form TRGSW, batched or not, with or without Shoup companions
    (``vs`` None).  Residues may come as u64 (the TPU package's jnp paths)
    or u32 (its kernels); this is also how a UBR phase-1 cache
    [..., n/u, J, C, P, N] crosses."""
    return TRGSWDFT(v=to_tensor(v, device),
                    vs=None if vs is None else to_tensor(vs, device),
                    l=l, Bg_bit=Bg_bit, primes=tuple(int(p) for p in primes))


def trgsw_dft_to_numpy(g: TRGSWDFT):
    return to_numpy(g.v), None if g.vs is None else to_numpy(g.vs)


def trgsw_reg_from_numpy(pos_v, pos_vs, neg_v, neg_vs, l: int, Bg_bit: int,
                         primes, device=None) -> TRGSWReg:
    """A TRGSW register from the NTT-form residues and Shoup companions (or
    None) of its positive and negative halves, X^m and X^-m."""
    return TRGSWReg(
        positive=trgsw_dft_from_numpy(pos_v, pos_vs, l, Bg_bit, primes,
                                      device),
        negative=trgsw_dft_from_numpy(neg_v, neg_vs, l, Bg_bit, primes,
                                      device))


def trgsw_reg_to_numpy(r: TRGSWReg):
    """(pos_v, pos_vs, neg_v, neg_vs), the companions None where absent."""
    return trgsw_dft_to_numpy(r.positive) + trgsw_dft_to_numpy(r.negative)


def bootstrap_key_from_numpy(v, vs, n: int, k: int, N: int, l: int,
                             Bg_bit: int, primes, device=None) -> BootstrapKey:
    """An unfold=1 bootstrap key from its NTT-form rows and Shoup companions
    [n, (k+1)l, k+1, P, N]; the kernel's 32-bit copies are built here, once."""
    dev = default_device(device)
    return BootstrapKey.from_dft(to_tensor(v, "cpu"), to_tensor(vs, "cpu"),
                                 n, k, N, l, Bg_bit, primes).to(dev)


def bootstrap_key_to_numpy(bk: BootstrapKey):
    return to_numpy(bk.v), to_numpy(bk.vs)


def unfolded_bootstrap_key_from_numpy(su_planes, n: int, k: int, N: int,
                                      l: int, Bg_bit: int, primes,
                                      unfolding: int,
                                      device=None) -> BootstrapKey:
    """An unfolded bootstrap key from the TPU package's u32 limb planes
    [nl, n/u, 2^u, (k+1)l, k+1, N] (plane 0 the low limb): two planes join
    into the port's int64 [n/u, 2^u, (k+1)l, k+1, N] u64 words, one plane
    (the 32-bit torus) is its int32 u32 words."""
    planes = np.asarray(su_planes, dtype=np.uint32)
    if planes.shape[0] == 2:
        su = planes[0].astype(np.uint64) | (planes[1].astype(np.uint64) << 32)
    elif planes.shape[0] == 1:
        su = planes[0]
    else:
        raise ValueError("want 1 (32-bit torus) or 2 (64-bit) limb planes, "
                         f"got {planes.shape[0]}")
    return BootstrapKey(None, None, n, k, N, l, Bg_bit, primes,
                        su=to_tensor(su, "cpu"),
                        unfolding=unfolding).to(default_device(device))


def unfolded_bootstrap_key_to_numpy(bk: BootstrapKey) -> np.ndarray:
    """The key products as the TPU package's u32 limb planes: two for u64
    words, one for u32 words."""
    su = to_numpy(bk.su)
    if su.dtype == np.uint32:
        return su[None]
    return np.stack([(su & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (su >> np.uint64(32)).astype(np.uint32)])


def ga_bootstrap_key_from_numpy(s_v, s_vs, ak_v, inv2n, n: int, k: int,
                                N: int, l: int, Bg_bit: int, ks_t: int,
                                ks_base_bit: int, primes, ks_primes,
                                device=None) -> GABootstrapKey:
    """A GA bootstrap key from the TPU package's fields: the NTT-form
    TRGSW(X^{s_i}) rows and Shoup companions [n, (k+1)l, k+1, P, N], the
    keyset residues [N, k t, k+1, P_ks, N] (its Shoup companions are not
    needed) and the inverse table [N]."""
    dev = default_device(device)
    return GABootstrapKey(
        u32_as_i32(to_tensor(s_v, dev)), u32_as_i32(to_tensor(s_vs, dev)),
        u32_as_i32(to_tensor(ak_v, dev)),
        torch.from_numpy(np.asarray(inv2n, np.int32).copy()).to(dev),
        n, k, N, l, Bg_bit, ks_t, ks_base_bit, primes, ks_primes)


def ga_bootstrap_key_to_numpy(bk: GABootstrapKey):
    """(s_v, s_vs, ak_v) as uint64 residues and inv2n as int32."""
    return (to_numpy(bk.s_v), to_numpy(bk.s_vs),
            to_numpy(i32_as_u32(bk.ak)), bk.inv2n.cpu().numpy())


def trlwe_ks_key_from_numpy(v, t: int, base_bit: int, primes,
                            device=None) -> TRLWEKSKey:
    """A TRLWE key-switch key from its NTT-form residues [k_in, t, k_out+1,
    P, N] (the Shoup companions are not needed)."""
    return TRLWEKSKey(u32_as_i32(to_tensor(v, device)), t, base_bit, primes)


def trlwe_ks_key_to_numpy(ksk: TRLWEKSKey) -> np.ndarray:
    return to_numpy(ksk.v)


def tlwe_ks_key_from_numpy(a, b, t: int, base_bit: int,
                           device=None) -> TLWEKSKey:
    """A precomputed KS table from its mask words a [n_in, t, base-1,
    n_out] and bodies b [n_in, t, base-1], joined once into the kernel's
    [n_in, t, base-1, n_out+1] form."""
    ab = np.concatenate([np.asarray(a), np.asarray(b)[..., None]], axis=-1)
    return TLWEKSKey(to_tensor(ab, device), t, base_bit)


def tlwe_ks_key_to_numpy(ksk: TLWEKSKey):
    return to_numpy(ksk.a), to_numpy(ksk.b)


def tlwe_ks_key_m_from_numpy(a, b, t: int, base_bit: int,
                             device=None) -> TLWEKSKeyM:
    return TLWEKSKeyM(a=to_tensor(a, device), b=to_tensor(b, device), t=t,
                      base_bit=base_bit)


def tlwe_ks_key_m_to_numpy(ksk: TLWEKSKeyM):
    return to_numpy(ksk.a), to_numpy(ksk.b)


def tlwe_ks_key_prepared_from_numpy(a_nib, b_nib, t: int, base_bit: int,
                                    device=None) -> TLWEKSKeyPrepared:
    """The int8-limb KS key; limbs a_nib [16, n_in*t, n_out] and b_nib
    [16, n_in*t] as int8 arrays."""
    dev = default_device(device)
    return TLWEKSKeyPrepared(
        a_nib=torch.from_numpy(np.array(a_nib, dtype=np.int8)).to(dev),
        b_nib=torch.from_numpy(np.array(b_nib, dtype=np.int8)).to(dev),
        t=t, base_bit=base_bit)


def tlwe_ks_key_prepared_to_numpy(ksk: TLWEKSKeyPrepared):
    return ksk.a_nib.cpu().numpy(), ksk.b_nib.cpu().numpy()


def seeds_to_tensor(x, device=None) -> torch.Tensor:
    """Threefry key words [..., 2] (u32) -> int64 tensor of their values."""
    x = np.asarray(x).astype(np.uint32).astype(np.int64)
    return torch.from_numpy(x).to(default_device(device))


def seeds_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint32)


def seeded_trlwe_from_numpy(seed, b, k: int, device=None) -> SeededTRLWE:
    return SeededTRLWE(seed=seeds_to_tensor(seed, device),
                       b=to_tensor(b, device), k=k)


def seeded_trlwe_to_numpy(c: SeededTRLWE):
    return seeds_to_numpy(c.seed), to_numpy(c.b)


def mosfhet_seeded_trlwe_from_numpy(seed, b, k: int, prng: str = "xoroshiro",
                                    device=None) -> MosfhetSeededTRLWE:
    """A reference-format seeded TRLWE: 16-byte seeds [..., 16] (uint8) and
    the b words [..., N]."""
    dev = default_device(device)
    return MosfhetSeededTRLWE(
        seed=torch.from_numpy(np.array(seed, dtype=np.uint8)).to(dev),
        b=to_tensor(b, dev), k=k, prng=prng)


def mosfhet_seeded_trlwe_to_numpy(c: MosfhetSeededTRLWE):
    return c.seed.cpu().numpy(), to_numpy(c.b)


def seeded_trlwe_ks_key_from_numpy(seeds, b_v, k_out: int, t: int,
                                   base_bit: int, primes,
                                   device=None) -> SeededTRLWEKSKey:
    """A seeded TRLWE key-switch key from its seeds [k_in, t, 2] and the b
    rows' residues [k_in, t, P, N] (the Shoup companions are not needed)."""
    return SeededTRLWEKSKey(seeds_to_tensor(seeds, device),
                            u32_as_i32(to_tensor(b_v, device)), k_out, t,
                            base_bit, primes)


def seeded_trlwe_ks_key_to_numpy(ksk: SeededTRLWEKSKey):
    return seeds_to_numpy(ksk.seeds), to_numpy(i32_as_u32(ksk.b_v32))


def trlwe_ks_keys_from_numpy(vs, t: int, base_bit: int, primes,
                             device=None) -> list:
    """A list of TRLWE key-switch keys of one gadget and plan from their
    residues: the private KS pair, the CDKS21 trace keys, the
    gadget-to-RGSW keys."""
    return [trlwe_ks_key_from_numpy(v, t, base_bit, primes, device)
            for v in vs]


def trlwe_ks_keys_to_numpy(ksks) -> list:
    return [trlwe_ks_key_to_numpy(k) for k in ksks]


def priv_ks_key_pair_from_numpy(v1, v2, t: int, base_bit: int, primes,
                                device=None):
    """The private KS pair (KS for -s_out s_in, KS for -s_out)."""
    return tuple(trlwe_ks_keys_from_numpy((v1, v2), t, base_bit, primes,
                                          device))


def full_packing_ks_key_from_numpy(v, vs, t: int, base_bit: int, primes,
                                   device=None) -> FullPackingKSKey:
    """A full packing key from its residues and Shoup companions [n, t,
    k+1, P, N]."""
    return FullPackingKSKey(to_tensor(v, device), to_tensor(vs, device), t,
                            base_bit, primes)


def full_packing_ks_key_to_numpy(ksk: FullPackingKSKey):
    return to_numpy(ksk.v), to_numpy(ksk.vs)


def generic_ks_key_from_numpy(table, t: int, base_bit: int, include_b: bool,
                              device=None) -> GenericKSKey:
    """A packing1 or private-SK table [n(+1), t, base-1, k+1, N]."""
    return GenericKSKey(to_tensor(table, device), t, base_bit, include_b)


def lut_packing_ks_key_from_numpy(table, t: int, base_bit: int,
                                  torus_base: int,
                                  device=None) -> LUTPackingKSKey:
    """A LUT packing table [n, torus_base, t, base-1, k+1, N]."""
    return LUTPackingKSKey(to_tensor(table, device), t, base_bit, torus_base)


def ks_table_to_numpy(ksk) -> np.ndarray:
    """The table of a `GenericKSKey` or `LUTPackingKSKey`."""
    return to_numpy(ksk.table)


def seeded_generic_ks_key_from_numpy(seeds, b, k: int, t: int, base_bit: int,
                                     include_b: bool,
                                     device=None) -> SeededGenericKSKey:
    return SeededGenericKSKey(seeds_to_tensor(seeds, device),
                              to_tensor(b, device), k, t, base_bit,
                              include_b)


def seeded_lut_packing_ks_key_from_numpy(seeds, b, k: int, t: int,
                                         base_bit: int, torus_base: int,
                                         device=None) -> SeededLUTPackingKSKey:
    return SeededLUTPackingKSKey(seeds_to_tensor(seeds, device),
                                 to_tensor(b, device), k, t, base_bit,
                                 torus_base)


def seeded_ks_table_to_numpy(ksk):
    """(seeds, b) of a `SeededGenericKSKey` or `SeededLUTPackingKSKey`."""
    return seeds_to_numpy(ksk.seeds), to_numpy(ksk.b)


# --- ufhe keysets and integers --------------------------------------------

def ufhe_priv_keyset_from_numpy(tlwe_s, trlwe_s, params, trlwe_s_bound=1,
                                device=None):
    """A ufhe private keyset from its LWE key [n] and ring key [k, N]
    (int64), with the parameters' sigmas, as `ufhe.new_priv_keyset` builds
    it (the extracted key takes the LWE sigma)."""
    from .apps import ufhe
    from .trgsw import new_key
    key_tlwe = tlwe_key_from_numpy(tlwe_s, params.lwe_sigma, device)
    key_trlwe = trlwe_key_from_numpy(trlwe_s, params.rlwe_sigma,
                                     trlwe_s_bound, device)
    extracted = TLWEKey(s=key_trlwe.s.reshape(-1), sigma=params.lwe_sigma)
    return ufhe.PrivKeyset(tlwe=key_tlwe, trlwe=key_trlwe,
                           extracted=extracted,
                           trgsw=new_key(key_trlwe, params.l, params.Bg_bit),
                           params=params)


def ufhe_priv_keyset_to_numpy(priv):
    """(LWE key, ring key) as int64."""
    return key_to_numpy(priv.tlwe), key_to_numpy(priv.trlwe)


def ufhe_public_keyset_from_numpy(bk_v, bk_vs, ks_a, ks_b, lut_table, params,
                                  torus_base: int, primes, device=None):
    """A ufhe public keyset from the TPU package's fields: the bootstrap
    key's residues and Shoup companions [n, (k+1)l, k+1, P, N], the TLWE
    key switch's a [kN, t, base-1, n] and b [kN, t, base-1], and the LUT
    packing table [kN, torus_base, t, base-1, k+1, N]."""
    from .apps import ufhe
    p = params
    bk = bootstrap_key_from_numpy(bk_v, bk_vs, p.n, p.k, p.N, p.l, p.Bg_bit,
                                  primes, device)
    ksk = tlwe_ks_key_from_numpy(ks_a, ks_b, p.t, p.base_bit, device)
    pk = lut_packing_ks_key_from_numpy(lut_table, p.t, p.base_bit,
                                       torus_base, device)
    return ufhe.PublicKeyset(bk, pk, ksk, p)


def ufhe_public_keyset_to_numpy(pub) -> dict:
    """The fields `ufhe_public_keyset_from_numpy` takes, by name."""
    bk_v, bk_vs = bootstrap_key_to_numpy(pub.bootstrap_key)
    ks_a, ks_b = tlwe_ks_key_to_numpy(pub.ks_key)
    return {"bk_v": bk_v, "bk_vs": bk_vs, "ks_a": ks_a, "ks_b": ks_b,
            "lut_table": ks_table_to_numpy(pub.packing_key),
            "torus_base": pub.packing_key.torus_base,
            "primes": pub.bootstrap_key.primes}


def ufhe_context_from_numpy(keyset, addsub_a, addsub_b, signextend_a,
                            signextend_b, torus_base: int):
    """A ufhe context on ``keyset`` (a port `PublicKeyset`) with its two
    test vectors as given; the multiplication tables follow from
    ``torus_base``."""
    import dataclasses

    from .apps import ufhe
    if keyset.packing_key.torus_base != torus_base:
        raise ValueError(f"the keyset packs {keyset.packing_key.torus_base} "
                         f"slots, the context says {torus_base}")
    dev = keyset.device
    return dataclasses.replace(
        ufhe.setup_context(keyset),
        addsub_lut=trlwe_from_numpy(addsub_a, addsub_b, dev),
        signextend_lut=trlwe_from_numpy(signextend_a, signextend_b, dev))


def ufhe_context_to_numpy(ctx) -> dict:
    """The context's test vectors and torus base, and its keyset's fields
    (`ufhe_public_keyset_to_numpy`)."""
    addsub_a, addsub_b = trlwe_to_numpy(ctx.addsub_lut)
    se_a, se_b = trlwe_to_numpy(ctx.signextend_lut)
    return {"addsub_a": addsub_a, "addsub_b": addsub_b,
            "signextend_a": se_a, "signextend_b": se_b,
            "keyset": ufhe_public_keyset_to_numpy(ctx.keyset)}


def ufhe_integer_from_numpy(a, b, signed: bool, device=None):
    """An encrypted integer from its digits' TLWE words a [d, ..., n], b
    [d, ...]."""
    from .apps import ufhe
    return ufhe.Integer(digits=tlwe_from_numpy(a, b, device), signed=signed)


def ufhe_integer_to_numpy(c):
    """(a, b, signed)."""
    return to_numpy(c.digits.a), to_numpy(c.digits.b), c.signed
