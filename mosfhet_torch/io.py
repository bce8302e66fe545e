"""Checkpoints and the reference's wire formats.

Two formats, as in the TPU package:

1. **The versioned container** (`save` / `load`): a zip holding a JSON
   manifest (type tag, version, static fields) and ``.npy`` arrays.  Every
   object is written under the TPU package's type tag and field names, with
   its dtypes and layouts (torus words u64, or u32 at the 32-bit torus;
   residues and Shoup companions u64; seeds u32; secret keys int64; an
   unfolded key's ``su`` as u32 limb planes), so a file written by either
   package loads in the other.  The fields cross through `bridge`.
   Objects load onto the card unless the caller names a device.

2. **The reference's raw binary layouts** (`import_mosfhet_*`,
   `export_mosfhet_*`): keys, samples, key-switch keys, the bootstrap key
   (time domain for unfolding >= 2, the f64 DFT layouts of the FFNT and
   SPQLIOS backends for unfolding 1) and compressed samples (xoroshiro,
   SHAKE, vaes).  The DFT wire format is converted on the host in numpy
   f64, as the TPU package does, so the doubles written and the words read
   back equal its own bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zipfile

import numpy as np
import torch

from . import bridge
from ._device import default_device

MAGIC = "mosfhet_tpu"
# v2: BootstrapKey.su became u32 limb planes [nl, n/u, 2^u, (k+1)l, k+1, N]
# (was torus words [n/u, 2^u, (k+1)l, k+1, N]); v1 files load too.
VERSION = 2

# Arrays above this size are written with zip64 headers from the start.
_ZIP64_BYTES = 1 << 30


# =========================================================================
# the versioned container
# =========================================================================

def _residues(t: torch.Tensor) -> np.ndarray:
    """Canonical residues (int64 values, or int32 holding u32 bits) as u64."""
    x = t.detach().cpu().numpy()
    if x.dtype == np.int32:
        return x.view(np.uint32).astype(np.uint64)
    return x.view(np.uint64)


def _shoup(v: np.ndarray, primes) -> np.ndarray:
    """Shoup companions floor(v 2^32 / p) of u64 residues [..., P, N]."""
    return (v << np.uint64(32)) // np.array(primes, np.uint64)[:, None]


def _opt(fn, x):
    return None if x is None else fn(x)


@dataclasses.dataclass(frozen=True)
class _Codec:
    cls: type
    fields: object   # port object -> {TPU field name: value}, in field order
    build: object    # ({field: decoded value}, device) -> port object


def _registry() -> dict:
    """TPU type tag -> codec, for the 28 types the container carries."""
    from . import bootstrap, bootstrap_ga, keyswitch, params, seeded, tlwe
    from . import trgsw, trlwe
    from .apps import ufhe

    def nested(cls, *names):
        """A type whose fields are other registered objects and statics,
        under the same names in both packages."""
        return _Codec(cls, lambda o: {n: getattr(o, n) for n in names},
                      lambda f, dev: cls(**f))

    br = bridge
    codecs = [
        nested(params.TFHEParams,
               *(f.name for f in dataclasses.fields(params.TFHEParams))),
        nested(ufhe.PrivKeyset, "tlwe", "trlwe", "extracted", "trgsw",
               "params"),
        nested(ufhe.PublicKeyset, "bootstrap_key", "packing_key", "ks_key",
               "params"),
        nested(ufhe.Context, "keyset", "addsub_lut", "signextend_lut",
               "torus_base", "log_torus_base", "mulmod", "mulquo"),
        nested(ufhe.Integer, "digits", "signed"),
        _Codec(tlwe.TLWE,
               lambda o: dict(zip("ab", br.tlwe_to_numpy(o))),
               lambda f, dev: br.tlwe_from_numpy(f["a"], f["b"], dev)),
        _Codec(tlwe.TLWEKey,
               lambda o: {"s": br.key_to_numpy(o), "sigma": o.sigma},
               lambda f, dev: br.tlwe_key_from_numpy(f["s"], f["sigma"],
                                                     dev)),
        _Codec(tlwe.TLWEKSKey,
               lambda o: {**dict(zip("ab", br.tlwe_ks_key_to_numpy(o))),
                          "t": o.t, "base_bit": o.base_bit},
               lambda f, dev: br.tlwe_ks_key_from_numpy(
                   f["a"], f["b"], f["t"], f["base_bit"], dev)),
        _Codec(tlwe.TLWEKSKeyM,
               lambda o: {**dict(zip("ab", br.tlwe_ks_key_m_to_numpy(o))),
                          "t": o.t, "base_bit": o.base_bit},
               lambda f, dev: br.tlwe_ks_key_m_from_numpy(
                   f["a"], f["b"], f["t"], f["base_bit"], dev)),
        _Codec(tlwe.TLWEKSKeyPrepared,
               lambda o: {**dict(zip(("a_nib", "b_nib"),
                                     br.tlwe_ks_key_prepared_to_numpy(o))),
                          "t": o.t, "base_bit": o.base_bit},
               lambda f, dev: br.tlwe_ks_key_prepared_from_numpy(
                   f["a_nib"], f["b_nib"], f["t"], f["base_bit"], dev)),
        _Codec(trlwe.TRLWE,
               lambda o: dict(zip("ab", br.trlwe_to_numpy(o))),
               lambda f, dev: br.trlwe_from_numpy(f["a"], f["b"], dev)),
        _Codec(trlwe.TRLWEKey,
               lambda o: {"s": br.key_to_numpy(o), "sigma": o.sigma,
                          "s_bound": o.s_bound},
               lambda f, dev: br.trlwe_key_from_numpy(
                   f["s"], f["sigma"], f["s_bound"], dev)),
        _Codec(trlwe.TRLWEDFT,
               lambda o: {"v": _residues(o.v), "vs": _opt(_residues, o.vs),
                          "primes": o.primes},
               lambda f, dev: br.trlwe_dft_from_numpy(
                   f["v"], f["vs"], f["primes"], dev)),
        _Codec(trgsw.TRGSW,
               lambda o: {"rows": br.trgsw_to_numpy(o), "l": o.l,
                          "Bg_bit": o.Bg_bit},
               lambda f, dev: br.trgsw_from_numpy(f["rows"], f["l"],
                                                  f["Bg_bit"], dev)),
        _Codec(trgsw.TRGSWDFT,
               lambda o: {"v": _residues(o.v), "vs": _opt(_residues, o.vs),
                          "l": o.l, "Bg_bit": o.Bg_bit, "primes": o.primes},
               lambda f, dev: br.trgsw_dft_from_numpy(
                   f["v"], f["vs"], f["l"], f["Bg_bit"], f["primes"], dev)),
        nested(trgsw.TRGSWKey, "trlwe_key", "l", "Bg_bit"),
        nested(trgsw.TRGSWReg, "positive", "negative"),
        _Codec(keyswitch.TRLWEKSKey, _trlwe_ks_key_fields,
               lambda f, dev: br.trlwe_ks_key_from_numpy(
                   f["v"], f["t"], f["base_bit"], f["primes"], dev)),
        _Codec(keyswitch.GenericKSKey,
               lambda o: {"table": br.ks_table_to_numpy(o), "t": o.t,
                          "base_bit": o.base_bit, "include_b": o.include_b},
               lambda f, dev: br.generic_ks_key_from_numpy(
                   f["table"], f["t"], f["base_bit"], f["include_b"], dev)),
        _Codec(keyswitch.LUTPackingKSKey,
               lambda o: {"table": br.ks_table_to_numpy(o), "t": o.t,
                          "base_bit": o.base_bit,
                          "torus_base": o.torus_base},
               lambda f, dev: br.lut_packing_ks_key_from_numpy(
                   f["table"], f["t"], f["base_bit"], f["torus_base"], dev)),
        _Codec(keyswitch.FullPackingKSKey,
               lambda o: {**dict(zip(("v", "vs"),
                                     br.full_packing_ks_key_to_numpy(o))),
                          "t": o.t, "base_bit": o.base_bit,
                          "primes": o.primes},
               lambda f, dev: br.full_packing_ks_key_from_numpy(
                   f["v"], f["vs"], f["t"], f["base_bit"], f["primes"],
                   dev)),
        _Codec(keyswitch.SeededGenericKSKey,
               lambda o: {**dict(zip(("seeds", "b"),
                                     br.seeded_ks_table_to_numpy(o))),
                          "k": o.k, "t": o.t, "base_bit": o.base_bit,
                          "include_b": o.include_b},
               lambda f, dev: br.seeded_generic_ks_key_from_numpy(
                   f["seeds"], f["b"], f["k"], f["t"], f["base_bit"],
                   f["include_b"], dev)),
        _Codec(keyswitch.SeededLUTPackingKSKey,
               lambda o: {**dict(zip(("seeds", "b"),
                                     br.seeded_ks_table_to_numpy(o))),
                          "k": o.k, "t": o.t, "base_bit": o.base_bit,
                          "torus_base": o.torus_base},
               lambda f, dev: br.seeded_lut_packing_ks_key_from_numpy(
                   f["seeds"], f["b"], f["k"], f["t"], f["base_bit"],
                   f["torus_base"], dev)),
        _Codec(keyswitch.SeededTRLWEKSKey, _seeded_trlwe_ks_key_fields,
               lambda f, dev: br.seeded_trlwe_ks_key_from_numpy(
                   f["seeds"], f["b_v"], f["k_out"], f["t"], f["base_bit"],
                   f["primes"], dev)),
        _Codec(bootstrap.BootstrapKey, _bootstrap_key_fields,
               _bootstrap_key_build),
        _Codec(bootstrap_ga.GABootstrapKey, _ga_bootstrap_key_fields,
               lambda f, dev: br.ga_bootstrap_key_from_numpy(
                   f["s_v"], f["s_vs"], f["ak_v"], f["inv2n"], f["n"],
                   f["k"], f["N"], f["l"], f["Bg_bit"], f["ks_t"],
                   f["ks_base_bit"], f["primes"], f["ks_primes"], dev)),
        _Codec(seeded.SeededTRLWE,
               lambda o: {**dict(zip(("seed", "b"),
                                     br.seeded_trlwe_to_numpy(o))),
                          "k": o.k},
               lambda f, dev: br.seeded_trlwe_from_numpy(f["seed"], f["b"],
                                                         f["k"], dev)),
        _Codec(seeded.MosfhetSeededTRLWE,
               lambda o: {**dict(zip(("seed", "b"),
                                     br.mosfhet_seeded_trlwe_to_numpy(o))),
                          "k": o.k, "prng": o.prng},
               lambda f, dev: br.mosfhet_seeded_trlwe_from_numpy(
                   f["seed"], f["b"], f["k"], f["prng"], dev)),
    ]
    return {c.cls.__name__: c for c in codecs}


# The port's key-switch keys hold no Shoup companions (their kernels
# multiply runtime keys by Barrett); the TPU package's fields do, so they
# are computed here.
def _trlwe_ks_key_fields(ksk) -> dict:
    v = bridge.trlwe_ks_key_to_numpy(ksk)
    return {"v": v, "vs": _shoup(v, ksk.primes), "t": ksk.t,
            "base_bit": ksk.base_bit, "primes": ksk.primes}


def _seeded_trlwe_ks_key_fields(ksk) -> dict:
    seeds, b_v = bridge.seeded_trlwe_ks_key_to_numpy(ksk)
    return {"seeds": seeds, "b_v": b_v, "b_vs": _shoup(b_v, ksk.primes),
            "k_out": ksk.k_out, "t": ksk.t, "base_bit": ksk.base_bit,
            "primes": ksk.primes}


def _ga_bootstrap_key_fields(bk) -> dict:
    s_v, s_vs, ak_v, inv2n = bridge.ga_bootstrap_key_to_numpy(bk)
    return {"s_v": s_v, "s_vs": s_vs, "ak_v": ak_v,
            "ak_vs": _shoup(ak_v, bk.ks_primes), "inv2n": inv2n, "n": bk.n,
            "k": bk.k, "N": bk.N, "l": bk.l, "Bg_bit": bk.Bg_bit,
            "ks_t": bk.ks_t, "ks_base_bit": bk.ks_base_bit,
            "primes": bk.primes, "ks_primes": bk.ks_primes}


def _bootstrap_key_fields(bk) -> dict:
    if bk.unfolding == 1:
        v, vs = bridge.bootstrap_key_to_numpy(bk)
        su = None
    else:
        v = vs = None
        su = bridge.unfolded_bootstrap_key_to_numpy(bk)
    return {"v": v, "vs": vs, "su": su, "n": bk.n, "k": bk.k, "N": bk.N,
            "l": bk.l, "Bg_bit": bk.Bg_bit, "unfolding": bk.unfolding,
            "primes": bk.primes}


def _bootstrap_key_build(f, dev):
    shape = (f["n"], f["k"], f["N"], f["l"], f["Bg_bit"])
    if f["su"] is None:
        return bridge.bootstrap_key_from_numpy(f["v"], f["vs"], *shape,
                                               f["primes"], dev)
    su = f["su"]
    if su.ndim == 5:
        # a version-1 file: torus words [n/u, 2^u, (k+1)l, k+1, N]; the
        # limb planes are ndim 6 at either width
        su = su[None] if su.dtype == np.uint32 else np.stack(
            [su & np.uint64(0xFFFFFFFF), su >> np.uint64(32)]).astype(
                np.uint32)
    return bridge.unfolded_bootstrap_key_from_numpy(
        su, *shape, f["primes"], f["unfolding"], dev)


def _encode(obj, arrays: dict, reg: dict):
    """The manifest spec of ``obj``; its arrays go into ``arrays``."""
    if obj is None:
        return {"kind": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"kind": "static", "value": obj}
    if isinstance(obj, tuple) and all(isinstance(x, (int, float, str))
                                      for x in obj):
        return {"kind": "static_tuple", "value": list(obj)}
    if isinstance(obj, np.ndarray):
        name = f"a{len(arrays)}"
        arrays[name] = obj
        return {"kind": "array", "name": name}
    if isinstance(obj, (list, tuple)):
        return {"kind": "list", "tuple": isinstance(obj, tuple),
                "items": [_encode(x, arrays, reg) for x in obj]}
    if isinstance(obj, dict):
        return {"kind": "dict",
                "items": {str(k): _encode(v, arrays, reg)
                          for k, v in obj.items()},
                "int_keys": all(isinstance(k, int) for k in obj)}
    codec = reg.get(type(obj).__name__)
    if codec is None or not isinstance(obj, codec.cls):
        raise TypeError(f"cannot serialize {type(obj)}")
    return {"kind": "dataclass", "type": type(obj).__name__,
            "fields": {name: _encode(v, arrays, reg)
                       for name, v in codec.fields(obj).items()}}


def _decode(spec, arrays: dict, reg: dict, dev):
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "static":
        return spec["value"]
    if kind == "static_tuple":
        return tuple(spec["value"])
    if kind == "array":
        return arrays[spec["name"]]
    if kind == "list":
        items = [_decode(x, arrays, reg, dev) for x in spec["items"]]
        return tuple(items) if spec.get("tuple") else items
    if kind == "dict":
        return {(int(k) if spec.get("int_keys") else k):
                _decode(v, arrays, reg, dev)
                for k, v in spec["items"].items()}
    if kind == "dataclass":
        fields = {k: _decode(v, arrays, reg, dev)
                  for k, v in spec["fields"].items()}
        return reg[spec["type"]].build(fields, dev)
    raise TypeError(f"bad spec kind {kind}")


def save(path, obj) -> None:
    """Save a (possibly nested) port object: keys, ciphertexts, keysets,
    lists, tuples and dicts of them.  Tensors are copied to the host."""
    arrays = {}
    manifest = {"magic": MAGIC, "version": VERSION,
                "root": _encode(obj, arrays, _registry())}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
        for name, arr in arrays.items():
            with z.open(name + ".npy", "w",
                        force_zip64=arr.nbytes > _ZIP64_BYTES) as fh:
                np.save(fh, arr, allow_pickle=False)


def load(path, device=None):
    """Load a file written by `save` (or by the TPU package's ``save``) with
    its tensors on ``device`` (default: the card)."""
    dev = default_device(device)
    with zipfile.ZipFile(path, "r") as z:
        manifest = json.loads(z.read("manifest.json"))
        if manifest.get("magic") != MAGIC:
            raise ValueError(f"{path}: not a {MAGIC} container")
        if manifest["version"] > VERSION:
            raise ValueError(f"{path}: version {manifest['version']} is "
                             f"newer than {VERSION}")
        arrays = {}
        for name in z.namelist():
            if name.endswith(".npy"):
                with z.open(name) as fh:
                    arrays[name[:-4]] = np.load(fh, allow_pickle=False)
    return _decode(manifest["root"], arrays, _registry(), dev)


# =========================================================================
# the reference's raw binary layouts
# =========================================================================

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def _read_u64(f, count: int) -> np.ndarray:
    return np.frombuffer(f.read(8 * count), dtype="<u8", count=count).copy()


def _write_u64(f, arr) -> None:
    f.write(np.ascontiguousarray(np.asarray(arr).astype("<u8")).tobytes())


def _words(t: torch.Tensor) -> np.ndarray:
    return bridge.to_numpy(t)


def export_mosfhet_tlwe_key(f, key) -> None:
    """`tlwe_save_key` layout (`tlwe.c:85-89`)."""
    f.write(struct.pack("<i", key.n))
    f.write(struct.pack("<d", float(key.sigma)))
    _write_u64(f, bridge.key_to_numpy(key).view(np.uint64))


def export_mosfhet_tlwe(f, c) -> None:
    """`tlwe_save_sample` (`tlwe.c:43-46`).  One (unbatched) sample."""
    _write_u64(f, _words(c.a))
    _write_u64(f, _words(c.b).reshape(1))


def export_mosfhet_trlwe_key(f, key) -> None:
    """`trlwe_save_key` (`trlwe.c:230-237`)."""
    f.write(struct.pack("<ii", key.k, key.N))
    f.write(struct.pack("<d", float(key.sigma)))
    _write_u64(f, bridge.key_to_numpy(key).view(np.uint64))


def export_mosfhet_trlwe(f, c) -> None:
    """`trlwe_save_sample` (`trlwe.c:24-29`)."""
    _write_u64(f, _words(c.a))
    _write_u64(f, _words(c.b))


def export_mosfhet_trgsw(f, g) -> None:
    """`trgsw_save_sample` (`trgsw.c:60-64`): (k+1)*l TRLWE rows."""
    _write_u64(f, _words(g.rows))


def export_mosfhet_tlwe_ks_key(f, ksk) -> None:
    """`tlwe_save_KS_key` (`tlwe.c:274-287`): the table's entries, each its
    mask words then its b, which is the port's ``ab`` layout."""
    n_in, t, base_m1, n_out1 = ksk.ab.shape
    f.write(struct.pack("<iiii", n_in, t,
                        (base_m1 + 1).bit_length() - 1, n_out1 - 1))
    _write_u64(f, _words(ksk.ab))


def import_mosfhet_tlwe_key(f, device=None):
    """`tlwe_save_key` layout: int n, double sigma, u64 s[n]
    (`tlwe.c:85-89`)."""
    (n,) = _read(f, "<i")
    (sigma,) = _read(f, "<d")
    s = _read_u64(f, n).view(np.int64)
    return bridge.tlwe_key_from_numpy(s, float(sigma), device)


def import_mosfhet_tlwe(f, n: int, device=None):
    """`tlwe_save_sample`: u64 a[n], u64 b (`tlwe.c:43-46`)."""
    a = _read_u64(f, n)
    b = _read_u64(f, 1)[0]
    return bridge.tlwe_from_numpy(a, b, device)


def import_mosfhet_trlwe_key(f, device=None):
    """`trlwe_save_key`: int k, int N, double sigma, u64 s[k][N]
    (`trlwe.c:230-237`)."""
    k, N = _read(f, "<ii")
    (sigma,) = _read(f, "<d")
    s = _read_u64(f, k * N).view(np.int64).reshape(k, N)
    bound = int(max(1, np.max(np.abs(s))))
    return bridge.trlwe_key_from_numpy(s, float(sigma), bound, device)


def import_mosfhet_trlwe(f, k: int, N: int, device=None):
    """`trlwe_save_sample`: u64 a[k][N], u64 b[N] (`trlwe.c:24-29`)."""
    a = _read_u64(f, k * N).reshape(k, N)
    b = _read_u64(f, N)
    return bridge.trlwe_from_numpy(a, b, device)


def import_mosfhet_trgsw(f, l: int, Bg_bit: int, k: int, N: int,
                         device=None):
    """`trgsw_save_sample`: (k+1)*l TRLWE samples, each a[k][N] then b[N]
    (`trgsw.c:60-64`): rows [(k+1)l, k+1, N]."""
    rows = _read_u64(f, (k + 1) * l * (k + 1) * N).reshape(
        (k + 1) * l, k + 1, N)
    return bridge.trgsw_from_numpy(rows, l, Bg_bit, device)


def import_mosfhet_bootstrap_key(f, device=None):
    """`save_bootstrap_key` (`bootstrap.c:62-79`): ints n, l, k, N, Bg_bit,
    unfolding, then the TRGSW array.  Only unfolding >= 2 keys are stored in
    the (exactly importable) time domain; unfolding-1 keys are in the f64
    DFT layout (`import_mosfhet_bootstrap_key_dft`).

    The primes come from a 1x `conv_bound`, as in the TPU package: the
    unfolded kernels rotate the key's products before the convolution, so
    the centred coefficients stay <= 2^63 and the 2x
    `external_product_bound` would only risk an extra prime for imported
    keys outside the registered sets."""
    from . import ntt as _ntt
    n, l, k, N, Bg_bit, unfolding = _read(f, "<iiiiii")
    if unfolding < 2:
        raise ValueError("unfolding-1 keys are stored in the f64 DFT "
                         "layout: use import_mosfhet_bootstrap_key_dft")
    M, R = 1 << unfolding, (k + 1) * l
    su = _read_u64(f, (n // unfolding) * M * R * (k + 1) * N).reshape(
        n // unfolding, M, R, k + 1, N)
    primes = _ntt.primes_for_bound(
        _ntt.conv_bound(N, 1 << (Bg_bit - 1), R))
    from .bootstrap import BootstrapKey
    return BootstrapKey(None, None, n, k, N, l, Bg_bit, primes,
                        su=bridge.to_tensor(su, "cpu"),
                        unfolding=unfolding).to(default_device(device))


def import_mosfhet_compressed_trlwe(f, k: int, N: int, prng="xoroshiro",
                                    device=None):
    """`trlwe_save_compressed_sample`: 16 seed bytes then u64 b[N]
    (`trlwe_compressed.c:66-69`).  Expand with `seeded.expand_mosfhet`."""
    seed = np.frombuffer(f.read(16), dtype=np.uint8).copy()
    b = _read_u64(f, N)
    return bridge.mosfhet_seeded_trlwe_from_numpy(seed, b, k, prng, device)


def import_mosfhet_tlwe_ks_key(f, device=None):
    """`tlwe_save_KS_key`: ints n, t, base_bit, n_out then n*t*(base-1)
    TLWE samples (`tlwe.c:274-287`), read straight into the port's table
    [n, t, base-1, n_out+1]."""
    from .tlwe import TLWEKSKey
    n, t, base_bit, n_out = _read(f, "<iiii")
    raw = _read_u64(f, n * t * ((1 << base_bit) - 1) * (n_out + 1))
    return TLWEKSKey(bridge.to_tensor(
        raw.reshape(n, t, (1 << base_bit) - 1, n_out + 1), device), t,
        base_bit)


# -------------------------------------------------------------------------
# The f64-DFT wire format
#
# The reference saves TRLWE key-switch keys and unfolding-1 bootstrap keys
# with their polynomials in its FFT backend's f64 DFT domain
# (`keyswitch.c:122-159`, `bootstrap.c:63-79`).  A DFT_Polynomial of N
# doubles holds N/2 complex values re[0:N/2], im[N/2:N]; slot j is the
# polynomial at psi^(e_j), psi = exp(i pi / N).  The FFNT backend
# (`src/fft/ffnt/ffnt.c`, the portable build) orders the odd exponents in
# its Gentleman-Sande output order, SPQLIOS (the default build) by plain
# bit reversal; both orders were fitted against probe transforms the
# reference wrote (tests/vectors/v2_dft_probe*.bin, v3_sp_probe*.bin) and
# hold exactly at N=256 and N=2048.
#
# The conversion back to integer coefficients is exact for key material
# (small values) and exact to f64 precision for torus-sized values, the
# precision the reference itself keeps for DFT-stored keys.
# -------------------------------------------------------------------------

def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _ffnt_slot_exponents(N: int) -> np.ndarray:
    """e_j (odd, mod 2N) for slots j < N/2 of the FFNT DFT layout."""
    half = N // 2
    bits = half.bit_length() - 1
    es = np.zeros(half, dtype=np.int64)
    for j in range(half):
        if j == 0:
            jp = 0
        else:
            m = j.bit_length() - 1          # dyadic block [2^m, 2^(m+1))
            jp = (1 << m) + ((1 << (m + 1)) - 1 - j)
        es[j] = 4 * _bitrev(jp, bits) + 1
    return es


def _spqlios_slot_exponents(N: int) -> np.ndarray:
    """e_j (odd, mod 2N) for slots j < N/2 of the SPQLIOS DFT layout
    (`fft_processor_spqlios.c:81-97`, tables `spqlios-fft-impl.c:70-113`):
    e_j = 4 bitrev(j) + 1, without FFNT's dyadic-block reordering."""
    half = N // 2
    bits = half.bit_length() - 1
    return np.array([4 * _bitrev(j, bits) + 1 for j in range(half)],
                    dtype=np.int64)


_DFT_LAYOUTS = {"ffnt": _ffnt_slot_exponents,
                "spqlios": _spqlios_slot_exponents}
_FFNT_CACHE = {}


def _ffnt_matrix(N: int, layout: str = "ffnt") -> np.ndarray:
    """[N/2, N] complex: M[j, k] = psi^(e_j * k)."""
    if (N, layout) not in _FFNT_CACHE:
        es = _DFT_LAYOUTS[layout](N)
        ks = np.arange(N)
        _FFNT_CACHE[N, layout] = np.exp(1j * np.pi * np.outer(es, ks) / N)
    return _FFNT_CACHE[N, layout]


def torus_to_ffnt_dft(p, layout: str = "ffnt") -> np.ndarray:
    """u64 torus coefficients [..., N] -> f64 DFT doubles [..., N]
    (`execute_reverse_torus64`: signed reinterpretation then the twisted
    forward transform; `ffnt.c:820-831` / `fft_processor_spqlios.c:81-97`
    depending on ``layout``)."""
    p = np.asarray(p, dtype=np.uint64)
    N = p.shape[-1]
    a = p.view(np.int64).astype(np.float64)
    z = a @ _ffnt_matrix(N, layout).T         # [..., N/2] complex
    return np.concatenate([z.real, z.imag], axis=-1)


def ffnt_dft_to_torus(d, layout: str = "ffnt") -> np.ndarray:
    """f64 DFT doubles [..., N] -> u64 torus coefficients [..., N]: the
    inverse evaluation a_k = (2/N) sum_j Re(z_j psi^(-e_j k)), rounded to
    the nearest integer mod 2^64."""
    d = np.asarray(d, dtype=np.float64)
    N = d.shape[-1]
    z = d[..., :N // 2] + 1j * d[..., N // 2:]
    a = (2.0 / N) * (z @ np.conj(_ffnt_matrix(N, layout)))
    # centred values in (-2^63, 2^63): two's-complement reinterpret
    return np.round(a.real).astype(np.int64).astype(np.uint64)


def _read_dft(f, rows: int, N: int, layout: str) -> np.ndarray:
    """``rows`` DFT polynomials -> u64 words [rows, N], in one product.

    The TPU package converts one TRLWE or TRGSW at a time; one product over
    all the rows is some 40 times faster at N=2048, and with numpy on
    OpenBLAS its rows round exactly as the small products do
    (tests/test_torch_io.py holds the words and bytes to the TPU
    package's)."""
    d = np.frombuffer(f.read(8 * rows * N), dtype="<f8").reshape(rows, N)
    return ffnt_dft_to_torus(d, layout)


def _write_dft(f, words: np.ndarray, layout: str) -> None:
    """Words [..., N] -> their DFT doubles, written in one product (see
    `_read_dft`)."""
    words = words.reshape(-1, words.shape[-1])
    f.write(np.ascontiguousarray(
        torus_to_ffnt_dft(words, layout).astype("<f8")).tobytes())


def import_mosfhet_trlwe_dft(f, k: int, N: int, layout: str = "ffnt",
                             device=None):
    """`trlwe_save_DFT_sample`: k+1 DFT polynomials of N doubles ->
    time-domain TRLWE."""
    coeffs = _read_dft(f, k + 1, N, layout)
    return bridge.trlwe_from_numpy(coeffs[:k], coeffs[k], device)


def export_mosfhet_trlwe_dft(f, c, layout: str = "ffnt") -> None:
    """Write a TRLWE in the reference's DFT-sample layout."""
    a, b = bridge.trlwe_to_numpy(c)
    _write_dft(f, np.concatenate([a.astype(np.uint64),
                                  b.astype(np.uint64)[None]]), layout)


def import_mosfhet_trlwe_ks_key(f, layout: str = "ffnt", device=None):
    """`trlwe_save_KS_key` (`keyswitch.c:122-141`): ints base_bit, t, k_in,
    k, N then k_in*t TRLWE DFT samples.  (The reference's save loop runs
    over the output k where its load runs over k_in: the same for every
    real use, k_in == k.)

    The primes are those of `keyswitch._ks_plan` for k_in*t inputs, as the
    TPU package picks them: a budget of k_in t^2 digit rows, above the k_in
    t a switch sums, so the imported key's words match the TPU package's."""
    from . import keyswitch as _ks
    from . import ntt as _ntt
    from .ops.pbs_kernel import u32_as_i32
    base_bit, t, k_in, k, N = _read(f, "<iiiii")
    dev = default_device(device)
    plan = _ks._ks_plan(N, base_bit, t, k_in * t, dev)
    st = _read_dft(f, k_in * t * (k + 1), N, layout).reshape(
        k_in, t, k + 1, N)
    v = _ntt.to_ntt_u64(bridge.to_tensor(st, dev), plan)
    return _ks.TRLWEKSKey(u32_as_i32(v), t, base_bit, plan.primes)


def export_mosfhet_trlwe_ks_key(f, ksk, layout: str = "ffnt") -> None:
    """Write a TRLWE key-switch key in the reference's format (DFT
    samples)."""
    from . import ntt as _ntt
    plan = _ntt.get_plan(ksk.N, ksk.primes, ksk.v32.device)
    st = _words(_ntt.from_ntt_u64(ksk.v, plan, torch.int64))
    k_in, t, C, N = st.shape
    f.write(struct.pack("<iiiii", ksk.base_bit, t, k_in, C - 1, N))
    _write_dft(f, st, layout)


def _read_compressed_trlwe_batch(f, count: int, k: int, N: int, prng: str,
                                 aes_key: bytes | None = None) -> np.ndarray:
    """Read ``count`` TRLWE samples and expand their masks on the host:
    [count, k+1, N] u64.  prng "shake", "xoroshiro" and "vaes" read the
    compressed form (a seed, then b[N]); "none" reads plain samples (the
    reference's A_PRNG=none build stores a and b)."""
    from . import native as _native
    if prng == "none":
        return _read_u64(f, count * (k + 1) * N).reshape(count, k + 1, N)
    if prng not in ("shake", "xoroshiro", "vaes"):
        raise ValueError(f"unknown prng {prng!r}")
    # the vaes build writes a 128-byte seed field (see
    # import_mosfhet_compressed_trlwe_vaes); the seed is its first 16 bytes
    seed_bytes = 128 if prng == "vaes" else 16
    rec = seed_bytes + 8 * N
    raw = np.frombuffer(f.read(count * rec), dtype=np.uint8).reshape(
        count, rec)
    out = np.zeros((count, k + 1, N), dtype=np.uint64)
    out[:, k] = raw[:, seed_bytes:].copy().view("<u8")
    expand = {"shake": _native.shake_mask_expand,
              "xoroshiro": _native.xoroshiro_expand}.get(prng)
    for i in range(count):
        seed = raw[i, :16].tobytes()
        out[i, :k] = (_expand_aes_mask(seed, aes_key, k, N) if expand is None
                      else expand(seed, k, N))
    return out


def export_mosfhet_packing_ks_key(f, key) -> None:
    """Write a LUT-packing key in `trlwe_save_packing_KS_key` layout with
    plain samples, which the reference's A_PRNG=none build reads (its
    compressed samples would need reference-PRNG seeds; the port's seeds
    are threefry keys)."""
    n, tb, t, base_m1, C, N = key.table.shape
    f.write(struct.pack("<iiiiii", key.base_bit, t, tb, n, C - 1, N))
    _write_u64(f, _words(key.table))


def export_mosfhet_generic_ks_key(f, key) -> None:
    """`trlwe_save_generic_ks_key` layout with plain samples (A_PRNG=none
    build)."""
    nb, t, base_m1, C, N = key.table.shape
    n = nb - (1 if key.include_b else 0)
    f.write(struct.pack("<iiiiii", key.base_bit, t, n, C - 1, N,
                        1 if key.include_b else 0))
    _write_u64(f, _words(key.table))


def import_mosfhet_packing_ks_key(f, prng: str = "shake",
                                  aes_key: bytes | None = None, device=None):
    """`trlwe_save_packing_KS_key` (`keyswitch.c:272-289`): ints base_bit,
    t, torus_base, n, k, N then n*torus_base*t*(base-1) compressed TRLWE
    samples (the reference's USE_COMPRESSED_TRLWE builds)."""
    base_bit, t, torus_base, n, k, N = _read(f, "<iiiiii")
    base = 1 << base_bit
    count = n * torus_base * t * (base - 1)
    tab = _read_compressed_trlwe_batch(f, count, k, N, prng, aes_key)
    tab = tab.reshape(n, torus_base, t, base - 1, k + 1, N)
    return bridge.lut_packing_ks_key_from_numpy(tab, t, base_bit,
                                                torus_base, device)


def import_mosfhet_generic_ks_key(f, prng: str = "shake",
                                  aes_key: bytes | None = None, device=None):
    """`trlwe_save_generic_ks_key` (`keyswitch.c:409-424`): ints base_bit,
    t, n, k, N, include_b then (n+include_b)*t*(base-1) compressed TRLWE
    samples."""
    base_bit, t, n, k, N, include_b = _read(f, "<iiiiii")
    base = 1 << base_bit
    count = (n + include_b) * t * (base - 1)
    tab = _read_compressed_trlwe_batch(f, count, k, N, prng, aes_key)
    tab = tab.reshape(n + include_b, t, base - 1, k + 1, N)
    return bridge.generic_ks_key_from_numpy(tab, t, base_bit,
                                            bool(include_b), device)


def _expand_aes_mask(seed: bytes, aes_key: bytes | None, k: int,
                     N: int) -> np.ndarray:
    """AES-CTR mask expansion (`trlwe_compressed_vaes.c:62-87`,
    `aes_rng.c:128-149`): block j of component i is
    AES128_Enc(process_key, seed_lo || LE64(seed_hi + i*N/2 + j)).

    The A_PRNG=vaes build derives the keystream from a process-wide AES key
    (the seed only sets the counter), so importing across processes needs
    that key too, ``aes_key`` (an application fixes it with
    `setup_aes_prgn_key`)."""
    from . import native as _native
    if aes_key is None or len(aes_key) != 16:
        raise ValueError("vaes samples need the 16-byte process AES key")
    masks = np.zeros((k, N), dtype=np.uint64)
    for i in range(k):
        iv = bytearray(seed)
        hi = int.from_bytes(iv[8:16], "little")
        hi = (hi + i * (N // 2)) & ((1 << 64) - 1)
        iv[8:16] = hi.to_bytes(8, "little")
        ks = _native.aes128_ctr_le(aes_key, bytes(iv), N // 2)
        masks[i] = np.frombuffer(ks, dtype="<u8", count=N)
    return masks


def import_mosfhet_compressed_trlwe_vaes(f, k: int, N: int, aes_key: bytes,
                                         device=None):
    """AES-CTR-mode compressed sample (`trlwe_compressed_vaes.c:44-59`): a
    seed field and u64 b[N], expanded at once to a full TRLWE.

    Quirk: the vaes build's save writes ``ID_SIZE`` Torus elements (128
    bytes) for the 16-byte seed (`fwrite(..., sizeof(Torus), ID_SIZE, ...)`,
    `trlwe_compressed_vaes.c:57-59`): only the first 16 bytes are the seed,
    the rest is the writer's adjacent heap memory."""
    seed = f.read(128)[:16]
    b = _read_u64(f, N)
    a = _expand_aes_mask(seed, aes_key, k, N)
    return bridge.trlwe_from_numpy(a, b, device)


def export_mosfhet_bootstrap_key(f, bk, layout: str = "ffnt") -> None:
    """`save_bootstrap_key` (`bootstrap.c:63-79`): ints n, l, k, N, Bg_bit,
    unfolding; unfolding-1 keys as DFT TRGSWs (the words from the key's
    residues on its device, the doubles on the host), unfolded keys as
    time-domain TRGSWs."""
    from . import ntt as _ntt
    f.write(struct.pack("<iiiiii", bk.n, bk.l, bk.k, bk.N, bk.Bg_bit,
                        bk.unfolding))
    if bk.unfolding > 1:
        _write_u64(f, _words(bk.su_u64()))
        return
    plan = bk.plan()
    _write_dft(f, _words(_ntt.garner_u64(_ntt.inverse_ntt(bk.v, plan), plan)),
               layout)


def import_mosfhet_bootstrap_key_dft(f, layout: str = "ffnt", device=None):
    """`load_new_bootstrap_key` for unfolding-1 (DFT-layout) keys: the
    time-domain TRGSW rows from the DFT samples, then the NTT-form key on
    ``device``, with the primes of `ntt.external_product_bound`."""
    from . import ntt as _ntt
    from .bootstrap import BootstrapKey
    n, l, k, N, Bg_bit, unfolding = _read(f, "<iiiiii")
    if unfolding != 1:
        raise ValueError(f"want an unfolding-1 key, got unfolding "
                         f"{unfolding}")
    R = (k + 1) * l
    rows = _read_dft(f, n * R * (k + 1), N, layout).reshape(n, R, k + 1, N)
    dev = default_device(device)
    primes = _ntt.primes_for_bound(
        _ntt.external_product_bound(N, Bg_bit, l, k))
    plan = _ntt.get_plan(N, primes, dev)
    v = _ntt.to_ntt_u64(bridge.to_tensor(rows, dev), plan)
    vs = _ntt.make_shoup(v, plan.p[:, None])
    return BootstrapKey.from_dft(v, vs, n, k, N, l, Bg_bit, primes)
