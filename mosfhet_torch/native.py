"""ctypes bindings to the repository's C++ codecs (``native/``).

The reference's seeded (compressed) ciphertexts and key material carry a
seed in place of the mask; the mask is the stream of a PRNG on the host
(`src/trlwe_compressed*.c`, `src/rnd/aes_rng.c`, `src/sha3/fips202.c`).
``native/src`` implements those streams in C++: xoroshiro128++ in the
reference's 4-lane order, SHAKE-128/256 and AES-128-CTR.  This module
compiles them with ``g++`` at first use into the port's own build
directory (``ops/build/libmosfhet_native.so``, rebuilt when a source is
newer) and binds them with ``ctypes``.  ``native/`` is only read.

There is no silent fallback: if the library does not build, the call
raises with the compiler's output.  The plain numpy/hashlib versions
(``*_plain``) are the tests' oracles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .ops._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
LIB_PATH = BUILD_DIR / "libmosfhet_native.so"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_REQUIRED_SYMBOLS = ("mosfhet_xoroshiro_expand", "mosfhet_xoroshiro_next_n",
                     "mosfhet_shake128", "mosfhet_shake256",
                     "mosfhet_aes128_ctr", "mosfhet_aes128_ctr_le")

_lib = None


def _sources() -> list[Path]:
    return [NATIVE_DIR / "src" / f"{name}.cc"
            for name in ("xoroshiro", "keccak", "aes_ctr")]


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = _sources() + [NATIVE_DIR / "include" / "mosfhet_native.h"]
    return any(src.stat().st_mtime > built for src in deps)


def build() -> None:
    """Compile ``native/src`` into ``LIB_PATH``: written under a name of this
    process, then moved into place, so no process loads a half-written
    library while another builds it.  Raises with the compiler's output on
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libmosfhet_native.so.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-I", str(NATIVE_DIR / "include"),
           *map(str, _sources()), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {LIB_PATH}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building {LIB_PATH}:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, LIB_PATH)


def _load() -> ctypes.CDLL:
    """The bound library, built first if missing or older than a source."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build()
    lib = ctypes.CDLL(str(LIB_PATH))
    missing = [s for s in _REQUIRED_SYMBOLS if not hasattr(lib, s)]
    if missing:
        raise RuntimeError(f"{LIB_PATH} lacks {missing}")
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mosfhet_xoroshiro_expand.restype = ctypes.c_int
    lib.mosfhet_xoroshiro_expand.argtypes = [
        ctypes.c_char_p, u64p, ctypes.c_size_t, ctypes.c_size_t]
    for name in ("mosfhet_shake128", "mosfhet_shake256"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p,
                       ctypes.c_size_t]
    for name in ("mosfhet_aes128_ctr", "mosfhet_aes128_ctr_le"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, u8p,
                       ctypes.c_size_t]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


# --- plain numpy/hashlib versions (the tests' oracles) -----------------------

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl(x, k):
    return (x << np.uint64(k)) | (x >> np.uint64(64 - k))


def _xoro_next(state):
    """Scalar xoroshiro128++ step on a length-2 u64 array (in place)."""
    with np.errstate(over="ignore"):
        s0, s1 = state[0], state[1]
        result = (_rotl(s0 + s1, 17) + s0) & _MASK
        s1 = s1 ^ s0
        state[0] = (_rotl(s0, 49) ^ s1 ^ (s1 << np.uint64(21))) & _MASK
        state[1] = _rotl(s1, 28)
    return result


def xoroshiro_expand_plain(seed: bytes, n_polys: int, N: int) -> np.ndarray:
    """The reference-order 4-lane expansion in numpy (lanes vectorized)."""
    _check_seed(seed, N)
    st = np.frombuffer(seed, dtype="<u8").copy()
    s0 = np.zeros(4, np.uint64)
    s1 = np.zeros(4, np.uint64)
    for i in range(4):
        s0[i] = _xoro_next(st)
        s1[i] = _xoro_next(st)
    total = n_polys * N
    out = np.zeros(total, np.uint64)
    with np.errstate(over="ignore"):
        for j in range(0, total, 4):
            out[j:j + 4] = (_rotl(s0 + s1, 17) + s0) & _MASK
            t1 = s0 ^ s1
            s0 = (_rotl(s0, 49) ^ t1 ^ (t1 << np.uint64(21))) & _MASK
            s1 = _rotl(t1, 28)
    return out.reshape(n_polys, N)


def shake128_expand_plain(seed: bytes, nbytes: int) -> bytes:
    return hashlib.shake_128(seed).digest(nbytes)


def shake256_expand_plain(seed: bytes, nbytes: int) -> bytes:
    return hashlib.shake_256(seed).digest(nbytes)


# The TPU package's names for the plain versions.
xoroshiro_expand_np = xoroshiro_expand_plain
shake128_expand_np = shake128_expand_plain
shake256_expand_np = shake256_expand_plain


# --- the library's entry points ----------------------------------------------

def _check_seed(seed: bytes, N: int) -> None:
    if len(seed) != 16 or N % 4:
        raise ValueError(f"want a 16-byte seed and N % 4 == 0, got "
                         f"{len(seed)} bytes and N={N}")


def _u8_out(nbytes: int):
    out = np.zeros(nbytes, np.uint8)
    return out, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def xoroshiro_expand(seed: bytes, n_polys: int, N: int) -> np.ndarray:
    """16-byte seed -> [n_polys, N] uint64, the reference's compressed-TRLWE
    mask expansion (`trlwe_compressed_sample`, `trlwe_compressed.c:72-99`)."""
    _check_seed(seed, N)
    out = np.zeros(n_polys * N, np.uint64)
    rc = _load().mosfhet_xoroshiro_expand(
        seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_polys, N)
    if rc != 0:
        raise RuntimeError(f"mosfhet_xoroshiro_expand returned {rc}")
    return out.reshape(n_polys, N)


def shake128_expand(seed: bytes, nbytes: int) -> bytes:
    out, ptr = _u8_out(nbytes)
    _load().mosfhet_shake128(seed, len(seed), ptr, nbytes)
    return out.tobytes()


def shake256_expand(seed: bytes, nbytes: int) -> bytes:
    out, ptr = _u8_out(nbytes)
    _load().mosfhet_shake256(seed, len(seed), ptr, nbytes)
    return out.tobytes()


def shake_mask_expand(seed: bytes, k: int, N: int) -> np.ndarray:
    """The reference's USE_SHAKE mask expansion: squeeze k*N torus words."""
    raw = shake128_expand(seed, 8 * k * N)
    return np.frombuffer(raw, dtype="<u8").reshape(k, N)


def _check_aes(key: bytes, iv: bytes) -> None:
    if len(key) != 16 or len(iv) != 16:
        raise ValueError(f"want a 16-byte key and iv, got {len(key)} and "
                         f"{len(iv)} bytes")


def aes128_ctr(key: bytes, iv: bytes, nblocks: int) -> bytes:
    """AES-128 CTR keystream, the counter's last 8 bytes incremented
    big-endian (FIPS-197 blocks)."""
    _check_aes(key, iv)
    out, ptr = _u8_out(nblocks * 16)
    _load().mosfhet_aes128_ctr(key, iv, ptr, nblocks)
    return out.tobytes()


def aes128_ctr_le(key: bytes, iv: bytes, nblocks: int) -> bytes:
    """The reference's A_PRNG=vaes keystream: the counter's high u64
    incremented little-endian (`src/rnd/aes_rng.c:128-149`)."""
    _check_aes(key, iv)
    out, ptr = _u8_out(nblocks * 16)
    _load().mosfhet_aes128_ctr_le(key, iv, ptr, nblocks)
    return out.tobytes()
