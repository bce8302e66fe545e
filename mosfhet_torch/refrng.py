"""Deterministic replay of the reference's PRNG byte stream and samplers.

The reference draws all randomness through `generate_random_bytes`
(`src/misc.c:58-82`): draws < 512 B come from a 1 KiB thread-local buffer,
larger draws go straight to the hash; every refill or direct draw re-seeds
from `generate_rnd_seed` and expands with SHAKE-256 (`USE_SHAKE`) over the
32-byte seed.  With the seed function replaced by the deterministic counter
form of `tests/vectors/generators/genvec_replay.c`
(p = [ctr++, 0x1111.., 0x2222.., 0x3333..]), the whole stream replays here
with `hashlib.shake_256`, and with it the Box-Muller noise sampler
(`misc.c:87-97`), binary keygen (`tlwe.c:70-82`, `trlwe.c:118-134`) and the
exact-integer TLWE encryption (`tlwe.c:106-115`), all bit for bit.

Host tooling in numpy and Python floats, not a device path: it makes
cross-implementation vectors in which every quantity but the reference's
f64 FFT matches exactly.
"""

from __future__ import annotations

import hashlib
import math
import struct

import numpy as np

_TWO64 = 18446744073709551616.0
_MASK = (1 << 64) - 1


class RefStream:
    """Replays `generate_random_bytes` with the deterministic seed."""

    def __init__(self, ctr: int = 0):
        self.ctr = ctr
        self.buf = b""
        self.idx = 1024

    def _hash(self, amount: int) -> bytes:
        seed = struct.pack(
            "<4Q", self.ctr, 0x1111111111111111, 0x2222222222222222,
            0x3333333333333333)
        self.ctr += 1
        return hashlib.shake_256(seed).digest(amount)

    def bytes(self, amount: int) -> bytes:
        if amount < 512:
            if amount > 1024 - self.idx:
                self.idx = 0
                self.buf = self._hash(1024)
            out = self.buf[self.idx:self.idx + amount]
            self.idx += amount
            return out
        return self._hash(amount)

    def u64(self, count: int) -> np.ndarray:
        return np.frombuffer(self.bytes(8 * count), dtype="<u8").copy()

    # -- samplers (exact reference semantics) -----------------------------

    def normal_torus(self, sigma: float) -> int:
        """`generate_normal_random` + `double2torus`: Box–Muller from two
        uniform torus doubles; truncation toward zero mod 2^64."""
        r0, r1 = struct.unpack("<2Q", self.bytes(16))
        u0 = r0 / _TWO64           # C: ((double)x)/2^64, same rounding
        u1 = r1 / _TWO64
        v = math.cos(2.0 * math.pi * u0) \
            * math.sqrt(-2.0 * math.log(u1)) * sigma
        return int(_TWO64 * v) & _MASK

    def normal_torus_array(self, sigma: float, count: int) -> np.ndarray:
        return np.array([self.normal_torus(sigma) for _ in range(count)],
                        dtype=np.uint64)

    def binary_key(self, n: int) -> np.ndarray:
        """`tlwe_new_bounded_key(bound=2)`: n u64 words & 1 (one draw of
        n*8 bytes)."""
        return (self.u64(n) & np.uint64(1)).astype(np.int64)

    def trlwe_binary_key(self, N: int, k: int) -> np.ndarray:
        """`trlwe_new_bounded_key(bound=2)`: k draws of N words."""
        return np.stack([(self.u64(N) & np.uint64(1)).astype(np.int64)
                         for _ in range(k)])

    def tlwe_encrypt(self, m: int, s: np.ndarray, sigma: float):
        """`tlwe_sample` — exact integer arithmetic, so the full (a, b)
        is reproduced bit-for-bit."""
        n = s.shape[0]
        a = self.u64(n)
        b = (np.uint64(m) + np.sum(a * s.astype(np.uint64),
                                   dtype=np.uint64))
        b = (int(b) + self.normal_torus(sigma)) & _MASK
        return a, np.uint64(b)

    def trlwe_draws(self, N: int, k: int, sigma: float):
        """The draws of one `trlwe_sample`: k mask polynomials then N
        noise samples (the b polynomial itself additionally carries the
        reference's FFT product, which is NOT replayed)."""
        a = np.stack([self.u64(N) for _ in range(k)])
        e = self.normal_torus_array(sigma, N)
        return a, e

    def skip_trgsw_monomial_sample(self, N: int, k: int, l: int,
                                   sigma: float):
        """Advance the stream past one `trgsw_monomial_sample`
        ((k+1)*l `trlwe_sample`s, `trgsw.c:152-175`)."""
        for _ in range((k + 1) * l):
            self.trlwe_draws(N, k, sigma)
