"""Exact negacyclic NTT over 30-bit Proth primes with CRT readback to torus
words.

Polynomial products are exact:

    torus coefficients --(mod p_m)--> residues --NTT--> pointwise mul/acc
        --iNTT--> residues --Garner CRT--> exact value mod 2^64 (or 2^32)

The product of the primes exceeds twice the largest negacyclic-convolution
magnitude of each use, so the CRT reconstruction is exact.  Residues are
below 2^30, so every product of two of them fits int64 and the plain
PyTorch code below needs no unsigned type; Shoup and Barrett forms are kept
because the reference defines its results through them (all end canonical).

Transforms use the Longa-Naehrig merged-psi iteration: the forward
Cooley-Tukey output is bit-reversed and the inverse Gentleman-Sande consumes
bit-reversed input.  The bootstrap key is stored in this order, so the
order is part of the key format.

Array convention: residue tensors carry the prime axis second-to-last,
[..., P, N], as int64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .torus import TORUS_BITS, TORUS_DTYPE, to_signed, wrap

# Proth primes in (2^28, 2^30) with 2^21 | p-1, ascending (Garner needs
# p_j < p_m for j < m).  < 2^30 keeps lazy values and butterfly sums inside
# u32 in the CUDA kernel.
MASTER_PRIMES = (943718401, 950009857, 962592769, 975175681,
                 985661441, 998244353, 1004535809, 1012924417)
DEFAULT_PRIMES = MASTER_PRIMES[-3:]   # 2^89.7 of CRT range
# Wider set for exact 128-bit products (the reference's Karatsuba path,
# `src/fft/karatsuba.c`): product 2^149.5 > 2 * N * 2^128.
TENSOR_PRIMES = MASTER_PRIMES[-5:]


def primes_for_bound(bound: int):
    """Smallest suffix of MASTER_PRIMES (largest primes first) whose product
    exceeds ``2 * bound`` (every master prime supports N up to 2^20)."""
    chosen = []
    prod = 1
    for p in reversed(MASTER_PRIMES):
        chosen.append(p)
        prod *= p
        if prod > 2 * bound:
            return tuple(sorted(chosen))
    raise ValueError(f"bound 2^{math.log2(float(bound)):.1f} exceeds CRT capacity")


def conv_bound(N: int, max_abs_digit: int, j_terms: int) -> int:
    """|sum_{j<J} digit_j (*) torus_j| bound for |digits| <= max_abs_digit
    and centred torus coefficients <= 2^(TORUS_BITS-1): 2 primes at the
    32-bit torus where the 64-bit one takes 3 or 4."""
    return N * max_abs_digit * (1 << (TORUS_BITS - 1)) * j_terms


def external_product_bound(N: int, Bg_bit: int, l: int, k: int) -> int:
    """Prime budget of the blind-rotate external product: twice the raw
    convolution bound, which keeps the key format of the reference's
    rotation-free step; it changes no registered set's prime count."""
    return 2 * conv_bound(N, 1 << (Bg_bit - 1), (k + 1) * l)


def _factorize(n: int):
    fs = {}
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs[d] = fs.get(d, 0) + 1
            n //= d
        d += 1
    if n > 1:
        fs[n] = fs.get(n, 0) + 1
    return fs


def _primitive_root(p: int) -> int:
    fs = _factorize(p - 1)
    for g in range(2, 1000):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fs):
            return g
    raise ValueError(f"no primitive root found for {p}")


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _shoup_companion(w: int, p: int) -> int:
    return (w << 32) // p


@functools.lru_cache(maxsize=None)
def _host_tables(N: int, primes: tuple):
    """numpy int64 tables of one (N, primes) plan, built once per process."""
    if N & (N - 1):
        raise ValueError("N must be a power of two")
    if list(primes) != sorted(primes):
        raise ValueError("primes must be ascending")
    logN = int(math.log2(N))
    P = len(primes)
    t = {name: np.zeros((P, N), np.int64)
         for name in ("psi_rev", "psi_rev_shoup", "ipsi_rev", "ipsi_rev_shoup")}
    n_inv = np.zeros(P, np.int64)
    n_inv_shoup = np.zeros(P, np.int64)
    # Monomial spectra: position i of the bit-reversed forward output is the
    # evaluation at zeta_i = psi^(2 bitrev(i) + 1), so X^a is diagonal in the
    # NTT domain, NTT(X^a (*) u)[i] = zeta_i^a NTT(u)[i] for a in [0, 2N].
    # xpow2[m, j] holds zeta^(2^j), and `xpow` multiplies over a's set bits.
    xpow2 = np.zeros((P, logN + 1, N), np.int64)
    bitrev = [_bitrev(i, logN) for i in range(N)]
    for m, p in enumerate(primes):
        if (p - 1) % (2 * N):
            raise ValueError(f"{p} has no 2N-th root for N={N}")
        psi = pow(_primitive_root(p), (p - 1) // (2 * N), p)
        ipsi = pow(psi, p - 2, p)
        for i in range(N):
            w = pow(psi, bitrev[i], p)
            iw = pow(ipsi, bitrev[i], p)
            t["psi_rev"][m, i] = w
            t["psi_rev_shoup"][m, i] = _shoup_companion(w, p)
            t["ipsi_rev"][m, i] = iw
            t["ipsi_rev_shoup"][m, i] = _shoup_companion(iw, p)
        ninv = pow(N, p - 2, p)
        n_inv[m] = ninv
        n_inv_shoup[m] = _shoup_companion(ninv, p)
        z = t["psi_rev"][m] * t["psi_rev"][m] % p * psi % p
        for j in range(logN + 1):
            xpow2[m, j] = z
            z = z * z % p
    t["n_inv"] = n_inv
    t["n_inv_shoup"] = n_inv_shoup
    t["xpow2"] = xpow2
    t["xpow2_shoup"] = (xpow2 << 32) // np.array(primes)[:, None, None]
    return t


class NTTPlan:
    """Tables for negacyclic NTTs of length N over a prime set, as int64
    tensors on one device."""

    def __init__(self, N: int, primes, device):
        self.N = N
        self.logN = int(math.log2(N))
        self.primes = tuple(int(p) for p in primes)
        self.P = len(self.primes)
        self.device = torch.device(device)
        dev = self.device
        for name, arr in _host_tables(N, self.primes).items():
            setattr(self, name, torch.from_numpy(arr).to(dev))
        self.p = torch.tensor(self.primes, dtype=torch.int64, device=dev)
        self.mu = torch.tensor([(1 << 60) // p for p in self.primes],
                               dtype=torch.int64, device=dev)
        # `barrett_mul` is exact only for p > 2^30 / 1.75.
        self.barrett_ok = min(self.primes) > (1 << 30) // 1.75
        self.mu62 = torch.tensor(
            [(1 << 62) // p if self.barrett_ok else 0 for p in self.primes],
            dtype=torch.int64, device=dev)

        # Garner mixed-radix constants as Python ints:
        # t_m = (r_m - sum_{j<m} t_j * prefix_j) * inv(prefix_m) mod p_m.
        self.garner_w = []        # [m][j] -> (prefix_j mod p_m, shoup)
        self.garner_cinv = []     # [m] -> (inv(prefix_m) mod p_m, shoup)
        for m, p in enumerate(self.primes):
            row, prefix = [], 1
            for j in range(m):
                w = prefix % p
                row.append((w, _shoup_companion(w, p)))
                prefix *= self.primes[j]
            self.garner_w.append(row)
            if m > 0:
                c = pow(prefix % p, p - 2, p)
                self.garner_cinv.append((c, _shoup_companion(c, p)))
            else:
                self.garner_cinv.append(None)
        self.half_last = self.primes[-1] // 2
        self.crt_half_range = math.prod(self.primes) // 2
        # 2^64 mod p: lifts a negative int64 word's residue to its unsigned
        # representative's (`to_resi_u64_raw`).
        self.two64 = torch.tensor([(1 << 64) % p for p in self.primes],
                                  dtype=torch.int64, device=dev)


@functools.lru_cache(maxsize=None)
def _get_plan(N: int, primes: tuple, device: str) -> NTTPlan:
    return NTTPlan(N, primes, device)


def get_plan(N: int, primes, device) -> NTTPlan:
    return _get_plan(N, tuple(primes), str(torch.device(device)))


# --- modular primitives (int64 tensors, values < 2^31) ----------------------

def shoup_mul_lazy(a, w, w_shoup, p):
    """a*w mod p in [0, 2p) for a < 2^31, w < p, w_shoup = floor(w*2^32/p).
    a * w_shoup < 2^63 stays positive in int64."""
    q = (a * w_shoup) >> 32
    return a * w - q * p


def shoup_mul(a, w, w_shoup, p):
    r = shoup_mul_lazy(a, w, w_shoup, p)
    return torch.where(r >= p, r - p, r)


def make_shoup(w, p):
    """On-the-fly Shoup companion floor(w * 2^32 / p)."""
    return torch.div(w << 32, p, rounding_mode="floor")


def barrett_small(z, p, mu):
    """z mod p for 0 <= z < 2^59, with mu = floor(2^60 / p), p > 2^28."""
    q = ((z >> 28) * mu) >> 32
    r = z - q * p
    r = torch.where(r >= 2 * p, r - 2 * p, r)
    return torch.where(r >= p, r - p, r)


def barrett_mul(a, b, plan: NTTPlan):
    """a * b mod p for two runtime residues in [0, p), with no Shoup
    companion and no division: Barrett with mu62 = floor(2^62 / p).  The
    product is < 2^60 and the quotient estimate low by less than 2.4, so two
    conditional subtractions give the canonical residue; that needs every
    prime > 2^30 / 1.75 (all of MASTER_PRIMES)."""
    if not plan.barrett_ok:
        raise ValueError("barrett_mul needs every prime > 2^30 / 1.75")
    pp = plan.p[:, None]
    z = a * b
    r = z - (((z >> 30) * plan.mu62[:, None]) >> 32) * pp
    r = torch.where(r >= pp, r - pp, r)
    return torch.where(r >= pp, r - pp, r)


def _unsigned_mod(x, p, two64):
    """The unsigned value of words ``x`` mod p: int32 words zero-extended,
    a negative int64 word lifted by 2^64 (``two64`` = 2^64 mod p)."""
    if x.dtype == torch.int32:
        return torch.remainder(x.to(torch.int64) & 0xFFFFFFFF, p)
    r = torch.remainder(x, p)
    return torch.where(x < 0, torch.remainder(r + two64, p), r)


def to_resi_i64(x, plan: NTTPlan):
    """Signed int64 coefficients [..., N] -> residues [..., P, N].  The
    floor remainder gives [0, p) for negative inputs too."""
    return torch.remainder(x.unsqueeze(-2), plan.p[:, None])


def to_resi_u64(x, plan: NTTPlan):
    """Torus coefficients [..., N] (int64 or int32 words) -> residues of
    their centred (signed) representatives, which is what the word's bit
    pattern already is at either width.  Halves the magnitude bound of
    downstream convolutions; the final mod-2^bits readback is unaffected."""
    return to_resi_i64(x, plan)


def to_resi_u64_raw(x, plan: NTTPlan):
    """Torus words [..., N] -> residues [..., P, N] of their *unsigned*
    representatives (u64, or u32 zero-extended).  The exact 128-bit product
    (`full_mul_with_scale`) needs them: it reproduces the reference's
    wrapping ``__uint128_t`` accumulation of unsigned products
    (`fft/karatsuba.c:61-90`), whose high limb differs from the signed
    representatives' product."""
    return _unsigned_mod(x.unsqueeze(-2), plan.p[:, None],
                         plan.two64[:, None])


def to_resi_small(d, plan: NTTPlan):
    """Small signed digits (|d| < min p) [..., N] -> residues [..., P, N]
    without division."""
    d = d.to(torch.int64).unsqueeze(-2)
    p = plan.p[:, None]
    return torch.where(d < 0, d + p, d)


# --- transforms --------------------------------------------------------------

def forward_ntt(x, plan: NTTPlan):
    """Negacyclic forward NTT over the last axis, [..., P, N] residues in
    [0, p) -> bit-reversed spectrum in [0, p)."""
    N, P = plan.N, plan.P
    batch = x.shape[:-2]
    pp = plan.p[:, None, None]
    m, t = 1, N
    while m < N:
        t //= 2
        xr = x.reshape(batch + (P, m, 2, t))
        U = xr[..., 0, :]
        V = xr[..., 1, :]
        S = plan.psi_rev[:, m:2 * m, None]
        Ss = plan.psi_rev_shoup[:, m:2 * m, None]
        Vw = shoup_mul(V, S, Ss, pp)
        add = U + Vw
        add = torch.where(add >= pp, add - pp, add)
        sub = U + pp - Vw
        sub = torch.where(sub >= pp, sub - pp, sub)
        x = torch.stack([add, sub], dim=-2).reshape(batch + (P, N))
        m *= 2
    return x


def inverse_ntt(x, plan: NTTPlan):
    """Inverse of `forward_ntt` (bit-reversed input) including the 1/N
    scaling.  Output residues in [0, p)."""
    N, P = plan.N, plan.P
    batch = x.shape[:-2]
    pp = plan.p[:, None, None]
    t, h = 1, N // 2
    while h >= 1:
        xr = x.reshape(batch + (P, h, 2, t))
        U = xr[..., 0, :]
        V = xr[..., 1, :]
        S = plan.ipsi_rev[:, h:2 * h, None]
        Ss = plan.ipsi_rev_shoup[:, h:2 * h, None]
        add = U + V
        add = torch.where(add >= pp, add - pp, add)
        diff = U + pp - V
        diff = torch.where(diff >= pp, diff - pp, diff)
        W = shoup_mul(diff, S, Ss, pp)
        x = torch.stack([add, W], dim=-2).reshape(batch + (P, N))
        t *= 2
        h //= 2
    return shoup_mul(x, plan.n_inv[:, None], plan.n_inv_shoup[:, None],
                     plan.p[:, None])


def _garner_digits(r, plan: NTTPlan):
    """The mixed-radix digits t_m of residues [..., P, N], each in [0, p_m):
    t_m = (r_m - sum_{j<m} t_j prefix_j) inv(prefix_m) mod p_m.  The lazy
    sum of at most P-1 Shoup products (< 2p each) stays far below 2^59."""
    ts = [r[..., 0, :]]
    for m in range(1, plan.P):
        p = plan.primes[m]
        acc = ts[0]
        for j in range(1, m):
            w, ws = plan.garner_w[m][j]
            acc = acc + shoup_mul_lazy(ts[j], w, ws, p)
        if m > 1:
            acc = barrett_small(acc, p, (1 << 60) // p)
        diff = r[..., m, :] + p - acc
        diff = torch.where(diff >= p, diff - p, diff)
        c, cs = plan.garner_cinv[m]
        ts.append(shoup_mul(diff, c, cs, p))
    return ts


def garner_u64(r, plan: NTTPlan):
    """Residues [..., P, N] -> exact signed CRT value mod 2^64 (int64 bits).

    Mixed-radix reconstruction with a centred top digit: any integer with
    |value| < prod(p)/2 round-trips exactly.  The Horner step wraps mod
    2^64 in int64, so its low 32 bits are the value mod 2^32 (the TPU
    kernel's `_garner_limb32`)."""
    ts = _garner_digits(r, plan)
    top = ts[-1]
    v = torch.where(top > plan.half_last, top - plan.primes[-1], top)
    for m in range(plan.P - 2, -1, -1):
        v = v * plan.primes[m] + ts[m]
    return v


_SIGN = -(1 << 63)


def _below(x, y):
    """x < y as unsigned 64-bit words held in int64: flipping the sign bit
    of both turns the unsigned order into the signed one."""
    return (x + _SIGN) < (y + _SIGN)


def garner_u128(r, plan: NTTPlan):
    """Residues [..., P, N] -> the CRT value mod 2^128 as two int64 tensors
    of u64 bits (lo, hi), negative values in two's complement (a centred
    top digit): the reference's exact path accumulates in a wrapping
    ``__uint128_t`` (`fft/karatsuba.c:61-90`).  The Horner step multiplies
    the 128-bit value by each prime p < 2^30 through lo's 32-bit halves;
    the carries are unsigned compares."""
    ts = _garner_digits(r, plan)
    top = ts[-1]
    neg = top > plan.half_last
    lo = torch.where(neg, top - plan.primes[-1], top)
    hi = -neg.to(torch.int64)
    for m in range(plan.P - 2, -1, -1):
        p = plan.primes[m]
        a = (lo & 0xFFFFFFFF) * p                 # < 2^62
        b = ((lo >> 32) & 0xFFFFFFFF) * p         # < 2^62
        lo2 = a + (b << 32)                       # wraps mod 2^64
        hi = hi * p + (b >> 32) + _below(lo2, a).to(torch.int64)
        lo = lo2 + ts[m]
        hi = hi + _below(lo, lo2).to(torch.int64)
    return lo, hi


def garner_shifted_u64(r, plan: NTTPlan, bit_scale: int):
    """((value mod 2^128) >> bit_scale) mod 2^64, a logical shift, for 0 <=
    bit_scale <= 64: the reference's readback of its exact product
    (`karatsuba_u128_scale64`, `fft/karatsuba.c:92-101`)."""
    lo, hi = garner_u128(r, plan)
    if bit_scale == 0:
        return lo
    if bit_scale == 64:
        return hi
    low_bits = (lo >> bit_scale) & ((1 << (64 - bit_scale)) - 1)
    return low_bits | (hi << (64 - bit_scale))


def from_ntt_u64(x, plan: NTTPlan, dtype: torch.dtype = TORUS_DTYPE):
    """[..., P, N] NTT domain -> exact torus coefficients [..., N] as words
    of ``dtype`` (the Garner value truncated to 32 bits for int32)."""
    return wrap(garner_u64(inverse_ntt(x, plan), plan), dtype)


def to_ntt_u64(x, plan: NTTPlan):
    """Torus coefficients [..., N] (int64 or int32 words) -> NTT domain
    [..., P, N]."""
    return forward_ntt(to_resi_u64(x, plan), plan)


def to_ntt_small(d, plan: NTTPlan):
    """Small signed digits [..., N] -> NTT domain."""
    return forward_ntt(to_resi_small(d, plan), plan)


def xpow(a_int, plan: NTTPlan):
    """Monomial spectra: exponents a_int [...] in [0, 2N] -> [..., P, N]
    canonical residues of NTT(X^a), one conditional Shoup multiply per bit
    of a (bit log2(2N), a == 2N, is the identity's row)."""
    a_int = torch.as_tensor(a_int, device=plan.device).to(torch.int64)
    x = torch.ones(a_int.shape + (plan.P, plan.N), dtype=torch.int64,
                   device=plan.device)
    pp = plan.p[:, None]
    for j in range(plan.logN + 1):
        bit = ((a_int >> j) & 1)[..., None, None] == 1
        xm = shoup_mul(x, plan.xpow2[:, j], plan.xpow2_shoup[:, j], pp)
        x = torch.where(bit, xm, x)
    return x


# --- pointwise algebra in the NTT domain -------------------------------------

def pointwise_mul(a, b, plan: NTTPlan):
    """Pointwise product of two dynamic operands."""
    pp = plan.p[:, None]
    return shoup_mul(a, b, make_shoup(b, pp), pp)


def pointwise_mul_key(a, key_val, key_shoup, plan: NTTPlan):
    """Pointwise product against key material with Shoup companions."""
    return shoup_mul(a, key_val, key_shoup, plan.p[:, None])


def pointwise_mul_acc_key(a, key_val, key_shoup, plan: NTTPlan, dim: int):
    """sum over ``dim`` of a * key: lazy Shoup products (< 2p) summed in
    int64 (J * 2p < 2^59 for any J < 2^27), then one Barrett reduction."""
    pp = plan.p[:, None]
    s = shoup_mul_lazy(a, key_val, key_shoup, pp).sum(dim=dim)
    return barrett_small(s, pp, plan.mu[:, None])


def pointwise_mul_acc_generic(a, b, plan: NTTPlan, dim: int):
    """sum over ``dim`` of a * b for two runtime operands (no Shoup
    companions).  Residues are < 2^30, so each product is exact in int64
    (< 2^60); the reduced products sum far below 2^63."""
    pp = plan.p[:, None]
    return torch.remainder(torch.remainder(a * b, pp).sum(dim=dim), pp)


def add(a, b, plan: NTTPlan):
    pp = plan.p[:, None]
    s = a + b
    return torch.where(s >= pp, s - pp, s)


def sub(a, b, plan: NTTPlan):
    pp = plan.p[:, None]
    d = a + pp - b
    return torch.where(d >= pp, d - pp, d)


def neg(a, plan: NTTPlan):
    return torch.where(a == 0, a, plan.p[:, None] - a)


def scale_u64(a, c, plan: NTTPlan):
    """NTT-domain values times the unsigned word ``c`` (a u64 Python int,
    or a word tensor broadcastable to [P, 1]), the DFT scaling of the
    reference's `polynomial_scale_and_add_DFT_polynomials`
    (`polynomial.c:106-120`)."""
    if isinstance(c, int):
        c = to_signed(c, 64)
    c = torch.as_tensor(c, device=a.device)
    cr = _unsigned_mod(c, plan.p[:, None], plan.two64[:, None])
    return pointwise_mul(a, cr.expand(a.shape), plan)
