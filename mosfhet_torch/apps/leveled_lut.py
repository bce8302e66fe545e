"""Leveled LUT evaluation (`applications/leveled_lut/`).

- The direct lookup: the input encrypted as TRGSW(X^(2N-m)); one external
  product per lookup (`main.c:7-29`).
- CGGI20 vertical packing: the input encrypted bit by bit as TRGSW(bit), a
  CMUX tree over the high bits, then a blind rotation with power-of-two
  exponents over the low log2(N) bits (`vertical_packing.c:24-52`).

On CUDA tensors every external product is one K3 launch (a CMUX tree level
is one launch for all its pairs) and the vertical packing's rotation one
K1 launch of log2(N) steps; on CPU tensors their plain versions.
"""

from __future__ import annotations

import math

import torch

from .. import bootstrap as _bs
from .. import trgsw as _trgsw
from .. import trlwe as _trlwe
from ..tlwe import TLWE
from ..trgsw import TRGSWDFT, TRGSWKey
from ..trlwe import TRLWE, TRLWEKey
from ..torus import TORUS_DTYPE, int2torus


def encrypt_input(m: int, key: TRGSWKey,
                  generator: torch.Generator) -> TRGSWDFT:
    """TRGSW(X^(2N - m)) in NTT form (`main.c:7-17`)."""
    N = key.trlwe_key.N
    g = _trgsw.monomial_encrypt(1, 2 * N - m, key, generator)
    return _trgsw.to_dft(g, key.plan())


def encrypt_lut(values, out_prec: int, key: TRLWEKey,
                generator: torch.Generator) -> TRLWE:
    """TRLWE encryption of a cleartext integer LUT [..., N] (`main.c:60-66`)."""
    m = int2torus(torch.as_tensor(values, device=key.s.device), out_prec)
    return _trlwe.encrypt(m, key, generator)


def eval_lut(enc_input: TRGSWDFT, enc_lut: TRLWE) -> TLWE:
    """One external product, then the extract (`main.c:19-29`)."""
    return _trlwe.extract_tlwe(_trgsw.external_product(enc_lut, enc_input), 0)


# --- CGGI20 vertical packing -------------------------------------------------

def encrypt_input_bits(m: int, size: int, key: TRGSWKey,
                       generator: torch.Generator) -> TRGSWDFT:
    """TRGSW(bit_i(m)) for i < size, stacked on a leading axis, in NTT form
    with Shoup companions (`vertical_packing.c:8-23`): one batched
    `trgsw.monomial_encrypt`."""
    dev = key.trlwe_key.s.device
    bits = torch.tensor([(m >> i) & 1 for i in range(size)],
                        dtype=torch.int64, device=dev)
    g = _trgsw.monomial_encrypt(bits, torch.zeros_like(bits), key, generator)
    return _trgsw.to_dft(g, key.plan())


def cmux(c0: TRLWE, c1: TRLWE, selector: TRGSWDFT) -> TRLWE:
    """c0 + selector (x) (c1 - c0) (`vertical_packing.c:25-35`)."""
    diff = _trlwe.sub(c1, c0)
    return _trlwe.add(_trgsw.external_product(diff, selector), c0)


def _select_dft(g: TRGSWDFT, i: int) -> TRGSWDFT:
    return TRGSWDFT(v=g.v[i], vs=None if g.vs is None else g.vs[i], l=g.l,
                    Bg_bit=g.Bg_bit, primes=g.primes)


def eval_lut_vertical(enc_bits: TRGSWDFT, size: int, luts: TRLWE) -> TLWE:
    """A 2^size-entry LUT held as 2^size / N TRLWEs ``luts`` (leading axis):
    a CMUX tree over the size - log2(N) high bits, then the blind rotation
    by sum_i bit_i 2^i over the low bits, with the input bits' TRGSWs as its
    bootstrap key (`vertical_packing.c:38-53`)."""
    N = luts.N
    log_N = int(math.log2(N))
    cur = luts
    for i in range(size - log_N):
        half = 1 << (size - log_N - i - 1)
        sel = _select_dft(enc_bits, size - i - 1)
        lo = TRLWE(a=cur.a[:half], b=cur.b[:half])
        hi = TRLWE(a=cur.a[half:2 * half], b=cur.b[half:2 * half])
        cur = cmux(lo, hi, sel)
    acc = TRLWE(a=cur.a[0], b=cur.b[0]) if cur.b.dim() > 1 else cur
    # exponent bit_i 2^i: a_i = (2N - 2^i) / 2N on the torus
    n_bits = min(size, log_N)
    a = int2torus(torch.tensor([2 * N - (1 << i) for i in range(n_bits)],
                               dtype=TORUS_DTYPE, device=acc.b.device),
                  log_N + 1)
    bk = _bs.BootstrapKey.from_dft(enc_bits.v[:n_bits], enc_bits.vs[:n_bits],
                                   n_bits, acc.k, N, enc_bits.l,
                                   enc_bits.Bg_bit, enc_bits.primes)
    return _trlwe.extract_tlwe(_bs.blind_rotate(acc, a, bk), 0)
