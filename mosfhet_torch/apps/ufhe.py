"""ufhe: radix-B encrypted integers on top of the programmable bootstrap
(`applications/multi-ciphertext-arith/`).

An integer is a vector of TLWE digits in base ``torus_base`` (digit v
encoded as v / (2 torus_base) on the torus), little-endian on the leading
axis of one TLWE, with any batch axes after it.  Addition and subtraction
propagate bootstrapped carries; multiplication builds per-digit mulmod /
mulquo LUTs with the factorized multi-value bootstrap and packs them with
the LUT packing switch; comparison chains bootstraps; ReLU selects on the
sign digit.

On CUDA tensors each key switch back to the LWE key and each LUT packing
switch is one K2 launch, each bootstrap one K1 launch (K4 with an unfolded
key); on CPU tensors their plain versions.  Keys are `nn.Module`s
(`PublicKeyset`) or dataclasses of tensors with a ``to`` method
(`PrivKeyset`, `Context`), so ``.to(device)`` moves them.  Keyset IO is
not part of the port yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import bootstrap as _bs
from .. import keyswitch as _ks
from .. import tlwe as _tlwe
from .. import trgsw as _trgsw
from .. import trlwe as _trlwe
from .._device import default_device
from ..params import UFHE_SET0, TFHEParams
from ..tlwe import TLWE, TLWEKey
from ..trgsw import TRGSWKey
from ..trlwe import TRLWE, TRLWEKey
from ..torus import TORUS_DTYPE, double2torus, torus2double


@dataclasses.dataclass
class PrivKeyset:
    """(`ufhe_new_priv_keyset`, `ufhe.c:22-32`)."""
    tlwe: TLWEKey
    trlwe: TRLWEKey
    extracted: TLWEKey
    trgsw: TRGSWKey
    params: TFHEParams

    def to(self, device) -> "PrivKeyset":
        trlwe_key = dataclasses.replace(self.trlwe, s=self.trlwe.s.to(device))
        return PrivKeyset(
            tlwe=dataclasses.replace(self.tlwe, s=self.tlwe.s.to(device)),
            trlwe=trlwe_key,
            extracted=dataclasses.replace(self.extracted,
                                          s=self.extracted.s.to(device)),
            trgsw=dataclasses.replace(self.trgsw, trlwe_key=trlwe_key),
            params=self.params)


class PublicKeyset(nn.Module):
    """(`ufhe_new_public_keyset`, `ufhe.c:34-42`): the bootstrap key, the
    LUT packing key and the TLWE key-switch key as submodules."""

    def __init__(self, bootstrap_key: _bs.BootstrapKey, packing_key,
                 ks_key: _tlwe.TLWEKSKey, params: TFHEParams):
        super().__init__()
        self.bootstrap_key = bootstrap_key
        self.packing_key = packing_key
        self.ks_key = ks_key
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.bootstrap_key.device


@dataclasses.dataclass
class Context:
    """Precomputed test vectors and multiplication tables
    (`ufhe_setup_context`, `ufhe.c:44-94`)."""
    keyset: PublicKeyset
    addsub_lut: TRLWE
    signextend_lut: TRLWE
    torus_base: int
    log_torus_base: int
    mulmod: tuple
    mulquo: tuple

    def to(self, device) -> "Context":
        def move(c):
            return TRLWE(a=c.a.to(device), b=c.b.to(device))
        return dataclasses.replace(self, keyset=self.keyset.to(device),
                                   addsub_lut=move(self.addsub_lut),
                                   signextend_lut=move(self.signextend_lut))


@dataclasses.dataclass
class Integer:
    """d base-B digits, little-endian, as one TLWE with a leading [d] axis."""
    digits: TLWE
    signed: bool

    @property
    def d(self) -> int:
        return self.digits.b.shape[0]


def new_priv_keyset(generator: torch.Generator,
                    params: TFHEParams = UFHE_SET0,
                    device=None) -> PrivKeyset:
    dev = default_device(device)
    key_tlwe = _tlwe.new_binary_key(params.n, params.lwe_sigma, generator,
                                    dev)
    key_trlwe = _trlwe.new_binary_key(params.N, params.k, params.rlwe_sigma,
                                      generator, dev)
    # the reference gives the extracted key the LWE sigma (`ufhe.c:28`)
    extracted = TLWEKey(s=_trlwe.extract_tlwe_key(key_trlwe).s,
                        sigma=params.lwe_sigma)
    gk = _trgsw.new_key(key_trlwe, params.l, params.Bg_bit)
    return PrivKeyset(tlwe=key_tlwe, trlwe=key_trlwe, extracted=extracted,
                      trgsw=gk, params=params)


def new_public_keyset(generator: torch.Generator, priv: PrivKeyset,
                      torus_base: int = 4, device=None) -> PublicKeyset:
    """The bootstrap key, the TLWE key switch from the extracted key back to
    the LWE key and the LUT packing key (at UFHE_SET0 a table of 2,048 x 4 x
    6 x 3 TRLWEs, 4.83 GB), each encrypted in chunks by its keygen."""
    p = priv.params
    dev = default_device(device)
    bk = _bs.new_key(priv.trgsw, priv.tlwe, generator, dev)
    ksk = _tlwe.new_ks_key(priv.tlwe, priv.extracted, p.t, p.base_bit,
                           generator, dev)
    pk = _ks.new_lut_packing_ks_key(priv.trlwe, priv.extracted, p.t,
                                    p.base_bit, torus_base, generator, dev)
    return PublicKeyset(bk, pk, ksk, p)


def _torus_word(x: float) -> int:
    return int(double2torus(x))


def setup_context(keyset: PublicKeyset) -> Context:
    tb = keyset.packing_key.torus_base
    p = keyset.params
    dev = keyset.device
    addsub = _trlwe.torus_packing(torch.tensor(
        [_torus_word(-1.0 / (4 * tb))], dtype=TORUS_DTYPE, device=dev),
        p.k, p.N)
    se_vals = torch.tensor([0] * (tb // 2) + [_torus_word(
        (tb - 1) / (2 * tb))] * (tb - tb // 2), dtype=TORUS_DTYPE,
        device=dev)
    mulmod = tuple(tuple((i * j) % tb for j in range(tb)) for i in range(tb))
    mulquo = tuple(tuple((i * j) // tb for j in range(tb)) for i in range(tb))
    return Context(keyset=keyset, addsub_lut=addsub,
                   signextend_lut=_trlwe.torus_packing(se_vals, p.k, p.N),
                   torus_base=tb, log_torus_base=int(math.log2(tb)),
                   mulmod=mulmod, mulquo=mulquo)


# --- integer construction / (de)cryption (`integer.c:5-53`) ------------------

def _n_digits(precision: int, ctx: Context) -> int:
    lt = ctx.log_torus_base
    return precision // lt + (1 if precision % lt else 0)


def _digit_torus(vals, ctx: Context):
    """Digit values (an int or an integer tensor) as torus words on the
    keys' device."""
    v = torch.as_tensor(vals, dtype=torch.float64,
                        device=ctx.keyset.device)
    return double2torus(v / (2 * ctx.torus_base))


def _digits_of(value: int, precision: int, ctx: Context) -> list[int]:
    mask = ctx.torus_base - 1
    return [(value >> (i * ctx.log_torus_base)) & mask
            for i in range(_n_digits(precision, ctx))]


def _n_out(ctx: Context) -> int:
    return ctx.keyset.params.k * ctx.keyset.params.N


def cleartext_integer(value: int, precision: int, signed: bool,
                      ctx: Context) -> Integer:
    c = _tlwe.noiseless_trivial(
        _digit_torus(_digits_of(value, precision, ctx), ctx), _n_out(ctx))
    return Integer(digits=c, signed=signed)


def encrypt_integer(generator: torch.Generator, value: int, precision: int,
                    signed: bool, priv: PrivKeyset, ctx: Context) -> Integer:
    c = _tlwe.encrypt(_digit_torus(_digits_of(value, precision, ctx), ctx),
                      priv.extracted, generator)
    return Integer(digits=c, signed=signed)


def decrypt_integer(c: Integer, priv: PrivKeyset, ctx: Context) -> int:
    """The cleartext of an unbatched integer."""
    ph = _tlwe.phase(c.digits, priv.extracted)
    vals = torch.round(torus2double(ph) * (2 * ctx.torus_base)) \
        .to(torch.int64) % ctx.torus_base
    result = 0
    for i in range(c.d - 1, -1, -1):
        result = (result << ctx.log_torus_base) | int(vals[i])
    if c.signed:
        bits = ctx.log_torus_base * c.d
        if result >= 1 << (bits - 1):
            result -= 1 << bits
    return result


def _digit(c: Integer, i: int) -> TLWE:
    return TLWE(a=c.digits.a[i], b=c.digits.b[i])


def _set_digit(c: Integer, i: int, v: TLWE) -> Integer:
    a, b = c.digits.a.clone(), c.digits.b.clone()
    a[i] = v.a
    b[i] = v.b
    return Integer(digits=TLWE(a=a, b=b), signed=c.signed)


def _batch_of(*ints) -> tuple:
    """The batch axes after the digit axis (digits are [d, *batch])."""
    return tuple(torch.broadcast_shapes(
        *[tuple(c.digits.b.shape[1:]) for c in ints]))


def _zero_tlwe(shape, ctx: Context) -> TLWE:
    return _tlwe.noiseless_trivial(
        torch.zeros(tuple(shape), dtype=TORUS_DTYPE,
                    device=ctx.keyset.device), _n_out(ctx))


def _zero_int(d: int, signed: bool, ctx: Context, batch=()) -> Integer:
    return Integer(digits=_zero_tlwe((d,) + tuple(batch), ctx),
                   signed=signed)


def _with_b(c: TLWE, delta: int) -> TLWE:
    return TLWE(a=c.a, b=c.b + delta)


def _carry_bootstrap(digit: TLWE, ctx: Context) -> TRLWE:
    """The key switch back to the LWE key, then the ADDSUB test vector's
    rotation: the shared step of add/sub carry propagation
    (`integer.c:94-95`)."""
    tmp = _tlwe.keyswitch(digit, ctx.keyset.ks_key)
    return _bs.functional_bootstrap_wo_extract(
        ctx.addsub_lut, tmp, ctx.keyset.bootstrap_key, ctx.torus_base)


def extend_integer(c: Integer, old_precision: int, ctx: Context) -> Integer:
    """Zero- or sign-extend (`ufhe_extend_integer`, `integer.c:62-76`)."""
    d_ini = old_precision // ctx.log_torus_base
    if not c.signed:
        zero = _zero_tlwe((), ctx)
        for i in range(d_ini, c.d):
            c = _set_digit(c, i, zero)
        return c
    if c.d <= d_ini:
        return c
    tmp = _tlwe.keyswitch(_digit(c, d_ini - 1), ctx.keyset.ks_key)
    acc = _bs.functional_bootstrap_wo_extract(
        ctx.signextend_lut, tmp, ctx.keyset.bootstrap_key, ctx.torus_base)
    for i, e in enumerate(_trlwe.mv_extract_tlwe(acc, c.d - d_ini)):
        c = _set_digit(c, d_ini + i, e)
    return c


def sl_add_integer(a: Integer, g: int, b: Integer, h: int, out_d: int,
                   ctx: Context) -> Integer:
    """c = a B^g + b B^h with bootstrapped carries
    (`ufhe_sl_add_integer`, `integer.c:79-107`)."""
    signed = a.signed or b.signed
    size = a.d if signed else min(max(a.d + g, b.d + h) + 1, out_d)
    c = _zero_int(out_d, signed, ctx, _batch_of(a, b))
    quarter = _torus_word(0.25)
    carry_init = _torus_word(1.0 / (ctx.torus_base * 4))
    for i in range(size):
        di = _digit(c, i)
        if 0 <= i - g < a.d:
            di = _tlwe.add(di, _digit(a, i - g))
        if 0 <= i - h < b.d:
            di = _tlwe.add(di, _digit(b, i - h))
        c = _set_digit(c, i, di)
        if i - g < 0 or i - h < 0:
            continue
        acc = _carry_bootstrap(di, ctx)
        delta = _trlwe.mv_extract_tlwe_scaling_delta(acc, ctx.torus_base)
        c = _set_digit(c, i, _with_b(_tlwe.sub(di, delta), -quarter))
        if i != size - 1:
            carry = _trlwe.mv_extract_tlwe_scaling_delta(acc, 1)
            c = _set_digit(c, i + 1, _with_b(carry, carry_init))
    return extend_integer(c, size * ctx.log_torus_base, ctx)


def add_integer(a: Integer, b: Integer, out_d: int, ctx: Context) -> Integer:
    return sl_add_integer(a, 0, b, 0, out_d, ctx)


def sl_addto_integer(b: Integer, a: Integer, g: int, ctx: Context) -> Integer:
    """b += a B^g (`ufhe_sl_addto_integer`, `integer.c:110-132`)."""
    signed = a.signed or b.signed
    size = a.d if signed else min(a.d + g + 1, b.d)
    quarter = _torus_word(0.25)
    carry_init = _torus_word(1.0 / (ctx.torus_base * 4))
    for i in range(size):
        di = _digit(b, i)
        if 0 <= i - g < a.d:
            di = _tlwe.add(di, _digit(a, i - g))
            b = _set_digit(b, i, di)
        if i - g < 0:
            continue
        acc = _carry_bootstrap(di, ctx)
        delta = _trlwe.mv_extract_tlwe_scaling_delta(acc, ctx.torus_base)
        b = _set_digit(b, i, _with_b(_tlwe.sub(di, delta), -quarter))
        if i != size - 1:
            carry = _trlwe.mv_extract_tlwe_scaling_delta(acc, 1)
            nxt = _tlwe.add(_digit(b, i + 1), carry)
            b = _set_digit(b, i + 1, _with_b(nxt, carry_init))
    return b


def sub_integer(a: Integer, b: Integer, out_d: int, ctx: Context) -> Integer:
    """c = a - b (`ufhe_sub_integer`, `integer.c:135-155`)."""
    c = _zero_int(out_d, a.signed or b.signed, ctx, _batch_of(a, b))
    quarter = _torus_word(0.25)
    carry_init = _torus_word(1.0 / (ctx.torus_base * 4))
    for i in range(out_d):
        di = _digit(c, i)
        if i < a.d:
            di = _tlwe.add(di, _digit(a, i))
        if i < b.d:
            di = _tlwe.sub(di, _digit(b, i))
        acc = _carry_bootstrap(di, ctx)
        delta = _trlwe.mv_extract_tlwe_scaling_delta(acc, ctx.torus_base)
        c = _set_digit(c, i, _with_b(_tlwe.add(di, delta), quarter))
        if i != out_d - 1:
            carry = _trlwe.mv_extract_tlwe_scaling_delta(acc, 1)
            c = _set_digit(c, i + 1, _with_b(_tlwe.neg(carry), -carry_init))
    return c


def neg_integer(a: Integer, ctx: Context) -> Integer:
    """(`ufhe_neg_integer`, `integer.c:157-165`)."""
    out = _tlwe.neg(a.digits)
    b = out.b + _torus_word(0.5)
    b[1:] -= _torus_word(1.0 / (2 * ctx.torus_base))
    return Integer(digits=TLWE(a=out.a, b=b), signed=a.signed)


def _stack_tlwe(cs: list) -> TLWE:
    """LUT entries stacked on the axis `lut_packing_keyswitch` reads ([...,
    tb, n], just before the mask axis), batch axes kept in front."""
    ash = torch.broadcast_shapes(*[tuple(c.a.shape) for c in cs])
    bsh = torch.broadcast_shapes(*[tuple(c.b.shape) for c in cs])
    return TLWE(a=torch.stack([c.a.expand(ash) for c in cs], dim=-2),
                b=torch.stack([c.b.expand(bsh) for c in cs], dim=-1))


def _pack(cs: list, ctx: Context) -> TRLWE:
    return _ks.lut_packing_keyswitch(_stack_tlwe(cs), ctx.keyset.packing_key)


def _bootstrap(tv: TRLWE, sel: TLWE, ctx: Context) -> TLWE:
    return _bs.functional_bootstrap(tv, sel, ctx.keyset.bootstrap_key,
                                    ctx.torus_base)


def _switch(c: TLWE, ctx: Context) -> TLWE:
    return _tlwe.keyswitch(c, ctx.keyset.ks_key)


def mul_integer(a: Integer, b: Integer, out_d: int, ctx: Context) -> Integer:
    """Schoolbook multiplication with per-digit mulmod / mulquo LUTs built
    by the factorized multi-value bootstrap and packed by the LUT packing
    switch (`ufhe_mul_integer`, `integer.c:167-215`)."""
    signed = a.signed or b.signed
    size = a.d if signed else min(a.d + b.d + 1, out_d)
    tb, log_tb = ctx.torus_base, ctx.log_torus_base
    batch = _batch_of(a, b)
    c = _zero_int(out_d, signed, ctx, batch)
    for i in range(a.d):
        mv_tv = _bs.multivalue_bootstrap_phase1(
            _switch(_digit(a, i), ctx), ctx.keyset.bootstrap_key, tb)
        zero = _zero_tlwe(batch, ctx)
        lut_mod = [zero, _digit(a, i)]
        lut_quo = [zero, zero]
        for j in range(2, tb):
            lut_mod.append(_bs.multivalue_bootstrap_phase2(
                ctx.mulmod[j], mv_tv, tb, log_tb))
            lut_quo.append(_bs.multivalue_bootstrap_phase2(
                ctx.mulquo[j], mv_tv, tb, log_tb))
        mod_tv = _pack(lut_mod, ctx)
        quo_tv = _pack(lut_quo, ctx)
        prod = _zero_int(b.d, signed, ctx, batch)
        carry = _zero_int(b.d, signed, ctx, batch)
        for j in range(b.d):
            if i + j >= size:
                break
            selb = _switch(_digit(b, j), ctx)
            prod = _set_digit(prod, j, _bootstrap(mod_tv, selb, ctx))
            carry = _set_digit(carry, j, _bootstrap(quo_tv, selb, ctx))
        res = sl_add_integer(prod, 0, carry, 1,
                             b.d + (0 if signed else 1), ctx)
        c = sl_addto_integer(c, res, i, ctx)
    if c.signed:
        c = extend_integer(c, size * ctx.log_torus_base, ctx)
    return c


def cmp_integer(a: Integer, b: Integer, ctx: Context) -> Integer:
    """c = 0 (a < b), 1 (a == b), 2 (a > b) (`ufhe_cmp_integer`,
    `integer.c:217-265`)."""
    tb = ctx.torus_base
    batch = _batch_of(a, b)
    one = _tlwe.noiseless_trivial(_digit_torus(1, ctx).expand(batch),
                                  _n_out(ctx))
    c0 = _zero_tlwe(batch, ctx)
    for i in range(max(a.d, b.d)):
        if i < a.d and i < b.d:
            diff = _tlwe.sub(_digit(a, i), _digit(b, i))
        elif i < a.d:
            diff = _digit(a, i)
        else:
            diff = _tlwe.neg(_digit(b, i))
        sel = _switch(diff, ctx)
        c0 = _bootstrap(_pack([c0] + [one] * (tb - 1), ctx), sel, ctx)
    for key_int in (a, b):
        if key_int.signed:
            tv = _pack([c0] * (tb // 2) + [_tlwe.neg(c0)] * (tb - tb // 2),
                       ctx)
            sel = _switch(_digit(key_int, key_int.d - 1), ctx)
            c0 = _bootstrap(tv, sel, ctx)
    c0 = TLWE(a=c0.a, b=c0.b + _digit_torus(1, ctx))
    return _set_digit(_zero_int(1, False, ctx, batch), 0, c0)


def encrypted_tlwe_lut(selector: Integer, lut: list, ctx: Context) -> TLWE:
    """lut[selector] by a tree of bootstrapped LUTs, one digit per level
    (`ufhe_encrypted_tlwe_lut`, `lut.c:6-21`)."""
    tb = ctx.torus_base
    size, i = len(lut), 0
    while size > 1:
        sel = _switch(_digit(selector, i), ctx)
        lut = [_bootstrap(_pack(lut[j * tb:(j + 1) * tb], ctx), sel, ctx)
               for j in range(size // tb)]
        size //= tb
        i += 1
    return lut[0]


def lut_integer(selector: Integer, lut_values, size: int, out_d: int,
                ctx: Context) -> Integer:
    """A cleartext integer LUT (Python ints) at an encrypted index
    (`ufhe_lut_integer`, `lut.c:23-47`)."""
    tb, log_tb = ctx.torus_base, ctx.log_torus_base
    mask = tb - 1
    mv_tv = _bs.multivalue_bootstrap_phase1(
        _switch(_digit(selector, 0), ctx), ctx.keyset.bootstrap_key, tb)
    rest = Integer(digits=TLWE(a=selector.digits.a[1:],
                               b=selector.digits.b[1:]), signed=False)
    out = _zero_int(out_d, False, ctx, _batch_of(selector))
    for j in range(out_d):
        enc = [_bs.multivalue_bootstrap_phase2(
            [int(lut_values[i * tb + q] >> (j * log_tb)) & mask
             for q in range(tb)], mv_tv, tb, log_tb)
            for i in range(size // tb)]
        out = _set_digit(out, j, encrypted_tlwe_lut(rest, enc, ctx))
    return out


def mux_integer_array(selector: Integer, vec: list, out_d: int,
                      ctx: Context) -> Integer:
    """vec[selector] (`ufhe_mux_integer_array`, `lut.c:49-64`)."""
    tb = ctx.torus_base
    batch = _batch_of(selector, *vec)
    zero = _zero_tlwe(batch, ctx)
    out = _zero_int(out_d, False, ctx, batch)
    for i in range(out_d):
        lut = [_digit(v, i) for v in vec]
        lut += [zero] * (-len(lut) % tb)
        out = _set_digit(out, i, encrypted_tlwe_lut(selector, lut, ctx))
    return out


def relu_integer(a: Integer, ctx: Context) -> Integer:
    """a > 0 ? a : 0 (`ufhe_relu_integer`, `ml.c:4-21`)."""
    tb = ctx.torus_base
    p = ctx.keyset.params
    sel = _switch(_digit(a, a.d - 1), ctx)
    batch = _batch_of(a)
    zero = _zero_tlwe(batch, ctx)
    out = _zero_int(a.d, a.signed, ctx, batch)
    for i in range(a.d - 1):
        tv = _pack([_digit(a, i)] * (tb // 2) + [zero] * (tb - tb // 2), ctx)
        out = _set_digit(out, i, _bootstrap(tv, sel, ctx))
    top = torch.cat([_digit_torus(torch.arange(tb // 2), ctx),
                     torch.zeros((tb - tb // 2,), dtype=TORUS_DTYPE,
                                 device=ctx.keyset.device)])
    tv = _trlwe.torus_packing(top, p.k, p.N)
    return _set_digit(out, a.d - 1, _bootstrap(tv, sel, ctx))
