"""The coefficient-sharded ("N-sharded") negacyclic NTT and blind rotation.

The single-device transforms keep a whole length-N polynomial on one device
(`ntt`, `ops/pbs_kernel`).  Here the coefficient axis itself is split over D
shards of a mesh axis, with a pair exchange between shards at each
cross-shard butterfly stage: the scale-out form for ring dimensions beyond
one device.  The TPU package's `parallel/dist_ntt.py`, on the port's
single-process mesh (`parallel.mesh`): its ``shard_map`` is a Python loop
over the D shards, ``axis_index`` the shard's index, and each ``ppermute``
pair exchange a copy between shards that takes every shard's partner value
before any shard updates.  Shards may repeat a device (virtual shards, one
after another on it), which is how the whole path runs on one card.

Factorization (four-step, Bailey): with N = D * N2, coefficient i = i1*N2 +
i2 is row i1 (the shard), column i2 of a [D, N2] matrix.

  negacyclic fold:  x[i] *= psi^i                      (local twist)
  step 1:           DFT_D over i1  (root w^N2)         log2(D) radix-2
                    stages ACROSS shards, one pair exchange each
  step 2:           *= w^(i2*k1)                       (local twiddle)
  step 3:           DFT_N2 over i2 (root w^D)          (local NTT)

The inverse mirrors the three steps with inverse roots and folds in N^-1.
The output's shard order is bit-reversed in k1 and its local order
bit-reversed in k2, which does not matter to a convolution: both operands'
pointwise product is taken in the same order.

Residues are int64 below p < 2^30, so every product of two fits (< 2^60);
a sum of products is reduced term by term (`_mac`), never as a raw sum of
J products, which int64 would overflow from J = 9 (the TPU package sums in
u64, exact while J (p-1)^2 < 2^64).  All of this is plain PyTorch: the TPU
package runs it as jnp and reaches no kernel of its own here.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from .. import bootstrap as _bs
from .. import ntt as _ntt
from .. import trlwe as _trlwe
from ..torus import gadget_decompose, torus2int, wrap
from ..trlwe import from_stacked


def _pow_table(base: int, count: int, p: int, step: int = 1) -> np.ndarray:
    """[base^(step*j) mod p for j in range(count)] by a running product."""
    out = np.empty(count, dtype=np.int64)
    b = pow(base, step, p)
    v = 1
    for j in range(count):
        out[j] = v
        v = (v * b) % p
    return out


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


class DistNTTPlan:
    """Tables of the D-way coefficient-sharded negacyclic NTT, held on the
    host as int64 tensors (the TPU package's layouts); `on` gives them on a
    device."""

    def __init__(self, N: int, D: int, primes):
        if N % D or D & (D - 1) or N & (N - 1):
            raise ValueError(f"N={N} and D={D} must be powers of two, D | N")
        self.N, self.D, self.N2 = N, D, N // D
        self.logD = D.bit_length() - 1
        self.primes = tuple(int(p) for p in primes)
        Pn, N2, logD = len(self.primes), self.N2, self.logD
        twist = np.empty((Pn, N), np.int64)
        itwist = np.empty((Pn, N), np.int64)
        mid = np.empty((Pn, D, N2), np.int64)
        imid = np.empty((Pn, D, N2), np.int64)
        dev_tw = np.ones((logD, Pn, D), np.int64)
        dev_itw = np.ones((logD, Pn, D), np.int64)
        for m, p in enumerate(self.primes):
            if (p - 1) % (2 * N):
                raise ValueError(f"{p} has no 2N-th root for N={N}")
            psi = pow(_ntt._primitive_root(p), (p - 1) // (2 * N), p)
            ipsi = pow(psi, p - 2, p)
            w = (psi * psi) % p
            iw = pow(w, p - 2, p)
            ninv = pow(N, p - 2, p)
            twist[m] = _pow_table(psi, N, p)
            itwist[m] = _pow_table(ipsi, N, p) * ninv % p
            # step-2 twiddle: w^(i2*k1) with k1 = bitrev(shard, logD)
            for j in range(D):
                k1 = _bitrev(j, logD)
                mid[m, j] = _pow_table(w, N2, p, step=k1)
                imid[m, j] = _pow_table(iw, N2, p, step=k1)
            # the shard axis's DIF/DIT stage twiddles (root wd = w^N2, order
            # D): bottom shard j of stage h takes W_{2h}^{j & (h-1)} with
            # W_{2h} = wd^(D/(2h))
            wd = pow(w, N2, p)
            iwd = pow(wd, p - 2, p)
            for s in range(logD):
                h = D >> (s + 1)
                hi = 1 << s                   # DIT stage s has half-size 2^s
                for j in range(D):
                    if j & h:
                        dev_tw[s, m, j] = pow(
                            wd, (j & (h - 1)) * (D // (2 * h)), p)
                    if j & hi:
                        dev_itw[s, m, j] = pow(
                            iwd, (j & (hi - 1)) * (D // (2 * hi)), p)
        # the local cyclic DFT_N2's stage twiddles (root wl = w^D)
        self.loc_tw, self.loc_itw = [], []
        for s in range(N2.bit_length() - 1):
            h, ih = N2 >> (s + 1), 1 << s
            rows = np.empty((Pn, h), np.int64)
            irows = np.empty((Pn, ih), np.int64)
            for m, p in enumerate(self.primes):
                w = pow(_ntt._primitive_root(p), 2 * ((p - 1) // (2 * N)), p)
                wl = pow(w, D, p)
                rows[m] = _pow_table(wl, h, p, step=N2 // (2 * h))
                irows[m] = _pow_table(pow(wl, p - 2, p), ih, p,
                                      step=N2 // (2 * ih))
            self.loc_tw.append(torch.from_numpy(rows))
            self.loc_itw.append(torch.from_numpy(irows))
        self.twist = torch.from_numpy(twist.reshape(Pn, D, N2))
        self.itwist = torch.from_numpy(itwist.reshape(Pn, D, N2))
        self.mid = torch.from_numpy(mid)
        self.imid = torch.from_numpy(imid)
        self.dev_tw = torch.from_numpy(dev_tw)
        self.dev_itw = torch.from_numpy(dev_itw)
        self.p = torch.tensor(self.primes, dtype=torch.int64)
        self._on = {}

    def on(self, device) -> SimpleNamespace:
        """The plan's tables on ``device``, made once per device."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = SimpleNamespace(**{
                name: [t.to(device) for t in v] if isinstance(v, list)
                else v.to(device)
                for name, v in vars(self).items()
                if name in ("twist", "itwist", "mid", "imid", "dev_tw",
                            "dev_itw", "loc_tw", "loc_itw", "p")})
        return self._on[key]

    def shard(self, j: int, device) -> SimpleNamespace:
        """Shard j's rows on ``device``: twist, itwist, mid, imid [P, N2],
        the shard-axis stage twiddles [logD][P] and the primes p [P]."""
        t = self.on(device)
        return SimpleNamespace(
            twist=t.twist[:, j], itwist=t.itwist[:, j], mid=t.mid[:, j],
            imid=t.imid[:, j], dev_tw=[t.dev_tw[s][:, j]
                                       for s in range(self.logD)],
            dev_itw=[t.dev_itw[s][:, j] for s in range(self.logD)],
            p=t.p)


def _col(t, ndim):
    """[P] -> [P, 1, ..., 1] (leading-P layout, ``ndim`` dims in all)."""
    return t.reshape(t.shape[:1] + (1,) * (ndim - 1))


def _row(t, ndim):
    """[P, W] -> [P, 1, ..., 1, W]."""
    return t.reshape(t.shape[:1] + (1,) * (ndim - 2) + t.shape[-1:])


def _local_dft(x, plan: DistNTTPlan):
    """Iterative cyclic DIF over the last axis (length N2), output
    bit-reversed.  x: [P, ..., N2] residues (< p), any batch dims between P
    and N2."""
    t = plan.on(x.device)
    N2 = plan.N2
    for s, tw in enumerate(t.loc_tw):
        h = N2 >> (s + 1)
        v = x.reshape(x.shape[:-1] + (N2 // (2 * h), 2, h))
        u, w_ = v[..., 0, :], v[..., 1, :]
        pb = _col(t.p, u.ndim)
        top = (u + w_) % pb
        bot = ((u + pb - w_) * _row(tw, u.ndim)) % pb
        x = torch.stack([top, bot], dim=-2).reshape(x.shape)
    return x


def _local_idft(x, plan: DistNTTPlan):
    """Inverse of `_local_dft` (takes bit-reversed input), without the 1/N2
    scaling (folded into the plan's itwist)."""
    t = plan.on(x.device)
    N2 = plan.N2
    for s, itw in enumerate(t.loc_itw):
        h = 1 << s
        v = x.reshape(x.shape[:-1] + (N2 // (2 * h), 2, h))
        u, w_ = v[..., 0, :], v[..., 1, :]
        pb = _col(t.p, u.ndim)
        wt = (w_ * _row(itw, u.ndim)) % pb
        top = (u + wt) % pb
        bot = (u + pb - wt) % pb
        x = torch.stack([top, bot], dim=-2).reshape(x.shape)
    return x


def _exchange(xs, h: int):
    """Each shard j's copy of shard j ^ h's value, all taken before any
    shard updates (the pair exchange of one stage)."""
    return [xs[j ^ h].to(x.device) for j, x in enumerate(xs)]


def _forward_sharded(xs, plan: DistNTTPlan, shards):
    """xs: shard j's [P, ..., N2] residues on its device, j = 0 .. D-1;
    shards: each shard's tables (`DistNTTPlan.shard`).  One pair exchange
    per shard-axis stage."""
    xs = [(x * _row(t.twist, x.ndim)) % _col(t.p, x.ndim)
          for x, t in zip(xs, shards)]
    for s in range(plan.logD):
        h = plan.D >> (s + 1)
        recv = _exchange(xs, h)
        xs = [((r + _col(t.p, x.ndim) - x) * _col(t.dev_tw[s], x.ndim))
              % _col(t.p, x.ndim) if j & h else (x + r) % _col(t.p, x.ndim)
              for j, (x, r, t) in enumerate(zip(xs, recv, shards))]
    return [_local_dft((x * _row(t.mid, x.ndim)) % _col(t.p, x.ndim), plan)
            for x, t in zip(xs, shards)]


def _inverse_sharded(xs, plan: DistNTTPlan, shards):
    """The inverse of `_forward_sharded`, N^-1 included."""
    xs = [(_local_idft(x, plan) * _row(t.imid, x.ndim)) % _col(t.p, x.ndim)
          for x, t in zip(xs, shards)]
    for s in range(plan.logD):
        h = 1 << s
        pre = [(x * _col(t.dev_itw[s], x.ndim)) % _col(t.p, x.ndim)
               if j & h else x for j, (x, t) in enumerate(zip(xs, shards))]
        recv = _exchange(pre, h)
        xs = [(r + _col(t.p, x.ndim) - x) % _col(t.p, x.ndim) if j & h
              else (x + r) % _col(t.p, x.ndim)
              for j, (x, r, t) in enumerate(zip(pre, recv, shards))]
    return [(x * _row(t.itwist, x.ndim)) % _col(t.p, x.ndim)
            for x, t in zip(xs, shards)]


def _shard_devices(mesh, axis: str):
    """The devices along ``axis`` of the port's 2-D mesh (the first of the
    other axis): one per shard.  A one-axis layout is a (D, 1) mesh, e.g.
    ``mesh.make_mesh(devices, data=D, model=1, names=("x", "y"))``."""
    return [row[0] for row in mesh.rows(axis, None)]


def _split_last(x, devices, N2: int):
    """x [..., D N2] -> shard j's [..., N2] slice on devices[j]."""
    return [x[..., j * N2:(j + 1) * N2].to(d).contiguous()
            for j, d in enumerate(devices)]


def make_dist_ntt_mul_small(mesh, N: int, axis: str = "x",
                            max_abs_digit: int = 256):
    """fn(d_small [..., N] small ints, b [..., N] torus words) -> the exact
    negacyclic product mod 2^64 (2^32 for int32 words), with the
    coefficient axis sharded over ``axis`` of ``mesh`` (a pair exchange per
    shard-axis stage of each transform).  The words of
    `polynomial.ntt_mul_small`; the result lands on b's device."""
    devices = _shard_devices(mesh, axis)
    primes = _ntt.primes_for_bound(_ntt.conv_bound(N, max_abs_digit, 1))
    dplan = DistNTTPlan(N, len(devices), primes)
    shards = [dplan.shard(j, d) for j, d in enumerate(devices)]

    def run(d, b):
        splan = _ntt.get_plan(N, primes, b.device)      # to_resi, Garner
        d_res = _ntt.to_resi_small(d, splan).movedim(-2, 0)   # [P, ..., N]
        b_res = _ntt.to_resi_u64(b, splan).movedim(-2, 0)
        a_hat = _forward_sharded(_split_last(d_res, devices, dplan.N2),
                                 dplan, shards)
        b_hat = _forward_sharded(_split_last(b_res, devices, dplan.N2),
                                 dplan, shards)
        c = [(x * y) % _col(t.p, x.ndim)
             for x, y, t in zip(a_hat, b_hat, shards)]
        r = torch.cat([x.to(b.device) for x in
                       _inverse_sharded(c, dplan, shards)], dim=-1)
        return wrap(_ntt.garner_u64(r.movedim(0, -2), splan), b.dtype)

    return run


# --- the serial emulation of the sharded transform (keys and tables) ------

def full_forward(x_res, plan: DistNTTPlan):
    """`_forward_sharded` over the whole array on one device: x_res [..., P,
    N] residues -> [..., P, N] spectra in the sharded ordering (shard-major
    [D, N2], k1 bit-reversed across shards, the local order bit-reversed).
    Transforms keys and monomial tables into the order the sharded path
    produces."""
    t = plan.on(x_res.device)
    lead = tuple(x_res.shape[:-2])
    Pn, D, N2 = len(plan.primes), plan.D, plan.N2
    x = x_res.reshape(lead + (Pn, D, N2))
    p3 = t.p.reshape(Pn, 1, 1)
    x = (x * t.twist) % p3
    for s in range(plan.logD):
        h = D >> (s + 1)
        v = x.reshape(lead + (Pn, D // (2 * h), 2, h, N2))
        u, w_ = v[..., 0, :, :], v[..., 1, :, :]
        p4 = t.p.reshape(Pn, 1, 1, 1)
        tw = t.dev_tw[s].reshape(Pn, D // (2 * h), 2, h)[:, :, 1, :][..., None]
        top = (u + w_) % p4
        bot = ((u + p4 - w_) * tw) % p4
        x = torch.stack([top, bot], dim=-3).reshape(lead + (Pn, D, N2))
    x = (x * t.mid) % p3
    x = _local_dft(x.movedim(-3, 0), plan).movedim(0, -3)
    return x.reshape(lead + (Pn, D * N2))


def dist_xpow2_tables(plan: DistNTTPlan):
    """Spectra of X^(2^t), t = 0 .. log2 N, in the sharded ordering: [log2 N
    + 1, P, N] int64 on the host.  Bit log2(2N) of an exponent is the
    identity (X^2N = 1) and needs no row, as `ntt.xpow`."""
    N, Pn = plan.N, len(plan.primes)
    T = N.bit_length()                                    # log2 N + 1 rows
    mono = torch.zeros((T, Pn, N), dtype=torch.int64)
    for t in range(T - 1):
        mono[t, :, 1 << t] = 1
    mono[T - 1, :, 0] = plan.p - 1                        # X^N = -1
    return full_forward(mono, plan)


def _dist_xpow(a_int, tables, p):
    """Monomial spectra zeta^a in the sharded ordering: a_int [...] in [0,
    2N]; tables [T, P, N2] (a shard's columns); p [P] -> [..., P, N2]."""
    a = a_int.to(torch.int64)
    x = torch.ones(a.shape + tables.shape[1:], dtype=torch.int64,
                   device=tables.device)
    pb = p[:, None]
    for t in range(tables.shape[0]):
        bit = ((a >> t) & 1)[..., None, None] == 1
        x = torch.where(bit, (x * tables[t]) % pb, x)
    return x


def _mac(spec, key, p):
    """sum_j spec_j * key_j mod p: spec [P, B, J, N2], key [P, J, C, N2] ->
    [P, B, C, N2].  Each product (< 2^60) is reduced before the sum, which
    then stays below J p: a raw int64 sum of J products would pass 2^63
    from J = 9."""
    prod = (spec[:, :, :, None, :] * key[:, None]) % _col(p, 5)
    return prod.sum(dim=2) % _col(p, 4)


# --- the N-sharded blind rotation ------------------------------------------

def make_dist_blind_rotate(mesh, N: int, k: int, l: int, Bg_bit: int,
                           axis: str = "x"):
    """The coefficient-sharded blind rotation: every polynomial of the
    accumulator, the digit spectra and the key lives split over ``axis`` of
    ``mesh`` (N/D coefficients per shard); the n CMUX steps run the
    rotation-free step (`bootstrap._cmux_step_rotntt`), so each step's
    data-dependent rotation is a local diagonal multiply and the traffic
    between shards is one pair exchange per shard-axis stage of each
    forward and inverse transform.

    Returns (prep_key, run):
      prep_key(bk) -> the key's spectra in the sharded ordering, one
                      [n, J, C, P, N2] int64 tensor per shard on its device
      run(acc0, a_int, key_dist) -> the rotated accumulators [B, k+1, N]
                      (acc0's words and device): acc0 [B, k+1, N], a_int
                      [B, n] exponents in [0, 2N]; the words of the
                      single-device rotation-free loop at the same primes.

    The primes are those of ``ntt.external_product_bound(N, Bg_bit, l, k)``
    (its doubled budget covers the rotation-free step), whatever the key's
    own: `prep_key` recovers the key's TRGSW rows from its NTT form (exact:
    the rows' centred values lie within the key's CRT range) and
    transforms them again."""
    devices = _shard_devices(mesh, axis)
    D, J, C = len(devices), (k + 1) * l, k + 1
    primes = _ntt.primes_for_bound(_ntt.external_product_bound(N, Bg_bit, l,
                                                               k))
    dplan = DistNTTPlan(N, D, primes)
    N2, Pn = dplan.N2, len(primes)
    shards = [dplan.shard(j, d) for j, d in enumerate(devices)]
    xp2 = _split_last(dist_xpow2_tables(dplan), devices, N2)   # [T, P, N2]
    splans = [_ntt.get_plan(N, primes, d) for d in devices]

    def prep_key(bk):
        rows = _ntt.from_ntt_u64(bk.v, bk.plan())           # [n, J, C, N]
        res = _ntt.to_resi_u64(rows, _ntt.get_plan(N, primes, bk.device))
        return _split_last(full_forward(res, dplan), devices, N2)

    def run(acc0, a_int, key_dist):
        B = acc0.shape[0]
        accs = _split_last(acc0, devices, N2)               # [B, C, N2]
        a_all = {str(d): a_int.t().to(d).contiguous() for d in devices}
        for i in range(a_int.shape[-1]):
            xs = [_ntt.to_resi_small(gadget_decompose(acc, Bg_bit, l)
                                     .reshape(B, J, N2), sp).movedim(-2, 0)
                  for acc, sp in zip(accs, splans)]          # [P, B, J, N2]
            specs = _forward_sharded(xs, dplan, shards)
            prods = []
            for j, (spec, t) in enumerate(zip(specs, shards)):
                prod = _mac(spec, key_dist[j][i].movedim(-2, 0), t.p)
                zeta = _dist_xpow(a_all[str(devices[j])][i], xp2[j], t.p)
                prod = (prod * (zeta.movedim(-2, 0) - 1)[:, :, None]) \
                    % _col(t.p, 4)                           # [P, B, C, N2]
                prods.append(prod.reshape(Pn, B * C, N2))
            invs = _inverse_sharded(prods, dplan, shards)
            accs = [acc + wrap(_ntt.garner_u64(
                        inv.reshape(Pn, B, C, N2).movedim(0, -2), sp),
                        acc.dtype)
                    for acc, inv, sp in zip(accs, invs, splans)]
        return torch.cat([acc.to(acc0.device) for acc in accs], dim=-1)

    return prep_key, run


def functional_bootstrap_n_sharded(mesh, tv, c, bk, key_dist, run,
                                   torus_base: int):
    """The whole PBS with the blind rotation N-sharded (``run`` and
    ``key_dist`` from `make_dist_blind_rotate` on ``mesh``): the test
    vector's rotation by -round(b) and the extraction on the caller's
    device, the CMUX steps sharded."""
    acc = _bs.rotate_test_vector(tv, c, bk, torus_base)
    a_int = torus2int(c.a, int(math.log2(2 * bk.N))).to(torch.int32)
    batch = tuple(a_int.shape[:-1])
    B = math.prod(batch)
    st = acc.stacked()
    st = st.expand(batch + tuple(st.shape[-2:])).reshape(B, bk.k + 1, bk.N)
    out = run(st.contiguous(), a_int.reshape(B, -1), key_dist)
    return _trlwe.extract_tlwe(
        from_stacked(out.reshape(batch + (bk.k + 1, bk.N))), 0)
