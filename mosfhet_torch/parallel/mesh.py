"""Meshes of devices, and the bootstraps sharded over them.

Two ways to spread a batched bootstrap, as in the TPU package's
``parallel/mesh.py``:

- **the batch axis ("data")**: independent bootstraps are split over the
  data shards, each holding the whole key.  No communication.
- **the gadget axis ("model")**: the external product sums over the key's
  J = (k+1)l decomposition rows; the key's rows are split over the model
  shards and the NTT-domain partials of every CMUX step are summed across
  them.  This trades a cross-shard sum per step for the key's memory per
  device.

A mesh is a 2-D grid of ``torch.device``s with axis names, driven by one
Python process, as the TPU package's single-controller mesh.  A device may
stand in the grid more than once: those shards are virtual and run one
after another on that device.  This is how the whole sharded path runs on
one card (and on the CPU in the tests), with the kernel launches a mesh of
distinct cards would make.  Meshes across processes (``torch.distributed``)
are not here.

Each data shard's batch lives on the first device of its data row; with the
key's rows sharded, every distinct device of the row holds a copy of the
row's accumulators.  Results are gathered on the caller's device.

At the 32-bit torus all three run on both axes, through the one-limb forms
of K1, K4, K6, K7, K8a and K8b.
"""

from __future__ import annotations

import torch

from .. import bootstrap as _bs
from .. import bootstrap_ga as _bga
from .. import ntt as _ntt
from .. import trlwe as _trlwe
from ..ops import pbs_kernel as _pk
from ..tlwe import TLWE
from ..torus import gadget_decompose
from ..trlwe import TRLWE, from_stacked


class Mesh:
    """A 2-D grid of devices, ``devices[i][j]`` at index i of the first axis
    and j of the second, with the axes' names; ``shape`` maps each name to
    its size."""

    def __init__(self, devices, axis_names=("data", "model")):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if (len(axis_names) != 2 or len(set(axis_names)) != 2 or not grid
                or not grid[0] or len({len(row) for row in grid}) != 1):
            raise ValueError("a mesh is a non-empty rectangular 2-D grid of "
                             "devices with two distinct axis names")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (len(grid), len(grid[0]))))

    def rows(self, data_axis: str, model_axis: str | None):
        """One list of devices per index of ``data_axis``: its devices along
        ``model_axis``, or only the first of them when ``model_axis`` is None
        (the key replicated, the other axis unused)."""
        if data_axis not in self.axis_names or model_axis == data_axis or (
                model_axis is not None and model_axis not in self.axis_names):
            raise ValueError(f"axes {data_axis!r}, {model_axis!r} are not "
                             f"two of the mesh's {self.axis_names}")
        grid = self.devices if self.axis_names[0] == data_axis \
            else tuple(zip(*self.devices))
        return [list(row) if model_axis else [row[0]] for row in grid]


def make_mesh(devices=None, data: int | None = None, model: int = 1,
              names=("data", "model")) -> Mesh:
    """A (data, model) mesh of ``devices`` in row-major order; every CUDA
    card when none are given (raises without one).  Name a device more than
    once for virtual shards: ``make_mesh([torch.device("cuda")] * 4,
    data=2, model=2)`` runs the 2 x 2 sharded path on one card, and a list
    of ``torch.device("cpu")`` runs it on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass the devices "
                               "(torch.device('cpu') repeated for the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if data is None:
        data = len(devices) // model
    if data < 1 or model < 1 or data * model != len(devices):
        raise ValueError(f"{len(devices)} devices do not form a "
                         f"{data} x {model} mesh")
    return Mesh([devices[r * model:(r + 1) * model] for r in range(data)],
                names)


def _distinct(devices):
    return list(dict.fromkeys(devices))


def _shard_size(batch: int, n_rows: int) -> int:
    if batch % n_rows:
        raise ValueError(f"a batch of {batch} does not split evenly over "
                         f"{n_rows} data shards")
    return batch // n_rows


def _split(total: int, m: int, what: str | None = None):
    """[(shard, its rows)]: ``total`` rows in m equal slices.  Raises when
    m does not divide ``total`` and ``what`` names them."""
    if what is not None and total % m:
        raise ValueError(f"the {total} {what} do not split over {m} model "
                         f"shards")
    w = total // m
    return [(s, slice(s * w, (s + 1) * w)) for s in range(m)]


def _key_slices(t, rows, parts):
    """Each shard's rows of ``t`` (along dim 1) on each device it sits on:
    {(s, device): contiguous copy}, made once.  ``parts`` [(s, rows)]."""
    out = {}
    for row in rows:
        for s, rs in parts:
            if (s, row[s]) not in out:
                out[s, row[s]] = t[:, rs].to(row[s]).contiguous()
    return out


def _gather(outs, batch, like: torch.Tensor, k: int, N: int) -> TLWE:
    acc = torch.cat([o.to(like.device) for o in outs])
    return _trlwe.extract_tlwe(from_stacked(acc.reshape(batch + (k + 1, N))),
                               0)


def _blind_rotate_tp(acc0, a_int, rows, keys, plans):
    """The blind rotation with the key's rows sharded, one Python loop over
    the n steps.  In each step and data row, every model shard runs K8a
    (`pbs_kernel.partial_step`) on its own device and key rows, writing its
    partial into its slot of the row's buffer [m, Bs, C, P, N]; a slot
    written on another device is copied in (the cross-shard sum is this
    gather); then K8b (`pbs_kernel.finish_step`) reduces the m partials mod
    p, which is exact for every m, and adds the step into the accumulators,
    once per distinct device of the row (once per data row on one card).

    acc0 [B, C, N] int64 or int32 words; a_int [n, B] int32; rows: the data
    rows' devices (model shards); keys {(s, device): (v32, vs32) [n, J/m,
    C, P, N]}; plans {device: kernel plan}.  Returns each data row's
    accumulators."""
    Bs = acc0.shape[0] // len(rows)
    m = len(rows[0])
    jl = keys[0, rows[0][0]][0].shape[1]
    state = []
    for r, row in enumerate(rows):
        sl = slice(r * Bs, (r + 1) * Bs)
        devs = _distinct(row)
        state.append((
            row,
            {d: acc0[sl].to(d, copy=True) for d in devs},
            {d: a_int[:, sl].to(d).contiguous() for d in devs},
            {d: torch.empty((m, Bs, plans[d].C, plans[d].P, plans[d].N),
                            dtype=torch.int32, device=d) for d in devs}))
    for i in range(a_int.shape[0]):
        for row, accs, a_s, bufs in state:
            for s, d in enumerate(row):
                kv, kvs = keys[s, d]
                _pk.partial_step(accs[d], a_s[d][i], s * jl, kv[i], kvs[i],
                                 plans[d], out=bufs[d][s])
            for s, d in enumerate(row):
                for e, buf in bufs.items():
                    if e != d:
                        buf[s].copy_(bufs[d][s])
            for d, acc in accs.items():
                _pk.finish_step(acc, bufs[d], plans[d])
    return [accs[row[0]] for row, accs, _, _ in state]


def pbs_on_mesh(mesh: Mesh, bk: _bs.BootstrapKey, torus_base: int,
                data_axis: str = "data", model_axis: str | None = "model"):
    """The batched functional bootstrap sharded over ``mesh``: returns
    ``run(tv, c) -> TLWE``, the words of `bootstrap.functional_bootstrap`.

    The batch is split over ``data_axis`` (it must divide evenly).  With
    ``model_axis`` None, or of size 1, the key is replicated: each data
    shard is one blind-rotation launch (K1).  With a model size m > 1 the
    key's J rows are split into m slices of J/m (J must divide), made here
    once, each on its shard's device, and every CMUX step runs K8a per
    shard and K8b per data row (`_blind_rotate_tp`): n (data m) K8a and
    n data K8b launches per call on one card.  The key needs no unfolding."""
    if bk.unfolding != 1:
        raise ValueError("pbs_on_mesh needs a key without unfolding "
                         "(see unfolded_pbs_on_mesh)")
    rows = mesh.rows(data_axis, model_axis)
    m = len(rows[0])
    parts = _split((bk.k + 1) * bk.l, m, "gadget rows of the key")
    devs = _distinct(d for row in rows for d in row)
    plans = {d: _pk.get_kernel_plan(bk.N, bk.primes, bk.l, bk.Bg_bit, bk.k,
                                    d) for d in devs}
    if m == 1:
        keys = {d: (bk.v32.to(d), bk.vs32.to(d)) for d in devs}
    else:
        v = _key_slices(bk.v32, rows, parts)
        vs = _key_slices(bk.vs32, rows, parts)
        keys = {sd: (v[sd], vs[sd]) for sd in v}

    def run(tv: TRLWE, c: TLWE) -> TLWE:
        acc0, a_int, batch = _bs.blind_rotate_inputs(
            _bs.rotate_test_vector(tv, c, bk, torus_base), c.a, bk)
        Bs = _shard_size(acc0.shape[0], len(rows))
        if m > 1:
            outs = _blind_rotate_tp(acc0, a_int, rows, keys, plans)
        else:
            outs = []
            for r, (d,) in enumerate(rows):
                sl = slice(r * Bs, (r + 1) * Bs)
                outs.append(_pk.blind_rotate_scan(
                    acc0[sl].to(d), a_int[:, sl].to(d).contiguous(),
                    *keys[d], plans[d]))
        return _gather(outs, batch, acc0, bk.k, bk.N)

    return run


def unfolded_pbs_on_mesh(mesh: Mesh, bk: _bs.BootstrapKey, torus_base: int,
                         data_axis: str = "data",
                         model_axis: str | None = None):
    """The bootstrap with an unfolded key sharded over ``mesh``
    (`blind_rotate_unfolded`, `bootstrap.c:124-148`): returns
    ``run(tv, c) -> TLWE``.

    The batch is split over ``data_axis``.  With a model size of 1 each data
    shard is one unfolded-rotation launch (K4).  With m > 1 the key's 2^u
    products of each group are split over the model shards (m must divide
    2^u): each shard rotates and sums its 2^u/m, the sums add mod 2^64 (or
    2^32) on the data row's first device (exact, as the single-device
    combine), and one replace-mode external product per group follows
    there.  That route is plain PyTorch: the TPU package has no kernel on
    it (it runs jnp there), so there is none to port."""
    if bk.unfolding == 1:
        raise ValueError("unfolded_pbs_on_mesh needs an unfolded key")
    rows = mesh.rows(data_axis, model_axis)
    m = len(rows[0])
    parts = _split(1 << bk.unfolding, m, "key products of a group")
    devs = _distinct(d for row in rows for d in row)
    plans = {d: _pk.get_kernel_plan(bk.N, bk.primes, bk.l, bk.Bg_bit, bk.k,
                                    d) for d in devs}
    sus = ({d: bk.su.to(d) for d in devs} if m == 1
           else _key_slices(bk.su, rows, parts))

    def run(tv: TRLWE, c: TLWE) -> TLWE:
        acc0, rot, batch = _bs.unfolded_rotate_inputs(
            _bs.rotate_test_vector(tv, c, bk, torus_base), c.a, bk)
        Bs = _shard_size(acc0.shape[0], len(rows))
        outs = []
        for r, row in enumerate(rows):
            sl, d0 = slice(r * Bs, (r + 1) * Bs), row[0]
            kp = plans[d0]
            acc = acc0[sl].to(d0)
            if m == 1:
                outs.append(_pk.unfolded_rotate(
                    acc, rot[sl].to(d0).contiguous(), sus[d0], kp))
                continue
            rot_s = [rot[sl, :, rs].to(row[s]) for s, rs in parts]
            for g in range(rot.shape[1]):
                comb = sum(_pk.combine_rotated(sus[s, row[s]][g],
                                               rot_s[s][:, g]).to(d0)
                           for s, _ in parts)
                acc = _pk.ext_product_replace(
                    acc, _ntt.to_ntt_u64(comb, kp.ntt), kp.ntt, kp.l,
                    kp.Bg_bit)
            outs.append(acc)
        return _gather(outs, batch, acc0, bk.k, bk.N)

    return run


def ga_pbs_on_mesh(mesh: Mesh, bkg: _bga.GABootstrapKey, torus_base: int,
                   data_axis: str = "data", model_axis: str | None = None):
    """The Galois-automorphism bootstrap sharded over ``mesh``
    (`blind_rotate_ga`, `bootstrap_ga.c:39-60`): returns
    ``run(tv, c) -> TLWE``.

    The batch is split over ``data_axis``.  With a model size of 1 each data
    shard is one automorphism key-switch launch (K6) and one GA-rotation
    launch (K7).  With m > 1 both row sums are split: the external
    product's J gadget rows and the key switch's k t keyset rows, each only
    where m divides its count (else that table stays whole on the row's
    first device).  Each shard's NTT-domain partial is summed mod p on the
    data row's first device, then the step goes on there.  That route is
    plain PyTorch: the TPU package has no kernel on it (it runs jnp there),
    so there is none to port.  Both torus widths: at the 32-bit one a model
    size of 1 runs K6 and K7 in their one-limb forms."""
    rows = mesh.rows(data_axis, model_axis)
    m = len(rows[0])
    k, N = bkg.k, bkg.N
    devs = _distinct(d for row in rows for d in row)
    plans = {d: (_pk.get_kernel_plan(N, bkg.primes, bkg.l, bkg.Bg_bit, k, d),
                 _pk.get_kernel_plan(N, bkg.ks_primes, bkg.ks_t,
                                     bkg.ks_base_bit, k, d)) for d in devs}
    inv2n = {d: bkg.inv2n.to(d) for d in devs}
    if m == 1:
        keys = {d: (bkg.s_v32.to(d), bkg.s_vs32.to(d), bkg.ak.to(d))
                for d in devs}

    # each row sum is split where m divides it, else kept whole on the
    # data row's first device
    J, Jk = (k + 1) * bkg.l, k * bkg.ks_t
    sv_rows = _split(J, m if J % m == 0 else 1)
    ak_rows = _split(Jk, m if Jk % m == 0 else 1)
    if m > 1:
        sv = _key_slices(bkg.s_v32, rows, sv_rows)
        svs = _key_slices(bkg.s_vs32, rows, sv_rows)
        ak = _key_slices(bkg.ak, rows, ak_rows)

    def ext_prod(acc, i, row):
        """BK_i (x) acc with the gadget rows split over the row's shards."""
        d0 = row[0]
        plan = plans[d0][0].ntt
        digits = gadget_decompose(acc, bkg.Bg_bit, bkg.l).reshape(-1, J, N)
        tot = 0
        for s, rs in sv_rows:
            d = row[s]
            spec = _ntt.to_ntt_small(digits[:, rs].to(d), plans[d][0].ntt)
            tot = tot + _ntt.pointwise_mul_acc_key(
                spec.unsqueeze(2), _pk.i32_as_u32(sv[s, d][i]),
                _pk.i32_as_u32(svs[s, d][i]), plans[d][0].ntt, dim=1).to(d0)
        return _ntt.from_ntt_u64(torch.remainder(tot, plan.p[:, None]), plan)

    def eval_auto(acc, gen, row):
        """psi_gen, then the key switch with keyset entry (gen - 1)/2, its
        k t rows split over the row's shards (`auto_keyswitch_rows`)."""
        d0 = row[0]
        plan = plans[d0][1].ntt
        kidx = (gen.to(torch.int64) - 1) >> 1
        perm = _bga._permute_dyn(acc, gen, inv2n[d0], N)
        digits = gadget_decompose(perm[:, :k], bkg.ks_base_bit,
                                  bkg.ks_t).reshape(-1, Jk, N)
        tot = 0
        for s, rs in ak_rows:
            d = row[s]
            spec = _ntt.to_ntt_small(digits[:, rs].to(d), plans[d][1].ntt)
            key = _pk.i32_as_u32(ak[s, d][kidx.to(d)])
            tot = tot + _ntt.pointwise_mul_acc_generic(
                spec.unsqueeze(2), key, plans[d][1].ntt, dim=1).to(d0)
        out = -_ntt.from_ntt_u64(torch.remainder(tot, plan.p[:, None]), plan)
        out[:, k] += perm[:, k]
        return out

    def run(tv: TRLWE, c: TLWE) -> TLWE:
        acc0, kidx0, ginv0, gens, batch = _bga.ga_rotate_inputs(
            _bs.rotate_test_vector(tv, c, bkg, torus_base), c.a, bkg)
        Bs = _shard_size(acc0.shape[0], len(rows))
        outs = []
        for r, row in enumerate(rows):
            sl, d0 = slice(r * Bs, (r + 1) * Bs), row[0]
            kp, kp_ks = plans[d0]
            acc = acc0[sl].to(d0)
            if m == 1:
                sv32, svs32, ak32 = keys[d0]
                acc = _pk.auto_keyswitch_stream(
                    acc, ak32, kidx0[sl].to(d0), ginv0[sl].to(d0), kp_ks)
                outs.append(_pk.ga_scan_fused(
                    acc, gens[:, sl].to(d0).contiguous(), sv32, svs32, ak32,
                    inv2n[d0], kp, kp_ks))
                continue
            acc = eval_auto(acc, 2 * kidx0[sl].to(d0) + 1, row)
            g_r = gens[:, sl].to(d0)
            for i in range(g_r.shape[0]):
                acc = eval_auto(ext_prod(acc, i, row), g_r[i], row)
            outs.append(acc)
        return _gather(outs, batch, acc0, k, N)

    return run
