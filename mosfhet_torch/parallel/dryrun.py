"""The multi-device dry run: every sharding mode of the port on one set of
devices, each decrypt-checked (the TPU package's ``dryrun_multichip``).

    python -c "import torch; from mosfhet_torch.parallel import dryrun; \\
        dryrun.dryrun_multichip([torch.device('cuda')] * 8)"

runs it on 8 virtual shards of one card; ``[torch.device('cpu')] * 8`` on
the CPU; distinct cards as distinct shards.
"""

from __future__ import annotations

import math

import torch

from .. import bootstrap, bootstrap_ga, rng, tlwe, torus, trgsw, trlwe
from ..params import TFHEParams
from . import dist_ntt, mesh as pmesh

DECRYPT_BOUND = 2.0**58


def small_params() -> TFHEParams:
    """Mid-size parameters of realistic structure (the TPU package's entry
    point's): n=32, N=256, k=1, l=3, Bg_bit=9."""
    return TFHEParams(n=32, N=256, k=1, l=3, Bg_bit=9, t=6, base_bit=4,
                      lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44,
                      name="GRAFT_ENTRY")


def dryrun_multichip(devices) -> dict:
    """Five modes over the mesh of ``devices`` (a list of `torch.device`s,
    repeats allowed), each a bootstrap of the same batch decrypted within
    2^58:

    1. data + model: `pbs_on_mesh`, the batch over ``data`` and the key's
       gadget rows over ``model`` (2 when the device count is even);
    2. kernel-TP, inside mode 1 (K8a and K8b per step on the card);
    3. N-sharded: every polynomial's coefficients over ALL the devices
       (`dist_ntt.make_dist_blind_rotate`);
    4. the unfolded (u=2) bootstrap, `unfolded_pbs_on_mesh`;
    5. the GA bootstrap, `ga_pbs_on_mesh`.

    Prints one line with each mode's error and returns the errors (log2 of
    the largest phase error).  Raises AssertionError past the bound."""
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    dev = devices[0]
    p = small_params()
    model = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    data = n_dev // model
    m = pmesh.make_mesh(devices, data=data, model=model)
    model_axis = "model" if model > 1 else None
    batch = max(8, 2 * data)
    gen = torch.Generator(device=dev).manual_seed(7)
    key_tlwe = tlwe.new_binary_key(p.n, p.lwe_sigma, gen, dev)
    key_trlwe = trlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, dev)
    key_out = trlwe.extract_tlwe_key(key_trlwe)
    gk = trgsw.new_key(key_trlwe, p.l, p.Bg_bit)
    bk = bootstrap.new_key(gk, key_tlwe, gen, dev)
    luts = rng.uniform_torus(gen, (4,), dev)
    tv = trlwe.torus_packing(luts, p.k, p.N)
    slots = torch.arange(batch, device=dev) % 4
    cs = tlwe.encrypt(torus.double2torus(slots.to(torch.float64) / 8.0),
                      key_tlwe, gen)

    def check(name, out):
        assert tuple(out.a.shape) == (batch, p.k * p.N), name
        err = (tlwe.phase(out, key_out) - luts[slots]).to(
            torch.float64).abs().max().item()
        assert err <= DECRYPT_BOUND, \
            f"{name}: sharded PBS phase error 2^{math.log2(err + 1):.1f}"
        return math.log2(err + 1)

    errs = {"data+model": check("data+model", pmesh.pbs_on_mesh(
        m, bk, 4, model_axis=model_axis)(tv, cs))}
    mn = pmesh.make_mesh(devices, data=n_dev, model=1, names=("x", "y"))
    prep_key, run = dist_ntt.make_dist_blind_rotate(mn, p.N, p.k, p.l,
                                                    p.Bg_bit, axis="x")
    errs["N-sharded"] = check("N-sharded",
                              dist_ntt.functional_bootstrap_n_sharded(
                                  mn, tv, cs, bk, prep_key(bk), run, 4))
    bk2 = bootstrap.new_key(gk, key_tlwe, gen, dev, unfolding=2)
    errs["unfolded"] = check("unfolded", pmesh.unfolded_pbs_on_mesh(
        m, bk2, 4, model_axis=model_axis)(tv, cs))
    bkg = bootstrap_ga.new_key(gk, key_tlwe, gen, dev)
    errs["ga"] = check("ga", pmesh.ga_pbs_on_mesh(
        m, bkg, 4, model_axis=model_axis)(tv, cs))
    print(f"dryrun_multichip OK: modes=[data+model (mesh={m.shape}, "
          f"batch={batch}, err 2^{errs['data+model']:.1f}), kernel-TP (in "
          f"pbs_on_mesh), N-sharded (D={n_dev}, err 2^{errs['N-sharded']:.1f}"
          f"), unfolded-BR data+2^u-TP (err 2^{errs['unfolded']:.1f}), "
          f"GA-BR data+row-TP (err 2^{errs['ga']:.1f})]", flush=True)
    return errs
