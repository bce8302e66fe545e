"""The port's unfolded bootstrap, UBR, external product and gadget-row
sharded step at the 32-bit torus (TORUS32) against the TPU package, word
for word.

As in `tests/test_torch_torus32.py`, the width is fixed at import
(``MOSFHET_TORUS_BITS=32``), so every case runs in one child interpreter
with that variable set (and 8 virtual CPU devices for the TPU package's
mesh), which imports both packages, runs the cases on numpy-seeded inputs
and writes one JSON result per case; each case is one test here.  Sizes
are the TPU package's TORUS32 suite's (`tests/_torus32_suite.py`): `T32K`
(n=8, N=128, k=1, l=2, Bg_bit=8) and `P32` (n=16, N=64, l=3, Bg_bit=7); 2
primes.  The TPU kernels K3, K4, K5, K8a and K8b, and the superseded
K3-step (`_apply_step_tiles`) and K5-v1 (`ubr_phase1_combine`), run in
Pallas interpret mode against the port's plain versions; the paths
against the TPU package's jnp routes.  Every word must be identical: no tolerance.  The
CUDA kernels meet the same plain versions in `test_torch_gpu.py`.
"""

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CASES = ("k3_broadcast_plain_vs_interpret", "k3_per_row_plain_vs_interpret",
         "external_product", "k4_plain_vs_interpret",
         "blind_rotate_unfolded_u2", "blind_rotate_unfolded_u4",
         "k5_plain_vs_interpret", "ubr_phase1", "ubr_phase2",
         "functional_bootstrap_unfolded_u2",
         "functional_bootstrap_unfolded_u4", "port_unfolded_keygen_decrypts",
         "bridge_one_plane_round_trip", "k8a_plain_vs_interpret_first_rows",
         "k8a_plain_vs_interpret_second_rows",
         "k8b_plain_vs_interpret_2_partials",
         "k8b_plain_vs_interpret_4_partials", "pbs_on_mesh_1x2",
         "pbs_on_mesh_1x4", "pbs_on_mesh_2x2",
         "unfolded_pbs_on_mesh_model2", "k3_step_broadcast_plain_vs_interpret",
         "k3_step_per_row_plain_vs_interpret", "k5_v1_plain_vs_interpret",
         "ubr_phase1_v1", "ubr_phase2_stepwise_broadcast",
         "ubr_phase2_stepwise_per_row")
M32 = 1 << 32


@pytest.fixture(scope="module")
def torus32_results(tmp_path_factory):
    """Run every case once in a child interpreter at the 32-bit torus."""
    out = tmp_path_factory.mktemp("torus32_unfolded") / "results.json"
    env = dict(os.environ, MOSFHET_TORUS_BITS="32", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "tests.test_torch_torus32_unfolded", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    results = json.loads(out.read_text())
    results["_seconds"] = time.perf_counter() - t0
    return results


@pytest.mark.parametrize("case", CASES)
def test_torus32_unfolded_case(torus32_results, case):
    res = torus32_results[case]
    assert res["ok"], res["detail"]


# --- the child: both packages at the 32-bit torus ---------------------------

T32K = dict(n=8, N=128, k=1, l=2, Bg_bit=8, t=5, base_bit=4,
            lwe_sigma=2.0**-20, rlwe_sigma=2.0**-25)
P32 = dict(n=16, N=64, k=1, l=3, Bg_bit=7, t=5, base_bit=4,
           lwe_sigma=2.0**-20, rlwe_sigma=2.0**-25)
BT = 8          # the TPU kernels' batch tile here: batches are multiples


def _child(out_path):
    assert os.environ.get("MOSFHET_TORUS_BITS") == "32"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from mosfhet_tpu import (bootstrap as jbs, ntt as jntt, params,
                             rng as jrng, tlwe as jtlwe, torus as jtorus,
                             trgsw as jtrgsw, trlwe as jtrlwe)
    from mosfhet_tpu.ops import pbs_kernel as jpk
    from mosfhet_tpu.parallel import mesh as jmesh
    from mosfhet_torch import (bootstrap as tbs, bridge, rng as trng,
                               tlwe as ttlwe, torus as ttorus,
                               trgsw as ttrgsw, trlwe as ttrlwe)
    from mosfhet_torch.ops import pbs_kernel as tpk
    from mosfhet_torch.parallel import mesh as tmesh

    assert jtorus.TORUS_BITS == 32 and ttorus.TORUS_BITS == 32
    CPU = "cpu"
    pk = params.TFHEParams(name="T32K", **T32K)
    p32 = params.TFHEParams(name="T32", **P32)
    rs = np.random.default_rng(3233)
    T = bridge.to_tensor

    def same(got, want):
        got, want = (bridge.to_numpy(x) if isinstance(x, torch.Tensor)
                     else np.asarray(x) for x in (got, want))
        if got.shape != want.shape:
            return f"shape {got.shape} != {want.shape}"
        if got.dtype != want.dtype:
            return f"dtype {got.dtype} != {want.dtype}"
        bad = int((got != want).sum())
        return f"{bad} of {got.size} words differ" if bad else ""

    def same_ct(got, want):
        return same(got.a, want.a) or same(got.b, want.b)

    def words(shape):
        return rs.integers(0, M32, shape, dtype=np.uint64).astype(np.uint32)

    def primes_of(p):
        return jntt.primes_for_bound(
            jntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))

    def residues(shape, primes):
        pr = np.array(primes, np.uint64)[:, None]
        return rs.integers(0, 1 << 62, shape, dtype=np.uint64) % pr

    def plans(p):
        primes = primes_of(p)
        jkp = jpk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, bt=BT,
                                  mxu=False, rot_ntt=False)
        kp = tpk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, CPU)
        assert jkp.nl == 1 and kp.torus_bits == 32 and kp.P == 2
        return primes, jkp, kp

    def exponents(B, G, M, N):
        rot = rs.integers(0, 2 * N + 1, (B, G, M), dtype=np.int32)
        rot[0, 0, 0], rot[-1, -1, -1], rot[0, -1, M // 2] = 0, 2 * N, N
        return rot

    def k3_case(per_row):
        primes, jkp, kp = plans(pk)
        B, G, C, J = BT, 2, pk.k + 1, (pk.k + 1) * pk.l
        acc0 = words((B, C, pk.N))
        rows = (G, B) if per_row else (G,)
        sa = residues(rows + (J, C, len(primes), pk.N), primes) \
            .astype(np.uint32)
        want = jpk.ext_product_apply_scan(jnp.asarray(acc0), jnp.asarray(sa),
                                          jkp, per_row, interpret=True)
        got = tpk.ext_product_apply_scan(T(acc0, CPU), T(sa, CPU), kp,
                                         per_row)
        return same(got, want)

    def case_k3_broadcast_plain_vs_interpret():
        return k3_case(False)

    def case_k3_per_row_plain_vs_interpret():
        return k3_case(True)

    def case_external_product():
        """Random TRLWEs under one TRGSW (broadcast) and one per row, the
        TPU package's jnp path (which reads the Shoup companions)."""
        primes = primes_of(pk)
        C, J = pk.k + 1, (pk.k + 1) * pk.l
        msgs = []
        for key_batch in ((), (3,)):
            a, b = words((3, pk.k, pk.N)), words((3, pk.N))
            v = residues(key_batch + (J, C, len(primes), pk.N), primes)
            vs = (v << np.uint64(32)) // np.array(primes, np.uint64)[:, None]
            jg = jtrgsw.TRGSWDFT(v=jnp.asarray(v), vs=jnp.asarray(vs),
                                 l=pk.l, Bg_bit=pk.Bg_bit, primes=primes)
            want = jax.jit(lambda c, g: jtrgsw.external_product(
                c, g, impl="jnp"))(
                jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)), jg)
            got = ttrgsw.external_product(
                bridge.trlwe_from_numpy(a, b, CPU),
                bridge.trgsw_dft_from_numpy(v, None, pk.l, pk.Bg_bit, primes,
                                            CPU))
            msgs.append(same_ct(got, want))
        return "; ".join(m for m in msgs if m)

    def case_k4_plain_vs_interpret():
        primes, jkp, kp = plans(pk)
        B, G, M, C, J = BT, 2, 4, pk.k + 1, (pk.k + 1) * pk.l
        acc0 = words((B, C, pk.N))
        su = words((G, M, J, C, pk.N))
        rot = exponents(B, G, M, pk.N)
        want = jpk.unfolded_rotate(
            jnp.asarray(acc0), jnp.asarray(rot),
            jnp.asarray(su.reshape(1, G, M, J * C, pk.N)), jkp,
            interpret=True)
        got = tpk.unfolded_rotate(T(acc0, CPU), torch.from_numpy(rot),
                                  T(su, CPU), kp)
        return same(got, want)

    def random_unfolded_keys(p, u, seed):
        """Both packages' unfolded keys holding the same random u32 key
        products (one limb plane)."""
        r = np.random.default_rng(seed)
        C, J = p.k + 1, (p.k + 1) * p.l
        planes = r.integers(0, M32, (1, p.n // u, 1 << u, J, C, p.N),
                            dtype=np.uint64).astype(np.uint32)
        primes = primes_of(p)
        bk_j = jbs.BootstrapKey(v=None, vs=None, su=jnp.asarray(planes),
                                n=p.n, k=p.k, N=p.N, l=p.l, Bg_bit=p.Bg_bit,
                                unfolding=u, primes=primes)
        bk_t = bridge.unfolded_bootstrap_key_from_numpy(
            planes, p.n, p.k, p.N, p.l, p.Bg_bit, primes, u, CPU)
        return bk_j, bk_t

    def rotate_case(u):
        bk_j, bk_t = random_unfolded_keys(pk, u, 40 + u)
        if bk_t.su.dtype != torch.int32:
            return f"su dtype {bk_t.su.dtype}"
        B = 5
        a, b = words((B, pk.k, pk.N)), words((B, pk.N))
        mask = words((B, pk.n))
        mask[0, :2] = [M32 - 1, 0]
        want = jax.jit(lambda tv, m: jbs.blind_rotate_unfolded(
            tv, m, bk_j, impl="jnp"))(
            jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
            jnp.asarray(mask))
        calls = tpk.unfolded_rotate_plain.calls
        got = tbs.blind_rotate_unfolded(bridge.trlwe_from_numpy(a, b, CPU),
                                        T(mask, CPU), bk_t)
        if tpk.unfolded_rotate_plain.calls != calls + 1:
            return "the rotation did not take the plain K4"
        rot_j = np.asarray(jbs._unfold_rotations(jnp.asarray(mask), bk_j))
        rot_t = tbs._unfold_rotations(T(mask, CPU), bk_t)
        return same_ct(got, want) or same(rot_t.numpy(), rot_j)

    def case_blind_rotate_unfolded_u2():
        return rotate_case(2)

    def case_blind_rotate_unfolded_u4():
        return rotate_case(4)

    def case_k5_plain_vs_interpret():
        primes, jkp, kp = plans(pk)
        B, G, M, C, J = 2, 2, 4, pk.k + 1, (pk.k + 1) * pk.l
        su = words((G, M, J, C, pk.N))
        rot = exponents(B, G, M, pk.N)
        want = jpk.ubr_phase1_combine_v2(
            jnp.asarray(su.reshape(1, G, M, J * C, pk.N)), jnp.asarray(rot),
            jkp, interpret=True)
        got = tpk.ubr_phase1_combine(T(su, CPU), torch.from_numpy(rot), kp)
        return same(got, want)

    jax_key_cache = {}

    def jax_keys(p, u, seed):
        """TPU-package keys (an unfolded bootstrap key when u > 1) and the
        port's copy of the bootstrap key, once per (p, u, seed)."""
        if (p.name, u, seed) not in jax_key_cache:
            kk = jax.random.split(jax.random.PRNGKey(seed), 6)
            kt = jtlwe.new_binary_key(kk[0], p.n, p.lwe_sigma)
            kr = jtrlwe.new_binary_key(kk[1], p.N, p.k, p.rlwe_sigma)
            gk = jtrgsw.new_key(kr, p.l, p.Bg_bit)
            bk = jax.jit(lambda rk: jbs.new_key(rk, gk, kt, u))(kk[2])
            if u == 1:
                bk_t = bridge.bootstrap_key_from_numpy(
                    np.asarray(bk.v), np.asarray(bk.vs), bk.n, bk.k, bk.N,
                    bk.l, bk.Bg_bit, bk.primes, CPU)
            else:
                bk_t = bridge.unfolded_bootstrap_key_from_numpy(
                    np.asarray(bk.su), bk.n, bk.k, bk.N, bk.l, bk.Bg_bit,
                    bk.primes, u, CPU)
            jax_key_cache[p.name, u, seed] = (kk, kt, kr, bk, bk_t)
        return jax_key_cache[p.name, u, seed]

    def decrypt_err(out, kr, want):
        ko = jtrlwe.extract_tlwe_key(kr)
        ph = ttlwe.phase(out, bridge.tlwe_key_from_numpy(
            np.asarray(ko.s), ko.sigma, CPU))
        d = (bridge.to_numpy(ph).astype(np.int64)
             - np.asarray(want).astype(np.int64)) % M32
        return int(np.minimum(d, M32 - d).max())

    ubr_state = {}

    def case_ubr_phase1():
        """The TPU suite's flow (`_torus32_suite.py:190-208`): one
        ciphertext of m = 2/8, its phase-1 cache."""
        kk, kt, kr, bk, bk_t = jax_keys(pk, 2, 31)
        c = jtlwe.encrypt(jtorus.double2torus(2 / 8.0), kt, kk[4])
        tc = bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)
        want = jax.jit(lambda c_: jbs.multivalue_bootstrap_UBR_phase1(
            c_, bk, impl="jnp").v)(c)
        calls = tpk.ubr_phase1_combine_plain.calls
        sa = tbs.multivalue_bootstrap_UBR_phase1(tc, bk_t)
        if tpk.ubr_phase1_combine_plain.calls != calls + 1:
            return "phase 1 did not take the plain K5"
        ubr_state.update(c=c, tc=tc, sa=sa)
        return same(sa.v.numpy().astype(np.uint64),
                    np.asarray(want, np.uint64))

    def case_ubr_phase2():
        """Two LUTs on the phase-1 cache, the TPU package's jnp phase 2;
        each LUT's slot 2 within 2^26."""
        kk, kt, kr, bk, bk_t = jax_keys(pk, 2, 31)
        if not ubr_state:
            return "phase 1 failed"
        c, tc, sa = ubr_state["c"], ubr_state["tc"], ubr_state["sa"]
        luts = jrng.uniform_torus(kk[3], (2, 4))
        tv = jtrlwe.torus_packing(luts, pk.k, pk.N)
        want = jax.jit(lambda tv_, c_, v_: jbs.multivalue_bootstrap_UBR_phase2(
            tv_, c_, jtrgsw.TRGSWDFT(v=v_, vs=None, l=bk.l, Bg_bit=bk.Bg_bit,
                                     primes=bk.primes), bk, 4, impl="jnp"))(
            tv, c, jnp.asarray(sa.v.numpy().astype(np.uint64)))
        calls = tpk.ext_product_apply_scan_plain.calls
        got = tbs.multivalue_bootstrap_UBR_phase2(
            bridge.trlwe_from_numpy(np.asarray(tv.a), np.asarray(tv.b), CPU),
            tc, sa, bk_t, 4)
        if tpk.ext_product_apply_scan_plain.calls != calls + 1:
            return "phase 2 did not take the plain K3"
        err = decrypt_err(got, kr, np.asarray(luts)[:, 2])
        return same_ct(got, want) or (
            "" if err < 1 << 26 else f"max error {err} >= 2^26")

    def bootstrap_case(u):
        kk, kt, kr, bk, bk_t = jax_keys(pk, u, 22 + u)
        luts = jrng.uniform_torus(kk[3], (4,))
        tv = jtrlwe.torus_packing(luts, pk.k, pk.N)
        B = 6
        c = jax.jit(jtlwe.encrypt)(
            jtorus.double2torus(jnp.arange(B) % 4 / 8.0), kt, kk[4])
        want = jax.jit(lambda c_: jbs.functional_bootstrap(tv, c_, bk, 4))(c)
        got = tbs.functional_bootstrap(
            ttrlwe.torus_packing(T(np.asarray(luts), CPU), pk.k, pk.N),
            bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU),
            bk_t, 4)
        err = decrypt_err(got, kr, np.asarray(luts)[np.arange(B) % 4])
        return same_ct(got, want) or (
            "" if err < 1 << 26 else f"max error {err} >= 2^26")

    def case_functional_bootstrap_unfolded_u2():
        return bootstrap_case(2)

    def case_functional_bootstrap_unfolded_u4():
        return bootstrap_case(4)

    def case_port_unfolded_keygen_decrypts():
        """The port alone at `P32`: its unfolded keygen (u=2 and 4), the
        bootstrap, UBR (phases 1 and 2) and the external product, each
        output within 2^26 of its message."""
        p = p32
        gen = torch.Generator().manual_seed(3232)
        kt = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
        kr = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
        ko = ttrlwe.extract_tlwe_key(kr)
        gk = ttrgsw.new_key(kr, p.l, p.Bg_bit)
        luts = trng.uniform_torus(gen, (4,), CPU)
        tv = ttrlwe.torus_packing(luts, p.k, p.N)
        slots = torch.arange(8) % 4
        cs = ttlwe.encrypt(ttorus.double2torus(slots.double() / 8.0), kt, gen)
        errs = []
        for u in (2, 4):
            bk = tbs.new_key(gk, kt, gen, CPU, unfolding=u)
            if bk.su.dtype != torch.int32 or tuple(bk.su.shape) != (
                    p.n // u, 1 << u, (p.k + 1) * p.l, p.k + 1, p.N):
                return f"su {bk.su.dtype} {tuple(bk.su.shape)}"
            out = tbs.functional_bootstrap(tv, cs, bk, 4)
            errs.append(ttlwe.phase(out, ko) - luts[slots])
        sa = tbs.multivalue_bootstrap_UBR_phase1(
            ttlwe.TLWE(a=cs.a[2], b=cs.b[2]), bk)
        luts2 = trng.uniform_torus(gen, (3, 4), CPU)
        out = tbs.multivalue_bootstrap_UBR_phase2(
            ttrlwe.torus_packing(luts2, p.k, p.N),
            ttlwe.TLWE(a=cs.a[2], b=cs.b[2]), sa, bk, 4)
        errs.append(ttlwe.phase(out, ko) - luts2[:, 2])
        m = trng.uniform_torus(gen, (3, p.N), CPU)
        c = ttrlwe.encrypt(m, kr, gen)
        g = ttrgsw.to_dft(ttrgsw.monomial_encrypt(1, 5, gk, gen), gk.plan(),
                          with_shoup=False)
        out = ttrgsw.external_product(c, g)
        if out.b.dtype != torch.int32:
            return f"external product words {out.b.dtype}"
        errs.append(ttrlwe.phase(out, kr) - ttrlwe.mul_by_xai(
            ttrlwe.noiseless_trivial(m, p.k, p.N), 5).b)
        worst = max(int(e.to(torch.int64).abs().max()) for e in errs)
        return "" if worst < 1 << 26 else f"max error {worst} >= 2^26"

    def case_bridge_one_plane_round_trip():
        kk, kt, kr, bk, bk_t = jax_keys(pk, 2, 31)
        su = np.asarray(bk.su)
        if su.shape[0] != 1 or bk_t.su.dtype != torch.int32:
            return f"planes {su.shape}, port su {bk_t.su.dtype}"
        back = bridge.unfolded_bootstrap_key_to_numpy(bk_t)
        return same(back, su) or same(bk_t.su_u64(), np.asarray(bk.su_u64()))

    def tiles(x):
        """[B, C, P, N] -> the TPU kernels' [nb, C, P, BT, N] (nb = 1)."""
        B, C, P, N = x.shape
        return x.reshape(1, B, C, P, N).transpose(0, 2, 3, 1, 4)

    def k8a_case(second):
        primes, jkp, kp = plans(pk)
        C, J, P, N = pk.k + 1, (pk.k + 1) * pk.l, len(primes), pk.N
        j_local = J // 2
        j0 = j_local if second else 0
        acc0 = words((BT, C, N))
        a = rs.integers(0, 2 * N + 1, BT).astype(np.int32)
        a[0], a[-1] = 0, 2 * N
        keyv = residues((j_local, C, P, N), primes)
        keyvs = (keyv << np.uint64(32)) // np.array(primes, np.uint64)[:, None]
        want = jpk.partial_step_tiles(
            jpk.split_limbs(jnp.asarray(acc0), jkp),
            jnp.asarray(a).reshape(1, BT, 1), jnp.asarray([j0], jnp.int32),
            jnp.asarray(keyv.astype(np.uint32)),
            jnp.asarray(keyvs.astype(np.uint32)), jkp, interpret=True)
        got = tpk.partial_step(T(acc0, CPU), torch.from_numpy(a), j0,
                               T(keyv.astype(np.uint32), CPU),
                               T(keyvs.astype(np.uint32), CPU), kp)
        return same(got.numpy().view(np.uint32),
                    np.asarray(want).transpose(0, 3, 1, 2, 4)
                    .reshape(BT, C, P, N))

    def case_k8a_plain_vs_interpret_first_rows():
        return k8a_case(False)

    def case_k8a_plain_vs_interpret_second_rows():
        return k8a_case(True)

    def k8b_case(m):
        """The psum of m exact partials (m p < 2^32 at 2 primes), the
        largest residues present."""
        primes, jkp, kp = plans(pk)
        C, P, N = pk.k + 1, len(primes), pk.N
        acc0 = words((BT, C, N))
        parts = residues((m, BT, C, P, N), primes)
        parts[:, 0, 0, :, 0] = np.array(primes) - 1
        want = jpk.merge_limbs(jpk.finish_step_tiles(
            jpk.split_limbs(jnp.asarray(acc0), jkp),
            jnp.asarray(tiles(parts.sum(0)).astype(np.uint32)), jkp, m,
            interpret=True))
        acc = T(acc0, CPU)
        got = tpk.finish_step(acc, T(parts.astype(np.uint32), CPU), kp)
        return ("" if got is acc else "not in place") or same(got, want)

    def case_k8b_plain_vs_interpret_2_partials():
        return k8b_case(2)

    def case_k8b_plain_vs_interpret_4_partials():
        return k8b_case(4)

    def mesh_inputs(p, B, seed):
        """Random ciphertexts and a random 4-slot LUT repeated over the
        batch (the TPU package's mesh shards the test vectors too)."""
        r = np.random.default_rng(seed)
        a = r.integers(0, M32, (B, p.n), dtype=np.uint64).astype(np.uint32)
        b = r.integers(0, M32, B, dtype=np.uint64).astype(np.uint32)
        lut = np.repeat(r.integers(0, M32, 4, dtype=np.uint64)
                        .astype(np.uint32), p.N // 4)
        tv_a = np.zeros((B, p.k, p.N), np.uint32)
        tv_b = np.broadcast_to(lut, (B, p.N)).copy()
        return ((jtrlwe.TRLWE(a=jnp.asarray(tv_a), b=jnp.asarray(tv_b)),
                 jtlwe.TLWE(a=jnp.asarray(a), b=jnp.asarray(b))),
                (bridge.trlwe_from_numpy(tv_a, tv_b, CPU),
                 bridge.tlwe_from_numpy(a, b, CPU)))

    def meshes(data, model):
        jm = jmesh.make_mesh(jax.devices()[:data * model], data=data,
                             model=model)
        tm = tmesh.make_mesh([torch.device(CPU)] * (data * model), data=data,
                             model=model)
        return jm, tm

    def mesh_case(data, model):
        """K8a and K8b per step on the port's mesh (n data model and n
        data launches of their plain versions), against the TPU package's
        CPU mesh, and against the unsharded bootstrap."""
        kk, kt, kr, bk, bk_t = jax_keys(pk, 1, 50)
        B = 8
        (tv_j, c_j), (tv_t, c_t) = mesh_inputs(pk, B, 60 + 10 * data + model)
        jm, tm = meshes(data, model)
        want = jmesh.pbs_on_mesh(jm, bk, 4, model_axis="model")(tv_j, c_j)
        calls = (tpk.partial_step_plain.calls, tpk.finish_step_plain.calls)
        got = tmesh.pbs_on_mesh(tm, bk_t, 4, model_axis="model")(tv_t, c_t)
        n = pk.n
        if (tpk.partial_step_plain.calls - calls[0],
                tpk.finish_step_plain.calls - calls[1]) != (
                n * data * model, n * data):
            return "wrong K8a / K8b counts"
        single = tbs.functional_bootstrap(tv_t, c_t, bk_t, 4)
        return same_ct(got, want) or same_ct(got, single)

    def case_pbs_on_mesh_1x2():
        return mesh_case(1, 2)

    def case_pbs_on_mesh_1x4():
        return mesh_case(1, 4)

    def case_pbs_on_mesh_2x2():
        return mesh_case(2, 2)

    def case_unfolded_pbs_on_mesh_model2():
        kk, kt, kr, bk, bk_t = jax_keys(pk, 2, 31)
        (tv_j, c_j), (tv_t, c_t) = mesh_inputs(pk, 4, 70)
        jm, tm = meshes(2, 2)
        want = jmesh.unfolded_pbs_on_mesh(jm, bk, 4, model_axis="model")(
            tv_j, c_j)
        got = tmesh.unfolded_pbs_on_mesh(tm, bk_t, 4, model_axis="model")(
            tv_t, c_t)
        single = tbs.functional_bootstrap(tv_t, c_t, bk_t, 4)
        return same_ct(got, want) or same_ct(got, single)

    def k3_step_case(per_row):
        """K3-step's one-limb plain version against the TPU's one-product
        kernel `_apply_step_tiles` in interpret mode, two batch tiles."""
        primes, jkp, kp = plans(pk)
        B, C, J, P = 2 * BT, pk.k + 1, (pk.k + 1) * pk.l, len(primes)
        acc0 = words((B, C, pk.N))
        key = residues(((B,) if per_row else ()) + (J, C, P, pk.N),
                       primes).astype(np.uint32)
        key_j = (key.reshape(2, BT, J, C, P, pk.N)
                 .transpose(0, 2, 3, 4, 1, 5) if per_row else key)
        want = jpk.merge_limbs(jpk._apply_step_tiles(
            jpk.split_limbs(jnp.asarray(acc0), jkp), jnp.asarray(key_j), jkp,
            per_row, interpret=True))
        acc = T(acc0, CPU)
        calls = tpk.ext_product_apply_step_plain.calls
        got = tpk.ext_product_apply_step(acc, T(key, CPU), kp, per_row)
        if tpk.ext_product_apply_step_plain.calls != calls + 1 \
                or got is not acc:
            return "K3-step did not take its plain version in place"
        return same(got, want)

    def case_k3_step_broadcast_plain_vs_interpret():
        return k3_step_case(False)

    def case_k3_step_per_row_plain_vs_interpret():
        return k3_step_case(True)

    def case_k5_v1_plain_vs_interpret():
        """K5-v1's one-limb plain version against the TPU's v1 phase-1
        kernel `ubr_phase1_combine` on one limb plane, G = 3 groups padded
        to its tile of 8 and cut back by `merge_phase1_out`."""
        primes, jkp, kp = plans(pk)
        B, G, M, C, J = 2, 3, 4, pk.k + 1, (pk.k + 1) * pk.l
        su = words((G, M, J, C, pk.N))
        rot = exponents(B, G, M, pk.N)
        want = jpk.merge_phase1_out(jpk.ubr_phase1_combine(
            jpk.tile_su_planes(jnp.asarray(su.reshape(1, G, M, J * C, pk.N)),
                               jkp),
            jpk.tile_rot(jnp.asarray(rot), jkp, G), jkp, interpret=True), G)
        got = tpk.ubr_phase1_combine_v1(T(su, CPU), torch.from_numpy(rot),
                                        kp)
        return same(got.numpy().view(np.uint32), want)

    def case_ubr_phase1_v1():
        """`multivalue_bootstrap_UBR_phase1_v1` on `case_ubr_phase1`'s
        ciphertext: one K5-v1 call (plain here), its cache."""
        kk, kt, kr, bk, bk_t = jax_keys(pk, 2, 31)
        if not ubr_state:
            return "phase 1 failed"
        calls = tpk.ubr_phase1_combine_v1_plain.calls
        sa = tbs.multivalue_bootstrap_UBR_phase1_v1(ubr_state["tc"], bk_t)
        if tpk.ubr_phase1_combine_v1_plain.calls != calls + 1:
            return "phase 1 v1 did not take the plain K5-v1"
        return same(sa.v, ubr_state["sa"].v)

    def phase2_stepwise_case(per_row):
        """`multivalue_bootstrap_UBR_phase2_stepwise` with one
        ciphertext's cache over two LUTs, or one cache per ciphertext for
        two: n/u K3-step calls (plain here), the words of the port's
        phase 2 and the TPU package's jnp phase 2."""
        kk, kt, kr, bk, bk_t = jax_keys(pk, 2, 31)
        B = 2
        ca, cb = words((B, pk.n)), words((B,))
        if not per_row:
            ca, cb = ca[0], cb[0]
        tc = bridge.tlwe_from_numpy(ca, cb, CPU)
        a, b = words((B, pk.k, pk.N)), words((B, pk.N))
        ttv = bridge.trlwe_from_numpy(a, b, CPU)
        sa = tbs.multivalue_bootstrap_UBR_phase1(tc, bk_t)
        calls = tpk.ext_product_apply_step_plain.calls
        got = tbs.multivalue_bootstrap_UBR_phase2_stepwise(ttv, tc, sa,
                                                           bk_t, 4)
        if tpk.ext_product_apply_step_plain.calls != \
                calls + bk_t.su.shape[0]:
            return "phase 2 step form did not take n/u plain K3-steps"
        fused = tbs.multivalue_bootstrap_UBR_phase2(ttv, tc, sa, bk_t, 4)
        want = jax.jit(lambda tv_, c_, v_: jbs.multivalue_bootstrap_UBR_phase2(
            tv_, c_, jtrgsw.TRGSWDFT(v=v_, vs=None, l=bk.l, Bg_bit=bk.Bg_bit,
                                     primes=bk.primes), bk, 4, impl="jnp"))(
            jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
            jtlwe.TLWE(a=jnp.asarray(ca), b=jnp.asarray(cb)),
            jnp.asarray(sa.v.numpy().astype(np.uint64)))
        return same_ct(got, fused) or same_ct(got, want)

    def case_ubr_phase2_stepwise_broadcast():
        return phase2_stepwise_case(False)

    def case_ubr_phase2_stepwise_per_row():
        return phase2_stepwise_case(True)

    results = {}
    for name in CASES:
        t0 = time.perf_counter()
        try:
            detail = locals()[f"case_{name}"]()
        except Exception:  # a case that raises fails alone, with its trace
            detail = traceback.format_exc()
        results[name] = {"ok": not detail, "detail": detail,
                         "seconds": time.perf_counter() - t0}
    Path(out_path).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    _child(sys.argv[1])
