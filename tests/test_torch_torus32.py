"""The port at the 32-bit torus (TORUS32) against the TPU package, word for
word, and PyTorch's int32 arithmetic that it rests on.

The width is fixed at import (``MOSFHET_TORUS_BITS=32``, like the
reference's ``-DTORUS32``), so the cases run in one child interpreter with
that variable set, which imports both packages, runs every case on the same
numpy-seeded inputs and writes one JSON result per case; each case is then
one test here.  Sizes are the TPU package's TORUS32 suite's (`P32` of
`tests/_torus32_suite.py`: n=16, N=64, k=1, l=3, Bg_bit=7; 2 primes).  The
JAX side is jitted; its kernels run in Pallas interpret mode.  Every word
must be identical: no tolerance.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

ROOT = Path(__file__).resolve().parents[1]
CASES = ("gadget_decompose", "double2torus", "torus2int", "ntt_product",
         "keyswitch", "k1_plain_vs_interpret", "k2_plain_vs_interpret",
         "functional_bootstrap", "fdfb_this_work", "port_keygen_decrypts",
         "unported_paths_raise", "k1_step_plain_vs_interpret",
         "blind_rotate_stepwise", "trgsw_matrix_ops", "leaf_ops",
         "packing1_and_priv_ks", "full_packing", "seeded",
         "bootstrap_family", "bootstrap_family_decrypts", "clot21_raises",
         "io_container", "rotntt_entry_points", "rotntt_plain_kernels_l2_32",
         "rotntt_mesh")
M32 = 1 << 32

i32 = st.integers(-(1 << 31), (1 << 31) - 1)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(i32, i32), min_size=1, max_size=64))
def test_int32_arithmetic_wraps_mod_2_32(pairs):
    """CPU int32 ``+``, ``-``, ``*`` and negation are exact mod 2^32, and an
    int64 -> int32 conversion keeps the low 32 bits: the port's u32 words
    rest on both (`torus.wrap`)."""
    a = torch.tensor([x for x, _ in pairs], dtype=torch.int32)
    b = torch.tensor([y for _, y in pairs], dtype=torch.int32)

    def u32(t):
        return [v % M32 for v in t.tolist()]

    ua, ub = u32(a), u32(b)
    assert u32(a + b) == [(x + y) % M32 for x, y in zip(ua, ub)]
    assert u32(a - b) == [(x - y) % M32 for x, y in zip(ua, ub)]
    assert u32(a * b) == [(x * y) % M32 for x, y in zip(ua, ub)]
    assert u32(-a) == [(-x) % M32 for x in ua]
    wide = a.to(torch.int64) * b.to(torch.int64) + (1 << 40)
    assert u32(wide.to(torch.int32)) == [(x * y + (1 << 40)) % M32
                                         for x, y in zip(ua, ub)]


@pytest.fixture(scope="module")
def torus32_results(tmp_path_factory):
    """Run every case once in a child interpreter at the 32-bit torus."""
    out = tmp_path_factory.mktemp("torus32") / "results.json"
    from tests.test_torch_suite_env import CHILD_XLA_FLAGS
    env = dict(os.environ, MOSFHET_TORUS_BITS="32", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", XLA_FLAGS=CHILD_XLA_FLAGS)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "tests.test_torch_torus32", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    results = json.loads(out.read_text())
    results["_seconds"] = time.perf_counter() - t0
    return results


@pytest.mark.parametrize("case", CASES)
def test_torus32_case(torus32_results, case):
    res = torus32_results[case]
    assert res["ok"], res["detail"]


# --- the child: both packages at the 32-bit torus ---------------------------

P32 = dict(n=16, N=64, k=1, l=3, Bg_bit=7, t=5, base_bit=4,
           lwe_sigma=2.0**-20, rlwe_sigma=2.0**-25)
# the TPU suite's P32K (`tests/_torus32_suite.py:222`)
P32K = dict(n=8, N=128, k=1, l=2, Bg_bit=8, t=5, base_bit=4,
            lwe_sigma=2.0**-20, rlwe_sigma=2.0**-25)


def _child(out_path):
    assert os.environ.get("MOSFHET_TORUS_BITS") == "32"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mosfhet_tpu import (bootstrap as jbs, keyswitch as jks,
                             ntt as jntt, params, polynomial as jpoly,
                             rng as jrng, seeded as jseeded, tlwe as jtlwe,
                             torus as jtorus, trgsw as jtrgsw,
                             trlwe as jtrlwe)
    from mosfhet_tpu.ops import pbs_kernel as jpk
    from mosfhet_torch import (bootstrap as tbs, bridge, keyswitch as tks,
                               ntt as tntt, polynomial as tpoly,
                               rng as trng, seeded as tseeded,
                               tlwe as ttlwe, torus as ttorus,
                               trgsw as ttrgsw, trlwe as ttrlwe)
    from mosfhet_torch.ops import prng as tprng
    from mosfhet_torch.ops import pbs_kernel as tpk

    assert jtorus.TORUS_BITS == 32 and ttorus.TORUS_BITS == 32
    CPU = "cpu"
    p = params.TFHEParams(name="T32", **P32)
    rs = np.random.default_rng(3232)
    T = bridge.to_tensor

    def same(got, want):
        got = bridge.to_numpy(got) if isinstance(got, torch.Tensor) else got
        want = np.asarray(want)
        if got.shape != want.shape:
            return f"shape {got.shape} != {want.shape}"
        if got.dtype != want.dtype:
            return f"dtype {got.dtype} != {want.dtype}"
        bad = int((got != want).sum())
        return f"{bad} of {got.size} words differ" if bad else ""

    def words(shape):
        return rs.integers(0, M32, shape, dtype=np.uint64).astype(np.uint32)

    def case_gadget_decompose():
        x = words((3, 5, p.N))
        x[0, 0, :4] = [0, 1, M32 - 1, 1 << 31]
        msgs = []
        for rounded in (True, False):
            want = jtorus.gadget_decompose(jnp.asarray(x), p.Bg_bit, p.l,
                                           rounded)
            got = ttorus.gadget_decompose(T(x, CPU), p.Bg_bit, p.l, rounded)
            msgs.append(same(got.numpy(), want))
        assert ttorus.gadget_offset(p.Bg_bit, p.l) == jtorus.gadget_offset(
            p.Bg_bit, p.l)
        return "; ".join(m for m in msgs if m)

    def case_double2torus():
        x = rs.uniform(-3.0, 3.0, 512)
        x[:6] = [0.0, 0.5, -0.5, 0.25, 1.0 - 2.0**-40, -2.0**-40]
        return same(ttorus.double2torus(torch.from_numpy(x)),
                    jtorus.double2torus(jnp.asarray(x)))

    def case_torus2int():
        x = words(4096)
        x[:3] = [0, M32 - 1, (1 << 31) - 1]
        msgs = [same(ttorus.torus2int(T(x, CPU), s).numpy().astype(np.uint32),
                     jtorus.torus2int(jnp.asarray(x), s))
                for s in (1, 4, 7, 12, 31)]
        return "; ".join(m for m in msgs if m)

    def case_ntt_product():
        bound = jntt.conv_bound(p.N, 1 << 8, 1)
        primes = jntt.primes_for_bound(bound)
        if primes != tntt.primes_for_bound(tntt.conv_bound(p.N, 1 << 8, 1)) \
                or len(primes) != 2:
            return f"primes {primes}"
        jplan = jntt.get_plan(p.N, primes)
        tplan = tntt.get_plan(p.N, primes, CPU)
        a = words((4, p.N))
        d = rs.integers(-256, 256, (4, p.N), dtype=np.int32)
        want, naive = jax.jit(lambda d_, a_: (
            jpoly.ntt_mul_small(d_, a_, jplan),
            jpoly.naive_negacyclic_mul(
                d_.astype(jnp.int64).astype(jnp.uint32), a_)))(
            jnp.asarray(d), jnp.asarray(a))
        got = tntt.from_ntt_u64(
            tntt.pointwise_mul(tntt.to_ntt_small(torch.from_numpy(d), tplan),
                               tntt.to_ntt_u64(T(a, CPU), tplan), tplan),
            tplan)
        return same(got, want) or same(got, naive)

    def ks_case(seed, n_out, n_in, batch):
        kk = jax.random.split(jax.random.PRNGKey(seed), 4)
        out_key = jtlwe.new_binary_key(kk[0], n_out, p.lwe_sigma)
        in_key = jtlwe.new_binary_key(kk[1], n_in, p.lwe_sigma)
        ksk = jax.jit(lambda k: jtlwe.new_ks_key(k, out_key, in_key, p.t,
                                                 p.base_bit))(kk[2])
        m = jtorus.double2torus(jnp.arange(batch) / 16.0)
        c = jax.jit(jtlwe.encrypt)(m, in_key, kk[3])
        return ksk, c

    def case_keyswitch():
        ksk, c = ks_case(11, p.n, p.k * p.N, 5)
        want = jax.jit(lambda c_: jtlwe.keyswitch(c_, ksk, impl="jnp"))(c)
        tksk = bridge.tlwe_ks_key_from_numpy(
            np.asarray(ksk.a), np.asarray(ksk.b), p.t, p.base_bit, CPU)
        if tksk.ab.dtype != torch.int32:
            return f"table dtype {tksk.ab.dtype}"
        got = ttlwe.keyswitch(
            bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU),
            tksk)
        return same(got.a, want.a) or same(got.b, want.b)

    def case_k1_plain_vs_interpret():
        N, k, l, Bg_bit, n, B = p.N, p.k, p.l, p.Bg_bit, 3, 32
        C, J = k + 1, (k + 1) * l
        primes = jntt.primes_for_bound(
            jntt.external_product_bound(N, Bg_bit, l, k))
        acc0 = words((B, C, N))
        a_int = rs.integers(0, 2 * N + 1, (n, B), dtype=np.int32)
        a_int[0, 0], a_int[-1, -1], a_int[1, 1] = 0, 2 * N, N
        pr = np.array(primes, np.uint64)[:, None]
        keyv = rs.integers(0, 1 << 62, (n, J, C, len(primes), N),
                           dtype=np.uint64) % pr
        keyvs = ((keyv << np.uint64(32)) // pr).astype(np.uint32)
        keyv = keyv.astype(np.uint32)
        jkp = jpk.get_kernel_plan(N, primes, l, Bg_bit, k, bt=32, mxu=False)
        if jkp.nl != 1 or jkp.P != 2:
            return f"TPU plan nl={jkp.nl}, P={jkp.P}"
        want = jpk.blind_rotate_scan_fused(
            jnp.asarray(acc0), jnp.asarray(a_int), jnp.asarray(keyv),
            jnp.asarray(keyvs), jkp, interpret=True)
        kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, CPU, 32)
        got = tpk.blind_rotate_scan(T(acc0, CPU), torch.from_numpy(a_int),
                                    T(keyv, CPU), T(keyvs, CPU), kp)
        return same(got, want)

    def case_k2_plain_vs_interpret():
        B, n_in, t, base_m1, npad = 16, 32, 6, 15, 128
        dig = rs.integers(0, base_m1 + 1, (B, n_in, t), dtype=np.int32)
        dig[0, 0, 0], dig[-1, -1, -1] = 0, base_m1
        ab = words((n_in, t, base_m1, npad))
        want = jpk.tlwe_keyswitch_sum(jnp.asarray(dig), (jnp.asarray(ab),),
                                      bt=8, chunk_i=16, interpret=True)
        got = tpk.tlwe_keyswitch_sum(torch.from_numpy(dig), T(ab, CPU))
        return same(got, want)

    @functools.cache
    def jax_keys(seed):
        kk = jax.random.split(jax.random.PRNGKey(seed), 6)
        kt = jtlwe.new_binary_key(kk[0], p.n, p.lwe_sigma)
        kr = jtrlwe.new_binary_key(kk[1], p.N, p.k, p.rlwe_sigma)
        ko = jtrlwe.extract_tlwe_key(kr)
        gk = jtrgsw.new_key(kr, p.l, p.Bg_bit)
        bk = jax.jit(lambda rk: jbs.new_key(rk, gk, kt))(kk[2])
        bk_t = bridge.bootstrap_key_from_numpy(
            np.asarray(bk.v), np.asarray(bk.vs), bk.n, bk.k, bk.N, bk.l,
            bk.Bg_bit, bk.primes, CPU)
        return kk, kt, ko, bk, bk_t

    def case_functional_bootstrap():
        kk, kt, ko, bk, bk_t = jax_keys(21)
        if len(bk.primes) != 2:
            return f"primes {bk.primes}"
        luts = jrng.uniform_torus(kk[3], (4,))
        tv = jtrlwe.torus_packing(luts, p.k, p.N)
        B = 8
        c = jax.jit(jtlwe.encrypt)(
            jtorus.double2torus(jnp.arange(B) % 4 / 8.0), kt, kk[4])
        want = jax.jit(lambda c_: jbs.functional_bootstrap(tv, c_, bk, 4))(c)
        got = tbs.functional_bootstrap(
            ttrlwe.torus_packing(T(np.asarray(luts), CPU), p.k, p.N),
            bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU),
            bk_t, 4)
        return same(got.a, want.a) or same(got.b, want.b)

    @contextlib.contextmanager
    def rot_ntt_env():
        """The TPU package's MOSFHET_ROT_NTT=1 for the JAX calls traced
        inside (each a fresh jax.jit)."""
        os.environ["MOSFHET_ROT_NTT"] = "1"
        try:
            yield
        finally:
            os.environ.pop("MOSFHET_ROT_NTT", None)

    def case_rotntt_entry_points():
        """`blind_rotate`, `blind_rotate_stepwise` and `functional_bootstrap`
        with rot_ntt=True on the P32 key: the TPU package's jnp words under
        MOSFHET_ROT_NTT=1 (one plain K1 call, n plain K1-step calls); the
        classic words without the variable, and they differ."""
        kk, kt, ko, bk, bk_t = jax_keys(21)
        B = 4
        a, b, mask = words((B, p.k, p.N)), words((B, p.N)), words((B, p.n))
        mask[0, :3] = [0, 1 << 31, M32 - 1]
        tv_j = jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b))
        tv = bridge.trlwe_from_numpy(a, b, CPU)
        luts = jrng.uniform_torus(kk[3], (4,))
        c = jax.jit(jtlwe.encrypt)(
            jtorus.double2torus(jnp.arange(8) % 4 / 8.0), kt, kk[4])
        with rot_ntt_env():
            want = jax.jit(lambda t, m: jbs.blind_rotate(t, m, bk,
                                                         impl="jnp"))(
                tv_j, jnp.asarray(mask))
            want_pbs = jax.jit(lambda c_: jbs.functional_bootstrap(
                jtrlwe.torus_packing(luts, p.k, p.N), c_, bk, 4))(c)
        classic = jax.jit(lambda t, m: jbs.blind_rotate(t, m, bk,
                                                        impl="jnp"))(
            tv_j, jnp.asarray(mask))
        calls = (tpk.blind_rotate_scan_plain.calls, tpk.pbs_step_plain.calls)
        got = tbs.blind_rotate(tv, T(mask, CPU), bk_t, rot_ntt=True)
        steps = tbs.blind_rotate_stepwise(tv, T(mask, CPU), bk_t,
                                          rot_ntt=True)
        if (tpk.blind_rotate_scan_plain.calls - calls[0],
                tpk.pbs_step_plain.calls - calls[1]) != (1, p.n):
            return "plain call counts"
        got_pbs = tbs.functional_bootstrap(
            ttrlwe.torus_packing(T(np.asarray(luts), CPU), p.k, p.N),
            bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU),
            bk_t, 4, rot_ntt=True)
        old = tbs.blind_rotate(tv, T(mask, CPU), bk_t)
        if np.array_equal(np.asarray(want.b), np.asarray(classic.b)):
            return "rot-NTT words equal the classic ones"
        return (same(got.a, want.a) or same(got.b, want.b)
                or same(steps.a, want.a) or same(steps.b, want.b)
                or same(got_pbs.a, want_pbs.a) or same(got_pbs.b, want_pbs.b)
                or same(old.a, classic.a) or same(old.b, classic.b))

    def case_rotntt_plain_kernels_l2_32():
        """At L2_32 widths (N=2048, l=3, Bg_bit=7, 2 primes; 4 steps, random
        key residues): `blind_rotate_scan_plain`, 4 `pbs_step_plain` calls
        and per step 2 `partial_step_plain` shards finished by
        `finish_step_plain`, all with rot_ntt, give the TPU package's
        `_cmux_step_rotntt` scan; exponents 0, N and 2N present."""
        N, l, Bg, n, B = 2048, 3, 7, 4, 3
        primes = jntt.primes_for_bound(jntt.external_product_bound(
            N, Bg, l, 1), N)
        jplan = jntt.get_plan(N, primes)
        J, P = 2 * l, len(primes)
        pr = np.array(primes, np.uint64)[:, None]
        v = rs.integers(0, 1 << 62, (n, J, 2, P, N), dtype=np.uint64) % pr
        vs = (v << np.uint64(32)) // pr
        acc0 = words((B, 2, N))
        a_np = rs.integers(0, 2 * N + 1, (n, B), dtype=np.int32)
        a_np[0, 0], a_np[1, 1], a_np[2, 2] = 0, N, 2 * N

        def step(acc, xs):
            kv, kvs, ai = xs
            return jbs._cmux_step_rotntt(acc, kv, kvs, ai, jplan, l, Bg, 1,
                                         N), None
        with rot_ntt_env():
            want = jax.jit(lambda *x: jax.lax.scan(step, x[0], x[1:])[0])(
                jnp.asarray(acc0), jnp.asarray(v), jnp.asarray(vs),
                jnp.asarray(a_np))
        kp = tpk.get_kernel_plan(N, primes, l, Bg, 1, CPU, 32)
        kv, kvs = T(v.astype(np.uint32), CPU), T(vs.astype(np.uint32), CPU)
        acc, a = T(acc0, CPU), torch.from_numpy(a_np)
        got = tpk.blind_rotate_scan(acc, a, kv, kvs, kp, rot_ntt=True)
        acc_s, acc_p = acc.clone(), acc.clone()
        for i in range(n):
            tpk.pbs_step(acc_s, a[i], kv[i], kvs[i], kp, rot_ntt=True)
            parts = torch.stack([tpk.partial_step(
                acc_p, a[i], j0, kv[i, j0:j0 + l], kvs[i, j0:j0 + l], kp,
                rot_ntt=True) for j0 in (0, l)])
            tpk.finish_step(acc_p, parts, kp)
        return same(got, want) or same(acc_s, want) or same(acc_p, want)

    def case_rotntt_mesh():
        """`pbs_on_mesh` with rot_ntt on (1, 2) and (2, 1) meshes of the CPU
        named twice: the TPU package's jnp `pbs_on_mesh` under
        MOSFHET_ROT_NTT=1 on two of its CPU devices."""
        from mosfhet_tpu.parallel import mesh as jmesh
        from mosfhet_torch.parallel import mesh as tmesh
        kk, kt, ko, bk, bk_t = jax_keys(29)
        B = 4
        lut = np.repeat(words(4), p.N // 4)
        tv_a = np.zeros((B, p.k, p.N), np.uint32)
        tv_b = np.broadcast_to(lut, (B, p.N)).copy()
        c = jax.jit(jtlwe.encrypt)(
            jtorus.double2torus(jnp.arange(B) % 4 / 8.0), kt, kk[4])
        tv_j = jtrlwe.TRLWE(a=jnp.asarray(tv_a), b=jnp.asarray(tv_b))
        tv = bridge.trlwe_from_numpy(tv_a, tv_b, CPU)
        ct = bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU)
        msgs = []
        for data, model in ((1, 2), (2, 1)):
            axis = "model" if model > 1 else None
            jm = jmesh.make_mesh(jax.devices()[:2], data=data, model=model)
            with rot_ntt_env():
                want = jmesh.pbs_on_mesh(jm, bk, 4, model_axis=axis,
                                         impl="jnp")(tv_j, c)
            tm = tmesh.make_mesh([torch.device(CPU)] * 2, data=data,
                                 model=model)
            got = tmesh.pbs_on_mesh(tm, bk_t, 4, model_axis=axis,
                                    rot_ntt=True)(tv, ct)
            msgs += [m for m in (same(got.a, want.a), same(got.b, want.b))
                     if m]
        return "; ".join(msgs)

    def case_fdfb_this_work():
        kk, kt, ko, bk, bk_t = jax_keys(27)
        tksk = jax.jit(lambda rk: jtlwe.new_ks_key(
            rk, kt, ko, p.t, p.base_bit))(kk[5])
        luts = jrng.uniform_torus(kk[3], (8,))
        tv = jtrlwe.torus_packing_many_lut(luts, 4, 2, p.k, p.N)
        c = jax.jit(jtlwe.encrypt)(
            jtorus.int2torus(jnp.arange(8, dtype=jnp.uint32), 3), kt, kk[4])
        want = jax.jit(lambda c_: jbs.fdfb_this_work(tv, c_, bk, tksk, 3))(c)
        got = tbs.fdfb_this_work(
            ttrlwe.torus_packing_many_lut(T(np.asarray(luts), CPU), 4, 2,
                                          p.k, p.N),
            bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b), CPU),
            bk_t, bridge.tlwe_ks_key_from_numpy(
                np.asarray(tksk.a), np.asarray(tksk.b), p.t, p.base_bit,
                CPU), 3)
        return same(got.a, want.a) or same(got.b, want.b)

    def case_port_keygen_decrypts():
        """The port alone at 32 bits: its keygen, the PBS and the gate on
        CPU tensors, each output within 2^26 of its LUT entry
        (`benchmarks/bench_torus32.py`'s bound)."""
        gen = torch.Generator().manual_seed(32)
        kt = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
        kr = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
        ko = ttrlwe.extract_tlwe_key(kr)
        bk = tbs.new_key(ttrgsw.new_key(kr, p.l, p.Bg_bit), kt, gen, CPU)
        ksk = ttlwe.new_ks_key(kt, ko, p.t, p.base_bit, gen, CPU)
        luts = trng.uniform_torus(gen, (8,), CPU)
        if luts.dtype != torch.int32 or ksk.ab.dtype != torch.int32:
            return f"words {luts.dtype}, table {ksk.ab.dtype}"
        m = torch.arange(16) % 8
        c = ttlwe.encrypt(ttorus.int2torus(m, 3), kt, gen)
        errs = []
        tv4 = ttrlwe.torus_packing(luts[:4], p.k, p.N)
        c4 = ttlwe.encrypt(ttorus.double2torus((m % 4).double() / 8.0), kt,
                           gen)
        out = tbs.functional_bootstrap(tv4, c4, bk, 4)
        errs.append(ttlwe.phase(out, ko) - luts[m % 4])
        tv8 = ttrlwe.torus_packing_many_lut(luts, 4, 2, p.k, p.N)
        out = tbs.fdfb_this_work(tv8, c, bk, ksk, 3)
        errs.append(ttlwe.phase(out, ko) - luts[m])
        worst = max(int(e.to(torch.int64).abs().max()) for e in errs)
        return "" if worst < 1 << 26 else f"max error {worst} >= 2^26"

    def case_unported_paths_raise():
        """What has no 32-bit form raises instead of giving words: K1-delta
        (`cmux_delta`) and the per-step GA forms built on it, 64-bit only as
        the TPU kernel is.  The GA key and the TRLWE key-switch key, which
        raised here before they were ported, now give int32 words (their
        paths: `test_torch_torus32_ga.py`)."""
        from mosfhet_torch import bootstrap_ga as tbga, keyswitch as tks
        gen = torch.Generator().manual_seed(5)
        kt = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
        kr = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
        bkg = tbga.new_key(ttrgsw.new_key(kr, p.l, p.Bg_bit), kt, gen, CPU)
        ksk = tks.new_trlwe_ks_key(kr, kr, p.t, p.base_bit, gen, CPU)
        if bkg.ak.dtype != torch.int32 or ksk.v32.dtype != torch.int32:
            return f"keys {bkg.ak.dtype}, {ksk.v32.dtype}"
        tv = ttrlwe.noiseless_trivial(trng.uniform_torus(gen, (p.N,), CPU),
                                      p.k, p.N)
        mask = trng.uniform_torus(gen, (2, p.n), CPU)
        kp = bkg.kernel_plans()[0]
        calls = {
            "cmux_delta": lambda: tpk.cmux_delta(
                tv.stacked()[None].contiguous(), bkg.s_v32[0],
                bkg.s_vs32[0], kp),
            "blind_rotate_ga_stepwise": lambda: tbga.blind_rotate_ga_stepwise(
                tv, mask, bkg),
            "blind_rotate_ga_gathered": lambda: tbga.blind_rotate_ga_gathered(
                tv, mask, bkg)}
        missing = []
        for what, call in calls.items():
            try:
                call()
                missing.append(what)
            except NotImplementedError:
                pass
        return f"no NotImplementedError from {missing}" if missing else ""

    def case_k1_step_plain_vs_interpret():
        """K1-step's one-limb plain version against the TPU's one-step
        kernel `_pbs_step_tiles` (its `nl == 1` branch) in interpret mode,
        exponents 0, N and 2N present; acc updated in place."""
        N, k, l, Bg_bit, B = p.N, p.k, p.l, p.Bg_bit, 8
        C, J = k + 1, (k + 1) * l
        primes = jntt.primes_for_bound(
            jntt.external_product_bound(N, Bg_bit, l, k))
        acc0 = words((B, C, N))
        a = rs.integers(0, 2 * N + 1, B, dtype=np.int32)
        a[:3] = [0, N, 2 * N]
        pr = np.array(primes, np.uint64)[:, None]
        keyv = rs.integers(0, 1 << 62, (J, C, len(primes), N),
                           dtype=np.uint64) % pr
        keyvs = ((keyv << np.uint64(32)) // pr).astype(np.uint32)
        keyv = keyv.astype(np.uint32)
        jkp = jpk.get_kernel_plan(N, primes, l, Bg_bit, k, bt=B, mxu=False,
                                  rot_ntt=False)
        if jkp.nl != 1:
            return f"TPU plan nl={jkp.nl}"
        want = jpk.merge_limbs(jpk._pbs_step_tiles(
            jpk.split_limbs(jnp.asarray(acc0), jkp),
            jnp.asarray(a).reshape(1, B, 1), jnp.asarray(keyv),
            jnp.asarray(keyvs), jkp, interpret=True))
        kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, CPU, 32)
        acc = T(acc0, CPU)
        calls = tpk.pbs_step_plain.calls
        got = tpk.pbs_step(acc, torch.from_numpy(a), T(keyv, CPU),
                           T(keyvs, CPU), kp)
        if tpk.pbs_step_plain.calls != calls + 1 or got is not acc:
            return "K1-step did not take its plain version in place"
        return same(got, want)

    def case_blind_rotate_stepwise():
        """`blind_rotate_stepwise` on the TPU package's P32 key: n K1-step
        calls (plain here), the jnp rotation's words and `blind_rotate`'s."""
        kk, kt, ko, bk, bk_t = jax_keys(29)
        B = 4
        a, b = words((B, p.k, p.N)), words((B, p.N))
        mask = words((B, p.n))
        mask[0, :2] = [0, M32 - 1]
        want = jax.jit(lambda tv, m: jbs.blind_rotate(tv, m, bk,
                                                      impl="jnp"))(
            jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
            jnp.asarray(mask))
        tv = bridge.trlwe_from_numpy(a, b, CPU)
        calls = tpk.pbs_step_plain.calls
        got = tbs.blind_rotate_stepwise(tv, T(mask, CPU), bk_t)
        if tpk.pbs_step_plain.calls != calls + p.n:
            return f"{tpk.pbs_step_plain.calls - calls} K1-step calls"
        fused = tbs.blind_rotate(tv, T(mask, CPU), bk_t)
        if not (torch.equal(got.a, fused.a) and torch.equal(got.b, fused.b)):
            return "blind_rotate_stepwise != blind_rotate"
        return same(got.a, want.a) or same(got.b, want.b)

    def jax_trgsw_key(seed):
        kk = jax.random.split(jax.random.PRNGKey(seed), 3)
        kr = jtrlwe.new_binary_key(kk[0], p.N, p.k, p.rlwe_sigma)
        tkr = bridge.trlwe_key_from_numpy(np.asarray(kr.s), kr.sigma,
                                          kr.s_bound, CPU)
        return (kk, kr, jtrgsw.new_key(kr, p.l, p.Bg_bit),
                ttrgsw.new_key(tkr, p.l, p.Bg_bit))

    def case_trgsw_matrix_ops():
        """The matrix ops `trgsw_mul` and `trgsw_reg_sub` at P32: a batch of
        4 exponent pairs (0, N and 2N-1 among them) and 2 register pairs
        made by the TPU package; mul_trgsw_dft's and reg_sub's words and
        every exponent against JAX (pairs through jax.vmap, one jitted
        call) and the expected (e1 + e2) mod N and m1 - m2."""
        kk, kr, gk, tgk = jax_trgsw_key(33)
        plan, N, B = gk.plan(), p.N, 4
        if tgk.plan().primes != plan.primes or len(plan.primes) != 2:
            return f"primes {plan.primes}, port {tgk.plan().primes}"
        e1 = np.array([0, N, 2 * N - 1, 77], np.int32)
        e2 = np.array([0, N - 1, 2 * N - 1, 5], np.int32)
        m1, m2 = np.array([9, 3], np.int32), np.array([4, 7], np.int32)
        enc = jax.vmap(lambda e, rk: jtrgsw.monomial_encrypt(1, e, gk,
                                                             rk).rows)
        reg = jax.vmap(lambda m, rk: jtrgsw.reg_encrypt(m, gk, rk))
        keys = jax.random.split(kk[1], 2 * B + 4)

        def jax_side(e1, e2, m1, m2, keys):
            g1 = jtrgsw.TRGSW(rows=enc(e1, keys[:B]), l=p.l,
                              Bg_bit=p.Bg_bit)
            g2 = jtrgsw.TRGSW(rows=enc(e2, keys[B:2 * B]), l=p.l,
                              Bg_bit=p.Bg_bit)
            prod = jax.vmap(jtrgsw.mul_trgsw_dft)(
                g1, jtrgsw.to_dft(g2, plan))
            r1, r2 = reg(m1, keys[2 * B:2 * B + 2]), reg(m2, keys[-2:])
            rsub = jax.vmap(jtrgsw.reg_sub)(r1, r2)
            exp = jtrgsw.debug_decrypt_exp_dft
            return (g1.rows, g2.rows, prod.v, exp(jtrgsw._with_shoup(prod),
                                                  gk),
                    (r1.positive.v, r1.positive.vs, r1.negative.v,
                     r1.negative.vs),
                    (r2.positive.v, r2.positive.vs, r2.negative.v,
                     r2.negative.vs),
                    rsub.positive.v, rsub.negative.v,
                    exp(rsub.positive, gk), exp(rsub.negative, gk))

        (g1, g2, prod, exps, r1, r2, sub_p, sub_n, exp_p, exp_n) = \
            jax.tree_util.tree_map(np.asarray, jax.jit(jax_side)(
                e1, e2, m1, m2, keys))
        tg1 = bridge.trgsw_from_numpy(g1, p.l, p.Bg_bit, CPU)
        tg2 = bridge.trgsw_from_numpy(g2, p.l, p.Bg_bit, CPU)
        if tg1.rows.dtype != torch.int32:
            return f"TRGSW rows {tg1.rows.dtype}"
        tprod = ttrgsw.mul_trgsw_dft(tg1, ttrgsw.to_dft(tg2, tgk.plan()))
        texps = ttrgsw.debug_decrypt_exp_dft(tprod, tgk).numpy()
        tr1 = bridge.trgsw_reg_from_numpy(*r1, p.l, p.Bg_bit, plan.primes,
                                          CPU)
        tr2 = bridge.trgsw_reg_from_numpy(*r2, p.l, p.Bg_bit, plan.primes,
                                          CPU)
        tsub = ttrgsw.reg_sub(tr1, tr2)
        tp = ttrgsw.debug_decrypt_exp_dft(tsub.positive, tgk).numpy()
        tn = ttrgsw.debug_decrypt_exp_dft(tsub.negative, tgk).numpy()
        msgs = [same(tprod.v, prod), same(tsub.positive.v, sub_p),
                same(tsub.negative.v, sub_n)]
        for got, want, oracle in (
                (texps, exps, (e1 + e2) % N), (tp, exp_p, (m1 - m2) % N),
                (tn, exp_n, (m2 - m1) % N)):
            if not (np.array_equal(got, want) and np.array_equal(got,
                                                                 oracle)):
                msgs.append(f"exponents {got}, JAX {want}, want {oracle}")
        return "; ".join(m for m in msgs if m)

    def case_leaf_ops():
        """to_resi_u64_raw and full_mul_with_scale (shifts 0, 1, 32, 63,
        64) on u32 words, dft_phase of int32 ciphertexts and the
        coefficient-form debug_decrypt_exp, against JAX."""
        kk, kr, gk, tgk = jax_trgsw_key(34)
        x, y, m = words((3, p.N)), words((3, p.N)), words((2, p.N))
        x[0, :3] = [0, M32 - 1, 1 << 31]
        shifts = (0, 1, 32, 63, 64)
        wide = jntt.get_plan(p.N, jntt.TENSOR_PRIMES)

        def jax_side(x, y, m):
            c = jtrlwe.encrypt(m, kr, kk[1])
            jd = jtrlwe.to_dft(c, kr.plan())
            return (jntt.to_resi_u64_raw(x, wide),
                    [jpoly.full_mul_with_scale(x, y, s) for s in shifts],
                    c.a, c.b, jd.v, jtrlwe.dft_phase(jd, kr))

        resi, muls, ca, cb, dv, ph = jax.jit(jax_side)(x, y, m)
        tplan = tntt.get_plan(p.N, jntt.TENSOR_PRIMES, CPU)
        msgs = [same(tntt.to_resi_u64_raw(T(x, CPU), tplan), resi)]
        for s_, want in zip(shifts, muls):
            got = tpoly.full_mul_with_scale(T(x, CPU), T(y, CPU), s_)
            if got.dtype != torch.int32:
                return f"full_mul_with_scale gave {got.dtype}"
            msgs.append(same(got, want))
        td = ttrlwe.to_dft(bridge.trlwe_from_numpy(
            np.asarray(ca), np.asarray(cb), CPU), tgk.trlwe_key.plan())
        msgs += [same(td.v, dv),
                 same(ttrlwe.dft_phase(td, tgk.trlwe_key), ph)]
        e = jnp.array([0, 5, p.N + 2], jnp.int32)
        g = jax.jit(jax.vmap(lambda e_, rk: jtrgsw.monomial_encrypt(
            1, e_, gk, rk).rows))(e, jax.random.split(kk[2], 3))
        got = ttrgsw.debug_decrypt_exp(bridge.trgsw_from_numpy(
            np.asarray(g), p.l, p.Bg_bit, CPU), tgk).numpy()
        want = np.asarray(jax.jit(lambda r: jtrgsw.debug_decrypt_exp(
            jtrgsw.TRGSW(rows=r, l=p.l, Bg_bit=p.Bg_bit), gk))(g))
        if not (np.array_equal(got, want)
                and np.array_equal(got, np.asarray(e) % p.N)):
            msgs.append(f"debug_decrypt_exp {got}, JAX {want}")
        return "; ".join(m for m in msgs if m)

    # --- the key-switch family (`_torus32_suite.py:318-372`), t=5, bb=4 --
    KS_T, KS_BIT = 5, 4
    base_m1 = (1 << KS_BIT) - 1
    gen32 = torch.Generator().manual_seed(3218)

    def ks_residues(lead, primes):
        """The NTT form of random u32 words [*lead, N]: a key's rows."""
        plan = tntt.get_plan(p.N, primes, CPU)
        v = tntt.to_ntt_u64(T(words(tuple(lead) + (p.N,)), CPU), plan)
        return v.numpy().astype(np.uint64)

    def ks_key(v, primes):
        plan = jntt.get_plan(p.N, primes)
        return jks.TRLWEKSKey(v=v, vs=jntt.make_shoup(v, plan.p[:, None]),
                              t=KS_T, base_bit=KS_BIT, primes=primes)

    def err32(ph, want):
        d = bridge.to_numpy(ph - want).astype(np.int64)
        d = np.abs(np.where(d >= 1 << 31, d - M32, d))
        return int(d.max())

    def case_packing1_and_priv_ks():
        """packing1 and private-SK tables (dense through K2's one-plane
        plain form, seeded through the streamed gather), the private pair
        (two K6 one-limb plain calls): jnp words; the port's keygens
        decrypt, packing1 within the TPU suite's 2^16, the pair within
        2^20: its error is the 20-bit gadget's rounding (uniform within
        2^11 per coefficient) times the key products s s' (about 16 terms
        of +-1 per coefficient) over N = 64 coefficients, sigma about
        2^16.7, so the suite's 2^18 is about 3 sigma and 2^20 about 10."""
        n = p.k * p.N
        tab = words((n, KS_T, base_m1, 2, p.N))
        tab_sk = words((n + 1, KS_T, base_m1, 2, p.N))
        sd = words((n, KS_T, base_m1, 2))
        sb = words((n, KS_T, base_m1, p.N))
        primes = jks._ks_plan(p.N, KS_BIT, KS_T, KS_T).primes
        pair_v = [ks_residues((1, KS_T, 2), primes) for _ in range(2)]
        ca, cb = words((3, n)), words((3,))
        ra, rb = words((3, 1, p.N)), words((3, p.N))

        def jax_side(tab, tab_sk, sd, sb, v0, v1, ca, cb, ra, rb):
            c = jtlwe.TLWE(a=ca, b=cb)
            outs = [jks.packing1_keyswitch(c, jks.GenericKSKey(
                        table=tab, t=KS_T, base_bit=KS_BIT, include_b=False)),
                    jks.priv_keyswitch(c, jks.GenericKSKey(
                        table=tab_sk, t=KS_T, base_bit=KS_BIT,
                        include_b=True)),
                    jks.packing1_keyswitch(c, jks.SeededGenericKSKey(
                        seeds=sd, b=sb, k=1, t=KS_T, base_bit=KS_BIT,
                        include_b=False)),
                    jks.priv_keyswitch_2(jtrlwe.TRLWE(a=ra, b=rb),
                                         [ks_key(v0, primes),
                                          ks_key(v1, primes)])]
            return [(o.a, o.b) for o in outs]

        want = jax.jit(jax_side)(tab, tab_sk, sd, sb, *pair_v, ca, cb, ra, rb)
        c = bridge.tlwe_from_numpy(ca, cb, CPU)
        got = [tks.packing1_keyswitch(c, bridge.generic_ks_key_from_numpy(
                   tab, KS_T, KS_BIT, False, CPU)),
               tks.priv_keyswitch(c, bridge.generic_ks_key_from_numpy(
                   tab_sk, KS_T, KS_BIT, True, CPU)),
               tks.packing1_keyswitch(
                   c, bridge.seeded_generic_ks_key_from_numpy(
                       sd, sb, 1, KS_T, KS_BIT, False, CPU)),
               tks.priv_keyswitch_2(
                   bridge.trlwe_from_numpy(ra, rb, CPU),
                   bridge.priv_ks_key_pair_from_numpy(
                       *pair_v, KS_T, KS_BIT, primes, CPU))]
        msgs = [same(g.a, w[0]) or same(g.b, w[1])
                for g, w in zip(got, want)]
        if got[0].a.dtype != torch.int32:
            msgs.append(f"packing1 words {got[0].a.dtype}")
        kr = ttrlwe.new_binary_key(p.N, p.k, 0.0, gen32, CPU)
        kt = ttrlwe.extract_tlwe_key(kr)
        m = ttorus.double2torus(torch.tensor([3 / 16.0, 5 / 16.0]))
        ksk = tks.new_packing1_ks_key(kr, kt, KS_T, KS_BIT, gen32, CPU)
        out = tks.packing1_keyswitch(ttlwe.encrypt(m, kt, gen32), ksk)
        e = err32(ttrlwe.phase(out, kr)[:, 0], m)
        if e >= 1 << 16:
            msgs.append(f"port packing1 decrypt error {e}")
        pair = tks.new_priv_ks_key_pair(kr, kr, KS_T, KS_BIT, gen32, CPU)
        mm = trng.uniform_torus(gen32, (p.N,), CPU)
        out = tks.priv_keyswitch_2(ttrlwe.encrypt(mm, kr, gen32), pair)
        want_p = -tpoly.ntt_mul_small(kr.s[0], mm, kr.plan())
        e = err32(ttrlwe.phase(out, kr), want_p)
        if e >= 1 << 20:
            msgs.append(f"port priv pair decrypt error {e}")
        return "; ".join(m_ for m_ in msgs if m_)

    def case_full_packing():
        """Full packing (plain PyTorch on the NTT): jnp words; the port's
        keygen decrypts within 2^16."""
        n, size = p.k * p.N, 4
        primes = jks._ks_plan(p.N, KS_BIT, KS_T, n * KS_T).primes
        v = ks_residues((n, KS_T, 2), primes)
        ca, cb = words((size, n)), words((size,))
        want = jax.jit(lambda v, a, b: (lambda o: (o.a, o.b))(
            jks.full_packing_keyswitch(jtlwe.TLWE(a=a, b=b), size,
                                       jks.FullPackingKSKey(
                                           v=v, vs=ks_key(v, primes).vs,
                                           t=KS_T, base_bit=KS_BIT,
                                           primes=primes))))(v, ca, cb)
        plan = tntt.get_plan(p.N, primes, CPU)
        vs = tntt.make_shoup(torch.from_numpy(v.view(np.int64)),
                             plan.p[:, None]).numpy()
        got = tks.full_packing_keyswitch(
            bridge.tlwe_from_numpy(ca, cb, CPU), size,
            bridge.full_packing_ks_key_from_numpy(v, vs, KS_T, KS_BIT,
                                                  primes, CPU))
        msg = same(got.a, want[0]) or same(got.b, want[1])
        kr = ttrlwe.new_binary_key(p.N, p.k, 0.0, gen32, CPU)
        kt = ttrlwe.extract_tlwe_key(kr)
        ms = ttorus.double2torus(torch.arange(size) / 8.0)
        fk = tks.new_full_packing_ks_key(kr, kt, KS_T, KS_BIT, gen32, CPU)
        out = tks.full_packing_keyswitch(ttlwe.encrypt(ms, kt, gen32), size,
                                         fk)
        e = err32(ttrlwe.phase(out, kr)[:size], ms)
        return msg or (f"port full packing decrypt error {e}"
                       if e >= 1 << 16 else "")

    def case_seeded():
        """The 32-bit stream against `rng.uniform_torus`, the TPU package's
        seeded samples expanded and subtracted by the port (jnp words), and
        the port's seeded encryption decrypting within 2^10."""
        keys = jax.random.split(jax.random.PRNGKey(37), 3)
        kd = np.asarray(jax.random.key_data(keys))
        want = jax.jit(jax.vmap(lambda k_: jrng.uniform_torus(
            k_, (2, 70))))(keys)
        msgs = [same(tprng.uniform_torus_from_key_data(
            bridge.seeds_to_tensor(kd, CPU), (2, 70)), want)]
        kr = jtrlwe.new_binary_key(keys[0], p.N, p.k, 2.0**-25)
        m = words((2, p.N))
        ca, cb = words((2, 1, p.N)), words((2, p.N))

        def jax_side(m, ca, cb):
            sc = jseeded.encrypt(m, kr, keys[1])
            full = jseeded.expand(sc)
            sub = jseeded.subto(jtrlwe.TRLWE(a=ca, b=cb), sc)
            return sc.seed, sc.b, full.a, sub.a, sub.b

        seed, sb, fa, sa, sbb = jax.jit(jax_side)(m, ca, cb)
        sc = bridge.seeded_trlwe_from_numpy(np.asarray(seed), np.asarray(sb),
                                            1, CPU)
        msgs.append(same(tseeded.expand(sc).a, fa))
        sub = tseeded.subto(bridge.trlwe_from_numpy(ca, cb, CPU), sc)
        msgs.append(same(sub.a, sa) or same(sub.b, sbb))
        kp = ttrlwe.new_binary_key(p.N, p.k, 2.0**-25, gen32, CPU)
        mm = trng.uniform_torus(gen32, (p.N,), CPU)
        e = err32(ttrlwe.phase(tseeded.expand(tseeded.encrypt(
            mm, kp, gen32)), kp), mm)
        if e >= 1 << 10:
            msgs.append(f"port seeded decrypt error {e}")
        return "; ".join(m_ for m_ in msgs if m_)


    # --- the rest of bootstrap (`_torus32_suite.py:215-301`) at P32K, where
    # 2l and l torus_base / 2 divide N (CB v2/v3, fdfb_ks21's many-LUT form)
    pk32 = params.TFHEParams(name="T32K", **P32K)
    FAM_TB, KS21_TB = 4, 8

    def case_bootstrap_family():
        """Random key material in the TPU package's layouts (bootstrap key
        residues, packing1 and private-SK tables, the private pair): the
        multi-value family, blind_rotate_trgsw and the TRGSW bootstrap,
        public_mux, fdfb_ks21 in both forms and the circuit bootstrap v1-v3
        give the jnp words, int32 throughout."""
        q = pk32
        R, n_ext, base_m1 = (q.k + 1) * q.l, q.k * q.N, (1 << q.base_bit) - 1
        bpr = jntt.primes_for_bound(jntt.external_product_bound(
            q.N, q.Bg_bit, q.l, q.k))
        kpr = jks._ks_plan(q.N, q.base_bit, q.t, q.t).primes

        def res_of(lead, primes):
            v = tntt.to_ntt_u64(T(words(tuple(lead) + (q.N,)), CPU),
                                tntt.get_plan(q.N, primes, CPU))
            return v.numpy().astype(np.uint64)

        keys = {"bk": res_of((q.n, R, 2), bpr),
                "p1": words((n_ext, q.t, base_m1, 2, q.N)),
                "sk": words((n_ext + 1, q.t, base_m1, 2, q.N)),
                "pair": [res_of((1, q.t, 2), kpr) for _ in range(2)]}
        x = {"ca": words((3, q.n)), "cb": words((3,)),
             "ta": words((1, q.N)), "tb": words((q.N,)),
             "rows": words((3, R, 2, q.N)), "tvp": words((2 * q.N,)),
             "p0": words((3, q.N)), "p1": words((3, q.N)),
             "sel": res_of((3, q.l, 2), bpr)}

        def jax_side(keys, x):
            plan = jntt.get_plan(q.N, bpr)
            bk = jbs.BootstrapKey(
                v=keys["bk"], vs=jntt.make_shoup(keys["bk"], plan.p[:, None]),
                su=None, n=q.n, k=1, N=q.N, l=q.l, Bg_bit=q.Bg_bit,
                unfolding=1, primes=bpr)
            c = jtlwe.TLWE(a=x["ca"], b=x["cb"])
            tv = jtrlwe.TRLWE(a=x["ta"], b=x["tb"])
            p1 = jks.GenericKSKey(table=keys["p1"], t=q.t, base_bit=q.base_bit,
                                  include_b=False)
            sk = jks.GenericKSKey(table=keys["sk"], t=q.t, base_bit=q.base_bit,
                                  include_b=True)
            kplan = jntt.get_plan(q.N, kpr)
            pair = [jks.TRLWEKSKey(v=v, vs=jntt.make_shoup(v, kplan.p[:, None]),
                                   t=q.t, base_bit=q.base_bit, primes=kpr)
                    for v in keys["pair"]]
            out = {"vs": bk.vs}
            out["clot21"] = [(o.a, o.b) for o in
                             jbs.multivalue_bootstrap_CLOT21(tv, c, bk, FAM_TB,
                                                             2)]
            rot = jbs.multivalue_bootstrap_phase1(c, bk, FAM_TB)
            out["phase1"] = [(r.a, r.b) for r in rot]
            o = jbs.multivalue_bootstrap_phase2([1, 0, 3, 2], rot, FAM_TB, 2)
            out["phase2"] = (o.a, o.b)
            o = jbs.multivalue_bootstrap_phase2_many(
                [[3, 0, 2, 1], [0, 0, 0, 0]], rot, FAM_TB, 2)
            out["phase2_many"] = (o.a, o.b)
            out["br"] = jbs.blind_rotate_trgsw(jtrgsw.TRGSW(
                rows=x["rows"], l=q.l, Bg_bit=q.Bg_bit), x["ca"], bk,
                impl="jnp").rows
            g = jbs.functional_bootstrap_trgsw_phase1(c, bk, FAM_TB, q.l,
                                                      q.Bg_bit)
            o = jbs.functional_bootstrap_trgsw_phase2(g, tv)
            out["trgsw"] = (g.v, o.a, o.b)
            o = jbs.public_mux(x["p0"], x["p1"], x["sel"], q.l, q.Bg_bit, 1,
                               q.N, bpr)
            out["mux"] = (o.a, o.b)
            for many in (True, False):
                o = jbs.fdfb_ks21(x["tvp"], c, bk, p1, KS21_TB,
                                  use_many_lut=many)
                out[f"ks21_{many}"] = (o.a, o.b)
            out["cb1"] = jbs.circuit_bootstrap(c, bk, sk, p1, q.l,
                                               q.Bg_bit).rows
            out["cb2"] = jbs.circuit_bootstrap_2(c, bk, sk, p1, q.l,
                                                 q.Bg_bit).rows
            out["cb3"] = jbs.circuit_bootstrap_3(c, bk, pair, p1, q.l,
                                                 q.Bg_bit).rows
            return out

        want = jax.jit(jax_side)(keys, x)
        bk = bridge.bootstrap_key_from_numpy(
            keys["bk"], np.asarray(want["vs"]), q.n, 1, q.N, q.l, q.Bg_bit,
            bpr, CPU)
        c = bridge.tlwe_from_numpy(x["ca"], x["cb"], CPU)
        tv = bridge.trlwe_from_numpy(x["ta"], x["tb"], CPU)
        p1 = bridge.generic_ks_key_from_numpy(keys["p1"], q.t, q.base_bit,
                                              False, CPU)
        sk = bridge.generic_ks_key_from_numpy(keys["sk"], q.t, q.base_bit,
                                              True, CPU)
        pair = bridge.priv_ks_key_pair_from_numpy(*keys["pair"], q.t,
                                                  q.base_bit, kpr, CPU)
        msgs = []

        def pair_same(got, w):
            msgs.append(same(got.a, w[0]) or same(got.b, w[1]))

        for got, w in zip(tbs.multivalue_bootstrap_CLOT21(tv, c, bk, FAM_TB,
                                                          2), want["clot21"]):
            pair_same(got, w)
        rot = tbs.multivalue_bootstrap_phase1(c, bk, FAM_TB)
        for got, w in zip(rot, want["phase1"]):
            pair_same(got, w)
        pair_same(tbs.multivalue_bootstrap_phase2([1, 0, 3, 2], rot, FAM_TB,
                                                  2), want["phase2"])
        pair_same(tbs.multivalue_bootstrap_phase2_many(
            [[3, 0, 2, 1], [0, 0, 0, 0]], rot, FAM_TB, 2),
            want["phase2_many"])
        msgs.append(same(tbs.blind_rotate_trgsw(
            bridge.trgsw_from_numpy(x["rows"], q.l, q.Bg_bit, CPU),
            T(x["ca"], CPU), bk).rows, want["br"]))
        g = tbs.functional_bootstrap_trgsw_phase1(c, bk, FAM_TB, q.l,
                                                  q.Bg_bit)
        msgs.append(same(g.v, want["trgsw"][0]))
        pair_same(tbs.functional_bootstrap_trgsw_phase2(g, tv),
                  want["trgsw"][1:])
        pair_same(tbs.public_mux(T(x["p0"], CPU), T(x["p1"], CPU),
                                 T(x["sel"], CPU), q.l, q.Bg_bit, 1, q.N,
                                 bpr), want["mux"])
        for many in (True, False):
            out = tbs.fdfb_ks21(T(x["tvp"], CPU), c, bk, p1, KS21_TB,
                                use_many_lut=many)
            pair_same(out, want[f"ks21_{many}"])
            if out.b.dtype != torch.int32:
                msgs.append(f"fdfb_ks21 words {out.b.dtype}")
        for key, fn, kska in (("cb1", tbs.circuit_bootstrap, sk),
                              ("cb2", tbs.circuit_bootstrap_2, sk),
                              ("cb3", tbs.circuit_bootstrap_3, pair)):
            msgs.append(same(fn(c, bk, kska, p1, q.l, q.Bg_bit).rows,
                             want[key]))
        return "; ".join(m_ for m_ in msgs if m_)

    def case_bootstrap_family_decrypts():
        """The port's own keygens at 32 bits: at P32 the TRGSW bootstrap of 8
        messages within 2^30 and public_mux within 2^28 (the TPU suite's);
        at P32K multi-value CLOT21 and phases 1/2 within 2^26 (the suite's)
        and fdfb_ks21, both forms, within 2^29 on all 8 messages.

        The suite checks one message against 2^27 for the TRGSW bootstrap
        and fdfb_ks21; over 8 messages both packages' outputs go past it
        (the same words on the same inputs, `bootstrap_family`): the
        TRGSW bootstrap's phase 2 multiplies the rotated TRGSW's noise by
        the test vector's digits (rms 2^27.4-2^27.7 in both, max 2^29.1
        over 32 outputs), and the public mux carries its selector rows'
        key-switch noise times digits up to 2^7 into fdfb_ks21's last
        test vector (16 outputs reached 2^27.8 over four seeds).  A wrong
        slot is off by a random LUT difference, ~2^31.  The circuit
        bootstrap is not decrypted at 32 bits: at P32 its last gadget
        level h_2 = 2^11 lies below the private-SK switch's rounding noise
        (t=5, base_bit=4 keep 20 bits), and in both packages a share of
        the ciphertexts flip (7 of 48 with the port's keys, 4 of 16 with
        the TPU package's keys on one seed); CB v2 and v3 need 2l to
        divide N.  Their 32-bit words are held in `bootstrap_family`."""
        msgs = []

        def check(what, ph, want, bound):
            e = err32(ph, want)
            if e >= bound:
                msgs.append(f"{what}: error {e} >= 2^{bound.bit_length() - 1}")

        def port_keys(q, seed):
            gen = torch.Generator().manual_seed(seed)
            kt = ttlwe.new_binary_key(q.n, q.lwe_sigma, gen, CPU)
            kr = ttrlwe.new_binary_key(q.N, q.k, q.rlwe_sigma, gen, CPU)
            gk = ttrgsw.new_key(kr, q.l, q.Bg_bit)
            return (gen, kt, kr, ttrlwe.extract_tlwe_key(kr), gk,
                    tbs.new_key(gk, kt, gen, CPU))

        # P32: the TRGSW bootstrap, public_mux
        q = p
        gen, kt, kr, ko, gk, bk = port_keys(q, 3219)
        luts = trng.uniform_torus(gen, (8,), CPU)
        m4 = torch.arange(8) % 4
        c = ttlwe.encrypt(ttorus.double2torus(m4 / 8.0), kt, gen)
        g = tbs.functional_bootstrap_trgsw_phase1(c, bk, 4, q.l, q.Bg_bit)
        out = tbs.functional_bootstrap_trgsw_phase2(
            g, ttrlwe.torus_packing(luts[:4], q.k, q.N))
        check("trgsw bootstrap", ttlwe.phase(out, ko), luts[m4], 1 << 30)
        plan = kr.plan()
        p0 = trng.uniform_torus(gen, (q.N,), CPU)
        p1_ = trng.uniform_torus(gen, (q.N,), CPU)
        for bit in (0, 1):
            rows = []
            for i in range(q.l):
                m = torch.zeros(q.N, dtype=torch.int32)
                m[0] = ttorus.to_signed(bit << (32 - (i + 1) * q.Bg_bit))
                rows.append(ttrlwe.to_dft(ttrlwe.encrypt(m, kr, gen), plan).v)
            out = tbs.public_mux(p0, p1_, torch.stack(rows, dim=-4), q.l,
                                 q.Bg_bit, q.k, q.N, plan.primes)
            check(f"public_mux bit={bit}", ttrlwe.phase(out, kr),
                  p1_ if bit else p0, 1 << 28)
        # P32K: multi-value CLOT21 and phases, fdfb_ks21
        q = pk32
        gen, kt, kr, ko, gk, bk = port_keys(q, 3220)
        luts = trng.uniform_torus(gen, (8,), CPU)
        c = ttlwe.encrypt(ttorus.double2torus(m4 / 8.0), kt, gen)
        outs = tbs.multivalue_bootstrap_CLOT21(
            ttrlwe.torus_packing_many_lut(luts, 4, 2, q.k, q.N), c, bk, 4, 2)
        for j, o in enumerate(outs):
            check(f"CLOT21 lut {j}", ttlwe.phase(o, ko), luts[m4 + 4 * j],
                  1 << 26)
        rot = tbs.multivalue_bootstrap_phase1(c, bk, 4)
        lv = [3, 0, 2, 1]
        check("phase2", ttlwe.phase(tbs.multivalue_bootstrap_phase2(
            lv, rot, 4, 2), ko), ttorus.double2torus(
            torch.tensor(lv)[m4] / 8.0), 1 << 26)
        kskb = tks.new_packing1_ks_key(kr, ko, q.t, q.base_bit, gen, CPU)
        m8 = torch.arange(8)
        c8 = ttlwe.encrypt(ttorus.int2torus(m8, 3), kt, gen)
        tvp = torch.repeat_interleave(luts, (2 * q.N) // 8)
        for many in (True, False):
            out = tbs.fdfb_ks21(tvp, c8, bk, kskb, KS21_TB, use_many_lut=many)
            check(f"fdfb_ks21 many={many}", ttlwe.phase(out, ko), luts[m8],
                  1 << 29)
        return "; ".join(msgs)

    def case_clot21_raises():
        """fdfb_clot21 and fdfb_clot21_2 run on the TLWE product, whose
        relinearization gadget does not fit 32 bits: NotImplementedError
        before any kernel call."""
        msgs = []
        for name in ("fdfb_clot21", "fdfb_clot21_2"):
            calls = tpk.blind_rotate_scan_plain.calls
            args = ((None,) * 7 if name == "fdfb_clot21" else (None,) * 6)
            try:
                getattr(tbs, name)(*args)
                msgs.append(f"{name} returned")
            except NotImplementedError:
                pass
            if tpk.blind_rotate_scan_plain.calls != calls:
                msgs.append(f"{name} ran a rotation first")
        return "; ".join(msgs)

    def case_io_container():
        """The container both ways at 32 bits: u32 torus words, an unfolded
        key's one limb plane, u64 residues, u32 seeds."""
        import tempfile

        from mosfhet_tpu import io as jio
        from mosfhet_torch import io as tio
        primes = tntt.primes_for_bound(
            tntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))
        R, C = (p.k + 1) * p.l, p.k + 1
        a, b, su = words((3, p.n)), words((3,)), words((1, 8, 4, R, C, p.N))
        v = rs.integers(0, 1 << 62, (p.k, p.t, C, len(primes), p.N),
                        dtype=np.uint64) % np.array(primes, np.uint64)[:, None]
        seed, sb = words((2, 2)), words((2, p.N))
        shape = dict(n=p.n, k=p.k, N=p.N, l=p.l, Bg_bit=p.Bg_bit)
        J = jnp.asarray
        objs = [
            (jtlwe.TLWE(a=J(a), b=J(b)), bridge.tlwe_from_numpy(a, b, CPU)),
            (jbs.BootstrapKey(v=None, vs=None, su=J(su), unfolding=2,
                              primes=primes, **shape),
             bridge.unfolded_bootstrap_key_from_numpy(
                 su, *shape.values(), primes, 2, CPU)),
            (jks.TRLWEKSKey(v=J(v), vs=J((v << np.uint64(32)) // np.array(
                primes, np.uint64)[:, None]), t=p.t, base_bit=p.base_bit,
                primes=primes),
             bridge.trlwe_ks_key_from_numpy(v, p.t, p.base_bit, primes, CPU)),
            (jseeded.SeededTRLWE(seed=J(seed), b=J(sb), k=p.k),
             bridge.seeded_trlwe_from_numpy(seed, sb, p.k, CPU))]
        def tensors(o):
            return (dict(o.state_dict()) if isinstance(o, torch.nn.Module)
                    else {k: x for k, x in vars(o).items()
                          if isinstance(x, torch.Tensor)})

        msgs = []
        with tempfile.TemporaryDirectory() as d:
            for i, (j, t) in enumerate(objs):
                jio.save(f"{d}/j{i}", j)
                back = tensors(tio.load(f"{d}/j{i}", device=CPU))
                for name, x in tensors(t).items():
                    if x.dtype != back[name].dtype or \
                            not torch.equal(x, back[name]):
                        msgs.append(f"{type(t).__name__}.{name}")
                tio.save(f"{d}/t{i}", t)
                lj, tj = jax.tree_util.tree_flatten(jio.load(f"{d}/t{i}"))
                lw, tw = jax.tree_util.tree_flatten(j)
                msgs += [f"{type(t).__name__} treedef"] if tj != tw else []
                msgs += [m for x, y in zip(lj, lw)
                         if (m := same(np.asarray(x), np.asarray(y)))]
        return "; ".join(msgs)

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
