"""The port's GA bootstrap, TRLWE key switch and Galois automorphisms at the
32-bit torus (TORUS32) against the TPU package, word for word.

As in `tests/test_torch_torus32_unfolded.py`, the width is fixed at import
(``MOSFHET_TORUS_BITS=32``), so every case runs in one child interpreter
with that variable set (and 8 virtual CPU devices for the TPU package's
mesh), which imports both packages, runs the cases on numpy-seeded inputs
and writes one JSON result per case; each case is one test here.  Sizes are
the TPU package's TORUS32 suite's `P32` (n=16, N=64, l=3, Bg_bit=7; its GA
test, `tests/_torus32_suite.py:397-409`) and, for the kernels, N=128 with
L2_32's digits (l=3, Bg_bit=7); 2 primes.  The automorphism key switch's
one-limb TPU kernels (`auto_keyswitch_stream` with and without its
in-kernel permutation, `auto_keyswitch` on gathered keys) run in Pallas
interpret mode against the port's plain versions; the GA rotation, which
the TPU package runs as a jnp scan at this width (its kernel asserts two
limbs), against that scan.  Every word must be identical: no tolerance.
The CUDA kernels meet the same plain versions in `test_torch_gpu.py`.
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
CASES = ("k6_plain_vs_interpret_ginv_1", "k6_plain_vs_interpret_random_ginv",
         "k6_old_plain_vs_interpret", "trlwe_keyswitch",
         "eval_automorphism", "trlwe_ks_key_bridge_round_trip",
         "k7_plain_vs_jnp_scan", "functional_bootstrap_ga",
         "port_ga_keygen_decrypts", "ga_key_bridge_round_trip",
         "ga_pbs_on_mesh_1x2", "ga_pbs_on_mesh_2x1",
         "guards_gone_and_64_bit_forms_refuse")
M32 = 1 << 32


@pytest.fixture(scope="module")
def torus32_ga_results(tmp_path_factory):
    """Run every case once in a child interpreter at the 32-bit torus."""
    out = tmp_path_factory.mktemp("torus32_ga") / "results.json"
    env = dict(os.environ, MOSFHET_TORUS_BITS="32", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", "tests.test_torch_torus32_ga", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", CASES)
def test_torus32_ga_case(torus32_ga_results, case):
    res = torus32_ga_results[case]
    assert res["ok"], res["detail"]


# --- the child: both packages at the 32-bit torus ---------------------------

P32 = dict(n=16, N=64, k=1, l=3, Bg_bit=7, t=5, base_bit=4,
           lwe_sigma=2.0**-20, rlwe_sigma=2.0**-25)
KN, KL, KBG = 128, 3, 7   # the kernel cases' N and key-switch digits
BT = 8                    # the TPU kernels' batch tile here
# The TPU suite's TORUS32 GA bound (`tests/_torus32_suite.py:408`).
GA_BOUND = 1 << 27
# A TRLWE key switch at P32 with t=3 digits of 7 bits adds sigma ~2^16 in
# u32 words (k t N = 192 digit x key-noise products, |digit| <= 64, key
# noise 2^7); 2^22 is ~2^6 sigma.
KS_BOUND = 1 << 22


def _child(out_path):
    assert os.environ.get("MOSFHET_TORUS_BITS") == "32"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from mosfhet_tpu import (bootstrap_ga as jga, keyswitch as jks, ntt as
                             jntt, params, rng as jrng, tlwe as jtlwe,
                             torus as jtorus, trgsw as jtrgsw,
                             trlwe as jtrlwe)
    from mosfhet_tpu.ops import pbs_kernel as jpk
    from mosfhet_tpu.parallel import mesh as jmesh
    from mosfhet_torch import (bootstrap_ga as tga, bridge,
                               keyswitch as tks, polynomial as tpoly,
                               rng as trng, tlwe as ttlwe, torus as ttorus,
                               trgsw as ttrgsw, trlwe as ttrlwe)
    from mosfhet_torch.ops import pbs_kernel as tpk
    from mosfhet_torch.parallel import mesh as tmesh

    assert jtorus.TORUS_BITS == 32 and ttorus.TORUS_BITS == 32
    CPU = "cpu"
    p32 = params.TFHEParams(name="T32", **P32)
    rs = np.random.default_rng(3234)
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
        """Random u32 words with 0x80000000 (negated to itself) and 0
        present."""
        w = rs.integers(0, M32, shape, dtype=np.uint64).astype(np.uint32)
        w.reshape(-1)[:3] = [1 << 31, 0, M32 - 1]
        return w

    def residues(shape, primes):
        pr = np.array(primes, np.uint64)[:, None]
        return rs.integers(0, 1 << 62, shape, dtype=np.uint64) % pr

    def ks_primes(N, t, base_bit, k=1):
        """`keyswitch._ks_plan`'s primes (k t^2 terms, kept for keys)."""
        return jntt.primes_for_bound(
            jntt.conv_bound(N, 1 << (base_bit - 1), k * t * t))

    def ks_plans(N, t, base_bit, k=1):
        primes = ks_primes(N, t, base_bit, k)
        jkp = jpk.get_kernel_plan(N, primes, t, base_bit, k, bt=BT,
                                  mxu=False, rot_ntt=False)
        kp = tpk.get_kernel_plan(N, primes, t, base_bit, k, CPU)
        assert jkp.nl == 1 and kp.torus_bits == 32 and kp.P == 2
        return primes, jkp, kp

    def k6_case(random_ginv):
        """BT rows, a keyset of 16 entries (kidx 0 and 15 present); ginv
        1 for every row (the TPU kernel without its permutation) or
        random (1 and 2N-1 present, the in-kernel permutation)."""
        primes, jkp, kp = ks_plans(KN, KL, KBG)
        G, C = 16, 2
        ak = residues((G, KL, C, 2, KN), primes).astype(np.uint32)
        x = words((BT, C, KN))
        kidx = rs.integers(0, G, BT).astype(np.int32)
        kidx[0], kidx[-1] = 0, G - 1
        ginv = np.ones(BT, np.int32)
        if random_ginv:
            ginv = (rs.integers(0, KN, BT) * 2 + 1).astype(np.int32)
            ginv[0], ginv[1] = 1, 2 * KN - 1
        want = jpk.auto_keyswitch_stream(
            jnp.asarray(x), jnp.asarray(ak), jnp.asarray(kidx), jkp,
            interpret=True,
            ginv=jnp.asarray(ginv) if random_ginv else None)
        calls = tpk.auto_keyswitch_stream_plain.calls
        got = tpk.auto_keyswitch_stream(T(x, CPU), T(ak, CPU),
                                        torch.from_numpy(kidx),
                                        torch.from_numpy(ginv), kp)
        if tpk.auto_keyswitch_stream_plain.calls != calls + 1:
            return "K6 did not take its plain version"
        return same(got, want)

    def case_k6_plain_vs_interpret_ginv_1():
        return k6_case(False)

    def case_k6_plain_vs_interpret_random_ginv():
        return k6_case(True)

    def case_k6_old_plain_vs_interpret():
        """Already-permuted rows, one random keyset entry per row."""
        primes, jkp, kp = ks_plans(KN, KL, KBG)
        C = 2
        perm = words((BT, C, KN))
        rows = residues((BT, KL, C, 2, KN), primes).astype(np.uint32)
        want = jpk.auto_keyswitch(jnp.asarray(perm), jnp.asarray(rows), jkp,
                                  interpret=True)
        calls = tpk.auto_keyswitch_plain.calls
        got = tpk.auto_keyswitch(T(perm, CPU), T(rows, CPU), kp)
        if tpk.auto_keyswitch_plain.calls != calls + 1:
            return "K6-old did not take its plain version"
        return same(got, want)

    ks_cache = {}

    def jax_ks_keys():
        """Two ring keys at P32, the KS key from the second to the first and
        the first key's automorphism keyset for generators 3 and 2N-1."""
        if not ks_cache:
            k0, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3240), 4)
            key = jtrlwe.new_binary_key(k0, p32.N, p32.k, p32.rlwe_sigma)
            key2 = jtrlwe.new_binary_key(k1, p32.N, p32.k, p32.rlwe_sigma)
            ksk = jax.jit(lambda rk: jks.new_trlwe_ks_key(
                rk, key, key2, p32.l, p32.Bg_bit))(k2)
            keyset = jax.jit(lambda rk: jks.new_automorphism_ks_keyset(
                rk, key, (3, 2 * p32.N - 1), p32.l, p32.Bg_bit))(k3)
            ks_cache.update(key=key, key2=key2, ksk=ksk, keyset=keyset)
        return ks_cache

    def port_ksk(ksk):
        return bridge.trlwe_ks_key_from_numpy(np.asarray(ksk.v), ksk.t,
                                              ksk.base_bit, ksk.primes, CPU)

    def random_trlwe(batch):
        a, b = words(batch + (p32.k, p32.N)), words(batch + (p32.N,))
        return (jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
                bridge.trlwe_from_numpy(a, b, CPU))

    def case_trlwe_keyswitch():
        """A [2, 3] batch of random TRLWEs: one plain K6 call, the jnp
        words, int32 words out."""
        ksk = jax_ks_keys()["ksk"]
        c_j, c_t = random_trlwe((2, 3))
        calls = tpk.auto_keyswitch_stream_plain.calls
        got = tks.trlwe_keyswitch(c_t, port_ksk(ksk))
        if tpk.auto_keyswitch_stream_plain.calls != calls + 1:
            return "not one plain K6 call"
        if got.b.dtype != torch.int32:
            return f"words {got.b.dtype}"
        return same_ct(got, jax.jit(jks.trlwe_keyswitch)(c_j, ksk))

    def case_eval_automorphism():
        """Generators 3 and 2N-1, each its keyset entry."""
        keyset = jax_ks_keys()["keyset"]
        msgs = []
        for gen, ksk in keyset.items():
            c_j, c_t = random_trlwe((5,))
            got = tks.eval_automorphism(c_t, gen, port_ksk(ksk))
            want = jax.jit(lambda c, k, g=gen: jks.eval_automorphism(
                c, g, k))(c_j, ksk)
            msgs.append(same_ct(got, want))
        return "; ".join(m for m in msgs if m)

    def case_trlwe_ks_key_bridge_round_trip():
        ksk = jax_ks_keys()["ksk"]
        ksk_t = port_ksk(ksk)
        if ksk_t.v32.dtype != torch.int32 or ksk_t.primes != tuple(
                ksk.primes) or len(ksk.primes) != 2:
            return f"v32 {ksk_t.v32.dtype}, primes {ksk_t.primes}"
        return same(bridge.trlwe_ks_key_to_numpy(ksk_t).astype(np.uint64),
                    np.asarray(ksk.v).astype(np.uint64))

    def random_ga_key(n, N, l, Bg_bit):
        """Both packages' GA keys holding the same random residues."""
        k = 1
        C, J = k + 1, (k + 1) * l
        primes = jntt.primes_for_bound(
            jntt.external_product_bound(N, Bg_bit, l, k))
        kprimes = ks_primes(N, l, Bg_bit)
        pp = np.array(primes, np.uint64)[:, None]
        pk = np.array(kprimes, np.uint64)[:, None]
        s_v = residues((n, J, C, len(primes), N), primes)
        ak_v = residues((N, k * l, C, len(kprimes), N), kprimes)
        inv2n = tga.inverse_mod_2n_table(N)
        bk_j = jga.GABootstrapKey(
            s_v=jnp.asarray(s_v),
            s_vs=jnp.asarray((s_v << np.uint64(32)) // pp),
            ak_v=jnp.asarray(ak_v),
            ak_vs=jnp.asarray((ak_v << np.uint64(32)) // pk),
            inv2n=jnp.asarray(inv2n), n=n, k=k, N=N, l=l, Bg_bit=Bg_bit,
            ks_t=l, ks_base_bit=Bg_bit, primes=tuple(primes),
            ks_primes=tuple(kprimes))
        return bk_j, port_bk(bk_j)

    def port_bk(bk):
        return bridge.ga_bootstrap_key_from_numpy(
            np.asarray(bk.s_v), np.asarray(bk.s_vs), np.asarray(bk.ak_v),
            np.asarray(bk.inv2n), bk.n, bk.k, bk.N, bk.l, bk.Bg_bit, bk.ks_t,
            bk.ks_base_bit, bk.primes, bk.ks_primes, CPU)

    def case_k7_plain_vs_jnp_scan():
        """`blind_rotate_ga` at N=128 with 4 steps on a random key: one plain
        K6 and one plain K7 (`ga_scan_fused_plain` on int32 words), the
        words of the TPU package's jnp scan; the mask holds 0, 2^31 and
        2^32-1."""
        bk_j, bk_t = random_ga_key(4, KN, KL, KBG)
        a, b = words((1, KN)), words((KN,))
        mask = words((3, 4))
        want = jax.jit(lambda tv, m: jga.blind_rotate_ga(
            tv, m, bk_j, impl="jnp"))(
            jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
            jnp.asarray(mask))
        calls = (tpk.auto_keyswitch_stream_plain.calls,
                 tpk.ga_scan_fused_plain.calls)
        got = tga.blind_rotate_ga(bridge.trlwe_from_numpy(a, b, CPU),
                                  T(mask, CPU), bk_t)
        if (tpk.auto_keyswitch_stream_plain.calls,
                tpk.ga_scan_fused_plain.calls) != (calls[0] + 1,
                                                   calls[1] + 1):
            return "not one plain K6 and one plain K7 call"
        return same_ct(got, want)

    ga_cache = {}

    def jax_ga_keys():
        """The TPU suite's GA flow at P32 (`_torus32_suite.py:397-409`):
        keys, the GA key as one compiled program, and its port copy."""
        if not ga_cache:
            kk = jax.random.split(jax.random.PRNGKey(39), 5)
            kt = jtlwe.new_binary_key(kk[0], p32.n, p32.lwe_sigma)
            kr = jtrlwe.new_binary_key(kk[1], p32.N, p32.k, p32.rlwe_sigma)
            gk = jtrgsw.new_key(kr, p32.l, p32.Bg_bit)
            bkg = jax.jit(lambda rk, s: jga.new_key(
                rk, gk, jtlwe.TLWEKey(s=s, sigma=kt.sigma)))(kk[2], kt.s)
            ga_cache.update(kk=kk, kt=kt, kr=kr, bkg=bkg, bkg_t=port_bk(bkg))
        return ga_cache

    def decrypt_err(out, kr, want):
        ko = jtrlwe.extract_tlwe_key(kr)
        ph = ttlwe.phase(out, bridge.tlwe_key_from_numpy(
            np.asarray(ko.s), ko.sigma, CPU))
        d = (bridge.to_numpy(ph).astype(np.int64)
             - np.asarray(want).astype(np.int64)) % M32
        return int(np.minimum(d, M32 - d).max())

    def case_functional_bootstrap_ga():
        """6 ciphertexts of the 4 slots and a random 4-slot LUT: the TPU
        package's words (its jnp route at this width), one plain K6 and one
        plain K7 call.  Then the TPU suite's own check
        (`_torus32_suite.py:397-409`): one ciphertext of 1/8 within 2^27 of
        the LUT's slot 1.  Only that one: at P32 (n=16 against the
        forced-all-odd envelope's 2N / torus_base = 32) the TPU package's
        own outputs miss their slot for about 1 ciphertext in 16 (4 of 64
        with this key), so a decrypt check of a batch tests the envelope,
        not the words."""
        g = jax_ga_keys()
        luts = jrng.uniform_torus(g["kk"][3], (4,))
        tv = jtrlwe.torus_packing(luts, p32.k, p32.N)
        tv_t = ttrlwe.torus_packing(T(np.asarray(luts), CPU), p32.k, p32.N)
        B = 6
        c = jax.jit(jtlwe.encrypt)(
            jtorus.double2torus(jnp.arange(B) % 4 / 8.0), g["kt"], g["kk"][4])
        boot = jax.jit(lambda c_: jga.functional_bootstrap_ga(
            tv, c_, g["bkg"], 4))
        want = boot(c)
        calls = (tpk.auto_keyswitch_stream_plain.calls,
                 tpk.ga_scan_fused_plain.calls)
        got = tga.functional_bootstrap_ga(
            tv_t, bridge.tlwe_from_numpy(np.asarray(c.a), np.asarray(c.b),
                                         CPU), g["bkg_t"], 4)
        if (tpk.auto_keyswitch_stream_plain.calls,
                tpk.ga_scan_fused_plain.calls) != (calls[0] + 1,
                                                   calls[1] + 1):
            return "not one plain K6 and one plain K7 call"
        c1 = jtlwe.encrypt(jtorus.double2torus(1 / 8.0), g["kt"], g["kk"][4])
        got1 = tga.functional_bootstrap_ga(
            tv_t, bridge.tlwe_from_numpy(np.asarray(c1.a), np.asarray(c1.b),
                                         CPU), g["bkg_t"], 4)
        err = decrypt_err(got1, g["kr"], np.asarray(luts)[1])
        return same_ct(got, want) or same_ct(got1, boot(c1)) or (
            "" if err < GA_BOUND else f"max error {err} >= 2^27")

    def case_port_ga_keygen_decrypts():
        """The port alone at P32: its GA keygen (int32 keyset of N entries
        under 2 key-switch primes), `functional_bootstrap_ga` of 8
        ciphertexts within 2^27; its TRLWE KS key and automorphism keyset,
        each switch within 2^22 of its message."""
        p = p32
        gen = torch.Generator().manual_seed(3241)
        kt = ttlwe.new_binary_key(p.n, p.lwe_sigma, gen, CPU)
        kr = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
        ko = ttrlwe.extract_tlwe_key(kr)
        bkg = tga.new_key(ttrgsw.new_key(kr, p.l, p.Bg_bit), kt, gen, CPU)
        if bkg.ak.shape != (p.N, p.k * p.l, p.k + 1, 2, p.N) or \
                len(bkg.primes) != 2:
            return f"keyset {tuple(bkg.ak.shape)}, primes {bkg.primes}"
        luts = trng.uniform_torus(gen, (4,), CPU)
        slots = torch.arange(8) % 4
        cs = ttlwe.encrypt(ttorus.double2torus(slots.double() / 8.0), kt, gen)
        out = tga.functional_bootstrap_ga(
            ttrlwe.torus_packing(luts, p.k, p.N), cs, bkg, 4)
        if out.b.dtype != torch.int32:
            return f"GA words {out.b.dtype}"
        err = int((ttlwe.phase(out, ko) - luts[slots]).to(torch.int64)
                  .abs().max())
        if err >= GA_BOUND:
            return f"GA max error {err} >= 2^27"
        kr2 = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
        ksk = tks.new_trlwe_ks_key(kr, kr2, p.l, p.Bg_bit, gen, CPU)
        keyset = tks.new_automorphism_ks_keyset(kr, [3, 2 * p.N - 1], p.l,
                                                p.Bg_bit, gen, CPU)
        m = trng.uniform_torus(gen, (4, p.N), CPU)
        errs = [ttrlwe.phase(tks.trlwe_keyswitch(
            ttrlwe.encrypt(m, kr2, gen), ksk), kr) - m]
        for g, key in keyset.items():
            out_g = tks.eval_automorphism(ttrlwe.encrypt(m, kr, gen), g, key)
            errs.append(ttrlwe.phase(out_g, kr) - tpoly.permute(m, g))
        worst = max(int(e.to(torch.int64).abs().max()) for e in errs)
        return "" if worst < KS_BOUND else f"KS max error {worst} >= 2^22"

    def case_ga_key_bridge_round_trip():
        g = jax_ga_keys()
        bkg, bkg_t = g["bkg"], g["bkg_t"]
        if bkg_t.ak.dtype != torch.int32 or bkg_t.ks_primes != tuple(
                bkg.ks_primes) or len(bkg.ks_primes) != 2:
            return f"ak {bkg_t.ak.dtype}, KS primes {bkg_t.ks_primes}"
        back = bridge.ga_bootstrap_key_to_numpy(bkg_t)
        return "; ".join(m for m in (
            same(back[0], np.asarray(bkg.s_v).astype(np.uint64)),
            same(back[1], np.asarray(bkg.s_vs).astype(np.uint64)),
            same(back[2], np.asarray(bkg.ak_v).astype(np.uint64)),
            same(back[3], np.asarray(bkg.inv2n))) if m)

    def mesh_case(data, model):
        """8 random ciphertexts with a repeated random LUT: model 1 is one
        plain K6 and one plain K7 per data shard, model 2 the plain route;
        the TPU package's CPU mesh's words, and the unsharded bootstrap's."""
        g = jax_ga_keys()
        p, B = p32, 8
        r = np.random.default_rng(70 + 10 * data + model)
        a = r.integers(0, M32, (B, p.n), dtype=np.uint64).astype(np.uint32)
        b = r.integers(0, M32, B, dtype=np.uint64).astype(np.uint32)
        lut = np.repeat(r.integers(0, M32, 4, dtype=np.uint64)
                        .astype(np.uint32), p.N // 4)
        tv_a = np.zeros((B, p.k, p.N), np.uint32)
        tv_b = np.broadcast_to(lut, (B, p.N)).copy()
        jm = jmesh.make_mesh(jax.devices()[:data * model], data=data,
                             model=model)
        tm = tmesh.make_mesh([torch.device(CPU)] * (data * model), data=data,
                             model=model)
        axis = "model" if model > 1 else None
        want = jmesh.ga_pbs_on_mesh(jm, g["bkg"], 4, model_axis=axis)(
            jtrlwe.TRLWE(a=jnp.asarray(tv_a), b=jnp.asarray(tv_b)),
            jtlwe.TLWE(a=jnp.asarray(a), b=jnp.asarray(b)))
        tv_t = bridge.trlwe_from_numpy(tv_a, tv_b, CPU)
        c_t = bridge.tlwe_from_numpy(a, b, CPU)
        calls = (tpk.auto_keyswitch_stream_plain.calls,
                 tpk.ga_scan_fused_plain.calls)
        got = tmesh.ga_pbs_on_mesh(tm, g["bkg_t"], 4, model_axis=axis)(
            tv_t, c_t)
        n_calls = data if model == 1 else 0
        if (tpk.auto_keyswitch_stream_plain.calls - calls[0],
                tpk.ga_scan_fused_plain.calls - calls[1]) != (n_calls,
                                                              n_calls):
            return "wrong plain K6 / K7 counts"
        single = tga.functional_bootstrap_ga(tv_t, c_t, g["bkg_t"], 4)
        return same_ct(got, want) or same_ct(got, single)

    def case_ga_pbs_on_mesh_1x2():
        return mesh_case(1, 2)

    def case_ga_pbs_on_mesh_2x1():
        return mesh_case(2, 1)

    def case_guards_gone_and_64_bit_forms_refuse():
        """What raised NotImplementedError at this width now gives int32
        words (the TRLWE KS key and keyset, the GA key, the GA mesh);
        K1-delta (`cmux_delta`) and the per-step GA forms built on it, 64-bit
        only as the TPU kernel is, raise it on int32 words."""
        g = jax_ga_keys()
        gen = torch.Generator().manual_seed(3242)
        kr = ttrlwe.new_binary_key(p32.N, p32.k, p32.rlwe_sigma, gen, CPU)
        kt = ttlwe.new_binary_key(p32.n, p32.lwe_sigma, gen, CPU)
        made = {
            "TRLWE KS key": tks.new_trlwe_ks_key(kr, kr, p32.l, p32.Bg_bit,
                                                 gen, CPU).v32,
            "automorphism keyset": tks.new_automorphism_ks_keyset(
                kr, [5], p32.l, p32.Bg_bit, gen, CPU)[5].v32,
            "GA key": tga.new_key(ttrgsw.new_key(kr, p32.l, p32.Bg_bit), kt,
                                  gen, CPU).ak}
        bad = [what for what, t in made.items() if t.dtype != torch.int32]
        tmesh.ga_pbs_on_mesh(tmesh.make_mesh([torch.device(CPU)] * 2, data=2,
                                             model=1), g["bkg_t"], 4)
        bkg_t = g["bkg_t"]
        tv = bridge.trlwe_from_numpy(words((p32.k, p32.N)), words((p32.N,)),
                                     CPU)
        mask = T(words((2, p32.n)), CPU)
        kp = bkg_t.kernel_plans()[0]
        refused = []
        for what, call in (
                ("cmux_delta", lambda: tpk.cmux_delta(
                    tv.stacked()[None].contiguous(), bkg_t.s_v32[0],
                    bkg_t.s_vs32[0], kp)),
                ("blind_rotate_ga_stepwise",
                 lambda: tga.blind_rotate_ga_stepwise(tv, mask, bkg_t)),
                ("blind_rotate_ga_gathered",
                 lambda: tga.blind_rotate_ga_gathered(tv, mask, bkg_t))):
            try:
                call()
            except NotImplementedError:
                refused.append(what)
        missing = {"cmux_delta", "blind_rotate_ga_stepwise",
                   "blind_rotate_ga_gathered"} - set(refused)
        return "; ".join(m for m in (
            f"not int32: {bad}" if bad else "",
            f"no NotImplementedError from {sorted(missing)}"
            if missing else "") if m)

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
