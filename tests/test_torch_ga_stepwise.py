"""The GA bootstrap's per-step forms at the 64-bit torus: the external
product launch K1-delta (`cmux_delta`) and the gathered-key automorphism key
switch K6-old (`auto_keyswitch`) against the TPU kernels `cmux_delta` and
`auto_keyswitch` in Pallas interpret mode, and the port's
`blind_rotate_ga_stepwise` and `blind_rotate_ga_gathered` against the TPU
package's jnp GA scan and the port's `blind_rotate_ga` (K6 + K7), bit for
bit, at the GA tests' widths (N=128, l=2, Bg_bit=10) with the rotation cut
to n=4 steps.  The TPU package's own `tests/test_ga_kernel.py` ties its
two-kernel forms to its jnp route, so the paths meet that route here.  The
CUDA kernels meet the same plain versions in `test_torch_gpu.py`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import bootstrap_ga as jga, trlwe as jtrlwe
from mosfhet_tpu.ops import pbs_kernel as jpk
from mosfhet_torch import bootstrap_ga as tga, bridge, ntt as tntt
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

N, K, L, BG_BIT, N_LWE = 128, 1, 2, 10, 4
C, J = K + 1, (K + 1) * L
PRIMES = tntt.primes_for_bound(tntt.external_product_bound(N, BG_BIT, L, K))
KS_PRIMES = tntt.primes_for_bound(tntt.conv_bound(N, 1 << (BG_BIT - 1),
                                                  K * L * L))
B = 8          # one TPU tile (bt=8), so the TPU kernels pad nothing


def _residues(rng, shape, primes):
    return rng.integers(0, 1 << 62, shape, dtype=np.uint64) \
        % np.array(primes, np.uint64)[:, None]


def _shoup(v, primes):
    return (v << np.uint64(32)) // np.array(primes, np.uint64)[:, None]


def _i32(x):
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def test_cmux_delta_plain_matches_tpu_kernel_interpret():
    """One TRGSW over 8 rows whose words have their top bit set, and low
    halves at 2^32 - 1, so the gadget offset carries into the high limb
    (as `tests/test_pbs_kernel.py:53`)."""
    rng = np.random.default_rng(81)
    x = rng.integers(1 << 63, 1 << 64, (B, C, N), dtype=np.uint64)
    x[:, :, ::3] |= np.uint64(0xFFFFFFFF)
    keyv = _residues(rng, (J, C, len(PRIMES), N), PRIMES)
    keyvs = _shoup(keyv, PRIMES)
    jkp = jpk.get_kernel_plan(N, PRIMES, L, BG_BIT, K, bt=B, mxu=False)
    want = jpk.cmux_delta(jnp.asarray(x), jnp.asarray(keyv.astype(np.uint32)),
                          jnp.asarray(keyvs.astype(np.uint32)), jkp,
                          interpret=True)
    kp = tpk.get_kernel_plan(N, PRIMES, L, BG_BIT, K, "cpu")
    calls = tpk.cmux_delta_plain.calls
    got = tpk.cmux_delta(to_tensor(x, "cpu"), _i32(keyv), _i32(keyvs), kp)
    assert tpk.cmux_delta_plain.calls == calls + 1
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_auto_keyswitch_gathered_plain_matches_tpu_kernel_interpret():
    """K6-old: 8 already-permuted rows, one random keyset entry each."""
    rng = np.random.default_rng(82)
    perm = rng.integers(0, 1 << 64, (B, C, N), dtype=np.uint64)
    rows = _residues(rng, (B, K * L, C, len(KS_PRIMES), N), KS_PRIMES)
    jkp = jpk.get_kernel_plan(N, KS_PRIMES, L, BG_BIT, K, bt=B, mxu=False)
    want = jpk.auto_keyswitch(jnp.asarray(perm),
                              jnp.asarray(rows.astype(np.uint32)), jkp,
                              interpret=True)
    kp = tpk.get_kernel_plan(N, KS_PRIMES, L, BG_BIT, K, "cpu")
    calls = tpk.auto_keyswitch_plain.calls
    got = tpk.auto_keyswitch(to_tensor(perm, "cpu"), _i32(rows), kp)
    assert tpk.auto_keyswitch_plain.calls == calls + 1
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@functools.cache
def _case():
    """Both packages' GA keys holding the same random residues, an
    unbatched test vector and a batch of 3 masks, and the TPU package's jnp
    rotation of them."""
    rng = np.random.default_rng(83)
    s_v = _residues(rng, (N_LWE, J, C, len(PRIMES), N), PRIMES)
    ak_v = _residues(rng, (N, K * L, C, len(KS_PRIMES), N), KS_PRIMES)
    inv2n = tga.inverse_mod_2n_table(N)
    bk_j = jga.GABootstrapKey(
        s_v=jnp.asarray(s_v), s_vs=jnp.asarray(_shoup(s_v, PRIMES)),
        ak_v=jnp.asarray(ak_v), ak_vs=jnp.asarray(_shoup(ak_v, KS_PRIMES)),
        inv2n=jnp.asarray(inv2n), n=N_LWE, k=K, N=N, l=L, Bg_bit=BG_BIT,
        ks_t=L, ks_base_bit=BG_BIT, primes=tuple(PRIMES),
        ks_primes=tuple(KS_PRIMES))
    bk_t = bridge.ga_bootstrap_key_from_numpy(
        s_v, _shoup(s_v, PRIMES), ak_v, inv2n, N_LWE, K, N, L, BG_BIT, L,
        BG_BIT, PRIMES, KS_PRIMES, "cpu")
    a = rng.integers(0, 1 << 64, (K, N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (N,), dtype=np.uint64)
    mask = rng.integers(0, 1 << 64, (3, N_LWE), dtype=np.uint64)
    want = jax.jit(lambda tv, m: jga.blind_rotate_ga(tv, m, bk_j,
                                                     impl="jnp"))(
        jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)), jnp.asarray(mask))
    return (bk_t, bridge.trlwe_from_numpy(a, b, "cpu"),
            to_tensor(mask, "cpu"), want)


_PLAINS = (tpk.cmux_delta_plain, tpk.auto_keyswitch_stream_plain,
           tpk.auto_keyswitch_plain, tpk.ga_scan_fused_plain)


@pytest.mark.parametrize("form,launches", [
    ("blind_rotate_ga_stepwise", {"cmux_delta_plain": N_LWE,
                                  "auto_keyswitch_stream_plain": N_LWE + 1}),
    ("blind_rotate_ga_gathered", {"cmux_delta_plain": N_LWE,
                                  "auto_keyswitch_plain": N_LWE + 1})])
def test_per_step_ga_form_matches_jnp_and_blind_rotate_ga(form, launches):
    """n K1-delta calls and n+1 key switches (K6 with its permutation, or
    K6-old on rows gathered in PyTorch), and no K7: the jnp scan's words,
    and `blind_rotate_ga`'s."""
    bk_t, tv, mask, want = _case()
    before = [f.calls for f in _PLAINS]
    got = getattr(tga, form)(tv, mask, bk_t)
    calls = {f.__name__: f.calls - c for f, c in zip(_PLAINS, before)
             if f.calls != c}
    assert calls == launches
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))
    fused = tga.blind_rotate_ga(tv, mask, bk_t)
    assert torch.equal(got.a, fused.a) and torch.equal(got.b, fused.b)
