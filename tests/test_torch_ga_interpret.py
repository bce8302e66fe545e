"""The port's `blind_rotate_ga` against the TPU package's GA rotation, bit
for bit, on random key material at the GA tests' widths.  Words need no
decryption envelope, so the keys are random residues, not encryptions.

The oracle is the TPU package's jnp path (jitted).  Its default path in
Pallas interpret mode (the initial key switch on `auto_keyswitch_stream`
with its in-kernel permutation, then the whole rotation as one
`ga_scan_fused`) gives the jnp words at these widths, an unbatched test
vector and a batch of 3 (`tests/test_ga_kernel.py::
test_ga_onekernel_bit_exact`); K6 and K7 meet their interpret-mode TPU
kernels directly in `test_torch_ga_kernels.py`."""

import jax
import jax.numpy as jnp
import numpy as np

from mosfhet_tpu import bootstrap_ga as jga, trlwe as jtrlwe
from mosfhet_torch import bootstrap_ga as tga, bridge, ntt as tntt
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_suite_env import port_test_env  # noqa: F401

N, K, L, BG_BIT, N_LWE = 128, 1, 2, 10, 8


def _random_ga_key(rng):
    """Both packages' GA keys holding the same random residues."""
    C, J = K + 1, (K + 1) * L
    primes = tntt.primes_for_bound(tntt.external_product_bound(N, BG_BIT, L,
                                                               K))
    ks_primes = tntt.primes_for_bound(tntt.conv_bound(N, 1 << (BG_BIT - 1),
                                                      K * L * L))
    pp = np.array(primes, np.uint64)[:, None]
    pk = np.array(ks_primes, np.uint64)[:, None]
    s_v = rng.integers(0, 1 << 62, (N_LWE, J, C, len(primes), N),
                       dtype=np.uint64) % pp
    ak_v = rng.integers(0, 1 << 62, (N, K * L, C, len(ks_primes), N),
                        dtype=np.uint64) % pk
    inv2n = tga.inverse_mod_2n_table(N)
    bk_j = jga.GABootstrapKey(
        s_v=jnp.asarray(s_v), s_vs=jnp.asarray((s_v << np.uint64(32)) // pp),
        ak_v=jnp.asarray(ak_v),
        ak_vs=jnp.asarray((ak_v << np.uint64(32)) // pk),
        inv2n=jnp.asarray(inv2n), n=N_LWE, k=K, N=N, l=L, Bg_bit=BG_BIT,
        ks_t=L, ks_base_bit=BG_BIT, primes=tuple(primes),
        ks_primes=tuple(ks_primes))
    bk_t = bridge.ga_bootstrap_key_from_numpy(
        np.asarray(bk_j.s_v), np.asarray(bk_j.s_vs), ak_v, inv2n, N_LWE, K, N,
        L, BG_BIT, L, BG_BIT, primes, ks_primes, "cpu")
    return bk_j, bk_t


def test_blind_rotate_ga_matches_tpu_kernels_interpret(monkeypatch):
    """An unbatched test vector and an odd batch of 3 masks: one plain K6
    and one plain K7 call in the port, the words of the TPU package's jnp
    rotation (which its interpret-mode kernels give, as the module's
    docstring says)."""
    for flag in ("MOSFHET_GA_ONEKERNEL", "MOSFHET_GA_STREAM",
                 "MOSFHET_GA_FUSED"):
        monkeypatch.delenv(flag, raising=False)
    rng = np.random.default_rng(15)
    bk_j, bk_t = _random_ga_key(rng)
    a = rng.integers(0, 1 << 64, (K, N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (N,), dtype=np.uint64)
    mask = rng.integers(0, 1 << 64, (3, N_LWE), dtype=np.uint64)
    want = jax.jit(lambda tv, m: jga.blind_rotate_ga(tv, m, bk_j,
                                                     impl="jnp"))(
        jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)), jnp.asarray(mask))
    calls = (tpk.auto_keyswitch_stream_plain.calls,
             tpk.ga_scan_fused_plain.calls)
    got = tga.blind_rotate_ga(bridge.trlwe_from_numpy(a, b, "cpu"),
                              to_tensor(mask, "cpu"), bk_t)
    assert (tpk.auto_keyswitch_stream_plain.calls,
            tpk.ga_scan_fused_plain.calls) == (calls[0] + 1, calls[1] + 1)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))
