"""The port's external product (`trgsw.external_product`, the apply-scan
kernel's plain version with G=1), `trlwe.decompose` and
`ntt.pointwise_mul_acc_generic` against the TPU package, bit for bit: one
TRGSW broadcast over a ragged batch and one TRGSW per row, at small widths
and at TFHEpp-L2 widths, and once against the TPU kernel
`_apply_scan_fused` run in Pallas interpret mode.  The CUDA kernel itself
is held against the plain version in `test_torch_gpu.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mosfhet_tpu import ntt as jntt, params, trgsw as jtrgsw, trlwe as jtrlwe
from mosfhet_torch import bridge, ntt as tntt, trgsw as ttrgsw, \
    trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import pbs_kernel as tpk

CPU = "cpu"
UNFOLD_TEST = params.TFHEParams(
    n=8, N=128, k=1, l=2, Bg_bit=10, t=6, base_bit=4,
    lwe_sigma=2.0**-28, rlwe_sigma=2.0**-44, name="UNFOLD_TEST")


def _primes(p):
    return tntt.primes_for_bound(
        tntt.external_product_bound(p.N, p.Bg_bit, p.l, p.k))


def _random_case(p, batch, key_batch, seed):
    """A random TRLWE batch and random canonical TRGSW residues (with Shoup
    companions for the TPU package's jnp path), as numpy."""
    rng = np.random.default_rng(seed)
    primes = _primes(p)
    a = rng.integers(0, 1 << 64, batch + (p.k, p.N), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, batch + (p.N,), dtype=np.uint64)
    pr = np.array(primes, np.uint64)[:, None]
    J, C = (p.k + 1) * p.l, p.k + 1
    v = rng.integers(0, 1 << 62, key_batch + (J, C, len(primes), p.N),
                     dtype=np.uint64) % pr
    vs = (v << np.uint64(32)) // pr
    return primes, a, b, v, vs


def _both(p, a, b, v, vs, primes, impl="jnp"):
    jg = jtrgsw.TRGSWDFT(v=jnp.asarray(v), vs=jnp.asarray(vs), l=p.l,
                         Bg_bit=p.Bg_bit, primes=tuple(primes))
    jc = jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b))
    want = jax.jit(lambda c, g: jtrgsw.external_product(c, g, impl=impl))(
        jc, jg)
    tg = bridge.trgsw_dft_from_numpy(v, None, p.l, p.Bg_bit, primes, CPU)
    got = ttrgsw.external_product(bridge.trlwe_from_numpy(a, b, CPU), tg)
    np.testing.assert_array_equal(to_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(to_numpy(got.b), np.asarray(want.b))
    return got


@pytest.mark.parametrize("p", [UNFOLD_TEST, params.TFHEPP_L2],
                         ids=lambda p: p.name)
@pytest.mark.parametrize("per_row", [False, True],
                         ids=["broadcast", "per_row"])
def test_external_product_matches_jnp(p, per_row):
    """Ragged batch of 3; per row: one TRGSW for each ciphertext."""
    batch = (3,)
    primes, a, b, v, vs = _random_case(p, batch, batch if per_row else (),
                                       seed=p.N + per_row)
    calls = tpk.ext_product_apply_scan_plain.calls
    got = _both(p, a, b, v, vs, primes)
    assert tpk.ext_product_apply_scan_plain.calls == calls + 1
    assert got.a.shape == batch + (p.k, p.N)


def test_external_product_unbatched_and_broadcast_ciphertext():
    """One TRLWE under a batch of TRGSWs (the ciphertext broadcast), and
    both operands unbatched."""
    p = UNFOLD_TEST
    primes, a, b, v, vs = _random_case(p, (), (2,), seed=5)
    _both(p, a, b, v, vs, primes)
    _both(p, a, b, v[0], vs[0], primes)


def test_external_product_matches_tpu_kernel_interpret():
    """The TPU kernel `_apply_scan_fused` in interpret mode with one TRGSW
    per row (through the TPU package's `external_product(impl=
    "pallas_interpret")`, which pads the batch of 3 to its tile).  The
    broadcast mode meets the interpret-mode kernel in `test_torch_ubr.py`."""
    p = UNFOLD_TEST
    primes, a, b, v, vs = _random_case(p, (3,), (3,), seed=12)
    _both(p, a, b, v, vs, primes, impl="pallas_interpret")


def test_apply_scan_plain_with_several_steps():
    """G=3 replace-mode steps with one key per row (the batched UBR phase
    2) against the TPU package's jnp external product taken three times."""
    p = UNFOLD_TEST
    B, G = 5, 3
    primes, a, b, v, vs = _random_case(p, (B,), (G, B), seed=21)
    jc = jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b))
    ep = jax.jit(lambda c, gv, gvs: jtrgsw.external_product(
        c, jtrgsw.TRGSWDFT(v=gv, vs=gvs, l=p.l, Bg_bit=p.Bg_bit,
                           primes=tuple(primes)), impl="jnp"))
    for g in range(G):
        jc = ep(jc, jnp.asarray(v[g]), jnp.asarray(vs[g]))
    kp = tpk.get_kernel_plan(p.N, primes, p.l, p.Bg_bit, p.k, CPU)
    acc0 = bridge.trlwe_from_numpy(a, b, CPU).stacked().contiguous()
    sa32 = tpk.u32_as_i32(bridge.to_tensor(v, CPU))
    out = tpk.ext_product_apply_scan(acc0, sa32, kp, per_row=True)
    np.testing.assert_array_equal(to_numpy(out[:, :p.k]), np.asarray(jc.a))
    np.testing.assert_array_equal(to_numpy(out[:, p.k]), np.asarray(jc.b))


def test_decompose_and_generic_mul_acc_match():
    p = params.TFHEPP_L2
    primes, a, b, v, _ = _random_case(p, (2,), (), seed=31)
    want = jtrlwe.decompose(jtrlwe.TRLWE(a=jnp.asarray(a), b=jnp.asarray(b)),
                            p.Bg_bit, p.l)
    got = ttrlwe.decompose(bridge.trlwe_from_numpy(a, b, CPU), p.Bg_bit, p.l)
    assert got.shape == (2, (p.k + 1) * p.l, p.N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(32)
    pr = np.array(primes, np.uint64)[:, None]
    x = rng.integers(0, 1 << 62, (2, 8, 1, 3, p.N), dtype=np.uint64) % pr
    jplan = jntt.get_plan(p.N, tuple(primes))
    want = jntt.pointwise_mul_acc_generic(jnp.asarray(x), jnp.asarray(v),
                                          jplan, axis=-4)
    got = tntt.pointwise_mul_acc_generic(
        bridge.to_tensor(x, CPU), bridge.to_tensor(v, CPU),
        tntt.get_plan(p.N, primes, CPU), dim=-4)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
