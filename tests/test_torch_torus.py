"""Torus helpers of the port against the TPU package, bit for bit, on edge
values near 0, 2^63 and 2^64 - 1 (the int64 wrap and logical-shift paths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import torus as jtorus
from mosfhet_torch import torus as ttorus
from mosfhet_torch.bridge import to_numpy, to_tensor

EDGES = np.array(
    [0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
     (1 << 62) - 1, 1 << 62, (1 << 63) - 2, (1 << 63) - 1, 1 << 63,
     (1 << 63) + 1, (1 << 64) - (1 << 55), (1 << 64) - 2, (1 << 64) - 1],
    dtype=np.uint64)


def _words(seed, n=240):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [EDGES, rng.integers(0, 1 << 64, size=n, dtype=np.uint64)])


@pytest.mark.parametrize("log_scale", [1, 5, 12, 32, 63])
def test_torus2int_matches(log_scale):
    x = _words(log_scale)
    want = np.asarray(jtorus.torus2int(jnp.asarray(x), log_scale))
    got = ttorus.torus2int(to_tensor(x, "cpu"), log_scale)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("Bg_bit,l,rounded", [
    (9, 4, True), (8, 3, True), (23, 1, True), (8, 8, False), (16, 4, False),
    (21, 3, True), (7, 6, False)])
def test_gadget_decompose_matches(Bg_bit, l, rounded):
    x = _words(Bg_bit * 10 + l).reshape(2, -1)
    want = np.asarray(jtorus.gadget_decompose(jnp.asarray(x), Bg_bit, l,
                                              rounded))
    got = ttorus.gadget_decompose(to_tensor(x, "cpu"), Bg_bit, l, rounded)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert ttorus.gadget_offset(Bg_bit, l, rounded) == \
        jtorus.gadget_offset(Bg_bit, l, rounded)


def test_double2torus_matches():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        [0.0, 0.5, -0.5, 0.25, 1.0, -1e-300, 1e-300, 0.9999999999999999,
         -0.9999999999999999, 3.75, -2.125, 1 / 3, -1 / 3, 2.0**-60,
         1 - 2.0**-53],
        rng.uniform(-4, 4, 200)])
    want = np.asarray(jtorus.double2torus(jnp.asarray(x)))
    got = ttorus.double2torus(torch.from_numpy(x))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_int2torus_matches():
    x = np.arange(-40, 40, dtype=np.int64)
    want = np.asarray(jtorus.int2torus(jnp.asarray(x.view(np.uint64)), 5))
    got = ttorus.int2torus(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(to_numpy(got), want)
