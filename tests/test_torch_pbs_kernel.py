"""The blind-rotate kernel module's plain version against the TPU kernel
`blind_rotate_scan_fused`, run in Pallas interpret mode as the TPU
package's own tests run it on the CPU.  Bit-exact.  The CUDA kernel itself
is held against the plain version in `test_torch_gpu.py`."""

import jax.numpy as jnp
import numpy as np
import torch

from mosfhet_tpu import ntt as jntt
from mosfhet_tpu.ops import pbs_kernel as jpk
from mosfhet_torch.bridge import to_numpy, to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk
from tests.test_torch_gpu import as_i32, random_rotation_inputs


def test_plain_matches_fused_tpu_kernel_interpret():
    N, k, l, Bg_bit, n, B = 256, 1, 2, 9, 5, 32
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=78)
    assert primes == jntt.primes_for_bound(
        jntt.external_product_bound(N, Bg_bit, l, k))
    jkp = jpk.get_kernel_plan(N, primes, l, Bg_bit, k, bt=32, mxu=False)
    want = jpk.blind_rotate_scan_fused(
        jnp.asarray(acc0), jnp.asarray(a_int), jnp.asarray(keyv),
        jnp.asarray(keyvs), jkp, interpret=True)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cpu")
    got = tpk.blind_rotate_scan(
        to_tensor(acc0, "cpu"), torch.from_numpy(a_int),
        as_i32(keyv, "cpu"), as_i32(keyvs, "cpu"), kp)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_u32_bit_patterns_round_trip():
    x = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    y = tpk.u32_as_i32(x)
    assert y.dtype == torch.int32
    assert tpk.i32_as_u32(y).tolist() == x.tolist()
