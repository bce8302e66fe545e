"""The hand-written CUDA blind-rotate kernel against its plain PyTorch
version, bit for bit.  Needs a CUDA card: without one every test here skips.

This file imports nothing but PyTorch, numpy and the port, so it runs on a
machine that has no TPU-package dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from mosfhet_torch import ntt
from mosfhet_torch.bridge import to_tensor
from mosfhet_torch.ops import pbs_kernel as tpk


def random_rotation_inputs(N, k, l, Bg_bit, n, B, seed):
    """Random accumulators, exponents in [0, 2N] with 0 and 2N present, and
    random canonical key residues with their Shoup companions (u32)."""
    C, J = k + 1, (k + 1) * l
    primes = ntt.primes_for_bound(ntt.external_product_bound(N, Bg_bit, l, k))
    rng = np.random.default_rng(seed)
    acc0 = rng.integers(0, 1 << 64, size=(B, C, N), dtype=np.uint64)
    a_int = rng.integers(0, 2 * N + 1, size=(n, B), dtype=np.int32)
    a_int[0, 0], a_int[-1, -1] = 0, 2 * N
    p = np.array(primes, np.uint64)[:, None]
    keyv = rng.integers(0, 1 << 62, size=(n, J, C, len(primes), N),
                        dtype=np.uint64) % p
    keyvs = (keyv << np.uint64(32)) // p
    return primes, acc0, a_int, keyv.astype(np.uint32), keyvs.astype(np.uint32)


def as_i32(x_u32, device):
    """u32 array -> int32 tensor with the same bits."""
    return torch.from_numpy(x_u32.view(np.int32).copy()).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("N,k,l,Bg_bit,n,B", [
    (2048, 1, 4, 9, 3, 5),     # TFHEpp-L2 widths
    (256, 2, 3, 8, 4, 3),      # k=2, TOY_K2-like digits
    (2048, 1, 1, 23, 2, 2),    # SET_2 digits: four primes
])
def test_cuda_kernel_matches_plain(N, k, l, Bg_bit, n, B):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    primes, acc0, a_int, keyv, keyvs = random_rotation_inputs(
        N, k, l, Bg_bit, n, B, seed=N)
    kp = tpk.get_kernel_plan(N, primes, l, Bg_bit, k, "cuda")
    args = (to_tensor(acc0, "cuda"), torch.from_numpy(a_int).cuda(),
            as_i32(keyv, "cuda"), as_i32(keyvs, "cuda"), kp)
    launches = tpk.blind_rotate_scan.launches
    got = tpk.blind_rotate_scan(*args)
    torch.cuda.synchronize()
    assert tpk.blind_rotate_scan.launches == launches + 1
    want = tpk.blind_rotate_scan_plain(*args)
    assert torch.equal(got, want)
