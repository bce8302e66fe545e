"""The port's threefry counter stream (`mosfhet_torch.ops.prng`) against
``jax.random``, word for word: the block cipher against the TPU package's
in-kernel form, ``random_u32_at`` against ``jax.random.bits``,
``folded_key_data`` against ``fold_in(key, 1)`` and
``uniform_torus_from_key_data`` against the TPU package's
``rng.uniform_torus`` (its high words from the key, its low words from the
folded key at 64 bits; the 32-bit torus in `test_torch_torus32.py`), on
several keys and shapes, one of them over 2^16 words.  The card's machine
has no JAX, so this is the stream's only guard: a seeded key made by the
TPU package decrypts in the port only while these hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import rng as jrng
from mosfhet_tpu.ops import prng as jprng
from mosfhet_torch.ops import prng as tprng
from tests.test_torch_suite_env import port_test_env  # noqa: F401

KEYS = jax.random.split(jax.random.PRNGKey(1818), 5)
KEY_DATA = np.asarray(jax.random.key_data(KEYS)).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_threefry_block_matches_the_tpu_kernels_form():
    """The 20-round block on random keys and counters, edge words
    included, against `mosfhet_tpu.ops.prng.threefry2x32`."""
    rs = np.random.default_rng(18)
    x = rs.integers(0, 1 << 32, (4, 257), dtype=np.uint64).astype(np.uint32)
    x[:, :4] = [[0, 1, 2**32 - 1, 2**31]] * 4
    k = rs.integers(0, 1 << 32, (4, 1), dtype=np.uint64).astype(np.uint32)
    want = jax.jit(jprng.threefry2x32)(k[0], k[1], x[0], x[1])
    got = tprng.threefry2x32(_t(k[0]), _t(k[1]), _t(x[0]), _t(x[1]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


@pytest.mark.parametrize("shape", [(7,), (3, 64), (2, 1, 40000)])
def test_bits_and_fold_in_match_jax_random(shape):
    """Every word of ``jax.random.bits(key, shape, uint32)`` and of the
    folded key's, per key (the last shape is 80,000 words > 2^16)."""
    total = int(np.prod(shape))
    fidx = torch.arange(total)
    folded = tprng.folded_key_data(_t(KEY_DATA))
    for i, key in enumerate(KEYS[:2]):
        for kd, jkey in ((KEY_DATA[i], key),
                         (folded[i].numpy(), jax.random.fold_in(key, 1))):
            np.testing.assert_array_equal(
                kd, np.asarray(jax.random.key_data(jkey), np.int64))
            got = tprng.random_u32_at(int(kd[0]), int(kd[1]), fidx)
            want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
            np.testing.assert_array_equal(got.numpy(),
                                          want.reshape(-1).astype(np.int64))


@pytest.mark.parametrize("shape", [(1, 64), (2, 128), (1, 70000)])
def test_uniform_torus_matches_the_tpu_package(shape):
    """`uniform_torus_from_key_data` on a [5] batch of keys equals
    ``rng.uniform_torus(wrap_key_data(seed), shape)`` of each, 64-bit
    words."""
    got = tprng.uniform_torus_from_key_data(_t(KEY_DATA), shape)
    assert got.shape == (len(KEYS),) + shape and got.dtype == torch.int64
    want = jax.jit(jax.vmap(lambda k: jrng.uniform_torus(k, shape)))(KEYS)
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))


def test_mask_words_match_the_tpu_kernels_form():
    """(hi, lo) halves at scattered indices against
    `mosfhet_tpu.ops.prng.mask_u64_words_at` with its precomputed fold."""
    fidx = np.array([0, 1, 63, 64, 4095, 65537], np.int32)
    kd = KEY_DATA[3].astype(np.uint32)
    klo = np.asarray(jprng.folded_key_data(jnp.asarray(kd)))
    want = jprng.mask_u64_words_at(jnp.asarray(kd), jnp.asarray(klo),
                                   jnp.asarray(fidx), 1 << 20)
    got = tprng.mask_u64_words_at(_t(kd), tprng.folded_key_data(_t(kd)),
                                  _t(fidx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


def test_stream_refuses_2_32_words():
    with pytest.raises(ValueError, match="2\\^32"):
        tprng.uniform_torus_from_key_data(_t(KEY_DATA[:1]), (1 << 16, 1 << 16))
