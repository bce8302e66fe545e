"""The port's seeded TRLWE samples against the TPU package, bit for bit:
samples made by the TPU package's `seeded.encrypt` cross through `bridge`
(seeds as u32 key words), and the port's `expand` and `subto` give the TPU
package's words at TOY and TOY_K2; the port's own `encrypt` (seeds from a
``torch.Generator``) decrypts, and its mask is the stream of its seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosfhet_tpu import params, rng as jrng, seeded as jseeded, \
    trlwe as jtrlwe
from mosfhet_torch import bridge, rng as trng, seeded as tseeded, \
    trlwe as ttrlwe
from mosfhet_torch.bridge import to_numpy
from mosfhet_torch.ops import prng as tprng

CPU = "cpu"


@pytest.mark.parametrize("p", [params.TOY, params.TOY_K2],
                         ids=lambda p: p.name)
def test_expand_and_subto_match_jnp(p):
    """A [2, 3] batch of TPU-made seeded samples: `expand` and `subto` of a
    random TRLWE, every word; the expanded sample decrypts (2^30 of its
    message, sigma 2^-44)."""
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(1900 + p.k), 3)
    key = jtrlwe.new_binary_key(k0, p.N, p.k, p.rlwe_sigma)
    rs = np.random.default_rng(p.k)
    m = rs.integers(0, 1 << 64, (2, 3, p.N), dtype=np.uint64)
    a = rs.integers(0, 1 << 64, (2, 3, p.k, p.N), dtype=np.uint64)
    b = rs.integers(0, 1 << 64, (2, 3, p.N), dtype=np.uint64)

    def jax_side(m, a, b):
        s = jseeded.encrypt(m, key, k1)
        c = jtrlwe.TRLWE(a=a, b=b)
        full = jseeded.expand(s)
        sub = jseeded.subto(c, s)
        return s.seed, s.b, full.a, full.b, sub.a, sub.b, \
            jtrlwe.phase(full, key)

    seed, sb, fa, fb, sa, sbb, ph = jax.jit(jax_side)(m, a, b)
    s_t = bridge.seeded_trlwe_from_numpy(np.asarray(seed), np.asarray(sb),
                                         p.k, CPU)
    assert s_t.seed.dtype == torch.int64 and s_t.N == p.N
    full = tseeded.expand(s_t)
    np.testing.assert_array_equal(to_numpy(full.a), np.asarray(fa))
    np.testing.assert_array_equal(to_numpy(full.b), np.asarray(fb))
    sub = tseeded.subto(bridge.trlwe_from_numpy(a, b, CPU), s_t)
    np.testing.assert_array_equal(to_numpy(sub.a), np.asarray(sa))
    np.testing.assert_array_equal(to_numpy(sub.b), np.asarray(sbb))
    seed_back, b_back = bridge.seeded_trlwe_to_numpy(s_t)
    np.testing.assert_array_equal(seed_back, np.asarray(seed))
    np.testing.assert_array_equal(b_back, np.asarray(sb))
    err = np.abs((np.asarray(ph) - m).view(np.int64).astype(np.float64))
    assert err.max() < 2.0**30


def test_port_encrypt_decrypts():
    """The port's seeded encryption of 4 messages: seeds are u32 words
    from the generator, the mask is their stream, and the sample decrypts
    within 2^30 (sigma 2^-44), alone and through `subto` of a trivial
    TRLWE."""
    p = params.TOY_K2
    gen = torch.Generator().manual_seed(19)
    key = ttrlwe.new_binary_key(p.N, p.k, p.rlwe_sigma, gen, CPU)
    m = trng.uniform_torus(gen, (4, p.N), CPU)
    s = tseeded.encrypt(m, key, gen)
    assert s.seed.shape == (4, 2) and s.k == p.k
    assert int(s.seed.min()) >= 0 and int(s.seed.max()) < 1 << 32
    c = tseeded.expand(s)
    torch.testing.assert_close(c.a, tprng.uniform_torus_from_key_data(
        s.seed, (p.k, p.N)), rtol=0, atol=0)

    def err(ph, want):
        d = to_numpy(ph - want).view(np.int64)
        return np.abs(d.astype(np.float64)).max()

    assert err(ttrlwe.phase(c, key), m) < 2.0**30
    zero = ttrlwe.noiseless_trivial(torch.zeros_like(m), p.k, p.N)
    assert err(ttrlwe.phase(tseeded.subto(zero, s), key), -m) < 2.0**30
    one = tseeded.encrypt(None, key, gen)
    assert one.seed.shape == (2,) and one.b.shape == (p.N,)
    assert err(ttrlwe.phase(tseeded.expand(one), key),
               torch.zeros(p.N, dtype=torch.int64)) < 2.0**30


def test_jax_uniform_torus_is_the_seeds_stream():
    """The TPU package's mask of a seeded sample is `rng.uniform_torus` of
    its seed: the fact the port's `expand` rests on."""
    kd = jax.random.key_data(jax.random.split(jax.random.PRNGKey(7), 2))
    want = jax.vmap(lambda sd: jrng.uniform_torus(
        jax.random.wrap_key_data(sd), (1, 64)))(kd)
    got = jax.jit(lambda s: jseeded._expand_a(s, 1, 64))(kd)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(
        to_numpy(tseeded._expand_a(bridge.seeds_to_tensor(np.asarray(kd),
                                                          CPU), 1, 64)),
        np.asarray(jnp.asarray(want)))
