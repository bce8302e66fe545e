"""What the port's CPU test files share: one torch intra-op thread, and the
TPU package's oracle programs compiled with XLA's optimizations off
(`jax_disable_most_optimizations`).

The oracles are exact integer programs whose compile takes most of these
files' time (each runs once, on small inputs), and the suite's workers
share the machine's cores: so their small torch ops run on one thread, and
XLA spends no time optimizing code that runs once.  A test file takes both
by importing ``port_test_env``, an autouse fixture of the importing
module's scope, which restores both settings when the module is done.  The
child interpreters of the 32-bit torus files get the same XLA setting
through ``XLA_FLAGS`` (``CHILD_XLA_FLAGS``).

The optimization level must not change a word: the test here compiles one
oracle, a jnp blind rotation at TOY, both ways.  JAX is imported where it
is used: the child interpreters that import a test module (the multihost
ranks) run the port alone."""

import numpy as np
import pytest
import torch

# the child interpreters' XLA flags: 8 host devices (the suite's meshes)
# and XLA's optimizations off, as `port_test_env` sets them in process
CHILD_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                   "--xla_backend_optimization_level=0 "
                   "--xla_llvm_disable_expensive_passes=true")
_FLAG = "jax_disable_most_optimizations"


@pytest.fixture(autouse=True, scope="module")
def port_test_env():
    import jax
    threads, flag = torch.get_num_threads(), jax.config.values[_FLAG]
    torch.set_num_threads(1)
    jax.config.update(_FLAG, True)
    yield
    jax.config.update(_FLAG, flag)
    torch.set_num_threads(threads)


def test_oracle_words_do_not_depend_on_xla_optimizations():
    """The fixture is in force here; a TOY blind rotation (the jnp path, 6
    steps, random key residues) compiled with XLA's optimizations off and
    on gives the same words."""
    import jax
    import jax.numpy as jnp

    from mosfhet_tpu import bootstrap as jbs, ntt as jntt, params, \
        trlwe as jtrlwe
    assert torch.get_num_threads() == 1 and jax.config.values[_FLAG]
    p, n, B = params.TOY, 6, 3
    primes = jntt.primes_for_bound(jntt.external_product_bound(
        p.N, p.Bg_bit, p.l, p.k), p.N)
    rs = np.random.default_rng(6)
    pr = np.array(primes, np.uint64)[:, None]
    v = rs.integers(0, 1 << 62, (n, (p.k + 1) * p.l, p.k + 1, len(primes),
                                 p.N), dtype=np.uint64) % pr
    bk = jbs.BootstrapKey(v=jnp.asarray(v),
                          vs=jnp.asarray((v << np.uint64(32)) // pr),
                          su=None, n=n, k=p.k, N=p.N, l=p.l,
                          Bg_bit=p.Bg_bit, unfolding=1, primes=primes)
    tv = jtrlwe.TRLWE(
        a=jnp.asarray(rs.integers(0, 1 << 64, (B, p.k, p.N), np.uint64)),
        b=jnp.asarray(rs.integers(0, 1 << 64, (B, p.N), np.uint64)))
    mask = jnp.asarray(rs.integers(0, 1 << 64, (B, n), np.uint64))
    words = []
    for off in (True, False):
        jax.config.update(_FLAG, off)
        out = jax.jit(lambda t, m: jbs.blind_rotate(t, m, bk, impl="jnp"))(
            tv, mask)
        words.append((np.asarray(out.a), np.asarray(out.b)))
    jax.config.update(_FLAG, True)
    np.testing.assert_array_equal(words[0][0], words[1][0])
    np.testing.assert_array_equal(words[0][1], words[1][1])
