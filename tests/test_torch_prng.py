"""The port's threefry draws against ``jax.random``, bit for bit.

Keys, splits, random bits, uniforms, normals and Poisson counts must all
be equal: they seed the forest's bootstrap and the MLP's initial weights,
and any difference there would start the models from other states.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 42, 123456789, 2**31 - 1, 1518500249]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_bits_are_bitwise(seed):
    key = prng.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    _same_bits(key, jkey)
    for n in (2, 3, 7):
        _same_bits(prng.split(key, n), jax.random.split(jkey, n))
    _same_bits(prng.random_bits(key, (3, 5)), jax.random.bits(jkey, (3, 5)))
    k1, _k2 = prng.split(key)
    j1, _j2 = jax.random.split(jkey)
    _same_bits(prng.split(k1, 2), jax.random.split(j1, 2))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_normal_are_bitwise(seed):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    _same_bits(prng.uniform(key, (4096,)),
               jax.random.uniform(jkey, (4096,)))
    # the MLP init shapes (d, h) and (h, 1), and a large sample that
    # reaches erfinv's tail branch
    for shape in ((1, 32), (32, 1), (3, 16), (50000,)):
        _same_bits(prng.normal(key, shape), jax.random.normal(jkey, shape))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(8, 128), (8, 256), (2, 1000)])
def test_poisson_counts_are_equal(seed, shape):
    got = prng.poisson(prng.prng_key(seed), 1.0, shape)
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), 1.0,
                                         shape))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_draws_match_under_jit_with_a_traced_seed():
    """The predictor builds its key from a seed traced inside jit."""
    seeds = [7, 99991, 2**30 + 5]

    @jax.jit
    def draws(s):
        key = jax.random.PRNGKey(s)
        k1, k2 = jax.random.split(key)
        return (jax.random.normal(k1, (1, 32)), jax.random.normal(k2, (32, 1)),
                jax.random.poisson(key, 1.0, (8, 128)))

    for s in seeds:
        n1, n2, p = draws(s)
        key = prng.prng_key(s)
        k1, k2 = prng.split(key)
        _same_bits(prng.normal(k1, (1, 32)), n1)
        _same_bits(prng.normal(k2, (32, 1)), n2)
        np.testing.assert_array_equal(prng.poisson(key, 1.0, (8, 128)), p)


def test_log_polynomials_match_xla():
    rng = np.random.default_rng(0)
    u = rng.random(200000).astype(np.float32) + np.float32(1e-7)
    _same_bits(prng.log_f32(u), jax.jit(jnp.log)(u))
    x = -(u * u)
    _same_bits(prng.log1p_f32(x), jax.jit(jnp.log1p)(x))


def test_seed_outside_int32_is_refused():
    with pytest.raises(ValueError):
        prng.prng_key(2**31)
