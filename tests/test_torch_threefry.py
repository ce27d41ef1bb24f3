"""The port's threefry PRNG and ALS factor init vs JAX's.

``predictionio_tpu_torch.ops.threefry`` reimplements, in numpy, what the
reference's ``_init_factors`` draws from ``jax.random`` (partitionable
threefry2x32): the key of a seed, ``split``, 32-bit ``bits`` and the
float32 ``normal``.  Keys and bits must equal JAX's bitwise.  The normals
and the init go through a float32 erfinv whose ``log1p`` rounds
differently in numpy and XLA, so they are held to 4 float32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models import als as jax_als
from predictionio_tpu_torch.models import als as port_als
from predictionio_tpu_torch.ops import threefry

SEEDS = (0, 1, 3, 42, 2**31 - 1)
# seeds outside int32: JAX keeps their low 32 bits
ODD_SEEDS = (-1, -5, 2**31, 2**32 + 3)
SHAPES = ((3, 4), (1, 1), (5, 7), (1000, 64))
MAX_ULP = 4


@pytest.mark.parametrize("seed", SEEDS + ODD_SEEDS)
def test_key_and_split_equal_jax_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.seed_key(seed), np.asarray(key))
    assert threefry.seed_key(seed).dtype == np.uint32
    np.testing.assert_array_equal(threefry.split(threefry.seed_key(seed)),
                                  np.asarray(jax.random.split(key)))
    np.testing.assert_array_equal(
        threefry.split(threefry.seed_key(seed), 5),
        np.asarray(jax.random.split(key, 5)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_equal_jax_bitwise(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    got = threefry.random_bits(np.asarray(key), shape)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    assert got.dtype == np.uint32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps_of_jax(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed))[0]
    got = threefry.normal(np.asarray(key), shape)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_max_ulp(got, want, maxulp=MAX_ULP)


def test_bits_cross_the_chunk_boundary():
    """A draw longer than one numpy pass equals the draw of its prefix
    and runs on past it (the counter is the flat index, not per pass)."""
    key = threefry.seed_key(9)
    n = threefry._CHUNK + 3
    long = threefry.random_bits(key, (n,))
    np.testing.assert_array_equal(long[:5], threefry.random_bits(key, (5,)))
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(9), (n,),
                                      jnp.uint32))
    np.testing.assert_array_equal(long, want)


def test_erfinv_within_ulps_of_xla():
    rng = np.random.default_rng(0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    x = np.concatenate([rng.uniform(-1, 1, 20000),
                        1 - rng.uniform(1e-7, 1e-3, 2000),
                        [lo, 0.0, 0.5, -0.999]]).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(threefry.erfinv(x), want,
                                    maxulp=MAX_ULP)


@pytest.mark.parametrize("shape", [(3, 2, 4, 42), (200, 100, 10, 3)])
def test_init_factors_match_the_reference(shape):
    """Before the port drew threefry itself, (3, 2, 4, 42) started 1.22
    apart from the reference."""
    got = port_als._init_factors(*shape)
    want = jax_als._init_factors(*shape)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w),
                                        maxulp=MAX_ULP)


@pytest.mark.parametrize("data", [0, 1, 1_000_003 + 50, 2_000_006 + 40,
                                  2**31 - 1, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_equals_jax_bitwise(seed, data):
    """``fold_in`` — the key two-tower's ``grow_state`` draws new rows
    from — is JAX's bit for bit, and its normals within MAX_ULP."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    got = threefry.fold_in(threefry.seed_key(seed), data)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, np.asarray(key))
    np.testing.assert_array_max_ulp(
        threefry.normal(got, (7, 8)),
        np.asarray(jax.random.normal(key, (7, 8), jnp.float32)),
        maxulp=MAX_ULP)
