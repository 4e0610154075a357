"""The port's threefry2x32 is bit-exact against JAX's (partitionable)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.selection  # noqa: E402,F401  (sets the partitionable flag)
from repro_torch import prng  # noqa: E402

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(1,), (7,), (3, 5), (1001,)]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed, device="cpu")


def _eq(j, t):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == np.uint32:
        j = j.astype(np.int64)
    if j.dtype == np.float32:
        # bitwise, so -0.0 / 0.0 and NaN payloads count
        j, t = j.view(np.int32), t.view(np.int32)
    assert j.shape == t.shape
    np.testing.assert_array_equal(j, t)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    kj, kt = _key(seed)
    _eq(kj, kt)
    for num in (2, 4, 5, 13):
        _eq(jax.random.split(kj, num), prng.split(kt, num))
    for data in (0, 1, 7, 12345):
        _eq(jax.random.fold_in(kj, data), prng.fold_in(kt, data))
    # batched keys: split/fold_in of a (5, 2) key array row by row
    sj, st = jax.random.split(kj, 5), prng.split(kt, 5)
    _eq(jax.vmap(lambda k: jax.random.split(k, 3))(sj), prng.split(st, 3))
    _eq(jax.vmap(lambda k: jax.random.fold_in(k, 1))(sj), prng.fold_in(st, 1))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    kj, kt = _key(seed)
    _eq(jax.random.bits(kj, shape, jnp.uint32), prng.bits(kt, shape))
    _eq(jax.random.uniform(kj, shape), prng.uniform(kt, shape))
    _eq(jax.random.uniform(kj, shape, minval=60.0, maxval=100.0),
        prng.uniform(kt, shape, 60.0, 100.0))
    _eq(jax.random.bernoulli(kj, 0.25, shape), prng.bernoulli(kt, 0.25, shape))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0, 1), (0, 20), (0, 64), (3, 1000),
                                    (0, 70000)])
def test_randint(seed, bounds):
    kj, kt = _key(seed)
    lo, hi = bounds
    for shape in SHAPES:
        _eq(jax.random.randint(kj, shape, lo, hi),
            prng.randint(kt, shape, lo, hi))
    # the cohort's batched minibatch draw: randint over (C, L) keys
    keys_j = jax.random.split(kj, 6)
    keys_t = prng.split(kt, 6)
    ref = jax.vmap(lambda k: jax.vmap(
        lambda kk: jax.random.randint(kk, (4,), lo, hi))(
            jax.random.split(k, 3)))(keys_j)
    _eq(ref, prng.randint(prng.split(keys_t, 3), (4,), lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_and_choice(seed):
    kj, kt = _key(seed)
    for n in (1, 35, 100):
        _eq(jax.random.permutation(kj, n), prng.permutation(kt, n))
    sj, st = jax.random.split(kj, 4), prng.split(kt, 4)
    _eq(jax.vmap(lambda k: jax.random.permutation(k, 35))(sj),
        prng.permutation(st, 35))
    p = (0.25, 0.45, 0.30)
    _eq(jax.random.choice(kj, 3, (999,), p=jnp.array(p)),
        prng.choice_p(kt, 3, (999,), p))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_is_close(seed):
    """erfinv differs between the two libraries in the last bits, so
    normal draws are close, not exact (tolerance: float32 erfinv error,
    largest in the tails)."""
    kj, kt = _key(seed)
    np.testing.assert_allclose(np.asarray(jax.random.normal(kj, (4096,))),
                               prng.normal(kt, (4096,)).numpy(),
                               rtol=1e-4, atol=1e-5)
