"""The port's threefry2x32 (`repro_torch.runtime.prng`) against
`jax.random` (JAX 0.9, `jax_threefry_partitionable` on), on the CPU.

Keys (`PRNGKey`), `fold_in`, `split`, 32-bit random bits and float32
uniforms are integer arithmetic and bit-equal to JAX's for every seed
(including seeds at and past 2^31 and 2^32, and negative ones) and shape
((), (V,), (1, V), (B, V), (2, B, V)); a batch of keys equals JAX's
vmap.  `gumbel` applies torch's log, which differs from XLA's by an ulp
now and then: within 2 ulps of max(|g|, 1).  `categorical` (arg-max of
Gumbel noise plus logits) picks the same indices on fixed seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.runtime import prng

SEEDS = [0, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5, 2 ** 32 - 1, 2 ** 32 + 3, -1, -5]
V, B = 257, 3
SHAPES = [(), (V,), (1, V), (B, V), (2, B, V)]


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) < 2 ** 32 if t.numel() else True
    return t.numpy().astype(np.uint32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread here: beside JAX's
    thread pool more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    for d in (0, 1, 11, 2 ** 31 + 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _u32(prng.fold_in(tk, d)),
            np.asarray(jax.random.fold_in(jk, np.uint32(d))))
    for num in (2, 3, (2, 3)):
        np.testing.assert_array_equal(_u32(prng.split(tk, num)),
                                      np.asarray(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 32 - 1])
def test_bits_and_uniform_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(
        _u32(prng.random_bits32(tk, shape)),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0), (float(np.finfo(np.float32).tiny), 1.0)):
        t = prng.uniform(tk, shape, lo, hi).numpy()
        j = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(t.view(np.int32), j.view(np.int32))


def test_key_batches_equal_jax_vmap():
    jks = jax.random.split(jax.random.PRNGKey(3), 4)
    tks = torch.from_numpy(np.asarray(jks).astype(np.int64))
    data = np.array([1, 2, 2 ** 31 + 7, 0], np.uint32)
    np.testing.assert_array_equal(
        _u32(prng.fold_in(tks, torch.from_numpy(data.astype(np.int64)))),
        np.asarray(jax.vmap(jax.random.fold_in)(jks, data)))
    np.testing.assert_array_equal(
        _u32(prng.random_bits32(tks, (5,))),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5,), jnp.uint32))(jks)))
    np.testing.assert_array_equal(
        _u32(prng.split(tks, 3)),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jks)))
    u = prng.uniform(tks, (2, 5)).numpy()
    np.testing.assert_array_equal(
        u, np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2, 5)))(jks)))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(-2 ** 40, 2 ** 40),
       shape=st.sampled_from(SHAPES + [(1,), (2, 9), (9, 1, 2)]),
       data=st.integers(0, 2 ** 32 - 1))
def test_prng_property_equal_jax(seed, shape, data):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    jk2, tk2 = jax.random.fold_in(jk, np.uint32(data)), prng.fold_in(tk, data)
    np.testing.assert_array_equal(_u32(tk2), np.asarray(jk2))
    np.testing.assert_array_equal(
        _u32(prng.random_bits32(tk2, shape)),
        np.asarray(jax.random.bits(jk2, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(tk2, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk2, shape)))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_gumbel_within_two_ulps(seed):
    """The uniforms under the noise are bit-equal; the two logs of torch
    and XLA differ by an ulp in about a quarter of the draws."""
    t = prng.gumbel(prng.PRNGKey(seed), (4, 4096)).numpy()
    j = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (4, 4096)))
    scale = np.maximum(np.abs(j), 1.0)
    ulp = np.spacing(scale.astype(np.float32))
    assert (np.abs(t - j) <= 2 * ulp).all(), np.abs(t - j).max()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2 ** 31 + 9])
def test_categorical_indices_equal_jax(seed):
    l = np.random.RandomState(seed % 1000).randn(6, 300).astype(np.float32) * 2
    l[:, :7] = -np.inf                           # masked tokens never drawn
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    t = prng.categorical(tk, torch.from_numpy(l)).numpy()
    np.testing.assert_array_equal(t, np.asarray(jax.random.categorical(jk, l)))
    assert (t >= 7).all()
    # one key per row, as the reference vmaps
    jks = jax.random.split(jk, 6)
    tks = torch.from_numpy(np.asarray(jks).astype(np.int64))
    np.testing.assert_array_equal(
        prng.categorical(tks, torch.from_numpy(l)).numpy(),
        np.asarray(jax.vmap(jax.random.categorical)(jks, l)))
