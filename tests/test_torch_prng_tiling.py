"""PyTorch port: the threefry key stream and tile offsets against JAX.

Keys, ``fold_in``, ``split``, ``randint`` and the per-image offsets of
all three tiling strategies must be exactly equal to ``jax.random`` and
``repro.core.tiling`` (jax_threefry_partitionable, 64-bit mode off) —
otherwise the port decodes other tiles than the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiling as jtiling
from repro_torch.core import prng, tiling

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1, -3]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_exact(seed):
    k, jk = prng.key(seed), jax.random.key(seed)
    np.testing.assert_array_equal(k.numpy(), _kd(jk))
    for d in (0, 1, 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(k, d).numpy(),
            _kd(jax.random.fold_in(jk, np.uint32(d))))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(prng.split(k, n).numpy(),
                                      _kd(jax.random.split(jk, n)))


@pytest.fixture(scope="module")
def jkeys64():
    return jax.jit(jax.vmap(
        lambda i: jax.random.fold_in(jax.random.key(11), i)))(
            jnp.arange(64))


# minval/maxval traced, so one compile serves every bound pair
_jrandint = jax.jit(lambda keys, lo, hi: jax.vmap(
    lambda kk: jax.random.randint(kk, (3,), lo, hi))(keys))
_jrandint_scalar = jax.jit(lambda k, lo, hi: jax.random.randint(k, (), lo,
                                                                hi))


@pytest.mark.parametrize("lo,hi", [(0, 16), (0, 1), (0, 193), (-5, 37),
                                   (4, 4), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 2 ** 31 - 1)])
def test_randint_exact(jkeys64, lo, hi):
    keys = torch.as_tensor(_kd(jkeys64))
    bounds = (np.int32(lo), np.int32(hi))
    got = prng.randint(keys, (3,), lo, hi).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jrandint(jkeys64,
                                                            *bounds)))
    np.testing.assert_array_equal(
        prng.randint(keys[0], (), lo, hi).numpy(),
        np.asarray(_jrandint_scalar(jkeys64[0], *bounds)))


SEEDS, N_BATCHES, MAX_B = (0, 3, 99), 4, 32
GEOMS = ((256, 64), (32, 16), (100, 24))
STRATEGIES = ("random", "random_grid", "fixed")


@pytest.fixture(scope="module")
def jax_offsets():
    """The reference's per-image keys fold_in(fold_in(key(seed), batch),
    i) for 3 seeds x 4 batches x 32 images, and its offsets for every
    strategy and geometry.  Image i's key and offset do not depend on
    the batch size, so a batch of b images is the first b columns."""
    def image_keys(seed, batch):
        bkey = jax.random.fold_in(jax.random.key(seed), batch)
        return jax.vmap(lambda i: jax.random.fold_in(bkey, i))(
            jnp.arange(MAX_B))
    s, t = np.meshgrid(SEEDS, np.arange(N_BATCHES), indexing="ij")
    keys = jax.jit(jax.vmap(image_keys))(jnp.asarray(s.ravel()),
                                         jnp.asarray(t.ravel()))
    flat = keys.reshape(-1)
    offs = jax.jit(lambda k: {
        (st, g): jtiling.tile_first_offsets(st, k, img_size=g[0],
                                            tile=g[1])
        for st in STRATEGIES for g in GEOMS})(flat)
    return _kd(keys), {k: np.asarray(v).reshape(len(SEEDS) * N_BATCHES,
                                                MAX_B, 2)
                       for k, v in offs.items()}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("b", [1, 5, 32])
def test_per_image_offsets_exact(jax_offsets, strategy, b):
    """The port's per-image keys and offsets equal the reference's for
    every image over 12 batch keys (3 seeds x 4 batches) and three
    geometries."""
    jkeys, joffs = jax_offsets
    keys = torch.stack([
        prng.fold_in(prng.fold_in(prng.key(seed), batch)[None]
                     .expand(b, 2), torch.arange(b))
        for seed in SEEDS for batch in range(N_BATCHES)])
    np.testing.assert_array_equal(keys.numpy(), jkeys[:, :b])
    for g in GEOMS:
        got = torch.stack([tiling.tile_first_offsets(
            strategy, k, img_size=g[0], tile=g[1]) for k in keys])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      joffs[(strategy, g)][:, :b])


def test_extract_tiles_matches_reference():
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((5, 40, 40, 3)).astype(np.float32)
    offs = rng.integers(0, 25, (5, 2)).astype(np.int32)
    want = np.asarray(jtiling.extract_tiles(jnp.asarray(imgs),
                                            jnp.asarray(offs), 16))
    got = tiling.extract_tiles(torch.as_tensor(imgs), torch.as_tensor(offs),
                               16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unknown_strategy_raises():
    with pytest.raises(ValueError):
        tiling.per_image_offsets("spiral", prng.key(0)[None], (32, 32), 16)
