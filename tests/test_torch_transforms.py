"""PyTorch port: the staged ingest against the JAX package — the unfused
``preprocess_reference`` (antialiased bilinear resize, crop, normalise),
the fused full-image ingest's plain version, and the staged tile
selection.

Tolerances: 1e-5 absolute on normalised pixels (values in about
[-2.2, 2.7]; the two stacks accumulate the resize products in their own
order, a few float32 ulps).  Offsets and selected tiles are exact.

One reference caveat, not a port fault: ``jax.image.resize`` runs
jitted, and XLA's compiled column normalisation of the antialiased
weight matrix is not exact division (at 400 -> 288 its weights differ
from JAX's own eager ``compute_weight_mat`` by up to 8e-6, and its
output from a float64 resize on the same weights by 1.3e-5).  The port
builds the eager weights exactly (checked here); the parity tests use
the small geometries, where XLA's rounding stays within the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from repro.core import tiling as jtiling
from repro.core import transforms as jtransforms
from repro.kernels import ops as jops
from repro_torch.core import prng, tiling, transforms
from repro_torch.kernels import fused_preprocess as fp
from repro_torch.kernels import ops

torch.set_num_threads(1)

ATOL = 1e-5


def _raw(hw, b=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, hw, hw, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n_in,n_out,antialias", [
    (64, 40, True), (24, 40, True), (400, 288, True), (400, 288, False)])
def test_resize_weights_equal_jax_eager(n_in, n_out, antialias):
    want = np.asarray(jscale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jscale._fill_triangle_kernel,
        antialias))
    got = transforms.resize_weights(n_in, n_out, antialias)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("raw_hw,resize,crop", [
    (64, 40, 32),     # downscale (antialiased)
    (24, 40, 32),     # upscale
    (40, 40, 32)])    # scale 1: the resize is skipped, as in JAX
def test_preprocess_reference_matches_jax(raw_hw, resize, crop):
    raw = _raw(raw_hw)
    want = np.asarray(jtransforms.preprocess_reference(
        jnp.asarray(raw), resize=resize, crop=crop))
    got = transforms.preprocess_reference(torch.as_tensor(raw),
                                          resize=resize, crop=crop)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("raw_hw,resize,crop,b", [
    (64, 40, 32, 3), (50, 36, 32, 3), (288, 288, 256, 1)])
def test_fused_preprocess_plain_matches_jax_kernel(raw_hw, resize, crop, b):
    raw = _raw(raw_hw, b=b, seed=1)
    want = np.asarray(jops.fused_preprocess(jnp.asarray(raw), resize=resize,
                                            crop=crop))
    got = ops.fused_preprocess(torch.as_tensor(raw), resize=resize,
                               crop=crop)
    assert got.shape == want.shape == (b, crop, crop, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_fused_preprocess_taps_rebuild_matrices():
    """The CUDA kernel's tables (two taps per row) rebuild the dense
    matrices the plain version multiplies by, exactly."""
    ry, rx = fp.interp_matrices(50, 50, resize=36, crop=32)
    for m in (ry, np.ascontiguousarray(rx.T)):
        idx, w = fp.taps(m)
        rebuilt = np.zeros_like(m)
        for o in range(m.shape[0]):
            for j in range(2):
                rebuilt[o, idx[o, j]] += w[o, j]
        np.testing.assert_array_equal(rebuilt, m)


@pytest.mark.parametrize("strategy", ["random_grid", "random", "fixed"])
def test_select_tiles_per_image_matches_jax(strategy):
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (5, 32, 32, 3)).astype(np.float32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.key(4), i))(jnp.arange(5))
    tkeys = prng.fold_in(prng.key(4)[None].expand(5, 2),
                         torch.arange(5, dtype=torch.int64))
    jt, jo = jtiling.select_tiles_per_image(strategy, jkeys,
                                            jnp.asarray(x), 16)
    tt, to = tiling.select_tiles_per_image(strategy, tkeys,
                                           torch.as_tensor(x), 16)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("strategy", ["random_grid", "random", "fixed"])
def test_select_tiles_batch_draw_matches_jax(strategy):
    x = np.random.default_rng(5).uniform(-2, 2, (6, 32, 32, 3)).astype(
        np.float32)
    jt, jo = jtiling.select_tiles(strategy, jax.random.key(9),
                                  jnp.asarray(x), 16)
    tt, to = tiling.select_tiles(strategy, prng.key(9), torch.as_tensor(x),
                                 16)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
