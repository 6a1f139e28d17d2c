"""PyTorch port: tile-first fused ingest against the JAX package.

The plain version (dense interpolation matmuls on the sliced matrices)
is held to the JAX kernel (interpret mode) within 1e-5 absolute
(normalised values lie in about [-2.2, 2.7]; the two stacks accumulate
the two nonzero taps of each row in their own order, a few float32
ulps), and to the kernel's oracle ``fused_tile_preprocess_ref`` within
3e-5 (the oracle divides by 255 before resizing and normalises as
(x - mean) / std, another rounding order; observed 1.7e-5).  The CUDA kernel's
host tables (two taps per row) must rebuild the reference's float32
interpolation matrices exactly, and a float32 emulation of the kernel's
gather arithmetic must agree with the plain version within the same
tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_tile_preprocess as ftp
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

ATOL = 1e-5
ORACLE_ATOL = 3e-5
# (raw, resize, crop, tile): the tests' small geometry, a downscale, and
# the full default (raw 288 = resize 288 -> crop 256, tile 64)
GEOMS = [(64, 40, 32, 16), (50, 36, 32, 16), (288, 288, 256, 64)]


def _case(raw_hw, crop, tile, b=5, k=None, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (b, raw_hw, raw_hw, 3), dtype=np.uint8)
    shape = (b, 2) if k is None else (b, k, 2)
    offs = rng.integers(0, crop - tile + 1, shape).astype(np.int32)
    flat = offs.reshape(-1, 2)
    flat[0] = (0, 0)                               # grid borders
    flat[-1] = (crop - tile, crop - tile)
    if flat.shape[0] > 2:
        flat[1] = (0, crop - tile)
    return raw, offs


@pytest.mark.parametrize("geom", GEOMS[:2])
@pytest.mark.parametrize("k", [None, 3])
def test_plain_matches_jax_kernel(geom, k):
    raw_hw, resize, crop, tile = geom
    raw, offs = _case(raw_hw, crop, tile, k=k)
    want = np.asarray(jops.fused_tile_preprocess(
        jnp.asarray(raw), jnp.asarray(offs), resize=resize, crop=crop,
        tile=tile))
    got = ops.fused_tile_preprocess(torch.as_tensor(raw),
                                    torch.as_tensor(offs), resize=resize,
                                    crop=crop, tile=tile)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("geom", GEOMS)
def test_plain_matches_reference_oracle(geom):
    raw_hw, resize, crop, tile = geom
    raw, offs = _case(raw_hw, crop, tile, b=2, seed=1)
    want = np.asarray(jref.fused_tile_preprocess_ref(
        jnp.asarray(raw), jnp.asarray(offs), resize=resize, crop=crop,
        tile=tile))
    got = ops.fused_tile_preprocess(torch.as_tensor(raw),
                                    torch.as_tensor(offs), resize=resize,
                                    crop=crop, tile=tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ORACLE_ATOL)


@pytest.mark.parametrize("n_in,n_out,crop", [(64, 40, 32), (288, 288, 256),
                                             (50, 36, 32), (30, 61, 55)])
def test_resize_matrix_and_taps_exact(n_in, n_out, crop):
    """The copy of ``resize_matrix`` equals the original bit for bit, and
    the kernel's (index, weight) taps rebuild it exactly — including
    edge-clamp rows, whose two taps were summed into one entry."""
    off = (n_out - crop) // 2
    m = ref.resize_matrix(n_in, n_out, off, crop)
    np.testing.assert_array_equal(m, jref.resize_matrix(n_in, n_out, off,
                                                        crop))
    idx, w = ftp._taps(m)
    rebuilt = np.zeros_like(m)
    for o in range(crop):
        for j in range(2):
            rebuilt[o, idx[o, j]] += w[o, j]
    np.testing.assert_array_equal(rebuilt, m)


def _gather_emulation(raw, offs, resize, crop, tile):
    """float32 numpy emulation of csrc/tile_preprocess.cu's arithmetic:
    vertical pass, horizontal pass, then scale and bias, each product
    and sum rounded separately (no FMA)."""
    b, H, W, _ = raw.shape
    ry_idx, ry_w, rx_idx, rx_w, scale, bias = (
        t.numpy() for t in ftp._device_tables(H, W, resize, crop, None,
                                              None, "cpu"))
    k = offs.shape[1] if offs.ndim == 3 else 1
    flat = np.clip(offs.reshape(-1, 2), 0, crop - tile)
    f32 = np.float32
    out = np.zeros((flat.shape[0], tile, tile, 3), f32)
    for t, (oy, ox) in enumerate(flat):
        img = raw[t // k].astype(f32)
        rows, cols = oy + np.arange(tile), ox + np.arange(tile)
        r0, r1 = ry_idx[rows, 0], ry_idx[rows, 1]
        wr0, wr1 = ry_w[rows, 0][:, None, None], ry_w[rows, 1][:, None, None]
        c0, c1 = rx_idx[cols, 0], rx_idx[cols, 1]
        wc0, wc1 = rx_w[cols, 0][None, :, None], rx_w[cols, 1][None, :, None]
        v0 = f32(wr0 * img[r0][:, c0]) + f32(wr1 * img[r1][:, c0])
        v1 = f32(wr0 * img[r0][:, c1]) + f32(wr1 * img[r1][:, c1])
        h = f32(v0 * wc0) + f32(v1 * wc1)
        out[t] = f32(h * scale) + bias
    return out


@pytest.mark.parametrize("geom", GEOMS)
def test_gather_arithmetic_matches_plain(geom):
    raw_hw, resize, crop, tile = geom
    raw, offs = _case(raw_hw, crop, tile, b=2, k=2, seed=2)
    want = ops.fused_tile_preprocess(torch.as_tensor(raw),
                                     torch.as_tensor(offs), resize=resize,
                                     crop=crop, tile=tile).numpy()
    got = _gather_emulation(raw, offs, resize, crop, tile)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_offsets_clamp_like_dynamic_slice():
    raw, offs = _case(64, 32, 16, b=2)
    bad = np.array([[-4, 40], [17, -1]], np.int32)
    got = ops.fused_tile_preprocess(torch.as_tensor(raw),
                                    torch.as_tensor(bad), resize=40,
                                    crop=32, tile=16)
    want = ops.fused_tile_preprocess(
        torch.as_tensor(raw), torch.as_tensor(np.clip(bad, 0, 16)),
        resize=40, crop=32, tile=16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
