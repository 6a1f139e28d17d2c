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
tolerance; a block-by-block model of the kernel (its launch shape,
clamped offsets and rows, and its one tables buffer read at the
kernel's offsets) must write every pixel once and equal that emulation
bit for bit.  The staged (full-image) ingest runs the same kernel on the
one tile of side crop at (0, 0), kStagedPixels / crop rows a block: its
model writes every pixel once, equals the emulation bit for bit, the
plain ``fused_preprocess_plain`` exactly where the resize is the
identity (every weight 0 or 1) and within the tolerance elsewhere (the
plain version's matmul rounds the two taps' sum in its own order), and
its tile gather equals the tile-first model bit for bit.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_preprocess as fp
from repro_torch.kernels import fused_tile_preprocess as ftp
from repro_torch.kernels import _build, ops, ref

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
    idx, w = fp.taps(m)
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
        t.numpy() for t in fp.device_tables(H, W, resize, crop, None,
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


CU = " ".join((_build.CSRC / "tile_preprocess.cu").read_text().split())
STAGED_PIXELS = int(re.search(r"constexpr int kStagedPixels = (\d+);",
                              CU).group(1))


def _kernel_model(raw, offs, n, k, resize, crop, tile, rows):
    """float32 numpy model of ``tile_preprocess_kernel`` block by block:
    n tiles of side ``tile``, ``rows`` rows of one tile a block, the
    block's clamped offsets (none: the one tile at (0, 0)) and rows, and
    its (index, weight) pairs read from the one tables buffer of
    ``ingest_tables`` at the kernel's offsets (row pairs at 0, their
    weights at 2 crop, column pairs at 4 crop, theirs at 6 crop, the
    affine at 8 crop); each pixel through ``interp_pixel``'s arithmetic.
    Returns the output and each pixel's writes."""
    b, H, W, _ = raw.shape
    tables = ftp.ingest_tables(H, W, resize, crop, None, None, "cpu").numpy()
    f32 = np.float32
    ry_idx, rx_idx = tables[:2 * crop], tables[4 * crop:6 * crop]
    ry_w, rx_w, aff = (tables[a:z].view(f32) for a, z in (
        (2 * crop, 4 * crop), (6 * crop, 8 * crop), (8 * crop, 8 * crop + 6)))
    groups = -(-tile // rows)
    out = np.full((n, tile, tile, 3), np.nan, f32)
    writes = np.zeros((n, tile, tile), np.int64)
    for block in range(n * groups):
        t, r0 = block // groups, (block % groups) * rows
        nr = min(rows, tile - r0)
        if offs is None:
            oy, ox = r0, 0
        else:
            oy = min(max(int(offs[t, 0]), 0), crop - tile) + r0
            ox = min(max(int(offs[t, 1]), 0), crop - tile)
        img = raw[t // k].astype(f32)
        i, j = np.divmod(np.arange(nr * tile), tile)  # the block's pixels
        r = 2 * (oy + i)
        c = 2 * (ox + j)
        for ch in range(3):
            def px(rr, cc):
                return img[ry_idx[rr], rx_idx[cc], ch]
            wr0, wr1, wc0, wc1 = ry_w[r], ry_w[r + 1], rx_w[c], rx_w[c + 1]
            v0 = f32(wr0 * px(r, c)) + f32(wr1 * px(r + 1, c))
            v1 = f32(wr0 * px(r, c + 1)) + f32(wr1 * px(r + 1, c + 1))
            h = f32(v0 * wc0) + f32(v1 * wc1)
            out[t, r0 + i, j, ch] = f32(h * aff[ch]) + aff[3 + ch]
        writes[t, r0 + i, j] += 1
    return out, writes


def _tile_kernel_model(raw, offs, resize, crop, tile):
    """The tile-first launch: 256 // tile rows of one tile a block."""
    k = offs.shape[1] if offs.ndim == 3 else 1
    flat = offs.reshape(-1, 2)
    out, writes = _kernel_model(raw, flat, flat.shape[0], k, resize, crop,
                                tile, 256 // tile if tile < 256 else 1)
    assert (writes == 1).all()
    return out


def _staged_kernel_model(raw, resize, crop):
    """The staged launch (``qr_preprocess``): each image's one tile of
    side crop at (0, 0), kStagedPixels // crop rows a block."""
    rows = STAGED_PIXELS // crop if crop < STAGED_PIXELS else 1
    return _kernel_model(raw, None, raw.shape[0], 1, resize, crop, crop,
                         rows)


@pytest.mark.parametrize("geom", GEOMS + [(40, 40, 40, 20)])
def test_tile_kernel_blocks_match_gather_emulation(geom):
    """The redesigned kernel's index math and tables buffer: every output
    pixel written once, equal to the gather emulation bit for bit and to
    the plain version within the tolerance; offsets past either edge
    clamp; a tile that the block rows do not divide (20 = 12 + 8)."""
    raw_hw, resize, crop, tile = geom
    raw, offs = _case(raw_hw, crop, tile, b=2, k=2, seed=3)
    offs.reshape(-1, 2)[1] = (-5, crop)              # clamped, both edges
    got = _tile_kernel_model(raw, offs, resize, crop, tile)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(
        got, _gather_emulation(raw, offs, resize, crop, tile))
    want = ops.fused_tile_preprocess(torch.as_tensor(raw),
                                     torch.as_tensor(offs), resize=resize,
                                     crop=crop, tile=tile).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    tables = ftp.ingest_tables(raw_hw, raw_hw, resize, crop, None, None,
                               "cpu")
    assert tables.dtype == torch.int32 and tables.shape == (8 * crop + 6,)


@pytest.mark.parametrize("geom", [(288, 288, 256, 64), (400, 288, 256, 64),
                                  (64, 40, 32, 16)])
def test_staged_kernel_blocks_match_plain(geom):
    """The staged ingest's launch of the tile kernel: every pixel of each
    (crop, crop) image written once; equal to the gather emulation at
    offset (0, 0) bit for bit, to ``fused_preprocess_plain`` exactly at
    the identity resize (288 -> 288 -> 256) and within ATOL at the
    others; its tiles (``tiling.extract_tiles``) equal the tile-first
    model's at the same offsets bit for bit."""
    from repro_torch.core import tiling
    raw_hw, resize, crop, tile = geom
    raw, offs = _case(raw_hw, crop, tile, b=2, seed=4)
    got, writes = _staged_kernel_model(raw, resize, crop)
    assert (writes == 1).all()
    zero = np.zeros((2, 2), np.int32)
    np.testing.assert_array_equal(
        got, _gather_emulation(raw, zero, resize, crop, crop))
    want = fp.fused_preprocess_plain(torch.as_tensor(raw), resize=resize,
                                     crop=crop).numpy()
    if resize == raw_hw:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    staged = tiling.extract_tiles(torch.as_tensor(got),
                                  torch.as_tensor(offs), tile).numpy()
    np.testing.assert_array_equal(
        staged, _tile_kernel_model(raw, offs, resize, crop, tile))
    for expr in (
            "constexpr int kStagedPixels = 1024;",
            "const int rows = crop < kStagedPixels ? kStagedPixels / crop : "
            "1;",
            "tile_preprocess_kernel<<<b * groups, kIngestThreads, "
            "ingest_smem(rows, crop), (cudaStream_t)stream>>>( "
            "(const uint8_t*)raw, nullptr, (const int*)tables, (float*)out, "
            "1, H, W, crop, crop, rows);",
            "const int oy = (offsets ? min(max(offsets[2 * t], 0), max_off) "
            ": 0) + r0;",
            "const int ox = offsets ? min(max(offsets[2 * t + 1], 0), "
            "max_off) : 0;",
            "const uint8_t* im = raw + (long long)(t / k) * H * W * 3;"):
        assert expr in CU, expr
