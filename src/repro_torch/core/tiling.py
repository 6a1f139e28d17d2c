"""Tile selection strategies (QRMark Table 1): random, random_grid, fixed
(counterpart of ``repro.core.tiling``).

Offsets are drawn from one key per image through :mod:`prng`, which
reproduces JAX's threefry key stream, so the port picks exactly the
tiles the JAX package picks for the same keys.  ``random_grid`` (the
QRMark default) partitions the image into an axis-aligned grid of
l x l cells and samples one cell uniformly; ``random`` samples any
l x l window; ``fixed`` crops the top-left corner.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng

STRATEGIES = ("random", "random_grid", "fixed")


def tile_offsets(strategy: str, key: torch.Tensor, image_hw, tile: int,
                 batch: int) -> torch.Tensor:
    """Per-image (y, x) offsets, (batch, 2) int32, from ONE batch-shaped
    draw of ``key`` (a (2,) key), as the reference's ``tile_offsets``."""
    H, W = image_hw
    if strategy == "fixed":
        return torch.zeros((batch, 2), dtype=torch.int32,
                           device=key.device)
    if strategy == "random":
        ky, kx = prng.split(key, 2)
        y = prng.randint(ky, (batch,), 0, H - tile + 1)
        x = prng.randint(kx, (batch,), 0, W - tile + 1)
        return torch.stack([y, x], dim=1).to(torch.int32)
    if strategy == "random_grid":
        gy, gx = H // tile, W // tile
        k = prng.randint(key, (batch,), 0, gy * gx)
        return torch.stack([(k // gx) * tile, (k % gx) * tile],
                           dim=1).to(torch.int32)
    raise ValueError(f"unknown tiling strategy {strategy!r}")


def per_image_offsets(strategy: str, keys: torch.Tensor, image_hw,
                      tile: int) -> torch.Tensor:
    """Per-image (y, x) offsets, (b, 2) int32, from one key per image
    (``keys`` (b, 2)).  Image i's offset depends only on ``keys[i]`` —
    not on the batch size — so padding or splitting a batch leaves
    every image's tile choice unchanged."""
    H, W = image_hw
    b = keys.shape[0]
    if strategy == "fixed":
        return torch.zeros((b, 2), dtype=torch.int32, device=keys.device)
    if strategy == "random":
        k = prng.split(keys, 2)
        y = prng.randint(k[:, 0], (), 0, H - tile + 1)
        x = prng.randint(k[:, 1], (), 0, W - tile + 1)
        return torch.stack([y, x], dim=1).to(torch.int32)
    if strategy == "random_grid":
        gy, gx = H // tile, W // tile
        c = prng.randint(keys, (), 0, gy * gx)
        return (torch.stack([c // gx, c % gx], dim=1) * tile).to(
            torch.int32)
    raise ValueError(f"unknown tiling strategy {strategy!r}")


def tile_first_offsets(strategy: str, keys: torch.Tensor, *,
                       img_size: int, tile: int) -> torch.Tensor:
    """Offsets for the tile-first ingest path: they depend only on the
    per-image key and the static preprocessed geometry, so they are
    derived before ingest and handed to the tile-first ingest kernel."""
    return per_image_offsets(strategy, keys, (img_size, img_size), tile)


def extract_tiles(images: torch.Tensor, offsets: torch.Tensor,
                  tile: int) -> torch.Tensor:
    """images (b, H, W, C), offsets (b, 2) -> (b, tile, tile, C)."""
    b = images.shape[0]
    ar = torch.arange(tile, device=images.device)
    offs = offsets.to(device=images.device, dtype=torch.int64)
    rows = (offs[:, 0:1] + ar)[:, :, None]          # (b, tile, 1)
    cols = (offs[:, 1:2] + ar)[:, None, :]          # (b, 1, tile)
    bi = torch.arange(b, device=images.device)[:, None, None]
    return images[bi, rows, cols]


def select_tiles(strategy: str, key: torch.Tensor, images: torch.Tensor,
                 tile: int):
    """One batch-shaped draw of offsets, then the tiles:
    -> ((b, tile, tile, C) tiles, (b, 2) offsets)."""
    b, H, W, _ = images.shape
    offs = tile_offsets(strategy, key, (H, W), tile, b)
    return extract_tiles(images, offs, tile), offs


def select_tiles_per_image(strategy: str, keys: torch.Tensor,
                           images: torch.Tensor, tile: int):
    """Per-image-keyed :func:`select_tiles`: the staged ingest's tile
    choice on the full preprocessed images.  The gather is plain tensor
    indexing on the images' device (the reference slices with
    ``lax.dynamic_slice`` outside any Pallas kernel)."""
    _, H, W, _ = images.shape
    offs = per_image_offsets(strategy, keys, (H, W), tile)
    return extract_tiles(images, offs, tile), offs
