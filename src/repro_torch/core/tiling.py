"""Tile selection strategies (QRMark Table 1): random, random_grid, fixed
(counterpart of ``repro.core.tiling``).

Offsets are drawn from one key per image through :mod:`prng`, which
reproduces JAX's threefry key stream, so the port picks exactly the
tiles the JAX package picks for the same keys.  ``random_grid`` (the
QRMark default) partitions the image into an axis-aligned grid of
l x l cells and samples one cell uniformly; ``random`` samples any
l x l window; ``fixed`` crops the top-left corner.

Escalation plans (:func:`escalation_offsets`) extend the one-tile draw
to k tiles an image: column 0 is the one-tile draw itself, the other
columns come from keys folded with ``_ESC_SALT``.
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


def extract_tiles_k(images: torch.Tensor, plans: torch.Tensor,
                    tile: int) -> torch.Tensor:
    """images (b, H, W, C) + plans (b, k, 2) -> (b*k, tile, tile, C),
    image-major (rows [i*k, (i+1)*k) are image i's tiles: the layout of
    the tile-first kernel's (b, k, 2) form)."""
    b, k = plans.shape[:2]
    return extract_tiles(images.repeat_interleave(k, dim=0),
                         plans.reshape(b * k, 2), tile)


# fold_in salt for the extra escalation tile draws: keeps columns 1..k-1
# independent of the column-0 draw without disturbing it
_ESC_SALT = 0x5AFE


def max_escalation_tiles(strategy: str, image_hw, tile: int) -> int:
    """Largest usable ``k`` for :func:`escalation_offsets`: the grid's
    cells for ``random_grid`` and ``fixed``, unbounded (2^30) for
    ``random``, whose windows may overlap."""
    H, W = image_hw
    if strategy in ("random_grid", "fixed"):
        return max(1, (H // tile) * (W // tile))
    return 2 ** 30


def _cells_to_offsets(cells: torch.Tensor, gx: int, tile: int
                      ) -> torch.Tensor:
    return (torch.stack([cells // gx, cells % gx], dim=-1) * tile).to(
        torch.int32)


def escalation_offsets(strategy: str, keys: torch.Tensor, image_hw,
                       tile: int, k: int) -> torch.Tensor:
    """Per-image k-tile escalation plans: (b, k, 2) int32 offsets from
    one key per image (``keys`` (b, 2)).  Column 0 is
    :func:`per_image_offsets`' own output, so round 1 decodes the tile
    the one-tile pipeline picks.  The other columns:

    * ``random_grid``: the grid cells in the order of
      ``prng.permutation(fold_in(key, _ESC_SALT), gy * gx)`` with column
      0's cell moved to the end by a stable sort, so no cell repeats;
    * ``fixed``: the grid cells in raster order from the top left;
    * ``random``: column j drawn from ``fold_in(key, _ESC_SALT + j)``.

    Image i's plan depends only on ``keys[i]`` and the geometry."""
    H, W = image_hw
    if k < 1:
        raise ValueError(f"escalation needs k >= 1, got {k}")
    cap = max_escalation_tiles(strategy, image_hw, tile)
    if k > cap:
        raise ValueError(
            f"strategy {strategy!r} on {H}x{W}/{tile} supports at most "
            f"{cap} distinct tiles, got k={k}")
    col0 = per_image_offsets(strategy, keys, image_hw, tile)
    b = keys.shape[0]
    gx = W // tile
    if strategy == "fixed":
        cells = torch.arange(k, dtype=torch.int64, device=keys.device)
        plan = _cells_to_offsets(cells, gx, tile)[None].repeat(b, 1, 1)
        plan[:, 0] = col0
        return plan
    if strategy == "random":
        extra = [per_image_offsets(strategy,
                                   prng.fold_in(keys, _ESC_SALT + j),
                                   image_hw, tile) for j in range(1, k)]
        return torch.stack([col0, *extra], dim=1)
    if strategy == "random_grid":
        if k == 1:
            return col0[:, None, :]
        n_cells = (H // tile) * gx
        c0 = (col0[:, 0] // tile) * gx + col0[:, 1] // tile
        perm = prng.permutation(prng.fold_in(keys, _ESC_SALT), n_cells)
        order = torch.argsort((perm == c0[:, None]).to(torch.int32),
                              dim=1, stable=True)
        cells = torch.gather(perm, 1, order)[:, : k - 1].to(torch.int64)
        return torch.cat([col0[:, None, :],
                          _cells_to_offsets(cells, gx, tile)], dim=1)
    raise ValueError(f"unknown tiling strategy {strategy!r}")
