"""Tile-first fused Resize -> Crop -> Normalize -> Tile-extract
(counterpart of ``repro.kernels.fused_tile_preprocess``).

The staged transform is two interpolation matmuls per channel,
``full[c] = scale_c * (Ry @ img_c @ Rx) + bias_c``, so the (y, x) tile
of the output only needs rows [y, y+l) of ``Ry`` and columns [x, x+l)
of ``Rx``: ingest computes exactly the (n, l, l, 3) decode input and
never the full preprocessed image.

* :func:`fused_tile_preprocess_plain` — the JAX kernel's dense form
  (``interp_affine`` on the per-image sliced matrices) in PyTorch;
* :func:`fused_tile_preprocess_cuda` — the hand-written CUDA kernel
  (``csrc/tile_preprocess.cu``): a gather with two taps per axis, whose
  (index, weight) pairs are read off the same float32 matrices; a block
  owns rows of one tile, a thread one pixel.  Its constant inputs (the
  pairs and the affine, one device buffer) and the launch's integer
  arguments are made once per geometry (:func:`ingest_geometry`), so a
  call allocates its output and launches.

Offsets are (b, 2) — one tile per image, output (b, l, l, 3) — or
(b, k, 2) — k tiles per image, output (b*k, l, l, 3) image-major.
Offsets are clamped to [0, crop - l] as ``lax.dynamic_slice`` clamps
them in the reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_preprocess import (affine, hashable,
                                                  ingest_tables,
                                                  interp_affine,
                                                  interp_matrices)


def _check(raw: torch.Tensor, offsets: torch.Tensor, crop: int,
           tile: int):
    if raw.dim() != 4 or raw.shape[-1] != 3:
        raise ValueError(f"raw must be (b, H, W, 3), got {tuple(raw.shape)}")
    if offsets.dim() not in (2, 3) or offsets.shape[-1] != 2 or \
            offsets.shape[0] != raw.shape[0]:
        raise ValueError(f"offsets must be (b, 2) or (b, k, 2) for b="
                         f"{raw.shape[0]}, got {tuple(offsets.shape)}")
    if tile > crop:
        raise ValueError(f"tile {tile} exceeds crop {crop}")


def _clamped(offsets: torch.Tensor, crop: int, tile: int) -> torch.Tensor:
    return offsets.reshape(-1, 2).to(torch.int64).clamp(0, crop - tile)


def slice_interp_matrices(offsets: torch.Tensor, *, H: int, W: int,
                          resize: int, crop: int, tile: int):
    """Per-tile (n, tile, H) row / (n, W, tile) column slices of the
    shared interpolation matrices at (b, 2) or (b, k, 2) offsets."""
    ry, rx = interp_matrices(H, W, resize=resize, crop=crop)
    ry = torch.as_tensor(ry, device=offsets.device)
    rx = torch.as_tensor(rx, device=offsets.device)
    offs = _clamped(offsets, crop, tile)
    ar = torch.arange(tile, device=offsets.device)
    return (ry[offs[:, 0:1] + ar],                       # (n, tile, H)
            rx[:, offs[:, 1:2] + ar].permute(1, 0, 2))   # (n, W, tile)


def fused_tile_preprocess_plain(raw: torch.Tensor, offsets: torch.Tensor,
                                *, resize: int, crop: int, tile: int,
                                mean=None, std=None) -> torch.Tensor:
    """uint8 (b, H, W, 3) + offsets -> f32 tiles, as dense matmuls on
    the sliced interpolation matrices (the JAX kernel's arithmetic)."""
    _check(raw, offsets, crop, tile)
    b, H, W, _ = raw.shape
    k = offsets.shape[1] if offsets.dim() == 3 else 1
    ry_t, rx_t = slice_interp_matrices(offsets, H=H, W=W, resize=resize,
                                       crop=crop, tile=tile)
    img = raw.to(torch.float32).repeat_interleave(k, dim=0)
    scale, bias = (torch.as_tensor(a, device=raw.device)
                   for a in affine(mean, std))
    return interp_affine(img, ry_t, rx_t, scale, bias)


class IngestGeometry(NamedTuple):
    """What a tile-first ingest call of one geometry launches with:
    the kernel's tables on the device (``ingest_tables``) and their
    address, the output's shape and the launch's integer arguments (n,
    k, H, W, tile, crop)."""
    tables: torch.Tensor
    tables_ptr: int
    out_shape: tuple
    ints: tuple


@functools.lru_cache(maxsize=64)
def ingest_geometry(raw_shape, offsets_shape, device, resize: int,
                    crop: int, tile: int, mean, std) -> IngestGeometry:
    """The :class:`IngestGeometry` of these shapes and options on
    ``device``, made once (raises ValueError for shapes the op does not
    take); ``mean`` / ``std`` as ``hashable`` gives them."""
    _check(torch.empty(raw_shape, device="meta"),
           torch.empty(offsets_shape, device="meta"), crop, tile)
    b, H, W, _ = raw_shape
    k = offsets_shape[1] if len(offsets_shape) == 3 else 1
    tables = ingest_tables(H, W, resize, crop, mean, std, str(device))
    return IngestGeometry(tables, tables.data_ptr(), (b * k, tile, tile, 3),
                          (b * k, k, H, W, tile, crop))


def fused_tile_preprocess_cuda(raw: torch.Tensor, offsets: torch.Tensor,
                               *, resize: int, crop: int, tile: int,
                               mean=None, std=None) -> torch.Tensor:
    """The CUDA kernel: same contract as the plain version."""
    dev = raw.device
    if dev.type != "cuda" or offsets.device != dev:
        raise ValueError("fused_tile_preprocess_cuda needs raw and offsets "
                         "on one CUDA device")
    if raw.dtype != torch.uint8 or offsets.dtype != torch.int32:
        raise TypeError(f"need uint8 raw and int32 offsets, got "
                        f"{raw.dtype} / {offsets.dtype}")
    if not (raw.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("raw and offsets must be contiguous")
    geo = ingest_geometry(raw.shape, offsets.shape, dev, resize, crop, tile,
                          None if mean is None else hashable(mean),
                          None if std is None else hashable(std))
    out = torch.empty(geo.out_shape, dtype=torch.float32, device=dev)
    if geo.ints[0]:
        _build.check("qr_tile_preprocess", _build.library().qr_tile_preprocess(
            raw.data_ptr(), offsets.data_ptr(), geo.tables_ptr,
            out.data_ptr(), *geo.ints, _build.current_stream(dev)))
        _build.launch_counts["fused_tile_preprocess"] += 1
    return out
