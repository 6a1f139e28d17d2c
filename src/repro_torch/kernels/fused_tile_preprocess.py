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
  (index, weight) pairs are read off the same float32 matrices.

Offsets are (b, 2) — one tile per image, output (b, l, l, 3) — or
(b, k, 2) — k tiles per image, output (b*k, l, l, 3) image-major.
Offsets are clamped to [0, crop - l] as ``lax.dynamic_slice`` clamps
them in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.transforms import IMAGENET_MEAN, IMAGENET_STD
from repro_torch.kernels import _build
from repro_torch.kernels.fused_preprocess import (interp_affine,
                                                  interp_matrices)


def _affine(mean, std):
    """Normalisation as a per-channel affine on raw bytes, float32 as
    the reference computes it: scale = 1/(255*std), bias = -mean/std."""
    mean = np.asarray(IMAGENET_MEAN if mean is None else mean, np.float32)
    std = np.asarray(IMAGENET_STD if std is None else std, np.float32)
    return (np.asarray(1.0 / (255.0 * std), np.float32),
            np.asarray(-mean / std, np.float32))


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
                   for a in _affine(mean, std))
    return interp_affine(img, ry_t, rx_t, scale, bias)


def _taps(m: np.ndarray):
    """(rows, n_in) interpolation matrix -> per-row (index, weight)
    pairs of its nonzeros, ascending index.  A row with one nonzero (an
    edge-clamp row whose two taps were summed into one entry, or an
    exact-integer source position) gets (i, i) with weights (w, 0)."""
    rows = m.shape[0]
    idx = np.zeros((rows, 2), np.int32)
    wgt = np.zeros((rows, 2), np.float32)
    for o in range(rows):
        nz = np.nonzero(m[o])[0]
        if not 1 <= nz.size <= 2:
            raise ValueError(f"interpolation row {o} has {nz.size} "
                             f"nonzeros; the kernel takes 1 or 2")
        idx[o, :nz.size] = nz
        idx[o, nz.size:] = nz[0]
        wgt[o, :nz.size] = m[o, nz]
    return idx, wgt


def _hashable(a):
    return None if a is None else tuple(
        float(v) for v in np.asarray(a, np.float32))


@functools.lru_cache(maxsize=16)
def _device_tables(H: int, W: int, resize: int, crop: int, mean, std,
                   device: str):
    """The kernel's constant inputs on ``device``: row/column taps of
    the (crop, H) / (W, crop) matrices and the normalising affine."""
    ry, rx = interp_matrices(H, W, resize=resize, crop=crop)
    ry_idx, ry_w = _taps(ry)
    rx_idx, rx_w = _taps(np.ascontiguousarray(rx.T))
    scale, bias = _affine(mean, std)
    return tuple(torch.as_tensor(a, device=device) for a in
                 (ry_idx, ry_w, rx_idx, rx_w, scale, bias))


def fused_tile_preprocess_cuda(raw: torch.Tensor, offsets: torch.Tensor,
                               *, resize: int, crop: int, tile: int,
                               mean=None, std=None) -> torch.Tensor:
    """The CUDA kernel: same contract as the plain version."""
    _check(raw, offsets, crop, tile)
    if raw.device.type != "cuda" or offsets.device != raw.device:
        raise ValueError("fused_tile_preprocess_cuda needs raw and offsets "
                         "on one CUDA device")
    if raw.dtype != torch.uint8 or offsets.dtype != torch.int32:
        raise TypeError(f"need uint8 raw and int32 offsets, got "
                        f"{raw.dtype} / {offsets.dtype}")
    if not (raw.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("raw and offsets must be contiguous")
    b, H, W, _ = raw.shape
    k = offsets.shape[1] if offsets.dim() == 3 else 1
    n = b * k
    tables = _device_tables(H, W, resize, crop, _hashable(mean),
                            _hashable(std), str(raw.device))
    out = torch.empty((n, tile, tile, 3), dtype=torch.float32,
                      device=raw.device)
    if n:
        err = _build.library().qr_tile_preprocess(
            raw.data_ptr(), offsets.data_ptr(),
            *(t.data_ptr() for t in tables), out.data_ptr(), n, k, H, W,
            tile, crop, torch.cuda.current_stream(raw.device).cuda_stream)
        _build.check("qr_tile_preprocess", err)
        _build.launch_counts["fused_tile_preprocess"] += 1
    return out
