"""Fused Resize -> CenterCrop -> Normalize, full image (counterpart of
``repro.kernels.fused_preprocess``), and the interpolation helpers it
shares with the tile-first ingest (``fused_tile_preprocess.py``).

The staged transform is two interpolation matmuls per channel,
``full[c] = scale_c * (Ry @ img_c @ Rx) + bias_c``, with ``Ry``
(crop, H) and ``Rx`` (W, crop) from ``ref.resize_matrix`` and the
normalisation folded into a per-channel affine.

* :func:`fused_preprocess_plain` — the JAX kernel's dense form
  (``interp_affine`` on the whole matrices) in PyTorch;
* :func:`fused_preprocess_cuda` — the hand-written CUDA kernel
  (``csrc/tile_preprocess.cu``): the tile-first kernel,
  ``tile_preprocess_kernel``, on the one tile of side ``crop`` at
  (0, 0) of each image, a block whole output rows of one image.  Each
  pixel goes through the same device function as a tile-first pixel, so
  staged ingest followed by ``tiling.extract_tiles`` equals tile-first
  ingest bit for bit on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.transforms import IMAGENET_MEAN, IMAGENET_STD
from repro_torch.kernels import _build
from repro_torch.kernels.ref import resize_matrix


def interp_affine(img: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Per-channel ``Ry @ img_c @ Rx`` then the normalising affine, in
    the JAX kernel's order (vertical pass, horizontal pass, scale,
    bias).  img (..., H, W, 3) f32; ry (..., rows, H); rx (..., W, cols)
    -> (..., rows, cols, 3); leading dimensions broadcast."""
    outs = []
    for c in range(3):
        t = torch.matmul(ry, img[..., c])
        t = torch.matmul(t, rx)
        outs.append(t * scale[c] + bias[c])
    return torch.stack(outs, dim=-1)


def interp_matrices(H: int, W: int, *, resize: int, crop: int):
    """The (crop, H) row / (W, crop) column interpolation matrices of
    the resize+centercrop composition, as numpy float32."""
    off = (resize - crop) // 2
    ry = resize_matrix(H, resize, off, crop)          # (crop, H)
    rx = resize_matrix(W, resize, off, crop).T        # (W, crop)
    return ry, np.ascontiguousarray(rx)


def affine(mean, std):
    """Normalisation as a per-channel affine on raw bytes, float32 as
    the reference computes it: scale = 1/(255*std), bias = -mean/std."""
    mean = np.asarray(IMAGENET_MEAN if mean is None else mean, np.float32)
    std = np.asarray(IMAGENET_STD if std is None else std, np.float32)
    return (np.asarray(1.0 / (255.0 * std), np.float32),
            np.asarray(-mean / std, np.float32))


def taps(m: np.ndarray):
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


def hashable(a):
    return None if a is None else tuple(
        float(v) for v in np.asarray(a, np.float32))


@functools.lru_cache(maxsize=16)
def device_tables(H: int, W: int, resize: int, crop: int, mean, std,
                  device: str):
    """The ingest kernels' constant inputs on ``device``: row/column
    taps of the (crop, H) / (W, crop) matrices and the normalising
    affine."""
    ry, rx = interp_matrices(H, W, resize=resize, crop=crop)
    ry_idx, ry_w = taps(ry)
    rx_idx, rx_w = taps(np.ascontiguousarray(rx.T))
    scale, bias = affine(mean, std)
    return tuple(torch.as_tensor(a, device=device) for a in
                 (ry_idx, ry_w, rx_idx, rx_w, scale, bias))


@functools.lru_cache(maxsize=64)
def ingest_tables(H: int, W: int, resize: int, crop: int, mean, std,
                  device: str) -> torch.Tensor:
    """The ingest kernel's constant input, one int32 buffer on
    ``device``, made once a geometry: the six tables of ``device_tables``
    end to end, ry_idx (crop, 2) | ry_w (crop, 2) | rx_idx (crop, 2) |
    rx_w (crop, 2) | scale (3) | bias (3), the float32 ones as their
    bits."""
    return torch.cat([t.reshape(-1).view(torch.int32) for t in
                      device_tables(H, W, resize, crop, mean, std, device)])


def check_raw(raw: torch.Tensor, crop: int, resize: int):
    if raw.dim() != 4 or raw.shape[-1] != 3:
        raise ValueError(f"raw must be (b, H, W, 3), got {tuple(raw.shape)}")
    if crop > resize:
        raise ValueError(f"crop {crop} exceeds resize {resize}")


def fused_preprocess_plain(raw: torch.Tensor, *, resize: int, crop: int,
                           mean=None, std=None) -> torch.Tensor:
    """uint8 (b, H, W, 3) -> f32 (b, crop, crop, 3), as dense matmuls on
    the interpolation matrices (the JAX kernel's arithmetic)."""
    check_raw(raw, crop, resize)
    b, H, W, _ = raw.shape
    ry, rx = (torch.as_tensor(m, device=raw.device) for m in
              interp_matrices(H, W, resize=resize, crop=crop))
    scale, bias = (torch.as_tensor(a, device=raw.device)
                   for a in affine(mean, std))
    return interp_affine(raw.to(torch.float32), ry, rx, scale, bias)


def fused_preprocess_cuda(raw: torch.Tensor, *, resize: int, crop: int,
                          mean=None, std=None) -> torch.Tensor:
    """The CUDA kernel: same contract as the plain version."""
    check_raw(raw, crop, resize)
    if raw.device.type != "cuda":
        raise ValueError("fused_preprocess_cuda needs a CUDA raw batch")
    if raw.dtype != torch.uint8 or not raw.is_contiguous():
        raise TypeError(f"need a contiguous uint8 raw batch, got "
                        f"{raw.dtype}")
    b, H, W, _ = raw.shape
    tables = ingest_tables(H, W, resize, crop, hashable(mean), hashable(std),
                           str(raw.device))
    out = torch.empty((b, crop, crop, 3), dtype=torch.float32,
                      device=raw.device)
    if b:
        _build.check("qr_preprocess", _build.library().qr_preprocess(
            raw.data_ptr(), tables.data_ptr(), out.data_ptr(), b, H, W, crop,
            _build.current_stream(raw.device)))
        _build.launch_counts["fused_preprocess"] += 1
    return out
