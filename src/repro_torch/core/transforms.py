"""Preprocessing ops of the unfused ingest (counterpart of
``repro.core.transforms``): Resize -> CenterCrop -> Normalize, the
fragmented-kernel baseline of the ``sequential`` and ``tiled`` modes and
of ``fused_preprocess=False``.

``resize_to`` reproduces ``jax.image.resize(..., "bilinear")`` with its
default ``antialias=True``: per spatial axis a float32 weight matrix
built as ``jax._src.image.scale.compute_weight_mat`` builds it (triangle
kernel, half-pixel centres, the kernel widened by ``1/scale`` when
downsampling, columns normalised to sum 1, samples outside the input
zeroed), applied as JAX's ``_scale_and_translate`` contracts them:
height first, then width.  An axis whose size does not change is left
as it is, as JAX skips it.  ``F.interpolate`` is not used: its
antialiasing filter is another one.  The attack ops come with the
``ATTACKS`` registry (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=32)
def resize_weights(n_in: int, n_out: int, antialias: bool = True
                   ) -> np.ndarray:
    """(n_in, n_out) float32 weight matrix of a bilinear resize along
    one axis, computed step for step in float32 as JAX computes it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / f32(kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_to(images: torch.Tensor, size: int, *,
              antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of (b, h, w, c) float32 images to (b, size, size,
    c), as ``jax.image.resize(images, ..., "bilinear")``."""
    b, h, w, c = images.shape
    x = images.permute(0, 3, 1, 2)                  # (b, c, h, w)
    if h != size:
        wh = torch.as_tensor(resize_weights(h, size, antialias),
                             device=images.device)
        x = torch.matmul(wh.T, x)                   # (b, c, size, w)
    if w != size:
        ww = torch.as_tensor(resize_weights(w, size, antialias),
                             device=images.device)
        x = torch.matmul(x, ww)                     # (b, c, size, size)
    return x.permute(0, 2, 3, 1).contiguous()


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    b, h, w, c = images.shape
    y0, x0 = (h - size) // 2, (w - size) // 2
    return images[:, y0: y0 + size, x0: x0 + size, :]


def normalize(images: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    """[0, 1] float images -> (x - mean) / std, per channel."""
    mean = IMAGENET_MEAN if mean is None else mean
    std = IMAGENET_STD if std is None else std
    x = images.to(torch.float32)
    return (x - torch.as_tensor(np.asarray(mean, np.float32),
                                device=x.device)) \
        / torch.as_tensor(np.asarray(std, np.float32), device=x.device)


def preprocess_reference(raw: torch.Tensor, *, resize: int = 288,
                         crop: int = 256, mean=None,
                         std=None) -> torch.Tensor:
    """Unfused Resize -> CenterCrop -> Normalize on a uint8 (b, H, W, 3)
    batch: ``raw / 255``, the antialiased resize, the crop, then the
    division by ``std``, each as its own pass (the baseline the fused
    ingest kernels replace)."""
    x = raw.to(torch.float32) / 255.0
    x = resize_to(x, resize)
    x = center_crop(x, crop)
    return normalize(x, mean, std)
