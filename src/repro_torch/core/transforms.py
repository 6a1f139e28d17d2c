"""Image transforms (counterpart of ``repro.core.transforms``): the
preprocessing ops of the unfused ingest, Resize -> CenterCrop ->
Normalize (the fragmented-kernel baseline of the ``sequential`` and
``tiled`` modes and of ``fused_preprocess=False``), and the evaluation
attacks with their registry ``ATTACKS``.

``resize_to`` reproduces ``jax.image.resize(..., "bilinear")`` with its
default ``antialias=True``: per spatial axis a float32 weight matrix
built as ``jax._src.image.scale.compute_weight_mat`` builds it (triangle
kernel, half-pixel centres, the kernel widened by ``1/scale`` when
downsampling, columns normalised to sum 1, samples outside the input
zeroed), applied as JAX's ``_scale_and_translate`` contracts them:
height first, then width.  An axis whose size does not change is left
as it is, as JAX skips it.  ``F.interpolate`` is not used: its
antialiasing filter is another one.

The attacks are plain torch ops on (b, h, w, c) float images on the
caller's device, differentiable as such (the clips split a tie's
gradient as ``jnp.clip`` does, :func:`clip`): crop and resize (through
:func:`resize_to`), brightness, contrast, saturation, sharpness, a
depthwise box blur with zero "SAME" padding, the blockwise 8x8 DCT
quantisation surrogate of JPEG (edge padding, rounding half to even),
and a burned-in text overlay.  ``STABLE_SIG_ATTACKS`` names the paper's
adversarial set.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

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


def resize_to(images: torch.Tensor, size, *,
              antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of (b, h, w, c) float32 images to (b, nh, nw, c),
    ``size`` an int (square) or (nh, nw), as ``jax.image.resize(images,
    ..., "bilinear")``."""
    nh, nw = (size, size) if isinstance(size, int) else size
    b, h, w, c = images.shape
    x = images.permute(0, 3, 1, 2)                  # (b, c, h, w)
    if h != nh:
        wh = torch.as_tensor(resize_weights(h, nh, antialias),
                             device=images.device)
        x = torch.matmul(wh.T, x)                   # (b, c, nh, w)
    if w != nw:
        ww = torch.as_tensor(resize_weights(w, nw, antialias),
                             device=images.device)
        x = torch.matmul(x, ww)                     # (b, c, nh, nw)
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


# -- evaluation attacks ------------------------------------------------------
def attack_crop(images: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the central ``frac`` of the area, resize back."""
    b, h, w, c = images.shape
    keep = max(int(round((frac ** 0.5) * h)), 4)
    return resize_to(center_crop(images, keep), (h, w))


def attack_resize(images: torch.Tensor, frac: float) -> torch.Tensor:
    b, h, w, c = images.shape
    nh, nw = max(int(h * frac), 4), max(int(w * frac), 4)
    return resize_to(resize_to(images, (nh, nw)), (h, w))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: the same values as ``torch.clamp``, and the
    gradient of ``minimum(maximum(x, lo), hi)``, which gives half of it
    to an element exactly at a bound (``torch.clamp`` gives all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


def attack_brightness(images: torch.Tensor, factor: float) -> torch.Tensor:
    return clip(images * factor, -3.0, 3.0)


def attack_contrast(images: torch.Tensor, factor: float) -> torch.Tensor:
    mu = images.mean(dim=(1, 2, 3), keepdim=True)
    return clip(mu + (images - mu) * factor, -3.0, 3.0)


def attack_saturation(images: torch.Tensor, factor: float) -> torch.Tensor:
    grey = images.mean(dim=-1, keepdim=True)
    return clip(grey + (images - grey) * factor, -3.0, 3.0)


def attack_sharpness(images: torch.Tensor, factor: float) -> torch.Tensor:
    blur = attack_blur(images)
    return clip(blur + (images - blur) * factor, -3.0, 3.0)


def attack_blur(images: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Depthwise k x k box filter, zero "SAME" padding (the extra row
    and column after, for even k, as XLA pads): the k * k shifted views
    times 1 / k^2, summed in row-major tap order.  Elementwise ops, so
    no convolution library (and none of its TF32 algorithms) is asked."""
    h, w = images.shape[1], images.shape[2]
    lo = (k - 1) // 2
    x = F.pad(images, (0, 0, lo, k - 1 - lo, lo, k - 1 - lo))
    wt = 1.0 / (k * k)
    acc = None
    for dy in range(k):
        for dx in range(k):
            v = x[:, dy: dy + h, dx: dx + w, :] * wt
            acc = v if acc is None else acc + v
    return acc


@functools.lru_cache(maxsize=None)
def _dct8() -> np.ndarray:
    k = np.arange(8)
    n = np.arange(8)
    D = np.sqrt(2 / 8) * np.cos(np.pi * (2 * n[None] + 1) * k[:, None] / 16)
    D[0] /= np.sqrt(2)
    return D.astype(np.float32)


# luminance quantisation table (JPEG Annex K), quality-scaled
_QTAB = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)


def jpeg_coefficients(images: torch.Tensor, quality: int = 50):
    """The DCT surrogate's steps before its rounding: (coefficients
    divided by the quantiser, (b, h/8, 8, w/8, 8, c) with h and w padded
    to multiples of 8 at the edges; the quantiser, broadcastable)."""
    b, h, w, c = images.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    x = images
    if (hp, wp) != (h, w):
        x = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h),
                  mode="replicate").permute(0, 2, 3, 1)
    scale = 50.0 / quality if quality < 50 else 2 - quality / 50.0
    q = torch.clamp(torch.as_tensor(_QTAB, device=images.device) * scale,
                    min=1.0) / 128.0
    q = q[None, None, :, None, :, None]
    D = torch.as_tensor(_dct8(), device=images.device)
    blocks = x.reshape(b, hp // 8, 8, wp // 8, 8, c)
    coef = torch.einsum("ij,bhjwkc,lk->bhiwlc", D, blocks, D)
    return coef / q, q


def attack_jpeg(images: torch.Tensor, quality: int = 50) -> torch.Tensor:
    """Blockwise DCT quantisation surrogate of JPEG compression."""
    b, h, w, c = images.shape
    scaled, q = jpeg_coefficients(images, quality)
    coef = torch.round(scaled) * q
    D = torch.as_tensor(_dct8(), device=images.device)
    rec = torch.einsum("ji,bhjwkc,kl->bhiwlc", D, coef, D)
    return rec.reshape(b, scaled.shape[1] * 8, scaled.shape[3] * 8,
                       c)[:, :h, :w, :]


def attack_overlay_text(images: torch.Tensor, intensity: float = 1.0
                        ) -> torch.Tensor:
    """Overlay a fixed block pattern simulating burned-in text."""
    b, h, w, c = images.shape
    yy, xx = torch.meshgrid(torch.arange(h, device=images.device),
                            torch.arange(w, device=images.device),
                            indexing="ij")
    band = (yy > h * 3 // 4) & (yy < h * 7 // 8)
    glyph = ((xx // 6) % 2 == 0) & ((xx > w // 8) & (xx < w * 7 // 8))
    mask = (band & glyph).to(images.dtype)[None, :, :, None]
    return images * (1 - mask) + intensity * mask


ATTACKS = {
    "none": lambda x: x,
    "crop_0.1": lambda x: attack_crop(x, 0.1),
    "crop_0.5": lambda x: attack_crop(x, 0.5),
    "resize_0.5": lambda x: attack_resize(x, 0.5),
    "resize_0.7": lambda x: attack_resize(x, 0.7),
    "blur": attack_blur,
    "brightness_2": lambda x: attack_brightness(x, 2.0),
    "contrast_2": lambda x: attack_contrast(x, 2.0),
    "saturation_2": lambda x: attack_saturation(x, 2.0),
    "sharpness_2": lambda x: attack_sharpness(x, 2.0),
    "jpeg_50": lambda x: attack_jpeg(x, 50),
    "overlay_text": attack_overlay_text,
}

# the paper's Stable-Signature adversarial set (Table 2 "Adv." column)
STABLE_SIG_ATTACKS = ("crop_0.5", "resize_0.7", "jpeg_50", "brightness_2",
                      "contrast_2", "saturation_2", "sharpness_2",
                      "overlay_text")
