"""Interpolation helpers of the fused Resize -> CenterCrop -> Normalize
ingest (counterpart of ``repro.kernels.fused_preprocess``).

Only the shared math is ported in this slice: the (crop, H) / (W, crop)
interpolation matrices and the per-channel ``scale_c * (Ry @ img_c @
Rx) + bias_c`` affine, which is the plain version of the tile-first
ingest kernel (``fused_tile_preprocess.py``).  The full-image kernel
(staged ingest, ``tile_first=False``) is not on the default path yet.
"""
from __future__ import annotations

import numpy as np
import torch

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
