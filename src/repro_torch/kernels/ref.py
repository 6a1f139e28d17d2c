"""Host-side interpolation matrices shared by the ingest kernels and
their plain versions, and the int8 rung's dequantized-weight oracle
(counterpart of ``repro.kernels.ref``; the plain versions beside each
kernel are the port's oracles, the others there are the JAX package's
own)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.extractor import (extractor_forward_packed,
                                        pack_params, unpack_params)


def resize_matrix(n_in: int, n_out: int, crop_off: int = 0,
                  n_crop: int = None) -> np.ndarray:
    """Row-interpolation matrix M (n_crop, n_in): out = M @ in reproduces
    bilinear resize (half-pixel centers, antialias=False, edge clamp)
    followed by cropping rows [crop_off, crop_off + n_crop).  Copied
    verbatim from ``repro.kernels.ref.resize_matrix`` so the weights are
    the same float32 values."""
    n_crop = n_out if n_crop is None else n_crop
    scale = n_in / n_out
    M = np.zeros((n_crop, n_in), np.float32)
    for o in range(n_crop):
        src = (o + crop_off + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        w = src - lo
        lo_c = min(max(lo, 0), n_in - 1)
        hi_c = min(max(lo + 1, 0), n_in - 1)
        M[o, lo_c] += 1.0 - w
        M[o, hi_c] += w
    return M


def fused_extractor_int8_ref(packed: dict, tiles: torch.Tensor
                             ) -> torch.Tensor:
    """Semantic oracle of the int8 rung: the packed fp32 body on the
    dequantized weights (q * scale).  The rung also quantizes each
    activation row, so it agrees with this oracle at the quantization
    noise (~1/127 of a row's largest value per tap), not bitwise — the
    JAX package holds its rung within atol 0.15, rtol 0.05 of it."""
    return extractor_forward_packed(pack_params(unpack_params(packed),
                                                "fp32"), tiles)
