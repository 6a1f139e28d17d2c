"""Host-side interpolation matrices shared by the ingest kernels and
their plain versions (counterpart of ``repro.kernels.ref``; the plain
versions beside each kernel are the port's oracles, the others there
are the JAX package's own)."""
from __future__ import annotations

import numpy as np


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

