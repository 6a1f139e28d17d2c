"""Public wrappers for the port's kernels (counterpart of
``repro.kernels.ops``).

Each op dispatches on the device of its input: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor the hand-written CUDA
kernel — which builds on first use and raises if it cannot build or
launch.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.rs.codec import DEFAULT_CODE, RSCode
from repro_torch.kernels import _build
from repro_torch.kernels import fused_extractor as _fx
from repro_torch.kernels import fused_tile_preprocess as _ftp
from repro_torch.kernels import rs_decode as _rs


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor, False for a CUDA one; raise otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def fused_tile_preprocess(raw: torch.Tensor, offsets: torch.Tensor, *,
                          resize: int = 256, crop: int = 256,
                          tile: int = 64, mean=None, std=None
                          ) -> torch.Tensor:
    """Tile-first fused ingest: uint8 (b, H, W, 3) + (b, 2) or (b, k, 2)
    offsets -> f32 (b*k, tile, tile, 3)."""
    fn = (_ftp.fused_tile_preprocess_plain
          if _on_cpu(raw, "fused_tile_preprocess")
          else _ftp.fused_tile_preprocess_cuda)
    return fn(raw, offsets, resize=resize, crop=crop, tile=tile,
              mean=mean, std=std)


def fused_extractor(tiles: torch.Tensor, packed: dict, *,
                    with_embed: bool = False):
    """Fused fp32 decode, flat schedule: tiles (b, l, l, 3) -> (b,
    n_bits) logits, plus the GAP embedding when ``with_embed``."""
    fn = (_fx.fused_extractor_plain if _on_cpu(tiles, "fused_extractor")
          else _fx.fused_extractor_cuda)
    return fn(tiles, packed, with_embed=with_embed)


def rs_decode(bits: torch.Tensor, *, code: RSCode = DEFAULT_CODE
              ) -> Dict[str, torch.Tensor]:
    """Batched Berlekamp-Welch decode of (B, 60) bits for the default
    RS(15,12) GF(16) code."""
    _rs.check_code(code)
    fn = (_rs.rs_decode_plain if _on_cpu(bits, "rs_decode")
          else _rs.rs_decode_cuda)
    return fn(bits)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_build.launch_counts)


def reset_launch_counts():
    for name in _build.launch_counts:
        _build.launch_counts[name] = 0
