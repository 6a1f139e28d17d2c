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

from repro_torch.core.rs import torch_rs as _torch_rs
from repro_torch.core.rs.codec import DEFAULT_CODE, RSCode
from repro_torch.kernels import _build
from repro_torch.kernels import fused_extractor as _fx
from repro_torch.kernels import fused_preprocess as _fp
from repro_torch.kernels import fused_tile_preprocess as _ftp
from repro_torch.kernels import rs_decode as _rs


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor, False for a CUDA one; raise otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def fused_preprocess(raw: torch.Tensor, *, resize: int = 256,
                     crop: int = 256, mean=None, std=None) -> torch.Tensor:
    """Fused Resize -> CenterCrop -> Normalize of the whole image:
    uint8 (b, H, W, 3) -> f32 (b, crop, crop, 3)."""
    fn = (_fp.fused_preprocess_plain if _on_cpu(raw, "fused_preprocess")
          else _fp.fused_preprocess_cuda)
    return fn(raw, resize=resize, crop=crop, mean=mean, std=std)


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


def fused_extractor(tiles: torch.Tensor, packed: dict, schedule=None,
                    with_embed: bool = False):
    """Fused decode: tiles (b, l, l, 3) -> (b, n_bits) logits, plus the
    GAP embedding when ``with_embed``.  ``packed`` is
    ``extractor.pack_params(params, dtype)``; its dtype picks the fp32,
    bf16 or int8 rung.  ``schedule`` None runs the flat kernel; a
    ``kernels.autotune.Schedule`` (anything with ``batch_block`` /
    ``channel_tile`` / ``double_buffer``) the blocked one, whose logits
    are bitwise the flat kernel's on the card at every rung."""
    cpu = _on_cpu(tiles, "fused_extractor")
    if schedule is None:
        fn = _fx.fused_extractor_plain if cpu else _fx.fused_extractor_cuda
        return fn(tiles, packed, with_embed=with_embed)
    fn = (_fx.fused_extractor_blocked_plain if cpu
          else _fx.fused_extractor_blocked_cuda)
    return fn(tiles, packed, batch_block=schedule.batch_block,
              channel_tile=schedule.channel_tile,
              double_buffer=schedule.double_buffer, with_embed=with_embed)


def rs_decode(bits: torch.Tensor, *, code: RSCode = DEFAULT_CODE
              ) -> Dict[str, torch.Tensor]:
    """Batched decode of integer (or bool) bits (B, n*m), equal to the
    reference's on every input: bits are cast to int32 as the reference
    casts them, and entries outside {0, 1} decode as there.  The default
    RS(15,12) GF(16) code takes the t = 1 kernel (the CUDA kernel's
    closed form covers words in {0, 1}, the reference's algorithm the
    rest, in one launch); any other code the batched Berlekamp-Welch
    ``torch_rs`` in torch ops on the bits' device, as the reference
    falls back to ``jax_rs``."""
    cpu = _on_cpu(bits, "rs_decode")
    if not _rs.is_kernel_code(code):
        return _torch_rs.make_batch_decoder(code)(bits)
    fn = _rs.rs_decode_plain if cpu else _rs.rs_decode_cuda
    return fn(bits)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_build.launch_counts)


def kernel_launch_counts() -> Dict[str, int]:
    """Launches per CUDA kernel of the decode ops since the last reset,
    by kernel name (``_build.kernel_launches``)."""
    return dict(_build.kernel_launches)


def reset_launch_counts():
    for name in _build.launch_counts:
        _build.launch_counts[name] = 0
    _build.kernel_launches.clear()
