"""Fused extractor decode, flat schedule, fp32 (counterpart of
``repro.kernels.fused_extractor.fused_extractor``).

* :func:`fused_extractor_plain` — ``extractor_forward_packed_embed``,
  the reference body in PyTorch (nine ``reshape(M, c) @ w_tap``
  products per conv, accumulated in order);
* :func:`fused_extractor_cuda` — the hand-written CUDA kernels
  (``csrc/fused_extractor.cu``): one direct-conv kernel per hidden block
  with a fused bias + channel_norm + ReLU epilogue, a to_bits kernel
  that also reduces the GAP and correlation partials per pixel tile, and
  a head kernel.  Activations go through global memory between layers
  (one image's fp32 activation is 1 MiB at l=64, C=64, more than an
  SM's shared memory).

Both return ``(logits, embed)`` with ``embed`` the (b, n_bits) GAP
vector when ``with_embed``, else ``logits`` alone.
"""
from __future__ import annotations

import torch

from repro_torch.core.extractor import extractor_forward_packed_embed
from repro_torch.kernels import _build

# instantiations of the CUDA kernels (csrc/fused_extractor.cu)
HIDDEN_CHANNELS = (16, 32, 64)
N_BITS = (60,)
PIXEL_TILE = (8, 16)  # (rows, cols) of the pixel tile a block owns


def fused_extractor_plain(tiles: torch.Tensor, packed: dict, *,
                          with_embed: bool = False):
    logits, g = extractor_forward_packed_embed(packed, tiles)
    return (logits, g) if with_embed else logits


def _check_pack(tiles: torch.Tensor, packed: dict):
    if tiles.dim() != 4 or tiles.shape[1] != tiles.shape[2] or \
            tiles.shape[3] != 3:
        raise ValueError(f"tiles must be (b, l, l, 3), got "
                         f"{tuple(tiles.shape)}")
    l = tiles.shape[1]
    if l % PIXEL_TILE[0] or l % PIXEL_TILE[1]:
        raise ValueError(f"tile size {l} must be a multiple of "
                         f"{PIXEL_TILE[1]} for the CUDA decode kernel")
    leaves = [tiles, packed["to_bits"]["w"], packed["to_bits"]["b"],
              packed["head"]["w"], packed["head"]["b"]]
    for blk in packed["blocks"]:
        leaves += [blk["w"], blk["b"]]
        if blk["w"].shape[-1] not in HIDDEN_CHANNELS:
            raise ValueError(f"hidden width {blk['w'].shape[-1]} not in "
                             f"{HIDDEN_CHANNELS}")
    if "corr" in packed:
        leaves += [packed["corr"], packed["corr_scale"]]
    for t in leaves:
        if t.device != tiles.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError("the CUDA decode kernel takes contiguous "
                             "float32 tiles and an fp32 pack on the tiles' "
                             "CUDA device")
    n_bits = packed["head"]["b"].shape[0]
    if n_bits not in N_BITS or packed["to_bits"]["w"].shape[-1] != n_bits:
        raise ValueError(f"n_bits {n_bits} not in {N_BITS}")


def fused_extractor_cuda(tiles: torch.Tensor, packed: dict, *,
                         with_embed: bool = False):
    """The CUDA kernels: same contract as the plain version.  One call
    is one launch of the op (D + 2 kernel launches on one stream)."""
    if tiles.device.type != "cuda":
        raise ValueError("fused_extractor_cuda needs CUDA tiles")
    _check_pack(tiles, packed)
    b, l = tiles.shape[0], tiles.shape[1]
    n_bits = packed["head"]["b"].shape[0]
    dev = tiles.device
    if b == 0:
        empty = torch.empty((0, n_bits), dtype=torch.float32, device=dev)
        return (empty, empty.clone()) if with_embed else empty
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    x, cin = tiles, 3
    for blk in packed["blocks"]:
        cout = blk["w"].shape[-1]
        y = torch.empty((b, l, l, cout), dtype=torch.float32, device=dev)
        _build.check("qr_conv3x3_norm_relu", lib.qr_conv3x3_norm_relu(
            x.data_ptr(), blk["w"].data_ptr(), blk["b"].data_ptr(),
            y.data_ptr(), b, l, cin, cout, stream))
        x, cin = y, cout
    n_tiles = (l // PIXEL_TILE[0]) * (l // PIXEL_TILE[1])
    has_corr = "corr" in packed and packed["corr"].shape[0] == l * l
    part_gap = torch.empty((b * n_tiles, n_bits), dtype=torch.float32,
                           device=dev)
    part_corr = torch.empty_like(part_gap) if has_corr else part_gap
    corr = packed["corr"] if has_corr else part_gap
    corr_scale = packed["corr_scale"] if has_corr else part_gap
    _build.check("qr_conv3x3_gap_corr", lib.qr_conv3x3_gap_corr(
        x.data_ptr(), packed["to_bits"]["w"].data_ptr(),
        packed["to_bits"]["b"].data_ptr(), tiles.data_ptr(),
        corr.data_ptr(), part_gap.data_ptr(), part_corr.data_ptr(), b, l,
        cin, n_bits, int(has_corr), stream))
    logits = torch.empty((b, n_bits), dtype=torch.float32, device=dev)
    embed = torch.empty_like(logits) if with_embed else None
    _build.check("qr_extractor_head", lib.qr_extractor_head(
        part_gap.data_ptr(), part_corr.data_ptr(),
        packed["head"]["w"].data_ptr(), packed["head"]["b"].data_ptr(),
        corr_scale.data_ptr(), logits.data_ptr(),
        None if embed is None else embed.data_ptr(), b, l, n_bits,
        int(has_corr), stream))
    _build.launch_counts["fused_extractor"] += 1
    return (logits, embed) if with_embed else logits
