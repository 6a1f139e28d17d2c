"""Fused extractor decode at the three rungs (fp32, bf16, int8), on the
flat schedule (counterpart of
``repro.kernels.fused_extractor.fused_extractor``) and on a blocked
schedule (``fused_extractor_blocked``).  The pack's dtype picks the rung
(``core.extractor.pack_params``), as in the reference.

* :func:`fused_extractor_plain` — ``extractor_forward_packed_embed``,
  the reference body in PyTorch (nine ``reshape(M, c) @ w_tap``
  products per conv, accumulated in order, at the pack's rung);
* :func:`fused_extractor_cuda` — the hand-written CUDA kernels
  (``csrc/extractor.cuh``, instantiated per rung in
  ``csrc/fused_extractor*.cu``): one direct-conv kernel per hidden
  block with a fused bias + channel_norm + ReLU epilogue, a to_bits
  kernel that also reduces the GAP and correlation partials per pixel
  tile, and a head kernel; the int8 rung adds a pass before each conv
  that quantizes its input once per pixel.  Activations go through
  global memory between layers, in fp32 (one image's activation is
  1 MiB at l=64, C=64, more than an SM's shared memory).

The blocked schedule (batch block ``bb``, output-channel tile ``ct``,
``double_buffer``; see ``kernels/autotune.Schedule``):

* :func:`fused_extractor_blocked_plain` — the reference's blocked body
  in PyTorch: the batch zero-padded to a multiple of ``bb``, each block
  of ``bb`` images through the packed body with the hidden convs'
  output columns in ``ct`` slices, pad rows sliced off;
* :func:`fused_extractor_blocked_cuda` — the blocked CUDA conv kernel
  for the hidden blocks (``conv_blocked_kernel``), then the flat
  to_bits and head kernels.  Its logits equal the flat kernel's bit
  for bit on every schedule, at every rung.

All four return ``(logits, embed)`` with ``embed`` the (b, n_bits) GAP
vector when ``with_embed``, else ``logits`` alone.
"""
from __future__ import annotations

import torch

from repro_torch.core.extractor import (extractor_forward_packed_embed,
                                        packed_dtype)
from repro_torch.kernels import _build

# instantiations of the CUDA kernels (csrc/extractor.cuh)
HIDDEN_CHANNELS = (16, 32, 64)
N_BITS = (60,)
PIXEL_TILE = (8, 16)  # (rows, cols) of the pixel tile a block owns
# blocked conv kernel: 16x16 pixel tiles, channel tiles that are
# multiples of 4 dividing the hidden width (see blocked_channel_tiles)
BLOCKED_PIXEL_TILE = 16
# the C entry points' ``rung`` argument, by the pack's dtype
RUNGS = {"fp32": 0, "bf16": 1, "int8": 2}


def fused_extractor_plain(tiles: torch.Tensor, packed: dict, *,
                          with_embed: bool = False):
    logits, g = extractor_forward_packed_embed(packed, tiles)
    return (logits, g) if with_embed else logits


def _check_pack(tiles: torch.Tensor, packed: dict) -> int:
    """Raise ValueError for inputs the CUDA kernels do not take; return
    the pack's rung id (``RUNGS``)."""
    if tiles.dim() != 4 or tiles.shape[1] != tiles.shape[2] or \
            tiles.shape[3] != 3:
        raise ValueError(f"tiles must be (b, l, l, 3), got "
                         f"{tuple(tiles.shape)}")
    l = tiles.shape[1]
    if l % PIXEL_TILE[0] or l % PIXEL_TILE[1]:
        raise ValueError(f"tile size {l} must be a multiple of "
                         f"{PIXEL_TILE[1]} for the CUDA decode kernel")
    dtype = packed_dtype(packed)
    f32 = torch.float32
    cdt = packed["blocks"][0]["w"].dtype
    hdt = f32 if dtype == "int8" else cdt
    leaves = [(tiles, f32), (packed["head"]["w"], hdt),
              (packed["head"]["b"], f32)]
    for blk in packed["blocks"] + [packed["to_bits"]]:
        leaves += [(blk["w"], cdt), (blk["b"], f32)]
        if ("scale" in blk) != (dtype == "int8"):
            raise ValueError("int8 packs, and only they, carry a 'scale' "
                             "per conv")
        if "scale" in blk:
            leaves.append((blk["scale"], f32))
    for blk in packed["blocks"]:
        if blk["w"].shape[-1] not in HIDDEN_CHANNELS:
            raise ValueError(f"hidden width {blk['w'].shape[-1]} not in "
                             f"{HIDDEN_CHANNELS}")
    if "corr" in packed:
        leaves += [(packed["corr"], hdt), (packed["corr_scale"], f32)]
    for t, want in leaves:
        if t.device != tiles.device or t.dtype != want or \
                not t.is_contiguous():
            raise ValueError(
                f"the CUDA decode kernel takes contiguous float32 tiles and "
                f"a {dtype} pack (conv weights {cdt}, head and correlation "
                f"{hdt}, biases and scales float32) on the tiles' CUDA "
                f"device")
    n_bits = packed["head"]["b"].shape[0]
    if n_bits not in N_BITS or packed["to_bits"]["w"].shape[-1] != n_bits:
        raise ValueError(f"n_bits {n_bits} not in {N_BITS}")
    return RUNGS[dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _layer_input(lib, x, cin, rung, stream):
    """A conv's input: the activation ``x`` itself, or at int8 its
    quantized words and per-pixel scales (one launch of the pass)."""
    if rung != RUNGS["int8"]:
        return x, None
    npix = x.numel() // cin
    q = torch.empty((npix, (cin + 3) // 4), dtype=torch.int32,
                    device=x.device)
    s = torch.empty((npix,), dtype=torch.float32, device=x.device)
    _build.check("qr_quantize_rows_int8", lib.qr_quantize_rows_int8(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), npix, cin, stream))
    return q, s


def _launch_flat(lib, tiles, packed, rung, with_embed, stream):
    """The flat schedule's launches on one stream (D + 2 kernels, plus a
    quantize pass per conv at int8)."""
    b, l = tiles.shape[0], tiles.shape[1]
    x, cin = tiles, 3
    for blk in packed["blocks"]:
        cout = blk["w"].shape[-1]
        y = torch.empty((b, l, l, cout), dtype=torch.float32,
                        device=tiles.device)
        xq, xs = _layer_input(lib, x, cin, rung, stream)
        _build.check("qr_conv3x3_norm_relu", lib.qr_conv3x3_norm_relu(
            xq.data_ptr(), _ptr(xs), blk["w"].data_ptr(),
            _ptr(blk.get("scale")), blk["b"].data_ptr(), y.data_ptr(), b, l,
            cin, cout, rung, stream))
        x, cin = y, cout
    return _head(lib, tiles, x, cin, packed, rung, with_embed, stream)


def fused_extractor_cuda(tiles: torch.Tensor, packed: dict, *,
                         with_embed: bool = False):
    """The CUDA kernels: same contract as the plain version, at the
    pack's rung.  One call is one launch of the op."""
    if tiles.device.type != "cuda":
        raise ValueError("fused_extractor_cuda needs CUDA tiles")
    rung = _check_pack(tiles, packed)
    if tiles.shape[0] == 0:
        return _empty(tiles, packed, with_embed)
    out = _launch_flat(_build.library(), tiles, packed, rung, with_embed,
                       torch.cuda.current_stream(tiles.device).cuda_stream)
    _build.launch_counts["fused_extractor"] += 1
    return out


def _empty(tiles, packed, with_embed):
    n_bits = packed["head"]["b"].shape[0]
    empty = torch.empty((0, n_bits), dtype=torch.float32,
                        device=tiles.device)
    return (empty, empty.clone()) if with_embed else empty


def _head(lib, tiles, x, cin, packed, rung, with_embed, stream):
    """The to_bits + GAP + correlation kernel and the head kernel on the
    last hidden activation ``x``."""
    b, l = tiles.shape[0], tiles.shape[1]
    n_bits = packed["head"]["b"].shape[0]
    dev = tiles.device
    n_tiles = (l // PIXEL_TILE[0]) * (l // PIXEL_TILE[1])
    has_corr = "corr" in packed and packed["corr"].shape[0] == l * l
    part_gap = torch.empty((b * n_tiles, n_bits), dtype=torch.float32,
                           device=dev)
    part_corr = torch.empty_like(part_gap) if has_corr else part_gap
    corr = packed["corr"] if has_corr else part_gap
    corr_scale = packed["corr_scale"] if has_corr else part_gap
    tb = packed["to_bits"]
    xq, xs = _layer_input(lib, x, cin, rung, stream)
    _build.check("qr_conv3x3_gap_corr", lib.qr_conv3x3_gap_corr(
        xq.data_ptr(), _ptr(xs), tb["w"].data_ptr(), _ptr(tb.get("scale")),
        tb["b"].data_ptr(), tiles.data_ptr(), corr.data_ptr(),
        part_gap.data_ptr(), part_corr.data_ptr(), b, l, cin, n_bits,
        int(has_corr), rung, stream))
    logits = torch.empty((b, n_bits), dtype=torch.float32, device=dev)
    embed = torch.empty_like(logits) if with_embed else None
    _build.check("qr_extractor_head", lib.qr_extractor_head(
        part_gap.data_ptr(), part_corr.data_ptr(),
        packed["head"]["w"].data_ptr(), packed["head"]["b"].data_ptr(),
        corr_scale.data_ptr(), logits.data_ptr(), _ptr(embed), b, l,
        n_bits, int(has_corr), rung, stream))
    return (logits, embed) if with_embed else logits


def block_sizes(b: int, channels: int, batch_block: int,
                channel_tile: int):
    """(bb, ct) as the reference clamps them: bb in [1, b], ct = C when
    ``channel_tile`` is 0, else min(channel_tile, C)."""
    bb = max(1, min(batch_block, b))
    ct = min(channel_tile, channels) if channel_tile else channels
    return bb, ct


def blocked_channel_tiles(channels: int) -> tuple:
    """The channel tiles the blocked CUDA kernel is built for at hidden
    width ``channels``: the multiples of 4 that divide it."""
    return tuple(ct for ct in range(4, channels + 1, 4)
                 if channels % ct == 0)


def check_blocked_schedule(*, channels: int, tile: int,
                           channel_tile: int):
    """Raise ValueError, naming the limit, for a blocked schedule that
    the CUDA kernel does not run at this width and tile size (the plain
    version runs any)."""
    if channels not in HIDDEN_CHANNELS:
        raise ValueError(f"the blocked CUDA kernel takes hidden widths "
                         f"{HIDDEN_CHANNELS}, got {channels}")
    _, ct = block_sizes(1, channels, 1, channel_tile)
    if ct not in blocked_channel_tiles(channels):
        raise ValueError(
            f"the blocked CUDA kernel takes channel tiles "
            f"{blocked_channel_tiles(channels)} (0 = {channels}) at C="
            f"{channels}: multiples of 4 that divide C; got ct"
            f"{channel_tile}")
    if tile % BLOCKED_PIXEL_TILE:
        raise ValueError(f"tile size {tile} must be a multiple of "
                         f"{BLOCKED_PIXEL_TILE} for the blocked kernel")


def fused_extractor_blocked_plain(tiles: torch.Tensor, packed: dict, *,
                                  batch_block: int = 1,
                                  channel_tile: int = 0,
                                  double_buffer: bool = True,
                                  with_embed: bool = False):
    """The blocked schedule's arithmetic: ragged batches zero-padded to
    a multiple of ``bb``, each block through the packed body with
    ``ct``-wide output-column slices, pad rows sliced off.
    ``double_buffer`` changes no arithmetic."""
    b = tiles.shape[0]
    C = packed["blocks"][0]["w"].shape[-1]
    bb, ct = block_sizes(b, C, batch_block, channel_tile)
    pad = -b % bb
    if pad:
        tiles = torch.cat([tiles, tiles.new_zeros((pad,) + tiles.shape[1:])])
    outs = [extractor_forward_packed_embed(packed, tiles[i: i + bb], ct)
            for i in range(0, b + pad, bb)]
    logits = torch.cat([o[0] for o in outs])[:b]
    g = torch.cat([o[1] for o in outs])[:b]
    return (logits, g) if with_embed else logits


def _launch_blocked(lib, tiles, packed, rung, bb, ct, double_buffer,
                    with_embed, stream):
    """The blocked schedule's launches: the blocked conv per hidden
    block (plus the quantize pass at int8), then the flat to_bits and
    head kernels."""
    b, l = tiles.shape[0], tiles.shape[1]
    C = packed["blocks"][0]["w"].shape[-1]
    x, cin = tiles, 3
    for blk in packed["blocks"]:
        y = torch.empty((b, l, l, C), dtype=torch.float32,
                        device=tiles.device)
        xq, xs = _layer_input(lib, x, cin, rung, stream)
        _build.check("qr_conv3x3_norm_relu_blocked",
                     lib.qr_conv3x3_norm_relu_blocked(
                         xq.data_ptr(), _ptr(xs), blk["w"].data_ptr(),
                         _ptr(blk.get("scale")), blk["b"].data_ptr(),
                         y.data_ptr(), b, l, cin, C, bb, ct,
                         int(double_buffer), rung, stream))
        x, cin = y, C
    return _head(lib, tiles, x, cin, packed, rung, with_embed, stream)


def fused_extractor_blocked_cuda(tiles: torch.Tensor, packed: dict, *,
                                 batch_block: int = 1,
                                 channel_tile: int = 0,
                                 double_buffer: bool = True,
                                 with_embed: bool = False):
    """The blocked CUDA schedule: same contract as the plain version, at
    the pack's rung.  One call is one launch of the op."""
    if tiles.device.type != "cuda":
        raise ValueError("fused_extractor_blocked_cuda needs CUDA tiles")
    rung = _check_pack(tiles, packed)
    b = tiles.shape[0]
    C = packed["blocks"][0]["w"].shape[-1]
    bb, ct = block_sizes(b, C, batch_block, channel_tile)
    check_blocked_schedule(channels=C, tile=tiles.shape[1],
                           channel_tile=channel_tile)
    for blk in packed["blocks"]:
        if blk["w"].shape[-1] != C or blk["w"].data_ptr() % 16:
            raise ValueError("the blocked kernel takes one hidden width "
                             "and 16-byte aligned packed weights")
    if b == 0:
        return _empty(tiles, packed, with_embed)
    out = _launch_blocked(_build.library(), tiles, packed, rung, bb, ct,
                          double_buffer, with_embed,
                          torch.cuda.current_stream(tiles.device).cuda_stream)
    _build.launch_counts["fused_extractor_blocked"] += 1
    return out
