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
  block with a fused bias + channel_norm + ReLU epilogue
  (:func:`conv_block`), a to_bits kernel that also reduces the GAP and
  correlation partials per 8x16 pixel tile (:func:`to_bits_partials`),
  and a head kernel (:func:`head_logits`).  At fp32 and bf16 the conv
  and to_bits kernels are register-tiled (a block owns a 16x16 pixel
  tile and every output column, a thread 8 pixels x 8 columns); the
  int8 rung keeps one thread per pixel of an 8x16 tile and adds a pass
  before each conv that quantizes its input once per pixel.
  Activations go through global memory between layers, in fp32 (one
  image's activation is 1 MiB at l=64, C=64, more than an SM's shared
  memory).

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
# the tile size l is a multiple of PIXEL_TILE on both schedules: the
# pixel tiles are 16x16 (flat fp32 / bf16, blocked) and 8x16 (flat int8);
# each GAP / correlation partial covers an 8x16 (rows, cols) tile.  The
# blocked kernel's channel tiles are multiples of 4 dividing the hidden
# width (see blocked_channel_tiles)
PIXEL_TILE = 16
PARTIAL_TILE = (8, 16)
# the C entry points' ``rung`` argument, by the pack's dtype
RUNGS = {"fp32": 0, "bf16": 1, "int8": 2}
# each rung's type parameter and head dtype in the kernels' names
_RUNG_TYPES = ("qr::RF32", "qr::RBF16", "qr::RI8")
_HEAD_TYPES = ("float", "__nv_bfloat16", "float")


def fused_extractor_plain(tiles: torch.Tensor, packed: dict, *,
                          with_embed: bool = False):
    logits, g = extractor_forward_packed_embed(packed, tiles)
    return (logits, g) if with_embed else logits


def check_tile(tile: int):
    """Raise ValueError unless the CUDA decode kernels (either schedule)
    take tiles of ``tile`` x ``tile`` pixels."""
    if tile % PIXEL_TILE:
        raise ValueError(f"tile size {tile} must be a multiple of "
                         f"{PIXEL_TILE} for the CUDA decode kernels")


def _check_pack(tiles: torch.Tensor, packed: dict) -> int:
    """Raise ValueError for inputs the CUDA kernels do not take; return
    the pack's rung id (``RUNGS``)."""
    if tiles.dim() != 4 or tiles.shape[1] != tiles.shape[2] or \
            tiles.shape[3] != 3:
        raise ValueError(f"tiles must be (b, l, l, 3), got "
                         f"{tuple(tiles.shape)}")
    check_tile(tiles.shape[1])
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
    if any(blk["w"].data_ptr() % 16
           for blk in packed["blocks"] + [packed["to_bits"]]):
        raise ValueError("the CUDA decode kernels take 16-byte aligned "
                         "packed conv weights")
    n_bits = packed["head"]["b"].shape[0]
    if n_bits not in N_BITS or packed["to_bits"]["w"].shape[-1] != n_bits:
        raise ValueError(f"n_bits {n_bits} not in {N_BITS}")
    return RUNGS[dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(name: str):
    """Count one launch of the CUDA kernel ``name``
    (``_build.kernel_launches``)."""
    _build.kernel_launches[name] = _build.kernel_launches.get(name, 0) + 1


def conv_kernel_name(rung: int, cin: int, cout: int,
                     channel_tile=None) -> str:
    """The CUDA kernel that ``qr_conv3x3_norm_relu`` (or, with a
    ``channel_tile``, ``qr_conv3x3_norm_relu_blocked``) launches for
    this layer at this rung."""
    r = _RUNG_TYPES[rung]
    if channel_tile is not None:
        return f"conv_blocked_kernel<{r},{cout},{channel_tile}>"
    if rung == RUNGS["int8"]:
        return f"conv_norm_relu_kernel<{r},{cout}>"
    return f"conv_regtile_kernel<{r},{cout},{cin}>"


def to_bits_kernel_name(rung: int, cin: int, n_bits: int) -> str:
    """The CUDA kernel that ``qr_conv3x3_gap_corr`` launches."""
    r = _RUNG_TYPES[rung]
    if rung == RUNGS["int8"]:
        return f"conv_gap_corr_kernel<{r},{n_bits}>"
    return f"gap_corr_regtile_kernel<{r},{cin}>"


def head_kernel_name(rung: int, n_bits: int) -> str:
    """The CUDA kernel that ``qr_extractor_head`` launches."""
    return f"head_kernel<{_HEAD_TYPES[rung]},{n_bits}>"


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
    _launched("quantize_rows_kernel")
    return q, s


def conv_block(lib, x, blk, rung, stream, blocked=None):
    """One hidden block (SAME 3x3 conv + bias + channel_norm + ReLU) of
    the pack entry ``blk`` on the contiguous fp32 activation ``x``
    (b, l, l, cin), cin 3 or a hidden width: the flat kernel
    (``qr_conv3x3_norm_relu``), or with ``blocked = (bb, ct,
    double_buffer)`` the blocked one; at int8 after the quantize pass.
    Returns the (b, l, l, cout) activation.  A kernel launch of the op,
    not the op: it counts in ``kernel_launches``, not in
    ``launch_counts``."""
    b, l, cin = x.shape[0], x.shape[1], x.shape[3]
    cout = blk["w"].shape[-1]
    y = torch.empty((b, l, l, cout), dtype=torch.float32, device=x.device)
    xq, xs = _layer_input(lib, x, cin, rung, stream)
    args = (xq.data_ptr(), _ptr(xs), blk["w"].data_ptr(),
            _ptr(blk.get("scale")), blk["b"].data_ptr(), y.data_ptr(), b, l,
            cin, cout)
    if blocked is None:
        _build.check("qr_conv3x3_norm_relu", lib.qr_conv3x3_norm_relu(
            *args, rung, stream))
        _launched(conv_kernel_name(rung, cin, cout))
    else:
        bb, ct, db = blocked
        _build.check("qr_conv3x3_norm_relu_blocked",
                     lib.qr_conv3x3_norm_relu_blocked(
                         *args, bb, ct, int(db), rung, stream))
        _launched(conv_kernel_name(rung, cin, cout, ct))
    return y


def _launch_flat(lib, tiles, packed, rung, with_embed, stream):
    """The flat schedule's launches on one stream (D + 2 kernels, plus a
    quantize pass per conv at int8)."""
    x = tiles
    for blk in packed["blocks"]:
        x = conv_block(lib, x, blk, rung, stream)
    return _head(lib, tiles, x, packed, rung, with_embed, stream)


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


def to_bits_partials(lib, tiles, x, packed, rung, stream):
    """The to_bits + GAP + correlation kernel on the last hidden
    activation ``x`` (at int8 after the quantize pass): the
    (b * (l / 8) * (l / 16), n_bits) GAP partials and, when the
    correlation bank applies at this tile size, the correlation
    partials (else None), one row per 8x16 pixel tile, tile-major
    within an image."""
    b, l, cin = x.shape[0], x.shape[1], x.shape[3]
    n_bits = packed["head"]["b"].shape[0]
    n_tiles = (l // PARTIAL_TILE[0]) * (l // PARTIAL_TILE[1])
    has_corr = "corr" in packed and packed["corr"].shape[0] == l * l
    part_gap = torch.empty((b * n_tiles, n_bits), dtype=torch.float32,
                           device=x.device)
    part_corr = torch.empty_like(part_gap) if has_corr else None
    tb = packed["to_bits"]
    xq, xs = _layer_input(lib, x, cin, rung, stream)
    _build.check("qr_conv3x3_gap_corr", lib.qr_conv3x3_gap_corr(
        xq.data_ptr(), _ptr(xs), tb["w"].data_ptr(), _ptr(tb.get("scale")),
        tb["b"].data_ptr(), tiles.data_ptr(),
        _ptr(packed["corr"] if has_corr else None), part_gap.data_ptr(),
        _ptr(part_corr), b, l, cin, n_bits, int(has_corr), rung, stream))
    _launched(to_bits_kernel_name(rung, cin, n_bits))
    return part_gap, part_corr


def head_logits(lib, part_gap, part_corr, packed, rung, l, with_embed,
                stream):
    """The head kernel on :func:`to_bits_partials`' partials: (b,
    n_bits) logits, and the GAP embedding when ``with_embed``."""
    n_bits = packed["head"]["b"].shape[0]
    b = part_gap.shape[0] // ((l // PARTIAL_TILE[0]) *
                              (l // PARTIAL_TILE[1]))
    has_corr = part_corr is not None
    logits = torch.empty((b, n_bits), dtype=torch.float32,
                         device=part_gap.device)
    embed = torch.empty_like(logits) if with_embed else None
    _build.check("qr_extractor_head", lib.qr_extractor_head(
        part_gap.data_ptr(), _ptr(part_corr),
        packed["head"]["w"].data_ptr(), packed["head"]["b"].data_ptr(),
        _ptr(packed["corr_scale"] if has_corr else None), logits.data_ptr(),
        _ptr(embed), b, l, n_bits, int(has_corr), rung, stream))
    _launched(head_kernel_name(rung, n_bits))
    return (logits, embed) if with_embed else logits


def _head(lib, tiles, x, packed, rung, with_embed, stream):
    parts = to_bits_partials(lib, tiles, x, packed, rung, stream)
    return head_logits(lib, *parts, packed, rung, tiles.shape[1],
                       with_embed, stream)


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
    check_tile(tile)


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
    x = tiles
    for blk in packed["blocks"]:
        x = conv_block(lib, x, blk, rung, stream,
                       blocked=(bb, ct, double_buffer))
    return _head(lib, tiles, x, packed, rung, with_embed, stream)


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
    if any(blk["w"].shape[-1] != C for blk in packed["blocks"]):
        raise ValueError("the blocked kernel takes one hidden width")
    if b == 0:
        return _empty(tiles, packed, with_embed)
    out = _launch_blocked(_build.library(), tiles, packed, rung, bb, ct,
                          double_buffer, with_embed,
                          torch.cuda.current_stream(tiles.device).cuda_stream)
    _build.launch_counts["fused_extractor_blocked"] += 1
    return out
