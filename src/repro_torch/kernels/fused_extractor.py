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
  tile and every output column, a thread 8 pixels x 8 columns).  At
  int8 they take each tap's dot on the int8 tensor cores
  (``mma.sync`` m16n8k32, weights re-laid once into the fragments'
  order by :func:`imma_fragments`) and quantize each layer's output in
  their epilogue, so activations travel as int8 words and one fp32
  scale a pixel (:class:`QuantAct`) and no quantize pass runs.  Between
  layers activations go through global memory (one image's fp32
  activation is 1 MiB at l=64, C=64, more than an SM's shared memory).

The blocked schedule (batch block ``bb``, output-channel tile ``ct``,
``double_buffer``; see ``kernels/autotune.Schedule``):

* :func:`fused_extractor_blocked_plain` — the reference's blocked body
  in PyTorch: the batch zero-padded to a multiple of ``bb``, each block
  of ``bb`` images through the packed body with the hidden convs'
  output columns in ``ct`` slices, pad rows sliced off;
* :func:`fused_extractor_blocked_cuda` — the blocked CUDA conv kernel
  for the hidden blocks (``conv_blocked_kernel`` at fp32 and bf16,
  ``conv_blocked_imma_kernel`` at int8), then the flat to_bits and
  head kernels.  It runs the flat kernels' engine (register-tiled at
  fp32 and bf16, the int8 tensor cores at int8, with the quantize in
  each conv's epilogue, so no quantize pass) on four 8x8 pixel slots at
  a time, filled by ``bb`` images, with each channel tile's weight
  slice staged once a block where it fits.  Its logits equal the flat
  kernel's bit for bit on every schedule, at every rung.

All four return ``(logits, embed)`` with ``embed`` the (b, n_bits) GAP
vector when ``with_embed``, else ``logits`` alone.
"""
from __future__ import annotations

import threading
import weakref
from typing import NamedTuple

import torch

from repro_torch.core.extractor import (extractor_forward_packed_embed,
                                        packed_dtype, quantize_rows_int8)
from repro_torch.kernels import _build

# instantiations of the CUDA kernels (csrc/extractor.cuh)
HIDDEN_CHANNELS = (8, 16, 24, 32, 64)
N_BITS = (60,)
# the tile size l is a multiple of PIXEL_TILE on both schedules: the flat
# kernels' pixel tiles are 16x16, the blocked kernels' regions 8x8 to
# 16x16; each GAP / correlation partial covers an 8x16 (rows, cols) tile.  The
# blocked kernel's channel tiles are multiples of 4 dividing the hidden
# width (see blocked_channel_tiles)
PIXEL_TILE = 16
PARTIAL_TILE = (8, 16)
# the C entry points' ``rung`` argument, by the pack's dtype
RUNGS = {"fp32": 0, "bf16": 1, "int8": 2}
# the fp32 and bf16 rungs' type parameter, and each rung's head dtype, in
# the kernels' names
_RUNG_TYPES = ("qr::RF32", "qr::RBF16")
_HEAD_TYPES = ("float", "__nv_bfloat16", "float")
INT8 = RUNGS["int8"]


class QuantAct(NamedTuple):
    """An int8 activation as the int8 kernels pass it between layers
    (both schedules): ``q`` (b, l, l, c / 4) int32, four channels' int8 values to a
    little-endian word, and ``s`` (b, l, l) fp32, one scale a pixel
    (``quantize_rows_int8``'s q and s)."""
    q: torch.Tensor
    s: torch.Tensor


def quantize_words(x2d: torch.Tensor):
    """(M, c) fp32 -> ((M, ceil(c / 4)) int32 words, (M,) fp32 scales):
    ``quantize_rows_int8`` with four channels' int8 values packed into a
    little-endian int32 word (a last partial word padded with zeros), the
    layout the int8 kernels read and write."""
    xq, s = quantize_rows_int8(x2d)
    pad = -x2d.shape[1] % 4
    if pad:
        xq = torch.cat([xq, xq.new_zeros((xq.shape[0], pad))], dim=1)
    return xq.contiguous().view(torch.int32), s[:, 0]


def imma_geometry(cin: int):
    """(words a pixel in memory, k-steps of 32 channels, words the dot
    reads a pixel) of an int8 layer with ``cin`` input channels."""
    cw = -(-cin // 4)
    ks = -(-cw // 8)
    return cw, ks, 8 * ks


def weight_fragments(w2d: torch.Tensor, cin: int) -> torch.Tensor:
    """A packed int8 conv weight (9 * cin, cout) -> the int8 tensor-core
    kernels' B fragments, (9, KS, NT, 32, 2) int32: for tap, k-step kk
    and column tile j, lane 4 g + t holds the words of input channels
    32 kk + 4 t .. + 3 and 32 kk + 16 + 4 t .. + 3 of column 8 j + g
    (``mma.m16n8k32``'s B layout).  Input channels past cin and columns
    past cout (up to a multiple of 8) are zero."""
    cout = w2d.shape[1]
    _, ks, kw = imma_geometry(cin)
    ncol = -(-cout // 8) * 8
    w = w2d.new_zeros((9, 4 * kw, ncol))
    w[:, :cin, :cout] = w2d.reshape(9, cin, cout)
    words = w.reshape(9, kw, 4, ncol).permute(0, 1, 3, 2).contiguous() \
        .view(torch.int32).reshape(9, ks, 2, 4, ncol // 8, 8)
    # (tap, kk, half, t, j, g) -> (tap, kk, j, g, t, half)
    return words.permute(0, 1, 4, 5, 3, 2).reshape(
        9, ks, ncol // 8, 32, 2).contiguous()


# weight fragments per packed int8 conv weight, made once on its device:
# id(weight) -> (weakref to it, versions, (fragments, scales)), dropped
# when the weight is freed; lanes look them up from several threads
_FRAGMENTS: dict = {}
_FRAGMENTS_LOCK = threading.Lock()


def imma_fragments(blk: dict, cin: int):
    """The int8 flat kernels' form of a pack entry: (B fragments of its
    weight, its column scales zero-padded to a multiple of 8), computed
    on the weight's device at first use and cached beside the pack (keyed
    by the weight tensor; the pack itself is left as ``pack_params`` made
    it).  On a card the building stream is synchronized before they are
    cached: lanes on other streams read them."""
    w, scale = blk["w"], blk["scale"]
    key = (w._version, scale.data_ptr(), scale._version, cin)
    with _FRAGMENTS_LOCK:
        hit = _FRAGMENTS.get(id(w))
        if hit is None or hit[0]() is not w or hit[1] != key:
            ncol = -(-w.shape[1] // 8) * 8
            ws = scale.new_zeros(ncol)
            ws[:w.shape[1]] = scale
            frags = weight_fragments(w, cin)
            if w.is_cuda:
                torch.cuda.current_stream(w.device).synchronize()
            if hit is None or hit[0]() is not w:
                weakref.finalize(w, _FRAGMENTS.pop, id(w), None)
            hit = (weakref.ref(w), key, (frags, ws))
            _FRAGMENTS[id(w)] = hit
        return hit[2]


def device_constants(packed: dict):
    """Build what the CUDA decode caches beside a pack (the int8 rung's
    weight fragments, every layer's), so no lane builds it."""
    if packed_dtype(packed) != "int8":
        return
    for blk in packed["blocks"] + [packed["to_bits"]]:
        imma_fragments(blk, blk["w"].shape[0] // 9)


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
    _build.count_kernel(name)


def conv_kernel_name(rung: int, cin: int, cout: int,
                     channel_tile=None) -> str:
    """The CUDA kernel that :func:`conv_block` launches for this layer at
    this rung: ``qr_conv3x3_norm_relu``'s (fp32 / bf16) or
    ``qr_conv3x3_imma``'s (int8), or with a ``channel_tile``
    ``qr_conv3x3_norm_relu_blocked``'s or ``qr_conv3x3_imma_blocked``'s."""
    if rung == INT8:
        return (f"conv_imma_kernel<{cin},{cout}>" if channel_tile is None
                else f"conv_blocked_imma_kernel<{cin},{cout},{channel_tile}>")
    if channel_tile is not None:
        return f"conv_blocked_kernel<{_RUNG_TYPES[rung]},{cout}," \
            f"{channel_tile},{cin}>"
    return f"conv_regtile_kernel<{_RUNG_TYPES[rung]},{cout},{cin}>"


def to_bits_kernel_name(rung: int, cin: int, n_bits: int) -> str:
    """The CUDA kernel that :func:`to_bits_partials` launches on either
    schedule (n_bits is always 60): ``qr_conv3x3_gap_corr``'s (fp32 /
    bf16) or ``qr_conv3x3_gap_corr_imma``'s (int8)."""
    if rung == INT8:
        return f"gap_corr_imma_kernel<{cin}>"
    return f"gap_corr_regtile_kernel<{_RUNG_TYPES[rung]},{cin}>"


def head_kernel_name(rung: int, n_bits: int) -> str:
    """The CUDA kernel that ``qr_extractor_head`` launches."""
    return f"head_kernel<{_HEAD_TYPES[rung]},{n_bits}>"


def is_decode_kernel(name: str) -> bool:
    """Whether a profiled device kernel is one of the decode's (a conv,
    to_bits or the head): what a decode's device time sums."""
    return "qr::" in name and any(
        p in name for p in ("conv_", "gap_corr", "head_kernel"))


def conv_block(lib, x, blk, rung, stream, blocked=None):
    """One hidden block (SAME 3x3 conv + bias + channel_norm + ReLU) of
    the pack entry ``blk`` on the contiguous fp32 activation ``x``
    (b, l, l, cin), cin 3 or a hidden width: the flat kernel
    (``qr_conv3x3_norm_relu``), or with ``blocked = (bb, ct,
    double_buffer)`` the blocked one.  Returns the (b, l, l, cout) fp32
    activation.  At int8 (``qr_conv3x3_imma``, blocked
    ``qr_conv3x3_imma_blocked``) ``x`` is the tiles (cin 3) or the layer
    before's :class:`QuantAct`, and so is what it returns.  A kernel
    launch of the op, not the op: it counts in ``kernel_launches``, not
    in ``launch_counts``."""
    if rung == INT8:
        return _conv_block_imma(lib, x, blk, stream, blocked)
    b, l, cin = x.shape[0], x.shape[1], x.shape[3]
    cout = blk["w"].shape[-1]
    y = torch.empty((b, l, l, cout), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), blk["w"].data_ptr(), blk["b"].data_ptr(),
            y.data_ptr(), b, l, cin, cout)
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


def _conv_block_imma(lib, x, blk, stream, blocked=None) -> QuantAct:
    """The int8 hidden block on either schedule: fp32 tiles or a
    :class:`QuantAct` in, a :class:`QuantAct` out.  The blocked kernel
    at ct < C keeps each pass's pre-norm columns in an fp32 (b, l, l, C)
    scratch, allocated here."""
    if isinstance(x, QuantAct):
        xq, xs, cin = x.q, x.s, 4 * x.q.shape[3]
    else:
        xq, xs, cin = x, None, x.shape[3]
    b, l = xq.shape[0], xq.shape[1]
    cout = blk["w"].shape[-1]
    frags, ws = imma_fragments(blk, cin)
    out = QuantAct(
        torch.empty((b, l, l, cout // 4), dtype=torch.int32,
                    device=xq.device),
        torch.empty((b, l, l), dtype=torch.float32, device=xq.device))
    args = (xq.data_ptr(), _ptr(xs), frags.data_ptr(), ws.data_ptr(),
            blk["b"].data_ptr(), out.q.data_ptr(), out.s.data_ptr())
    if blocked is None:
        _build.check("qr_conv3x3_imma", lib.qr_conv3x3_imma(
            *args, b, l, cin, cout, stream))
    else:
        bb, ct, db = blocked
        scratch = None if ct == cout else torch.empty(
            (b, l, l, cout), dtype=torch.float32, device=xq.device)
        _build.check("qr_conv3x3_imma_blocked", lib.qr_conv3x3_imma_blocked(
            *args, _ptr(scratch), b, l, cin, cout, bb, ct, int(db), stream))
    _launched(conv_kernel_name(INT8, cin, cout,
                               None if blocked is None else blocked[1]))
    return out


def _launch_flat(lib, tiles, packed, rung, with_embed, stream):
    """The flat schedule's launches on one stream (D + 2 kernels)."""
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
                       _build.current_stream(tiles.device))
    _build.count("fused_extractor")
    return out


def _empty(tiles, packed, with_embed):
    n_bits = packed["head"]["b"].shape[0]
    empty = torch.empty((0, n_bits), dtype=torch.float32,
                        device=tiles.device)
    return (empty, empty.clone()) if with_embed else empty


def to_bits_partials(lib, tiles, x, packed, rung, stream):
    """The to_bits + GAP + correlation kernel on the last hidden
    activation ``x`` (at int8 a :class:`QuantAct`, on either schedule):
    the
    (b * (l / 8) * (l / 16), n_bits) GAP partials and, when the
    correlation bank applies at this tile size, the correlation
    partials (else None), one row per 8x16 pixel tile, tile-major
    within an image."""
    imma = rung == INT8
    xq = x.q if imma else x
    b, l = xq.shape[0], xq.shape[1]
    cin = 4 * xq.shape[3] if imma else xq.shape[3]
    n_bits = packed["head"]["b"].shape[0]
    n_tiles = (l // PARTIAL_TILE[0]) * (l // PARTIAL_TILE[1])
    has_corr = "corr" in packed and packed["corr"].shape[0] == l * l
    part_gap = torch.empty((b * n_tiles, n_bits), dtype=torch.float32,
                           device=xq.device)
    part_corr = torch.empty_like(part_gap) if has_corr else None
    tb = packed["to_bits"]
    corr = _ptr(packed["corr"] if has_corr else None)
    if imma:
        frags, ws = imma_fragments(tb, cin)
        _build.check("qr_conv3x3_gap_corr_imma", lib.qr_conv3x3_gap_corr_imma(
            x.q.data_ptr(), x.s.data_ptr(), frags.data_ptr(), ws.data_ptr(),
            tb["b"].data_ptr(), tiles.data_ptr(), corr, part_gap.data_ptr(),
            _ptr(part_corr), b, l, cin, n_bits, int(has_corr), stream))
        _launched(to_bits_kernel_name(rung, cin, n_bits))
        return part_gap, part_corr
    _build.check("qr_conv3x3_gap_corr", lib.qr_conv3x3_gap_corr(
        x.data_ptr(), tb["w"].data_ptr(), tb["b"].data_ptr(),
        tiles.data_ptr(), corr, part_gap.data_ptr(), _ptr(part_corr), b, l,
        cin, n_bits, int(has_corr), rung, stream))
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
    """The blocked schedule's launches (D + 2 kernels): the blocked conv
    per hidden block, then the flat to_bits and head kernels."""
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
                          _build.current_stream(tiles.device))
    _build.count("fused_extractor_blocked")
    return out
