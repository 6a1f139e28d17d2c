"""PyTorch port: the blocked int8 decode conv on the int8 tensor cores
(``conv_blocked_imma_kernel``, ``src/repro_torch/kernels/csrc/
fused_extractor_int8.cu``), modelled on the CPU, where no CUDA kernel
runs.

A numpy model of one launch, lane for lane where the kernel differs from
the flat one and on the flat one's lane model (``tests/test_torch_int8.py``:
``ldmatrix.x4``, ``mma.m16n8k32`` s8, the weight fragments, the 1.5 * 2^23
accumulator start and the dequantize fold) where it shares it:

* the grid (``bk_blocks``) and each block's images and region
  (``bk_region``), the four 8x8 slots of a round and the (image, subtile)
  pair of each, idle slots of a ragged last block;
* each slot's 10x10 halo as ``imma_halo`` lays it out (layer 0
  quantizing the fp32 tiles as they land), warp w on slot w / 2 with its
  two fragments of two 8-pixel rows, the lanes' ``ldmatrix`` row addresses
  and the rows' scales as the kernel computes them;
* each channel tile's slice of B fragments (``stage_fragments``: the
  tile's 8-column tiles, one of them at ct 4, whose other half is
  dropped), staged at the top of its pass, or with db prefetched into the
  other buffer during the pass before;
* ct = C: the pre-norm rows staged at ``frag_pixel`` / ``frag_col`` and
  each pixel's epilogue one thread a pixel; ct < C: each pass's columns
  written to the fp32 scratch, then each round's rows read back and the
  same epilogue (``norm_relu_quantize``: ``norm_relu`` in channel order,
  then the quantize of ``quantize_rows_int8``).

Its pre-norm values equal the plain blocked conv (``conv3x3_mm`` on the
int8 pack with the channel tile) and the flat kernel's model bit for bit,
each (pixel, column) written once a pass and each pixel's words and scale
once; its words and scales equal ``quantize_words`` of the plain blocked
conv's activation (normalised with the kernel's float32 chain) bit for
bit.  With the model in place of the hidden convs, the decode equals
``fused_extractor_blocked_plain`` at int8 bit for bit.  The expressions
the model copies are checked against the source text.  Exact equality is
the tolerance throughout: the int32 dots are exact and every float
operation is the kernel's, in its order.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import extractor as ex
from repro_torch.kernels import _build
from repro_torch.kernels import fused_extractor as fx
from test_torch_blocked import bk_blocks, bk_region, norm_relu
from test_torch_int8 import (G, IT, MAGIC, T, kernel_model, ldmatrix_x4,
                             mma_model, quantize_model)

torch.set_num_threads(1)

SRC = (_build.CSRC / "fused_extractor_int8.cu").read_text()
FLAT = " ".join(SRC.split())
CUH = " ".join((_build.CSRC / "extractor.cuh").read_text().split())
F32 = np.float32
m_ = re.search(r"constexpr int BS = (\d+), BSLOTS = (\d+), BHW = BS \+ 2",
               CUH)
BS, BSLOTS = int(m_.group(1)), int(m_.group(2))
BHW = BS + 2        # a slot's halo side and pitch
SLOT = BHW * BHW    # pixels of a slot's halo


def test_model_index_math_is_the_kernels():
    """The expressions the model copies, as the kernel writes them."""
    for expr in (
            # grid, region, pairs and rounds as the fp32 blocked kernel's
            "<<<bk_blocks(b, l, bb), ITHREADS, smem, stream>>>(",
            "const int q = bk_region(bb), qw = q == 1 ? 1 : 2, "
            "qh = q == 4 ? 2 : 1;",
            "const int img0 = blockIdx.x / regions * bb, "
            "reg = blockIdx.x % regions;",
            "const int pairs = min(bb, b - img0) * q;",
            "img = img0 + p / q; y0 = ry0 + (p % q) / qw * BS; "
            "x0 = rx0 + (p % q) % qw * BS; return p < pairs;",
            # the slot halos and the warps' fragments
            "imma_halo<CIN, BHW>(x, xs, s_in + s * K::SLOT * G::P, "
            "s_sc + s * K::SLOT, img, y0, x0, l);",
            "const int gy = y0 + p / HW - 1, gx = x0 + p % HW - 1;",
            "const int slot = warp >> 1;",
            "const int first = slot * K::SLOT + 4 * (warp & 1) * BHW;",
            "s_in, first + ((lane >> 3) & 1) * BHW + (lane & 7));",
            "const int s_row = first + (lane >> 2);",
            "imma_tap<CIN, NT, BHW, 2 * BHW, true>(0, a_row, s_row, s_sc, "
            "w_lane, s_ws + 8 * nt0, acc);",
            "tap / 3 * BHW + tap % 3, a_row, s_row, s_sc, "
            "w_lane + tap * G::KS * NT * 32, s_ws + 8 * nt0, acc);",
            "const int off = toff + m * MSTEP;",
            "sx[m][1] = s_sc[s_row + off + R8];",
            # the channel tiles and their slices
            "static constexpr int NT = (CT + 7) / 8;",
            "static constexpr int NJ = COUT / CT;",
            "const int nt0 = jt * CT / 8;",
            "const int2* w_lane = s_w0 + (two ? (jt & 1) * K::SLICE : 0) "
            "+ lane;",
            "const bool two = db && NJ > 1;",
            "const bool fresh = jt == 0 || rounds > 1;",
            "const bool prefetch = two && jt + 1 < NJ && r == 0;",
            "stage_fragments<CIN, NT>(wf, s_w0 + ((jt + 1) & 1) * K::SLICE, "
            "COUT / 8, (jt + 1) * CT / 8);",
            "stage_fragments<CIN, NT>(wf, s_w0, COUT / 8, nt0);",
            "cp_async16(reinterpret_cast<char*>(s_w + tk * NT * 32) + "
            "16 * c, reinterpret_cast<const char*>(wf + (tk * ntt + nt0) * "
            "32) + 16 * c);",
            # the stores, the read-back and the epilogue
            "stage_pre<NT, SP>(s_pre, acc);",
            "s_pre[frag_pixel(m, i) * SP + frag_col(j, i)] = acc[m][j][i];",
            "return (2 * (threadIdx.x >> 5) + m) * IT + "
            "((threadIdx.x & 31) >> 2) + 8 * (i >> 1);",
            "return 8 * j + 2 * (threadIdx.x & 3) + (i & 1);",
            "const int col = 8 * (nt0 + j) + 2 * (lane & 3);",
            "if (col / CT != jt) continue;",
            "const int row = 4 * (warp & 1) + 2 * m + h;",
            "(img * l + y0 + row) * l + x0 + (lane >> 2);",
            "make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);",
            "const int p = e / (COUT / 4), c4 = e % (COUT / 4);",
            "if (origin(r * BSLOTS + p / (BS * BS), img, y0, x0)) {",
            "(img * l + y0 + p % (BS * BS) / BS) * l + x0 + p % BS;",
            "s_out[gp] = norm_relu_quantize<COUT>( s_pre + p * SP, bias,"):
        assert expr in FLAT, expr
    assert "quantize_rows_kernel" not in SRC


def _halos(x, xs, img, y0, x0, act, cin: int, l: int):
    """``imma_halo<CIN, BHW>`` of each slot instance (its image, origin and
    whether it is active): (n, SLOT, P) int32 words and (n, SLOT) scales,
    zero outside the image; an idle slot's halo is left as zeros (the
    kernel loads none)."""
    cw, _, kw = fx.imma_geometry(cin)
    p = np.arange(SLOT)
    gy = y0[:, None] + p // BHW - 1
    gx = x0[:, None] + p % BHW - 1
    inside = (gy >= 0) & (gy < l) & (gx >= 0) & (gx < l) & act[:, None]
    im = np.broadcast_to(img[:, None], gy.shape)[inside]
    gy, gx = gy[inside], gx[inside]
    halo = np.zeros((len(img), SLOT, kw + 4), np.int32)
    s_sc = np.zeros((len(img), SLOT), F32)
    if cin == 3:
        words, s = quantize_model(x[im, gy, gx])
        halo[inside, 0] = words[:, 0]
    else:
        halo[inside, :cw] = x[im, gy, gx]
        s = xs[im, gy, gx]
    s_sc[inside] = s
    return halo, s_sc


def check_slices(NJ: int, rounds: int, db: bool):
    """The slice buffers through a block's passes: the taps of pass jt
    read slice jt in every round, staged at the top of its pass, or with
    db prefetched into the other buffer during the pass before."""
    two = db and NJ > 1
    bufs = [0, None] if two else [None]
    for jt in range(NJ):
        if not two:
            bufs[0] = jt
        for r in range(rounds):
            if two and jt + 1 < NJ and r == 0:
                bufs[(jt + 1) & 1] = jt + 1
            assert bufs[(jt & 1) if two else 0] == jt


def blocked_model(x, xs, frags, ws, bias, *, cin: int, C: int, l: int,
                  bb: int, ct: int, dbs=(True, False)):
    """One ``conv_blocked_imma_kernel`` launch: x the (b, l, l, 3) fp32
    tiles (cin 3) or (b, l, l, cin / 4) int32 words with their (b, l, l)
    scales xs; frags, ws: ``imma_fragments``.  Every (block, round, slot)
    is one slot instance, all of them computed at once; db changes only
    which buffer holds a slice (``check_slices``, for each of ``dbs``),
    not a value.  Returns
    (pre-norm (b, l, l, C) as staged or written to the scratch, words (b,
    l, l, C / 4), scales (b, l, l), writes per (pixel, column) per pass,
    writes per pixel)."""
    b = x.shape[0]
    _, ks, kw = fx.imma_geometry(cin)
    P = kw + 4
    NT, NJ = (ct + 7) // 8, C // ct
    q = bk_region(bb)
    qw, qh = (1 if q == 1 else 2), (2 if q == 4 else 1)
    rcols = l // (BS * qw)
    regions = rcols * (l // (BS * qh))
    # the slot instances, four a (block, round), slot-major
    inst = []
    for blk in range(bk_blocks(b, l, bb)):
        img0, reg = blk // regions * bb, blk % regions
        ry0, rx0 = reg // rcols * BS * qh, reg % rcols * BS * qw
        pairs = min(bb, b - img0) * q
        rounds = -(-pairs // BSLOTS)
        for db in dbs:
            check_slices(NJ, rounds, db)
        for p in range(rounds * BSLOTS):
            inst.append((img0 + p // q, ry0 + (p % q) // qw * BS,
                         rx0 + (p % q) % qw * BS, p < pairs))
    img, y0, x0, act = (np.array(v) for v in zip(*inst))
    n = len(inst)
    halo, s_sc = _halos(x, xs, img, y0, x0, act, cin, l)
    hb, sc = halo.view(np.uint8).reshape(-1), s_sc.reshape(-1)
    base = (np.arange(n) * SLOT)[:, None, None]
    # warp w = 2 s + hw on slot s; its lanes' ldmatrix row pixel and the
    # scale row of fragment 0 at tap 0
    lane = np.arange(32)
    first = 4 * np.arange(2)[:, None] * BHW
    a_pix = first + ((lane >> 3) & 1) * BHW + (lane & 7)      # (2, 32)
    s_row = first + G                                        # (2, 32)
    ws = np.asarray(ws, F32)
    slot = np.arange(n) % BSLOTS
    pre = np.full((b, l, l, C), np.nan, F32)
    pass_writes = np.zeros((NJ, b, l, l, C), np.int64)
    staged = np.full((n // BSLOTS, BSLOTS * BS * BS, C), np.nan, F32)
    scratch = np.full((b, l, l, C), np.nan, F32)
    # every pass at once: pass jt's slice is 8-column tiles nt0 .. + NT
    nt0 = np.arange(NJ) * ct // 8
    sl = np.stack([frags[:, :, t:t + NT] for t in nt0])  # (NJ, 9, KS, NT..)
    col = 8 * (nt0[:, None] + np.arange(NT))[:, :, None, None] + \
        2 * T[None, None, :, None] + (np.arange(4) & 1)   # (NJ, NT, 32, 4)
    accs = None
    for tap in range(9):
        toff = tap // 3 * BHW + tap % 3
        c = np.zeros((NJ, n, 2, 2, NT, 32, 4), np.int32) + MAGIC
        sx = np.zeros((n, 2, 2, 32, 2), F32)
        for m in range(2):
            off = toff + m * 2 * BHW
            sx[:, :, m, :, 0] = sc[base + s_row + off]
            sx[:, :, m, :, 1] = sc[base + s_row + off + BHW]
            for kk in range(ks):
                addr = (base + a_pix + off) * P * 4 + \
                    16 * (lane >> 4) + 32 * kk
                a = ldmatrix_x4(hb, addr)                    # (n, 2, 32, 4)
                d = mma_model(
                    np.broadcast_to(a[None, :, :, None], (NJ, n, 2, NT, 32, 4)),
                    np.broadcast_to(sl[:, None, None, tap, kk],
                                    (NJ, n, 2, NT, 32, 2)))
                c[:, :, :, m] = d + (c[:, :, :, m] - MAGIC)
        dot = c.view(F32) - F32(12582912.0)
        dq = (dot * sx[None, :, :, :, None, :, np.arange(4) >> 1]) * \
            ws[col][:, None, None, None]
        accs = dq if tap == 0 else accs + dq
    for jt in range(NJ):
        acc = accs[jt]
        # acc (instance, hw, m, j, lane, i)
        if NJ == 1:  # stage_pre into its (block, round)'s rows
            cnt = np.zeros(staged.shape[1:], np.int64)
            for hw in range(2):
                for m in range(2):
                    for i in range(4):
                        for j in range(NT):
                            pix = (2 * (2 * slot + hw) + m)[:, None] * IT + \
                                G + 8 * (i >> 1)             # frag_pixel
                            cols = 8 * j + 2 * T + (i & 1)   # frag_col
                            staged[np.arange(n)[:, None] // BSLOTS, pix,
                                   cols] = acc[:, hw, m, j, :, i]
                            np.add.at(cnt, (pix[:BSLOTS], cols), 1)
            assert (cnt == 1).all()
            continue
        for hw in range(2):      # pass jt's columns to the scratch
            for m in range(2):
                for j in range(NT):
                    for hh in range(2):
                        col = 8 * (nt0[jt] + j) + 2 * T
                        keep = col // ct == jt
                        row = 4 * hw + 2 * m + hh
                        k = np.nonzero(act)[0][:, None]
                        ii, yy = img[k], y0[k] + row
                        xx = x0[k] + G[keep]
                        for e in range(2):
                            scratch[ii, yy, xx, col[keep] + e] = \
                                acc[k, hw, m, j, np.nonzero(keep)[0],
                                    2 * hh + e]
                            np.add.at(pass_writes[jt],
                                      (ii, yy, xx, col[keep] + e), 1)
    # the epilogue, one thread a pixel of each (block, round)'s rows
    p = np.arange(BSLOTS * BS * BS)
    k = np.arange(n // BSLOTS)[:, None] * BSLOTS + p // (BS * BS)
    live = act[k]
    ii = img[k][live]
    yy = (y0[k] + p % (BS * BS) // BS)[live]
    xx = (x0[k] + p % BS)[live]
    if NJ > 1:  # read back from the scratch
        staged[live] = scratch[ii, yy, xx]
    rows = staged[live]
    pre[ii, yy, xx] = rows
    if NJ == 1:
        np.add.at(pass_writes[0], (ii, yy, xx), 1)
    words = np.full((b, l, l, C // 4), 0x7f7f7f7f, np.int32)
    scales = np.full((b, l, l), np.nan, F32)
    out_writes = np.zeros((b, l, l), np.int64)
    wq, sq = quantize_model(norm_relu(rows, bias))
    words[ii, yy, xx], scales[ii, yy, xx] = wq, sq
    np.add.at(out_writes, (ii, yy, xx), 1)
    return pre, words, scales, pass_writes, out_writes


def _pack(C: int, depth: int, seed: int = 0):
    return ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        seed, n_bits=60, channels=C, depth=depth, tile=0,
        bias_scale=0.1)), "int8")


def _hold(C, b, l, bb, ct, seed):
    """Layer 0 and a C -> C block of an int8 pack on b ragged images:
    the model against the plain blocked conv, the flat model, and
    quantize_words of the plain activation, bit for bit."""
    pk = _pack(C, 2, seed)
    tiles = np.random.default_rng(seed).uniform(
        -2.0, 2.5, (b, l, l, 3)).astype(F32)
    x, xs, cin, xp = tiles, None, 3, torch.from_numpy(tiles)
    for blk in pk["blocks"]:
        frags, ws = fx.imma_fragments(blk, cin)
        bias = blk["b"].numpy()
        pre, words, scales, pass_writes, out_writes = blocked_model(
            x, xs, frags.numpy(), ws.numpy(), bias, cin=cin, C=C, l=l,
            bb=bb, ct=ct)
        assert (out_writes == 1).all()
        for jt in range(C // ct):   # each pass writes its columns once
            cols = np.arange(C) // ct == jt
            assert (pass_writes[jt][..., cols] == 1).all()
            assert (pass_writes[jt][..., ~cols] == 0).all()
        want = ex.conv3x3_mm(xp, blk["w"], blk["scale"], channel_tile=ct) \
            .numpy().reshape(b, l, l, C)
        assert np.array_equal(pre.view(np.int32), want.view(np.int32))
        flat = kernel_model(x, xs, frags.numpy(), ws.numpy(), cin, C,
                            b - 1, l // IT - 1, 0, l)
        assert np.array_equal(flat, pre[b - 1, l - IT:, :IT].reshape(IT * IT,
                                                                    C))
        act = norm_relu(want.reshape(-1, C), bias)
        qw, sw = fx.quantize_words(torch.from_numpy(act))
        assert np.array_equal(words.reshape(-1, C // 4), qw.numpy())
        assert np.array_equal(scales.reshape(-1), sw.numpy())
        x, xs, cin = words, scales, C
        xp = torch.from_numpy(act.reshape(b, l, l, C))


@pytest.mark.parametrize("l,bb", [(16, 1), (16, 2), (16, 3), (16, 4),
                                  (16, 8), (32, 1), (32, 2), (32, 3),
                                  (32, 4), (32, 8)])
@pytest.mark.parametrize("ct", fx.blocked_channel_tiles(16))
def test_model_equals_flat_and_plain(l, bb, ct):
    """C 16, b 5 (ragged at bb 2, 3, 4 and 8), layer 0 and a 16 -> 16
    block at every channel tile, db on and off."""
    _hold(16, 5, l, bb, ct, seed=l * 100 + bb * 10 + ct)


@pytest.mark.parametrize("ct", [64, 32])
def test_model_full_width(ct):
    """C 64 (b 2, l 16, bb 4): two k-steps a tap; ct = C and two passes."""
    _hold(64, 2, 16, 4, ct, seed=ct)


def test_grid_and_shared_memory():
    """Every batch block keeps at least 256 blocks at b = 32, l = 64;
    every instantiation's shared memory leaves room for two blocks an
    SM (228 KB, 1 KB of it kept a block): the staged rows over the slot
    halos and their scales, the column scales, two slices with db."""
    for bb in (1, 2, 4, 8):
        assert bk_blocks(32, 64, bb) >= 256
    for C in fx.HIDDEN_CHANNELS:
        for ct in fx.blocked_channel_tiles(C):
            for cin in (3, C):
                _, ks, kw = fx.imma_geometry(cin)
                halo = BSLOTS * SLOT * (kw + 4) * 4 + BSLOTS * SLOT * 4
                stage = BSLOTS * BS * BS * (C + 1) * 4
                w = ((max(halo, stage) + 15) & ~15) + C * 4
                nj = C // ct
                end = w + (2 if nj > 1 else 1) * 9 * ks * \
                    ((ct + 7) // 8) * 32 * 8
                assert 2 * (end + 1024) <= 233472, (C, ct, cin)
    for expr in ("static constexpr int SC = BSLOTS * SLOT * G::P * 4;",
                 "static constexpr int HALO_END = SC + BSLOTS * SLOT * 4;",
                 "static constexpr int STAGE = BSLOTS * BS * BS * (COUT + 1) "
                 "* 4;",
                 "static constexpr int WS = ((HALO_END > STAGE ? HALO_END : "
                 "STAGE) + 15) & ~15;",
                 "static constexpr int W = WS + COUT * 4;",
                 "static constexpr int SLICE = 9 * G::KS * NT * 32;",
                 "static constexpr int END2 = W + (NJ > 1 ? 2 : 1) * SLICE "
                 "* 8;",
                 "2 * (END2 + 1024) <= 233472"):
        assert expr in FLAT, expr


@pytest.mark.parametrize("bb,ct", [(2, 0), (4, 8), (3, 4)])
def test_model_decode_equals_blocked_plain(monkeypatch, bb, ct):
    """The int8 decode with the model in place of every hidden conv, on
    the whole ragged batch (b 5, C 16, D 3, l 32, correlation bank; each
    conv's input quantized as the kernel before it writes it), equals
    ``fused_extractor_blocked_plain`` at int8 bit for bit, logits and
    embedding."""
    pk = ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        0, n_bits=60, channels=16, depth=3, tile=32, bias_scale=0.1)),
        "int8")
    tiles = torch.as_tensor(np.random.default_rng(9).uniform(
        -2.0, 2.5, (5, 32, 32, 3)).astype(F32))
    want = fx.fused_extractor_blocked_plain(
        tiles, pk, batch_block=bb, channel_tile=ct, with_embed=True)
    plain_conv = ex.conv3x3_mm
    ct_ = ct or 16
    blocks = {id(blk["w"]): blk for blk in pk["blocks"]}

    def conv(x, w2d, scale=None, channel_tile=0):
        if id(w2d) not in blocks:  # to_bits: the flat kernel's
            return plain_conv(x, w2d, scale, channel_tile)
        assert channel_tile == ct_
        b, l, _, cin = x.shape
        if cin == 3:
            xin, xs = x.numpy(), None
        else:
            qw, sw = fx.quantize_words(x.reshape(-1, cin))
            xin, xs = qw.numpy().reshape(b, l, l, -1), \
                sw.numpy().reshape(b, l, l)
        frags, ws = fx.imma_fragments(blocks[id(w2d)], cin)
        pre, *_ = blocked_model(xin, xs, frags.numpy(), ws.numpy(),
                                np.zeros(16, F32), cin=cin, C=16, l=l,
                                bb=min(bb, b), ct=ct_)
        return torch.from_numpy(pre.reshape(-1, 16))

    monkeypatch.setattr(ex, "conv3x3_mm", conv)
    got = ex.extractor_forward_packed_embed(pk, tiles, ct_)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32),
                              w.numpy().view(np.int32))
