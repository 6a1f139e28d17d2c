"""PyTorch port: the int8 flat decode's tensor-core kernels
(``src/repro_torch/kernels/csrc/fused_extractor_int8.cu``), modelled on
the CPU, where no CUDA kernel runs.

* The weight fragments the kernels read (``imma_fragments``, made once
  on the device beside the pack) round-trip to ``pack_params``' int8
  weights, which equal the reference's.
* The epilogue's quantize (``norm_relu``, then the pixel's amax, scale
  and int8 words, ``norm_relu_quantize``'s arithmetic), written out in
  numpy float32 op for op, equals the port's
  ``quantize_rows_int8`` / ``quantize_words`` and the jitted reference's
  ``quantize_rows_int8`` on the same activation, exactly.
* A numpy model of one block of the kernel, lane for lane: the halo as
  the kernel lays it out (layer 0 quantizing the tiles as they land),
  ``ldmatrix.x4``'s row addresses as the kernel computes them, the A, B
  and C fragment layouts of ``mma.m16n8k32`` s8 (PTX ISA), the weight
  fragments, the accumulator started at the bits of 1.5 * 2^23 and the
  dequantize fold ``(dot * s_pixel) * w_scale`` in tap order.  Its
  pre-norm output equals the plain int8 tap chain (``conv3x3_mm`` on
  the int8 pack) exactly, at layer 0, hidden blocks of 16, 32 and 64
  channels (one and two k-steps) and to_bits' 60 columns padded to 64,
  on tiles away from the image's corner.  The blocked kernel's work
  split runs the same lane model (``tests/test_torch_blocked_int8.py``);
  the card tests (``tests/test_torch_cuda.py``, ``-m gpu``) hold the
  kernels themselves to each other bit for bit.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import extractor as jex
from repro_torch.core import extractor as ex
from repro_torch.kernels import _build
from repro_torch.kernels import fused_extractor as fx

torch.set_num_threads(1)

SRC = (_build.CSRC / "fused_extractor_int8.cu").read_text()


def _const(name: str) -> int:
    m = re.search(r"constexpr (?:int|float) " + name + r" = ([0-9a-fA-Fx.]+)f?;",
                  SRC)
    assert m, name
    return int(m.group(1), 0) if "." not in m.group(1) else m.group(1)


IT = _const("IT")                  # a block's pixel tile side
IHW = IT + 2                       # halo side
MAGIC = _const("kMagic")
F32 = np.float32
INV_QMAX = F32(1.0) / F32(127.0)   # float(1/127), kInvQmax
EPS = F32(1e-8)


def test_source_constants():
    """The model runs on the kernel's constants: a 16 x 16 tile, and a
    magic whose float is 1.5 * 2^23 (the dot lands in the mantissa of a
    float in [2^23, 2^24))."""
    assert IT == 16
    assert np.array(MAGIC, np.int32).view(F32) == F32(1.5 * 2 ** 23)
    assert "kMagicF = 12582912.f" in SRC
    assert "kInvQmax = 0x1.020408p-7f" in SRC
    assert float.fromhex("0x1.020408p-7") == float(INV_QMAX)


def test_model_index_math_is_the_kernels():
    """The expressions the model below copies, as the kernel writes
    them: ldmatrix's per-lane row address, the halo row and the scales
    of a tap, the B fragment a lane loads, and where fragment element i
    lands in the tile."""
    flat = " ".join(SRC.split())
    for expr in (
            "(unsigned)((pix * Geo<CIN>::P + 4 * ((threadIdx.x & 31) >> 4)) "
            "* 4);",
            "const int first = 2 * warp * IHW;",
            "lane_row<CIN>(s_in, first + (lane & 7) + 8 * ((lane >> 3) & 1));",
            "const int s_row = first + (lane >> 2);",
            "const int off = toff + m * MSTEP;",
            "ldmatrix_x4(a[m][kk], a_row + off * G::P * 4 + 32 * kk);",
            "sx[m][0] = s_sc[s_row + off];",
            "sx[m][1] = s_sc[s_row + off + R8];",
            "imma_tap<CIN, NT, 8, IHW, true>(0, a_row, s_row, s_sc, w_lane, "
            "s_ws, acc);",
            "imma_tap<CIN, NT, 8, IHW, false>(tap / 3 * IHW + tap % 3, a_row, "
            "s_row, s_sc, w_lane + tap * S::WTAP, s_ws, acc);",
            "const int2* w_lane = s_w + lane;",
            "b[kk] = w_lane[(kk * NT + j) * 32];",
            "s_ws + 8 * j + 2 * t",
            "(2 * (threadIdx.x >> 5) + m) * IT + ((threadIdx.x & 31) >> 2) "
            "+ 8 * (i >> 1);",
            "8 * j + 2 * (threadIdx.x & 3) + (i & 1);",
            "int c[4] = {kMagic, kMagic, kMagic, kMagic};",
            "__fsub_rn(__int_as_float(c[i]), kMagicF);",
            "__fmul_rn(__fmul_rn(dot, sx[m][i >> 1]), (i & 1) ? ws.y : ws.x);",
            "acc[m][j][i] = FIRST ? d : __fadd_rn(acc[m][j][i], d);",
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32",
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16"):
        assert expr in flat, expr


# -- the epilogue's quantize, op for op ---------------------------------------
def quantize_model(v: np.ndarray):
    """(npix, c) float32 -> ((npix, ceil(c / 4)) int32 words, (npix,)
    scales), as layer 0's halo and every epilogue compute them
    (``quant_byte``; ``quant_byte_rcp`` gives the same bytes): amax over
    the channels (exact in any order), s = fmaxf(amax, 1e-8)
    * float(1/127), q = fminf(fmaxf(rintf(v / s), -127), 127), byte j of
    word k channel 4k + j."""
    v = v.astype(F32)
    amax = np.zeros(v.shape[0], F32)
    for c in range(v.shape[1]):
        amax = np.maximum(amax, np.abs(v[:, c]))
    s = np.maximum(amax, EPS) * INV_QMAX
    q = np.clip(np.rint(v / s[:, None]), -127, 127).astype(np.int8)
    pad = -v.shape[1] % 4
    q = np.concatenate([q, np.zeros((v.shape[0], pad), np.int8)], axis=1)
    return np.ascontiguousarray(q).view(np.int32), s


def _activation(seed: int, npix: int, c: int) -> torch.Tensor:
    """What an epilogue quantizes: relu(channel_norm(y + b)), with rows
    of zeros (a dead pixel), of one live channel and of tiny values."""
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.normal(0, 1.5, (npix, c)).astype(F32))
    act = torch.relu(ex.channel_norm(y + torch.as_tensor(
        rng.normal(0, 0.1, c).astype(F32))))
    act[0] = 0.0
    act[1] = 0.0
    act[1, c // 2] = 3.0
    act[2] *= 1e-9
    return act


@pytest.mark.parametrize("c", [3, 16, 60, 64])
def test_epilogue_quantize_equals_references(c):
    act = _activation(c, 300, c)
    words, s = quantize_model(act.numpy())
    q_port, s_port = ex.quantize_rows_int8(act)
    q_words, s_words = fx.quantize_words(act)
    q_jax, s_jax = jax.jit(jex.quantize_rows_int8)(act.numpy())
    np.testing.assert_array_equal(s, s_port[:, 0].numpy())
    np.testing.assert_array_equal(s, np.asarray(s_jax)[:, 0])
    np.testing.assert_array_equal(s, s_words.numpy())
    np.testing.assert_array_equal(words, q_words.numpy())
    q = words.view(np.int8)[:, :c]
    np.testing.assert_array_equal(q, q_port.numpy())
    np.testing.assert_array_equal(q, np.asarray(q_jax))


def quantize_rcp_model(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The fused epilogue's bytes (``quant_byte_rcp``): x = v * rcp(s)
    rounded, rint(x) unless x lies within 2^-14 of a half-integer, where
    the division decides; clipped to +-127."""
    rs = (F32(1.0) / s).astype(F32)
    x = (v * rs).astype(F32)
    r = np.rint(x)
    unsure = np.abs((x - r).astype(F32)) > F32(0.5) - F32(2.0 ** -14)
    r = np.where(unsure, np.rint((v / s).astype(F32)), r)
    return np.clip(r, -127, 127).astype(np.int8)


def test_reciprocal_quantize_equals_the_division():
    """quant_byte_rcp equals quant_byte (rint of the correctly rounded
    quotient) on 400,000 samples: values at random and values within 40
    ulps of every half-integer step k + 1/2 of their scale, at scales
    from the 1e-8 floor up; its constants are the source's."""
    flat = " ".join(SRC.split())
    for expr in ("const float rsc = __frcp_rn(sc);",
                 "if (fabsf(__fsub_rn(x, r)) > 0.5f - 0x1p-14f) "
                 "r = rintf(__fdiv_rn(v, s));",
                 "quant_byte_rcp(u[16 * v + 4 * k + j], sc, rsc)"):
        assert expr in flat, expr
    rng = np.random.default_rng(5)
    n = 100_000
    for near_half in (False, True):
        for tiny in (False, True):
            amax = (rng.uniform(0, 1, n) ** 3 * 10).astype(F32)
            if tiny:
                amax *= F32(1e-9)
            s = np.maximum(amax, EPS) * INV_QMAX
            if near_half:
                k = rng.integers(-127, 127, n).astype(F32)
                v = ((k + F32(0.5)) * s).astype(F32)
                v = (v.view(np.int32) +
                     rng.integers(-40, 41, n).astype(np.int32)).view(F32)
                v = np.clip(v, -amax, amax)
            else:
                v = (rng.uniform(-1, 1, n).astype(F32) * amax).astype(F32)
            want = np.clip(np.rint((v / s).astype(F32)), -127,
                           127).astype(np.int8)
            np.testing.assert_array_equal(quantize_rcp_model(v, s), want)


# -- the weight fragments ------------------------------------------------------
def fragments_to_weight(frags: torch.Tensor, cin: int,
                        cout: int) -> torch.Tensor:
    """Inverse of ``weight_fragments``: the (9 * cin, cout) int8 weight
    (byte j of a word is input channel 4 k + j, little-endian)."""
    ks, nt = frags.shape[1], frags.shape[2]
    words = frags.reshape(9, ks, nt, 8, 4, 2).permute(0, 1, 5, 4, 2, 3)
    w = words.reshape(9, 8 * ks, 8 * nt, 1).contiguous().view(torch.int8)
    w = w.reshape(9, 8 * ks, 8 * nt, 4).permute(0, 1, 3, 2).reshape(
        9, 32 * ks, 8 * nt)
    return w[:, :cin, :cout].reshape(9 * cin, cout)


def _pack(channels: int, depth: int, tile: int, seed: int = 0):
    return ex.pack_params(ex.params_from_numpy(ex.init_extractor_numpy(
        seed, n_bits=60, channels=channels, depth=depth, tile=tile,
        bias_scale=0.1)), "int8")


@pytest.mark.parametrize("channels", [16, 32, 64])
def test_weight_fragments_round_trip_to_the_pack(channels):
    """Every conv of an int8 pack (layer 0, the hidden blocks, to_bits):
    the fragments invert to the pack's weight, which equals the
    reference's ``pack_params`` weight; lane 4 g + t of (tap, k-step,
    column tile j) holds input channels 32 kk + 4 t .. + 3 (and 16 on)
    of column 8 j + g, little-endian; padding is zero."""
    p = ex.init_extractor_numpy(3, n_bits=60, channels=channels, depth=2,
                                tile=16, bias_scale=0.1)
    pk = ex.pack_params(ex.params_from_numpy(p), "int8")
    jpk = jex.pack_params(jax.tree.map(np.asarray, p), "int8")
    cin = 3
    for blk, jblk in zip(pk["blocks"] + [pk["to_bits"]],
                         jpk["blocks"] + [jpk["to_bits"]]):
        w = blk["w"]
        np.testing.assert_array_equal(w.numpy(), np.asarray(jblk["w"]))
        cout = w.shape[1]
        frags, ws = fx.imma_fragments(blk, cin)
        assert fx.imma_fragments(blk, cin)[0] is frags  # made once
        _, ks, _ = fx.imma_geometry(cin)
        assert frags.shape == (9, ks, -(-cout // 8), 32, 2)
        assert torch.equal(fragments_to_weight(frags, cin, cout), w)
        np.testing.assert_array_equal(ws.numpy()[:cout], blk["scale"])
        assert not ws[cout:].any()
        # one lane by hand: tap 4, k-step 0, column tile 1, g = 3, t = 1
        got = frags[4, 0, 1, 4 * 3 + 1].numpy().view(np.int8)
        col, w9 = 8 + 3, w.reshape(9, cin, cout).numpy()
        want = np.zeros(8, np.int8)
        for i, ch in enumerate(list(range(4, 8)) + list(range(20, 24))):
            if ch < cin and col < cout:
                want[i] = w9[4, ch, col]
        np.testing.assert_array_equal(got, want)
        cin = cout


# -- one block of the kernel, lane for lane ------------------------------------
G, T = np.arange(32) // 4, np.arange(32) % 4   # lane = 4 g + t


def _a_index():
    """mma.m16n8k32 s8 A (16 x 32, row): a lane's byte i (register i / 4)
    is (row, col) = (g or g + 8, 4 t + i % 4 (+ 16 for i >= 8)): rows g
    for i in [0, 4) and [8, 12)."""
    i = np.arange(16)
    row = G[:, None] + np.where((i < 4) | ((i >= 8) & (i < 12)), 0, 8)
    col = 4 * T[:, None] + (i & 3) + np.where(i >= 8, 16, 0)
    return row, col                                       # (32, 16)


def _b_index():
    """B (32 x 8, col): a lane's byte i is (k, n) = (4 t + i % 4 (+ 16
    for i >= 4), g)."""
    i = np.arange(8)
    k = 4 * T[:, None] + (i & 3) + np.where(i >= 4, 16, 0)
    return k, np.broadcast_to(G[:, None], k.shape)        # (32, 8)


def _c_index():
    """C (16 x 8, s32): a lane's element i is (g + 8 (i / 2), 2 t + i % 2)."""
    i = np.arange(4)
    return G[:, None] + 8 * (i >> 1), 2 * T[:, None] + (i & 1)


A_ROW, A_COL = _a_index()
B_K, B_N = _b_index()
C_ROW, C_COL = _c_index()


def mma_model(a_regs: np.ndarray, b_regs: np.ndarray) -> np.ndarray:
    """(..., 32, 4) int32 A registers, (..., 32, 2) int32 B registers ->
    (..., 32, 4) int32 D = A . B + MAGIC, distributed as the fragments
    are."""
    lead = a_regs.shape[:-2]
    a_bytes = np.ascontiguousarray(a_regs).view(np.int8).reshape(
        lead + (32, 16))
    b_bytes = np.ascontiguousarray(b_regs).view(np.int8).reshape(
        lead + (32, 8))
    # int8 products summed over 32 stay below 2^19: exact in float64
    A = np.zeros(lead + (16, 32), np.float64)
    B = np.zeros(lead + (32, 8), np.float64)
    A[..., A_ROW, A_COL] = a_bytes
    B[..., B_K, B_N] = b_bytes
    D = (A @ B).astype(np.int64) + MAGIC
    return D[..., C_ROW, C_COL].astype(np.int32)


def ldmatrix_x4(halo: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """``ldmatrix.x4 .b16``: lane i supplies the address of row i % 8 of
    matrix i / 8 (16 bytes); lane 4 g + t receives bytes 4 t .. 4 t + 3 of
    row g of each matrix.  halo: the shared bytes; addrs (..., 32)."""
    rows = addrs[..., (np.arange(4)[:, None] * 8 + G[None, :])]  # (..,4,32)
    idx = rows[..., None] + 4 * T[None, :, None] + np.arange(4)
    regs = halo[idx].reshape(idx.shape[:-1] + (4,))
    regs = np.ascontiguousarray(regs).view(np.int32)[..., 0]      # (..,4,32)
    return np.swapaxes(regs, -1, -2)                              # (..,32,4)


def kernel_model(x, xs, frags, ws, cin: int, nc: int, img: int, by: int,
                 bx: int, l: int) -> np.ndarray:
    """``imma_conv`` on the tile (by, bx) of image img: the (IT^2, nc)
    pre-norm fp32 sums at (pixel row-major, column).  x: the (b, l, l, 3)
    fp32 tiles (cin 3) or the (b, l, l, cin / 4) int32 words with their
    (b, l, l) scales xs; frags, ws: ``imma_fragments``."""
    cw, ks, kw = fx.imma_geometry(cin)
    P = kw + 4
    nt = frags.shape[2]
    y0, x0 = by * IT, bx * IT
    # the halo, as imma_halo lays it out: (IHW^2, P) words, scales
    halo = np.zeros((IHW * IHW, P), np.int32)
    s_sc = np.zeros(IHW * IHW, F32)
    for p in range(IHW * IHW):
        gy, gx = y0 + p // IHW - 1, x0 + p % IHW - 1
        if 0 <= gy < l and 0 <= gx < l:
            if cin == 3:
                words, s = quantize_model(x[img, gy, gx][None])
                halo[p, 0], s_sc[p] = words[0, 0], s[0]
            else:
                halo[p, :cw], s_sc[p] = x[img, gy, gx], xs[img, gy, gx]
    hbytes = halo.view(np.uint8).reshape(-1)
    s_ws = np.zeros(nt * 8, F32)
    s_ws[:nc] = ws[:nc]
    lane = np.arange(32)
    a_base = ((lane & 7) + 8 * ((lane >> 3) & 1)) * P * 4 + 16 * (lane >> 4)
    rows = np.arange(16)                       # pixel row 2 w + m
    acc = np.zeros((16, nt, 32, 4), F32)
    for tap in range(9):
        dy, dx = tap // 3, tap % 3
        hrow = rows + dy
        addr = a_base[None, :] + ((hrow * IHW + dx) * P * 4)[:, None]
        sx = np.stack([s_sc[hrow[:, None] * IHW + dx + G[None, :]],
                       s_sc[hrow[:, None] * IHW + dx + G[None, :] + 8]],
                      axis=-1)                 # (16 rows, 32 lanes, 2)
        c = np.zeros((16, nt, 32, 4), np.int32) + MAGIC
        for kk in range(ks):
            a = ldmatrix_x4(hbytes, addr + 32 * kk)          # (16, 32, 4)
            b = frags[tap, kk]                                # (nt, 32, 2)
            d = mma_model(np.broadcast_to(a[:, None], (16, nt, 32, 4)),
                          np.broadcast_to(b[None], (16, nt, 32, 2)))
            c = d + (c - MAGIC)   # the k-steps chain through c
        dot = c.view(F32) - F32(12582912.0)
        col = 8 * np.arange(nt)[:, None, None] + 2 * T[None, :, None] + \
            (np.arange(4) & 1)[None, None, :]                 # (nt, 32, 4)
        d = (dot * sx[:, None, :, np.arange(4) >> 1]) * s_ws[col][None]
        acc = d if tap == 0 else acc + d
    out = np.zeros((IT * IT, nt * 8), F32)
    pix = rows[:, None, None, None] * IT + G[None, None, :, None] + \
        8 * (np.arange(4) >> 1)[None, None, None, :]
    out[np.broadcast_to(pix, acc.shape),
        np.broadcast_to(col[None], acc.shape)] = acc
    return out[:, :nc]


def _tile_of(y: np.ndarray, img: int, by: int, bx: int) -> np.ndarray:
    """The (IT^2, n) rows of (b, l, l, n) y in the tile (by, bx)."""
    return y[img, by * IT:(by + 1) * IT, bx * IT:(bx + 1) * IT].reshape(
        IT * IT, -1)


@pytest.mark.parametrize("channels,l", [(16, 32), (32, 16), (64, 32)])
def test_kernel_model_equals_plain_tap_chain(channels, l):
    """Layer 0, a hidden block and to_bits of an int8 pack: the model's
    pre-norm sums equal ``conv3x3_mm`` on the int8 pack (quantize per
    tap-shifted row, exact dot, (y * s) * scale, summed in tap order)
    bit for bit, on the four corner-and-edge tiles of an image; the
    layer's input is what the layer before's epilogue writes (the
    quantized words and scales of its fp32 output)."""
    b = 2
    pk = _pack(channels, 2, l, seed=channels)
    rng = np.random.default_rng(l)
    tiles = torch.as_tensor(rng.uniform(-2.0, 2.5, (b, l, l, 3)).astype(F32))
    x, xq, xs, cin = tiles, tiles.numpy(), None, 3
    tiles_at = [(1, l // IT - 1, 0), (0, 0, l // IT - 1)]
    for blk in pk["blocks"] + [pk["to_bits"]]:
        cout = blk["w"].shape[1]
        y = ex.conv3x3_mm(x, blk["w"], blk["scale"]).reshape(b, l, l, cout)
        frags, ws = fx.imma_fragments(blk, cin)
        for img, by, bx in tiles_at:
            got = kernel_model(xq, xs, frags.numpy(), ws.numpy(), cin, cout,
                               img, by, bx, l)
            np.testing.assert_array_equal(got, _tile_of(y.numpy(), img, by,
                                                        bx))
        x = torch.relu(ex.channel_norm(y + blk["b"]))
        words, s = quantize_model(x.reshape(-1, cout).numpy())
        xq = words.reshape(b, l, l, -1)
        xs = s.reshape(b, l, l)
        cin = cout
