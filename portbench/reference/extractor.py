"""The detector's ingest and extractor in plain PyTorch, at a stated
precision.

Ingest: a raw uint8 image, bilinear resize to ``resize`` (half-pixel
centres, edge clamp, no antialias), centre crop to ``img``, per-channel
``x / (255 std) - mean / std`` (ImageNet statistics), then the tile at
(y, x) of the crop.

Extractor (NHWC, HWIO weights): ``depth`` blocks of SAME 3x3 conv + bias,
normalisation over channels (population variance, eps 1e-5) and ReLU;
a 3x3 ``to_bits`` conv + bias; the global average; ``logits = gap @ W_head
+ b_head``; plus, at the bank's tile size, the correlation of the
high-passed tile (tile minus its 3x3 zero-padded box mean) with each
pattern of the bank, times ``corr_scale``.

Precisions (``mode``): ``fp32`` (float32, TF32 off); ``tf32`` (every
product's operands rounded to TF32's 10-bit mantissa, float32 sums);
``int8`` and ``int4`` (conv and to_bits weights quantized symmetrically
per output channel (scale amax / qmax), each pixel's input channels
quantized symmetrically with one scale a pixel (amax times float32(1 /
qmax)), rounding half to even, integer dots, float32 dequantisation;
head and correlation float32).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
QMAX = {"int8": 127.0, "int4": 7.0}
MODES = ("fp32", "tf32", "int8", "int4")


def resize_rows(n_in: int, n_out: int, off: int, n_crop: int) -> np.ndarray:
    """(n_crop, n_in) float32 interpolation rows of output rows
    [off, off + n_crop) of a bilinear resize n_in -> n_out."""
    m = np.zeros((n_crop, n_in), np.float32)
    scale = n_in / n_out
    for o in range(n_crop):
        src = (o + off + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        w = src - lo
        m[o, min(max(lo, 0), n_in - 1)] += 1.0 - w
        m[o, min(max(lo + 1, 0), n_in - 1)] += w
    return m


def ingest(raw: torch.Tensor, offsets: torch.Tensor, *, resize: int,
           img: int, tile: int) -> torch.Tensor:
    """raw (b, H, W, 3) uint8, offsets (b, 2) in the crop -> (b, tile,
    tile, 3) float32 tiles."""
    b, H, W, _ = raw.shape
    dev = raw.device
    off = (resize - img) // 2
    ry = torch.as_tensor(resize_rows(H, resize, off, img), device=dev)
    rx = torch.as_tensor(resize_rows(W, resize, off, img), device=dev)
    ar = torch.arange(tile, device=dev)
    offs = offsets.to(dev, torch.int64)
    ry_t = ry[offs[:, 0:1] + ar]                     # (b, tile, H)
    rx_t = rx[offs[:, 1:2] + ar].transpose(1, 2)     # (b, W, tile)
    x = raw.to(torch.float32)
    scale = 1.0 / (255.0 * STD)
    bias = -MEAN / STD
    return torch.stack([(ry_t @ x[..., c] @ rx_t) * float(scale[c])
                        + float(bias[c]) for c in range(3)], dim=-1)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest value with a 10-bit mantissa."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def _shifted(x: torch.Tensor):
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def conv3x3(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """SAME 3x3 conv, (b, h, w, cin) x (3, 3, cin, cout) -> (b, h, w,
    cout), as nine tap products summed in raster order."""
    b, h, wd, cin = x.shape
    w2 = w.reshape(9, cin, -1)
    if mode in QMAX:
        qmax = QMAX[mode]
        xs = x.abs().amax(dim=3, keepdim=True).clamp_min(1e-8) * \
            float(np.float32(1.0) / np.float32(qmax))
        xq = torch.round(x / xs).clamp(-qmax, qmax)
        w2d = w2.reshape(9 * cin, -1)
        ws = w2d.abs().amax(dim=0).clamp_min(1e-8) / qmax
        wq = torch.round(w2d / ws).clamp(-qmax, qmax)
        # the integer dot of each tap is dequantised with the scale of the
        # pixel it read, so the taps are summed after dequantisation
        acc = None
        for t, (v, s) in enumerate(zip(_shifted(xq), _shifted(xs))):
            y = (v.reshape(-1, cin) @ wq[t * cin:(t + 1) * cin]) * \
                s.reshape(-1, 1) * ws
            acc = y if acc is None else acc + y
        return acc.reshape(b, h, wd, -1)
    acc = None
    for t, v in enumerate(_shifted(x)):
        y = _mm(v.reshape(-1, cin), w2[t], mode)
        acc = y if acc is None else acc + y
    return acc.reshape(b, h, wd, -1)


def forward(params: dict, tiles: torch.Tensor, mode: str = "fp32"
            ) -> torch.Tensor:
    """tiles (b, l, l, 3) float32 -> (b, n_bits) logits."""
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}")
    b, l = tiles.shape[0], tiles.shape[1]
    x = tiles
    for blk in params["blocks"]:
        y = conv3x3(x, blk["w"], mode) + blk["b"]
        mu = y.mean(dim=-1, keepdim=True)
        var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
        x = torch.relu((y - mu) * torch.rsqrt(var + 1e-5))
    tb = params["to_bits"]
    g = (conv3x3(x, tb["w"], mode) + tb["b"]).mean(dim=(1, 2))
    hmode = "tf32" if mode == "tf32" else "fp32"
    logits = _mm(g, params["head"]["w"], hmode) + params["head"]["b"]
    corr = params.get("corr")
    if corr is not None and corr.shape[1] == l:
        box = sum(_shifted(tiles)) * (1.0 / 9.0)
        hp = (tiles - box).reshape(b, -1)
        logits = logits + _mm(hp, corr.reshape(corr.shape[0], -1).T,
                              hmode) * params["corr_scale"]
    return logits
