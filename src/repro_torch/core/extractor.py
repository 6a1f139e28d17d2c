"""Tile extractor H_D, decode half, fp32 (counterpart of
``repro.core.extractor``).

The parameter tree keeps the JAX package's structure and layouts (NHWC
activations, HWIO conv weights), so weights cross between the two as
numpy arrays: :func:`params_from_numpy` takes what
``jax.tree.map(np.asarray, params)`` gives and returns the port's tree.

:func:`extractor_forward_packed_embed` is the plain PyTorch version of
the fused decode kernel (``kernels/fused_extractor.py``): the same body
as the reference — nine tap dots per SAME 3x3 conv accumulated in
static [ky, kx] order, bias + channel_norm + ReLU, the to_bits conv,
GAP, the head and the correlation bank as broadcast-multiply + sum.
Only the fp32 rung is ported in this slice; bf16 and int8 packs come
with ROADMAP queue 1 item 10.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

DECODE_DTYPES = ("fp32",)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """A params pytree of numpy arrays (dicts, lists, arrays — what
    ``jax.tree.map(np.asarray, params)`` gives) -> the same tree of
    torch tensors on ``device``, dtypes kept.  Leaves that already are
    tensors are moved to ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.asarray(tree), device=device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of :func:`params_from_numpy`."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(device)


def conv_init(gen, kh, kw, cin, cout, scale=None, device="cpu"):
    scale = scale or (2.0 / (kh * kw * cin)) ** 0.5
    return scale * _normal(gen, (kh, kw, cin, cout), device)


def pattern_bank(gen, n_bits: int, tile: int, device="cpu"):
    """Unit-norm, zero-mean white patterns, one per bit."""
    P = _normal(gen, (n_bits, tile, tile, 3), device)
    P = P - P.mean(dim=(1, 2, 3), keepdim=True)
    return P / torch.sqrt(torch.sum(P * P, dim=(1, 2, 3), keepdim=True))


def init_extractor(gen: torch.Generator, *, n_bits: int,
                   channels: int = 64, depth: int = 7, tile: int = 0,
                   device="cpu") -> dict:
    """Randomly initialised extractor with the reference's structure
    and scales (``repro.core.extractor.init_extractor``).  The values
    come from ``gen``, a ``torch.Generator``, so they differ from JAX's
    for the same seed; tests hand both packages numpy weights instead."""
    blocks, cin = [], 3
    for _ in range(depth):
        blocks.append({"w": conv_init(gen, 3, 3, cin, channels,
                                      device=device),
                       "b": torch.zeros(channels, device=device)})
        cin = channels
    p = {
        "blocks": blocks,
        "to_bits": {"w": conv_init(gen, 3, 3, channels, n_bits,
                                   device=device),
                    "b": torch.zeros(n_bits, device=device)},
        "head": {"w": 0.2 * _normal(gen, (n_bits, n_bits), device),
                 "b": torch.zeros(n_bits, device=device)},
    }
    if tile:
        p["corr"] = pattern_bank(gen, n_bits, tile, device)
        p["corr_scale"] = torch.ones(n_bits, device=device)
    return p


def init_extractor_numpy(seed: int, *, n_bits: int, channels: int = 64,
                         depth: int = 7, tile: int = 0,
                         bias_scale: float = 0.0) -> dict:
    """:func:`init_extractor`'s structure and scales drawn by numpy from
    ``seed``: weights that the JAX package (``jnp.asarray``) and the port
    (:func:`params_from_numpy`) both take, so parity checks involve
    neither framework's generator.  ``bias_scale`` > 0 draws the biases
    from N(0, bias_scale) instead of zeros, to exercise the bias path."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    blocks, cin = [], 3
    for _ in range(depth):
        blocks.append({"w": normal((3, 3, cin, channels),
                                   (2.0 / (9 * cin)) ** 0.5),
                       "b": normal((channels,), bias_scale)})
        cin = channels
    p = {
        "blocks": blocks,
        "to_bits": {"w": normal((3, 3, channels, n_bits),
                                (2.0 / (9 * channels)) ** 0.5),
                    "b": normal((n_bits,), bias_scale)},
        "head": {"w": normal((n_bits, n_bits), 0.2),
                 "b": normal((n_bits,), bias_scale)},
    }
    if tile:
        P = rng.standard_normal((n_bits, tile, tile, 3))
        P -= P.mean(axis=(1, 2, 3), keepdims=True)
        P /= np.sqrt(np.sum(P * P, axis=(1, 2, 3), keepdims=True))
        p["corr"] = P.astype(np.float32)
        p["corr_scale"] = np.ones((n_bits,), np.float32)
    return p


def channel_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise over the channel axis with the population variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def _shifts3x3(x: torch.Tensor):
    """The nine 3x3-tap shifted views of x (b, h, w, c), zero padding,
    [ky, kx] order."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, dy: dy + h, dx: dx + w, :]
            for dy in range(3) for dx in range(3)]


def tap_dot(xs2d: torch.Tensor, w2d: torch.Tensor, tap: int,
            cin: int) -> torch.Tensor:
    """One tap's fp32 dot: (M, cin) shifted view x rows
    [tap*cin, (tap+1)*cin) of the packed weight -> (M, cout)."""
    return xs2d @ w2d[tap * cin: (tap + 1) * cin]


def conv3x3_mm(x: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv as nine tap dots accumulated left to right:
    x (b, h, w, c) x packed weight (9c, cout) -> (b*h*w, cout)."""
    b, h, w, c = x.shape
    acc = None
    for tap, xs in enumerate(_shifts3x3(x)):
        y = tap_dot(xs.reshape(b * h * w, c), w2d, tap, c)
        acc = y if acc is None else acc + y
    return acc


def _box3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box blur with zero padding: the nine views summed, times
    float32(1/9) — the reference multiplies, it does not divide."""
    acc = None
    for xs in _shifts3x3(x):
        acc = xs if acc is None else acc + xs
    return acc * (1.0 / 9.0)


def _need_fp32(dtype):
    if dtype not in DECODE_DTYPES:
        raise NotImplementedError(
            f"decode_dtype {dtype!r}: only fp32 is ported so far (bf16 "
            f"and int8 packs are ROADMAP queue 1 item 10)")


def pack_params(params: dict, dtype: str = "fp32") -> dict:
    """Extractor params -> the matmul layout the decode path reads:
    conv weights (3, 3, cin, cout) -> (9*cin, cout); the correlation
    bank (n, t, t, 3) -> (t*t, n, 3), pixel-major."""
    _need_fp32(dtype)

    def conv_entry(w4d, bias):
        return {"w": w4d.reshape(-1, w4d.shape[-1]).to(
                    torch.float32).contiguous(),
                "b": bias.to(torch.float32).contiguous()}

    pk = {
        "blocks": [conv_entry(b["w"], b["b"]) for b in params["blocks"]],
        "to_bits": conv_entry(params["to_bits"]["w"],
                              params["to_bits"]["b"]),
        "head": {"w": params["head"]["w"].to(torch.float32),
                 "b": params["head"]["b"].to(torch.float32)},
    }
    if "corr" in params:
        n, t = params["corr"].shape[0], params["corr"].shape[1]
        pk["corr"] = params["corr"].permute(1, 2, 0, 3).reshape(
            t * t, n, 3).to(torch.float32).contiguous()
        pk["corr_scale"] = params["corr_scale"].to(torch.float32)
    return pk


def unpack_params(packed: dict) -> dict:
    """Exact inverse of :func:`pack_params` for fp32 packs."""
    cin, blocks = 3, []
    for blk in packed["blocks"]:
        cout = blk["w"].shape[-1]
        blocks.append({"w": blk["w"].reshape(3, 3, cin, cout),
                       "b": blk["b"]})
        cin = cout
    nb = packed["to_bits"]["w"].shape[-1]
    p = {
        "blocks": blocks,
        "to_bits": {"w": packed["to_bits"]["w"].reshape(3, 3, cin, nb),
                    "b": packed["to_bits"]["b"]},
        "head": {"w": packed["head"]["w"], "b": packed["head"]["b"]},
    }
    if "corr" in packed:
        t2, n, _ = packed["corr"].shape
        t = int(round(t2 ** 0.5))
        p["corr"] = packed["corr"].reshape(t, t, n, 3).permute(2, 0, 1, 3)
        p["corr_scale"] = packed["corr_scale"]
    return p


def extractor_forward_packed_embed(packed: dict, tiles: torch.Tensor):
    """tiles (b, l, l, 3) on packed fp32 params -> ((b, n_bits) logits,
    (b, n_bits) GAP embedding).  The correlation path runs only at the
    bank's native tile size, as in the reference."""
    b, l = tiles.shape[0], tiles.shape[1]
    x = tiles
    for blk in packed["blocks"]:
        y = conv3x3_mm(x, blk["w"])
        x = torch.relu(channel_norm(y.reshape(b, l, l, -1) + blk["b"]))
    y = conv3x3_mm(x, packed["to_bits"]["w"])
    y = y.reshape(b, l, l, -1) + packed["to_bits"]["b"]
    g = y.mean(dim=(1, 2))  # GAP
    logits = (g[:, :, None] * packed["head"]["w"][None]).sum(dim=1) + \
        packed["head"]["b"]
    if "corr" in packed and packed["corr"].shape[0] == l * l:
        hp = (tiles - _box3x3(tiles)).reshape(b, l * l, 1, 3)
        corr = (hp * packed["corr"][None]).sum(dim=(1, 3))
        logits = logits + corr * packed["corr_scale"]
    return logits, g


def extractor_forward_packed(packed: dict, tiles: torch.Tensor
                             ) -> torch.Tensor:
    """The embed-free view of :func:`extractor_forward_packed_embed`."""
    return extractor_forward_packed_embed(packed, tiles)[0]


def extractor_forward(params: dict, tiles: torch.Tensor) -> torch.Tensor:
    """tiles (b, l, l, 3) -> bit logits (b, n_bits), via the packed
    body."""
    return extractor_forward_packed(pack_params(params), tiles)
