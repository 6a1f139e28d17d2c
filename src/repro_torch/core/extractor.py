"""Tile extractor H_D and watermark encoder H_E (counterpart of
``repro.core.extractor``).

The encoder (:func:`init_encoder`, :func:`encoder_forward`) and the
plain convs of training (:func:`conv2d`, :func:`_block`,
:func:`highpass`) run as plain PyTorch ops under autograd, the convs as
tap matmuls: the reference trains through XLA's plain forward, and no
decode kernel has a backward.

The parameter tree keeps the JAX package's structure and layouts (NHWC
activations, HWIO conv weights), so weights cross between the two as
numpy arrays: :func:`params_from_numpy` takes what
``jax.tree.map(np.asarray, params)`` gives and returns the port's tree.

:func:`extractor_forward_packed_embed` is the plain PyTorch version of
the fused decode kernel (``kernels/fused_extractor.py``): the same body
as the reference — nine tap dots per SAME 3x3 conv accumulated in
static [ky, kx] order, bias + channel_norm + ReLU, the to_bits conv,
GAP, the head and the correlation bank as broadcast-multiply + sum.

The packed dtype picks the rung, as in the reference (:func:`tap_dot`):

* ``fp32``: fp32 tap dots (TF32 off on the card);
* ``bf16``: every matmul operand rounded to bf16, exact products, fp32
  sums — ``x.to(bf16).float() @ w.float()``, never a bf16 matmul, whose
  reductions cuBLAS may run at reduced precision.  The head and
  correlation products are fp32 products of bf16-rounded operands, not
  rounded back to bf16: what the jitted reference computes (XLA keeps
  the bf16 elementwise products at fp32);
* ``int8``: int8 conv / to_bits weights with fp32 per-output-channel
  scales, each tap's input rows quantized on the fly, an exact integer
  dot (an fp32 matmul of the int8 values: a tap sums at most 64
  products of at most 127^2, below 2^24), dequantized as
  ``(y * s) * scale``; head and correlation stay fp32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.transforms import clip

DECODE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}

INT8_QMAX = 127.0
# the jitted reference divides by the constant INT8_QMAX as a multiply
# by its float32 reciprocal (XLA's rewrite); the activation scales
# follow that, the weight scales (packed eagerly) the true division
_INV_QMAX = float(np.float32(1.0) / np.float32(INT8_QMAX))
_EPS = float(np.float32(1e-8))


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
    """Inverse of :func:`params_from_numpy`; bf16 leaves come back as
    float32 (exactly: numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        tree = tree.float()
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
                   patterns: torch.Tensor = None, device="cpu") -> dict:
    """Randomly initialised extractor with the reference's structure
    and scales (``repro.core.extractor.init_extractor``).  The values
    come from ``gen``, a ``torch.Generator``, so they differ from JAX's
    for the same seed; tests hand both packages numpy weights instead.
    ``patterns`` ties the correlation bank to an encoder's pattern bank
    (the trainer's warm start); without it the bank is drawn."""
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
        p["corr"] = (pattern_bank(gen, n_bits, tile, device)
                     if patterns is None else patterns.clone().to(device))
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


def quantize_weight_int8(w2d: torch.Tensor):
    """(K, N) fp32 weight -> (int8 weight, fp32 per-output-channel scale
    (N,)): symmetric per-channel quantization with the true division
    ``amax / 127`` of the reference's eager ``pack_params``."""
    scale = torch.clamp_min(w2d.abs().amax(dim=0), _EPS) / INT8_QMAX
    q = torch.round(w2d / scale).clamp(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale.to(torch.float32)


def quantize_rows_int8(x2d: torch.Tensor):
    """(M, K) fp32 activations -> (int8, fp32 per-row scale (M, 1)):
    ``s = max(amax, 1e-8) * float32(1/127)`` as the jitted reference
    computes it, then ``round(x / s)`` (half to even), clipped to
    +-127.  Per-row scales keep a row's result independent of its
    batch."""
    s = torch.clamp_min(x2d.abs().amax(dim=1, keepdim=True), _EPS) * \
        _INV_QMAX
    q = torch.round(x2d / s).clamp(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), s


def tap_dot(xs2d: torch.Tensor, w2d: torch.Tensor, tap: int, cin: int,
            scale: torch.Tensor = None) -> torch.Tensor:
    """One tap's dot: (M, cin) shifted view x rows [tap*cin, (tap+1)*cin)
    of a packed weight -> (M, cout), fp32.  fp32 / bf16 weights: the
    input rounded to the weight's dtype, exact products, fp32 sums.
    int8 weights (``scale`` = the per-output-channel dequant scale,
    column-sliced like ``w2d``): per-row quantized input, exact integer
    dot, ``(y * s) * scale``."""
    wt = w2d[tap * cin: (tap + 1) * cin]
    if w2d.dtype == torch.int8:
        xq, s = quantize_rows_int8(xs2d)
        y = xq.to(torch.float32) @ wt.to(torch.float32)
        return y * s * scale[None, :]
    return xs2d.to(w2d.dtype).to(torch.float32) @ wt.to(torch.float32)


def conv3x3_mm(x: torch.Tensor, w2d: torch.Tensor,
               scale: torch.Tensor = None,
               channel_tile: int = 0) -> torch.Tensor:
    """SAME 3x3 conv as nine tap dots accumulated left to right:
    x (b, h, w, c) x packed weight (9c, cout) -> (b*h*w, cout).  With
    ``channel_tile`` > 0 the output columns are computed in
    [j0, j0 + channel_tile) slices, each from nine N-restricted tap
    dots, as the reference's blocked schedule does (``_taps_fold``).
    ``scale`` carries the int8 rung's per-channel dequant scales."""
    b, h, w, c = x.shape
    cout = w2d.shape[-1]
    ct = channel_tile or cout
    cols = []
    for j0 in range(0, cout, ct):
        sc = None if scale is None else scale[j0: j0 + ct]
        acc = None
        for tap, xs in enumerate(_shifts3x3(x)):
            y = tap_dot(xs.reshape(b * h * w, c), w2d[:, j0: j0 + ct], tap,
                        c, sc)
            acc = y if acc is None else acc + y
        cols.append(acc)
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def _box3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box blur with zero padding: the nine views summed, times
    float32(1/9) — the reference multiplies, it does not divide."""
    acc = None
    for xs in _shifts3x3(x):
        acc = xs if acc is None else acc + xs
    return acc * (1.0 / 9.0)


def pack_params(params: dict, dtype: str = "fp32") -> dict:
    """Extractor params -> the matmul layout the decode path reads:
    conv weights (3, 3, cin, cout) -> (9*cin, cout); the correlation
    bank (n, t, t, 3) -> (t*t, n, 3), pixel-major.  Matmul operands are
    stored in the rung's dtype (an unknown ``dtype`` raises KeyError, as
    in the reference); int8 packs quantize the conv / to_bits weights
    per output channel (``"scale"`` leaf) and keep head and correlation
    fp32; biases and ``corr_scale`` stay fp32."""
    cdt = DECODE_DTYPES[dtype]
    f32 = torch.float32

    def conv_entry(w4d, bias):
        w2d = w4d.reshape(-1, w4d.shape[-1]).to(f32)
        b = bias.to(f32).contiguous()
        if cdt == torch.int8:
            q, scale = quantize_weight_int8(w2d)
            return {"w": q.contiguous(), "scale": scale.contiguous(), "b": b}
        return {"w": w2d.to(cdt).contiguous(), "b": b}

    hdt = f32 if cdt == torch.int8 else cdt
    pk = {
        "blocks": [conv_entry(b["w"], b["b"]) for b in params["blocks"]],
        "to_bits": conv_entry(params["to_bits"]["w"],
                              params["to_bits"]["b"]),
        "head": {"w": params["head"]["w"].to(hdt).contiguous(),
                 "b": params["head"]["b"].to(f32).contiguous()},
    }
    if "corr" in params:
        n, t = params["corr"].shape[0], params["corr"].shape[1]
        pk["corr"] = params["corr"].permute(1, 2, 0, 3).reshape(
            t * t, n, 3).to(hdt).contiguous()
        pk["corr_scale"] = params["corr_scale"].to(f32).contiguous()
    return pk


def packed_dtype(packed: dict) -> str:
    """The rung of a pack: "fp32", "bf16" or "int8" (its conv weights'
    dtype)."""
    cdt = packed["blocks"][0]["w"].dtype
    for name, dt in DECODE_DTYPES.items():
        if dt == cdt:
            return name
    raise ValueError(f"conv weights of dtype {cdt} are no decode rung")


def _dequant_w(entry: dict) -> torch.Tensor:
    w = entry["w"].to(torch.float32)
    return w * entry["scale"][None, :] if "scale" in entry else w


def unpack_params(packed: dict) -> dict:
    """Inverse of :func:`pack_params`: exact for fp32 packs; bf16 packs
    give the bf16-rounded weights, int8 packs the dequantized
    ``q * scale`` weights, all fp32."""
    cin, blocks = 3, []
    for blk in packed["blocks"]:
        cout = blk["w"].shape[-1]
        blocks.append({"w": _dequant_w(blk).reshape(3, 3, cin, cout),
                       "b": blk["b"]})
        cin = cout
    nb = packed["to_bits"]["w"].shape[-1]
    p = {
        "blocks": blocks,
        "to_bits": {"w": _dequant_w(packed["to_bits"]).reshape(
            3, 3, cin, nb), "b": packed["to_bits"]["b"]},
        "head": {"w": packed["head"]["w"].to(torch.float32),
                 "b": packed["head"]["b"]},
    }
    if "corr" in packed:
        t2, n, _ = packed["corr"].shape
        t = int(round(t2 ** 0.5))
        p["corr"] = packed["corr"].to(torch.float32).reshape(
            t, t, n, 3).permute(2, 0, 1, 3)
        p["corr_scale"] = packed["corr_scale"]
    return p


def extractor_forward_packed_embed(packed: dict, tiles: torch.Tensor,
                                   channel_tile: int = 0):
    """tiles (b, l, l, 3) on packed params of any rung -> ((b, n_bits)
    logits, (b, n_bits) GAP embedding).  The correlation path runs only
    at the bank's native tile size, as in the reference.
    ``channel_tile`` slices the hidden convs' output columns
    (:func:`conv3x3_mm`).  Head and correlation operands are rounded to
    the pack's head dtype (a no-op at fp32), their products and sums
    fp32."""
    b, l = tiles.shape[0], tiles.shape[1]
    hdt = packed["head"]["w"].dtype
    x = tiles
    for blk in packed["blocks"]:
        y = conv3x3_mm(x, blk["w"], blk.get("scale"), channel_tile)
        x = torch.relu(channel_norm(y.reshape(b, l, l, -1) + blk["b"]))
    tb = packed["to_bits"]
    y = conv3x3_mm(x, tb["w"], tb.get("scale"))
    y = y.reshape(b, l, l, -1) + tb["b"]
    g = y.mean(dim=(1, 2))  # GAP
    logits = (g.to(hdt).float()[:, :, None] *
              packed["head"]["w"].float()[None]).sum(dim=1) + \
        packed["head"]["b"]
    if "corr" in packed and packed["corr"].shape[0] == l * l:
        hp = (tiles - _box3x3(tiles)).reshape(b, l * l, 1, 3)
        corr = (hp.to(hdt).float() * packed["corr"].float()[None]
                ).sum(dim=(1, 3))
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


def extractor_forward_embed(params: dict, tiles: torch.Tensor):
    """Unfused forward returning (logits, GAP embedding): the
    embed-emitting decode of pipelines without the fused kernel (the
    near-duplicate cache's probe), on the packed body, so its logits are
    bitwise :func:`extractor_forward`'s."""
    return extractor_forward_packed_embed(pack_params(params), tiles)


# ---------------------------------------------------------------------------
# encoder H_E and the plain convs of training (autograd through plain ops)
# ---------------------------------------------------------------------------


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """``lax.conv_general_dilated`` at NHWC / HWIO, stride 1, SAME
    padding (the extra row and column after, for even kernels): x (b, h,
    w, cin), w (kh, kw, cin, cout) -> (b, h, w, cout), the kh * kw tap
    matmuls summed in row-major tap order.  Matmuls, not a convolution
    library: their float32 precision is the caller's matmul precision
    (TF32 only where the caller has allowed it), never cuDNN's TF32
    default for convolutions."""
    if stride != 1 or padding != "SAME":
        raise ValueError("conv2d takes stride 1 and SAME padding")
    kh, kw = w.shape[0], w.shape[1]
    h, wd = x.shape[1], x.shape[2]
    top, left = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (0, 0, left, kw - 1 - left, top, kh - 1 - top))
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            y = xp[:, dy: dy + h, dx: dx + wd, :] @ w[dy, dx]
            acc = y if acc is None else acc + y
    return acc


def _block(params: dict, x: torch.Tensor) -> torch.Tensor:
    x = conv2d(x, params["w"]) + params["b"]
    return torch.relu(channel_norm(x))


def highpass(x: torch.Tensor) -> torch.Tensor:
    """Remove the local 3x3 mean (a depthwise box filter, zero
    padding): image content is low-frequency, the spread-spectrum
    watermark is white."""
    return x - _box3x3(x)


def init_encoder(gen: torch.Generator, *, n_bits: int, channels: int = 32,
                 depth: int = 4, tile: int = 0, device="cpu") -> dict:
    """Randomly initialised encoder with the reference's structure and
    scales (``repro.core.extractor.init_encoder``), values from ``gen``."""
    blocks, cin = [], 3
    for _ in range(depth):
        blocks.append({"w": conv_init(gen, 3, 3, cin, channels,
                                      device=device),
                       "b": torch.zeros(channels, device=device)})
        cin = channels
    p = {
        "blocks": blocks,
        # input: features + broadcast message + original image
        "fuse": {"w": conv_init(gen, 3, 3, channels + n_bits + 3, channels,
                                device=device),
                 "b": torch.zeros(channels, device=device)},
        "out": {"w": conv_init(gen, 1, 1, channels, 3, scale=0.02,
                               device=device),
                "b": torch.zeros(3, device=device)},
    }
    if tile:
        p["patterns"] = pattern_bank(gen, n_bits, tile, device)
    return p


def init_encoder_numpy(seed: int, *, n_bits: int, channels: int = 32,
                       depth: int = 4, tile: int = 0) -> dict:
    """:func:`init_encoder`'s structure and scales drawn by numpy from
    ``seed`` (see :func:`init_extractor_numpy`)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    blocks, cin = [], 3
    for _ in range(depth):
        blocks.append({"w": normal((3, 3, cin, channels),
                                   (2.0 / (9 * cin)) ** 0.5),
                       "b": np.zeros((channels,), np.float32)})
        cin = channels
    fin = channels + n_bits + 3
    p = {
        "blocks": blocks,
        "fuse": {"w": normal((3, 3, fin, channels), (2.0 / (9 * fin)) ** 0.5),
                 "b": np.zeros((channels,), np.float32)},
        "out": {"w": normal((1, 1, channels, 3), 0.02),
                "b": np.zeros((3,), np.float32)},
    }
    if tile:
        P = rng.standard_normal((n_bits, tile, tile, 3))
        P -= P.mean(axis=(1, 2, 3), keepdims=True)
        P /= np.sqrt(np.sum(P * P, axis=(1, 2, 3), keepdims=True))
        p["patterns"] = P.astype(np.float32)
    return p


def encoder_forward(params: dict, tiles: torch.Tensor,
                    messages: torch.Tensor, *, alpha: float = 1.0,
                    embed_rms: float = 0.06):
    """tiles (b, l, l, 3), messages (b, n) in {0, 1} -> (watermarked
    tiles, residual delta).  The residual is power-normalised to
    ``embed_rms`` per sample before the alpha scale; the result is
    clipped to [-1, 1] as ``jnp.clip`` clips."""
    b, l = tiles.shape[0], tiles.shape[1]
    x = tiles
    for blk in params["blocks"]:
        x = _block(blk, x)
    m = 2.0 * messages.to(torch.float32) - 1.0
    mb = m[:, None, None, :].expand(b, l, l, m.shape[-1])
    x = torch.cat([x, mb, tiles], dim=-1)
    x = _block(params["fuse"], x)
    delta = conv2d(x, params["out"]["w"]) + params["out"]["b"]
    if "patterns" in params:
        # spread-spectrum pathway: delta += sum_i mtilde_i * P_i
        delta = delta + torch.einsum("bn,nhwc->bhwc", m, params["patterns"])
    rms = torch.sqrt(torch.mean(torch.square(delta), dim=(1, 2, 3),
                                keepdim=True) + 1e-8)
    delta = delta * (embed_rms / rms)
    return clip(tiles + alpha * delta, -1.0, 1.0), delta
