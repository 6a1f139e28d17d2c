"""Shared layers of the LM seed code (counterpart of
``repro.models.layers``): RMSNorm, the SwiGLU MLP, rotary position
embeddings and the next-token loss, as functions on tensors, plus the
parameter initialiser the modules draw from an explicit
``torch.Generator``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense_init(gen: Optional[torch.Generator], shape, scale: float = 0.02,
               dtype=torch.float32) -> nn.Parameter:
    """``scale`` * N(0, 1) drawn on the CPU from ``gen`` (so a seed gives
    the same weights whatever device the model moves to); uninitialised
    when ``gen`` is None."""
    if gen is None:
        return nn.Parameter(torch.empty(tuple(shape), dtype=dtype))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return nn.Parameter((scale * w).to(dtype))


def zeros_param(*shape, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + scale``, back in x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP.  p: w_gate (d, ff), w_up (d, ff), w_down (ff, d)."""
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (F.silu(g) * u) @ p["w_down"].to(dt)


class MLP(nn.Module):
    """The dense SwiGLU MLP's weights (``init_mlp``)."""

    def __init__(self, gen: torch.Generator, d: int, ff: int,
                 dtype=torch.float32):
        super().__init__()
        self.w_gate = dense_init(gen, (d, ff), dtype=dtype)
        self.w_up = dense_init(gen, (d, ff), dtype=dtype)
        self.w_down = dense_init(gen, (ff, d), dtype=dtype)

    def forward(self, x):
        return swiglu_mlp(dict(self.named_parameters()), x)


# -- rotary position embeddings --------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., s, h, hd); positions: broadcastable to (..., s).  The two
    halves of the head dimension rotate together (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., s, hd/2)
    sin = torch.sin(angles)[..., None, :]  # (..., s, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy.  logits: (b, s, V) predicts tokens[:, 1:];
    the log-sum-exp in float32, averaged over the mask."""
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    else:
        mask = mask[:, 1:].float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
