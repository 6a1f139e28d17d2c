"""Backbone blocks of the LM seed code (counterpart of
``repro.models.blocks``): pre-norm residual layers and the backbone as
one loop over them.

Layers are organised into *groups*: the smallest repeating pattern of the
architecture (1 layer for uniform archs, ``attn_period`` layers — or the
least common multiple with the MoE period — for hybrids).  The reference
stacks each group's parameters on a leading axis and scans over groups;
the port keeps one module a layer (``LM.layers``, layer ``gi * gs + j``
being in-group position ``j`` of group ``gi``) and loops over them.  The
reference's ``unroll`` (a Python loop in place of the scan, for XLA's
cost analysis) has no counterpart: the port's loop is the only one.
``remat`` checkpoints each group with ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, moe as moe_lib, ssm as ssm_lib
from repro_torch.models.layers import MLP, rmsnorm, zeros_param


def group_size(cfg) -> int:
    g = cfg.attn_period if cfg.attn_period else 1
    if cfg.moe is not None:
        g = math.lcm(g, cfg.moe.period)
    return g


def n_groups(cfg) -> int:
    gs = group_size(cfg)
    if cfg.n_layers % gs:
        raise ValueError(f"{cfg.n_layers} layers are not a whole number of "
                         f"groups of {gs}")
    return cfg.n_layers // gs


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    """One backbone layer (``init_layer``): attention or SSM, then an MoE,
    a dense or no MLP (a pure-SSM block has no ``ln2``), and with
    ``cross`` a cross-attention sub-layer.  ``i`` is the layer's in-group
    position, which selects its kind and MLP."""

    def __init__(self, gen, cfg, i: int, *, cross=False,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.ln1 = zeros_param(d, dtype=dtype)
        if cfg.layer_kind(i) == "attn":
            self.attn = attention.Attention(gen, cfg, dtype)
        else:
            self.ssm = ssm_lib.SSM(gen, cfg, dtype)
        if cfg.layer_is_moe(i):
            self.ln2 = zeros_param(d, dtype=dtype)
            self.moe = moe_lib.MoE(gen, cfg, cfg.moe, dtype)
        elif cfg.d_ff > 0:
            self.ln2 = zeros_param(d, dtype=dtype)
            self.mlp = MLP(gen, d, cfg.d_ff, dtype)
        if cross:
            self.cross = attention.Attention(gen, cfg, dtype)
            self.ln_cross = zeros_param(d, dtype=dtype)


def layer_forward(p: Layer, x, cfg, *, mode, cache=None, cache_index=None,
                  positions=None, cross_kv=None, causal=True):
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if hasattr(p, "attn"):
        h, new_cache = attention.attn_forward(
            p.attn, h, cfg, mode=mode, cache=cache, cache_index=cache_index,
            positions=positions, causal=causal)
    else:
        h, new_cache = ssm_lib.ssm_forward(p.ssm, h, cfg, mode=mode,
                                           cache=cache)
    x = x + h
    if cross_kv is not None:
        h = rmsnorm(x, p.ln_cross, cfg.norm_eps)
        h, _ = attention.attn_forward(
            p.cross, h, cfg, mode="decode" if mode == "decode" else "train",
            cross_kv=cross_kv)
        x = x + h
    if not hasattr(p, "ln2"):  # pure-SSM block: no MLP sub-layer
        return x, new_cache
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    h = p.moe(h) if hasattr(p, "moe") else p.mlp(h)
    return x + h, new_cache


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


def run_backbone(layers, x, cfg, *, mode, caches=None, cache_index=None,
                 positions=None, cross_kv=None, causal=True, remat=False):
    """The layers in order.  ``caches`` and ``cross_kv`` are per-layer
    lists (or None).  Returns (x, the per-layer caches that prefill and
    decode make, or None in train mode).

    ``remat`` recomputes each group's forward in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
    activations.
    """
    gs = group_size(cfg)
    want_cache = mode != "train"
    new_caches = []

    def group(x, g0):
        out = []
        for i in range(g0, g0 + gs):
            x, nc = layer_forward(
                layers[i], x, cfg, mode=mode,
                cache=caches[i] if caches is not None else None,
                cache_index=cache_index, positions=positions,
                cross_kv=cross_kv[i] if cross_kv is not None else None,
                causal=causal)
            out.append(nc)
        return x, out

    for g0 in range(0, len(layers), gs):
        if remat and torch.is_grad_enabled():
            x, nc = checkpoint(group, x, g0, use_reentrant=False)
        else:
            x, nc = group(x, g0)
        new_caches.extend(nc)
    return x, (new_caches if want_cache else None)
