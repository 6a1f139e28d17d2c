"""Mixture-of-Experts MLP with capacity-based scatter dispatch
(counterpart of ``repro.models.moe``).

  1. top-k routing per token over the float32 router softmax, the k
     gates renormalised;
  2. position-in-expert as a cumulative sum over the (T*k, E) one-hot
     (the reference's ``DISPATCH_SCAN`` computes the same integers with
     an associative scan; one cumulative sum serves both);
  3. tokens scatter into an (E*C + 1, d) buffer — over-capacity choices
     go to the last row, which is dropped;
  4. the batched expert SwiGLU;
  5. gather back and combine with the gates.

Group-wise dispatch (the reference's ``DISPATCH_GROUPS``) splits the
tokens into ``groups`` equal groups, each with its own capacity (the
reference maps over them, the port loops); a module dispatches in its
``groups`` groups (0, one global dispatch, by default; the dry-run's
``--moe-local`` sets it).  The reference also
pins the group dimension to the data axes of a mesh (``MESH``); one
device has no such constraint, so nothing here stands for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init


class MoE(nn.Module):
    """Router and stacked expert weights (``init_moe``); ``moe`` is the
    layer's :class:`MoEConfig`."""

    groups = 0  # dispatch groups (``moe_mlp``'s ``groups``)

    def __init__(self, gen: torch.Generator, cfg, moe, dtype=torch.float32):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, moe.n_experts
        self.moe = moe
        self.router = dense_init(gen, (d, E), dtype=dtype)
        self.w_gate = dense_init(gen, (E, d, ff), dtype=dtype)
        self.w_up = dense_init(gen, (E, d, ff), dtype=dtype)
        self.w_down = dense_init(gen, (E, ff, d), dtype=dtype)

    def forward(self, x, return_aux=False):
        return moe_mlp(self, x, self.moe, groups=self.groups,
                       return_aux=return_aux)


def capacity(n_tokens: int, moe) -> int:
    c = int(-(-n_tokens * moe.top_k * moe.capacity_factor // moe.n_experts))
    return max(8, -(-c // 8) * 8)  # rounded up to a multiple of 8


def route(p, x: torch.Tensor, moe):
    """x: (T, d) -> (probs (T, E) float32, gates (T, k) renormalised,
    expert ids (T, k)).  Ties go to the lower expert id, as
    ``lax.top_k`` breaks them."""
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = order[:, :moe.top_k]
    gate = torch.gather(probs, 1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def dispatch(idx: torch.Tensor, n_experts: int, cap: int):
    """Expert ids (T, k) -> (position of each (token, choice) in its
    expert, whether it fits, its row in the (E*C + 1)-row buffer), each
    (T*k,); a dropped choice's row is the last."""
    eid = idx.reshape(-1)
    # the one-hot as a comparison: ``F.one_hot`` takes another path on
    # the meta device than on a real one, and the dry-run's byte count
    # must not depend on the device
    oh = (eid[:, None] == torch.arange(n_experts, device=eid.device)
          ).to(torch.int32)
    pos = torch.gather(torch.cumsum(oh, dim=0, dtype=torch.int32) - 1, 1,
                       eid[:, None])[:, 0]
    keep = pos < cap
    dst = torch.where(keep, eid * cap + pos,
                      torch.full_like(eid, n_experts * cap))
    return pos, keep, dst


def moe_mlp(p, x, moe, *, groups: int = 0, return_aux=False):
    """x: (..., d) -> (..., d).  Flattens to (T, d).  With ``groups``
    dividing T and T / groups >= n_experts each group dispatches alone
    (then, as in the reference, only the output comes back)."""
    orig_shape = x.shape
    d = x.shape[-1]
    x = x.reshape(-1, d)
    T = x.shape[0]
    if groups and T % groups == 0 and T // groups >= moe.n_experts:
        xg = x.reshape(groups, T // groups, d)
        out = torch.stack([_moe_mlp_flat(p, xg[g], moe)
                           for g in range(groups)])
        return out.reshape(orig_shape)
    out = _moe_mlp_flat(p, x, moe, return_aux=return_aux)
    if return_aux:
        return out[0].reshape(orig_shape), out[1]
    return out.reshape(orig_shape)


def _moe_mlp_flat(p, x, moe, *, return_aux=False):
    T, d = x.shape
    E, k = moe.n_experts, moe.top_k
    C = capacity(T, moe)
    dt = x.dtype

    probs, gate, idx = route(p, x, moe)
    _, keep, dst = dispatch(idx, E, C)

    x_rep = torch.repeat_interleave(x, k, dim=0)  # token i -> rows i*k..
    # duplicate writes land only on the drop row, which is discarded
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device).index_copy(
        0, dst, x_rep)
    eb = buf[:E * C].reshape(E, C, d)

    g = torch.bmm(eb, p.w_gate.to(dt))
    u = torch.bmm(eb, p.w_up.to(dt))
    y = torch.bmm(F.silu(g) * u, p.w_down.to(dt))

    y_flat = torch.cat([y.reshape(E * C, d),
                        torch.zeros((1, d), dtype=dt, device=x.device)])
    y_tok = y_flat[dst]  # (T*k, d); dropped choices read zeros
    w = (gate.reshape(-1) * keep.float()).to(dt)
    out = (y_tok * w[:, None]).reshape(T, k, d).sum(dim=1)
    if return_aux:
        # Switch load-balancing loss: E * sum_e f_e * p_e
        me = torch.mean(F.one_hot(idx, E).float(), dim=(0, 1))
        pe = torch.mean(probs, dim=0)
        return out, E * torch.sum(me * pe)
    return out
