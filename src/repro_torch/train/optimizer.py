"""AdamW from scratch with global-norm clipping (counterpart of
``repro.train.optimizer``), over parameter trees of dicts, lists and
float32 tensors.

Leaves are visited in JAX's flattening order (dict keys sorted, lists in
order), so the global norm sums the leaves in the reference's order.
The schedule, the bias corrections and every update are float32 tensor
arithmetic on the parameters' device; the step count is an int32
tensor, as in the reference's state.  Everything here runs without
autograd: it consumes gradients, it does not make them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a tree of dicts and lists in JAX's order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_items(tree: Any, prefix: str = "") -> List[tuple]:
    """(name, leaf) of every leaf in :func:`tree_leaves`' order, each name
    the leaf's path as ``jax.tree_util.keystr`` writes it (``['groups'][0]
    ['attn']['wq']``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_items(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_items(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with its leaves replaced, in
    :func:`tree_leaves`' order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params: Any) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine decay to ``min_lr_frac``
    of it at ``total_steps``; float32, on ``step``'s device."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 opt_state: dict):
    """One AdamW step.  Returns (new_params, new_opt_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, v):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p32)
        return p32.to(p.dtype), m, v

    leaves = [tree_leaves(t) for t in (params, grads, opt_state["m"],
                                       opt_state["v"])]
    res = [upd(*x) for x in zip(*leaves)]
    new_params = tree_unflatten(params, [r[0] for r in res])
    new_state = {"m": tree_unflatten(params, [r[1] for r in res]),
                 "v": tree_unflatten(params, [r[2] for r in res]),
                 "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
