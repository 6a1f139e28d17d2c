"""Train / prefill / decode steps of the LM seed code (counterpart of
``repro.train.step``).

``make_train_step`` accumulates gradients over ``n_micro`` microbatches
(a float32 accumulator, bf16 under ``grad_compress``; the sum divided by
``n_micro``), recomputes each layer group's forward in the backward pass
under ``remat``, and applies AdamW with global-norm clipping
(``repro_torch.train.optimizer``).  Gradients come from autograd; the
parameters are the model's, updated in place.

At float32 compute the step refuses a TF32 float32-matmul precision on
the card (the reference's float32 is full float32) instead of changing
the global setting.
"""
from __future__ import annotations

import torch

from repro_torch.core.train_extractor import check_fp32
from repro_torch.models import lm
from repro_torch.train import optimizer as opt_lib


def make_train_step(cfg, opt_cfg, *, n_micro=1, compute_dtype=torch.bfloat16,
                    grad_compress=False, remat=True):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; ``batch`` is a dict of tensors on the model's device whose
    leading (batch) dimension ``n_micro`` divides, ``opt_state`` a tree in
    the port's layout (``optimizer.init_opt_state(lm.param_tree(model))``).
    ``cfg`` is the model's config (kept for the reference's signature)."""

    def loss_and_grads(model, leaves, mb):
        loss = lm.forward_train(model, mb, compute_dtype=compute_dtype,
                                remat=remat)
        return loss, torch.autograd.grad(loss, leaves)

    def train_step(model, opt_state, batch):
        tree = lm.param_tree(model)
        leaves = opt_lib.tree_leaves(tree)
        if compute_dtype == torch.float32:
            check_fp32(leaves[0].device)
        if n_micro == 1:
            loss, grads = loss_and_grads(model, leaves, batch)
            loss = loss.detach()
        else:
            acc_dtype = torch.bfloat16 if grad_compress else torch.float32
            acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                   for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _microbatches(batch, n_micro):
                l, g = loss_and_grads(model, leaves, mb)
                acc = [a + gi.to(acc_dtype) for a, gi in zip(acc, g)]
                loss = loss + l.detach()
            loss = loss / n_micro
            grads = [(a / n_micro).float() for a in acc]
        new_tree, opt_state, metrics = opt_lib.adamw_update(
            opt_cfg, tree, opt_lib.tree_unflatten(tree, list(grads)),
            opt_state)
        with torch.no_grad():
            for p, new in zip(leaves, opt_lib.tree_leaves(new_tree)):
                p.copy_(new)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def _microbatches(batch: dict, n_micro: int):
    """The batch cut into ``n_micro`` equal consecutive slices of its
    leading dimension, as the reference reshapes it."""
    n = next(iter(batch.values())).shape[0]
    if n % n_micro:
        raise ValueError(f"a batch of {n} does not split into {n_micro} "
                         f"microbatches")
    per = n // n_micro
    for i in range(n_micro):
        yield {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


def make_prefill_step(cfg, *, compute_dtype=torch.bfloat16, max_len=None):
    """``prefill_step(model, batch) -> (last logits, decode state)``, no
    autograd; ``max_len`` as in :func:`lm.forward_prefill`."""
    @torch.no_grad()
    def prefill_step(model, batch):
        return lm.forward_prefill(model, batch, compute_dtype=compute_dtype,
                                  max_len=max_len)
    return prefill_step


def make_decode_step(cfg, *, compute_dtype=torch.bfloat16):
    """``decode_step(model, tokens, state) -> (logits, new state)``, no
    autograd."""
    @torch.no_grad()
    def decode_step(model, tokens, state):
        return lm.forward_decode(model, tokens, state,
                                 compute_dtype=compute_dtype)
    return decode_step
