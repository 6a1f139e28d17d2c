"""Top-level model of the LM seed code (counterpart of
``repro.models.lm``): the ``LM`` module, the train / prefill / decode
forwards, and the carry-across of a reference parameter tree.

One code path serves the ten architectures (dense / MoE / SSM / hybrid /
VLM / audio enc-dec) driven by :class:`repro_torch.configs.base.ArchConfig`.

Parameter layouts.  The reference's tree is
``{"embed", "final_norm", ["head"], "groups", ["encoder", "enc_norm"]}``
with ``groups`` a tuple of one dict a layer of the group, each leaf
stacked over the groups on a leading axis (the encoder-decoder path
stacks one layer per group).  The port's tree (:func:`param_tree`) has
``"layers"`` (and ``"encoder"``) as lists of one dict a layer instead;
:func:`to_reference` stacks it into the reference's layout and
:func:`from_reference` splits it back, for any leaves (numpy arrays or
tensors), so a reference tree round-trips exactly and checkpoints keep
the reference's entry names.

The dry-run's abstract trees (:func:`abstract_params`,
:func:`input_specs`, :func:`abstract_decode_state`) are tensors on the
``meta`` device: shapes and dtypes, no storage, in the reference's
layout leaf for leaf.  :func:`decode_state_from_reference` and
:func:`decode_state_to_reference` carry a decode state between that
stacked layout and the port's one cache a layer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import attention, blocks, ssm as ssm_lib
from repro_torch.models.layers import (causal_lm_loss, dense_init, rmsnorm,
                                       zeros_param)
from repro_torch.train.optimizer import tree_items, tree_leaves, tree_map


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """All parameters of one architecture (``init_params``), float32 by
    default, drawn on the CPU from ``gen`` in a fixed order.  ``gen=None``
    leaves them uninitialised (for weights loaded afterwards)."""

    def __init__(self, cfg, gen: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab
        self.embed = dense_init(gen, (V, d), dtype=dtype)
        self.final_norm = zeros_param(d, dtype=dtype)
        if not cfg.tie_embeddings:
            self.head = dense_init(gen, (d, V), dtype=dtype)
        gs = blocks.group_size(cfg)
        kw = dict(dtype=dtype)
        if cfg.is_encoder_decoder:
            if gs != 1:
                raise ValueError("enc-dec assumes uniform layers")
            self.encoder = nn.ModuleList(
                blocks.Layer(gen, cfg, 0, **kw)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = zeros_param(d, dtype=dtype)
            self.layers = nn.ModuleList(
                blocks.Layer(gen, cfg, 0, cross=True, **kw)
                for _ in range(cfg.n_layers))
        else:
            blocks.n_groups(cfg)  # raises unless whole groups
            self.layers = nn.ModuleList(
                blocks.Layer(gen, cfg, i % gs, **kw)
                for i in range(cfg.n_layers))

    def forward(self, batch, *, compute_dtype=torch.bfloat16, remat=True):
        return forward_train(self, batch, compute_dtype=compute_dtype,
                             remat=remat)


def init_params(cfg, seed: int = 0, *, device=None, dtype=torch.float32
                ) -> LM:
    """A freshly initialised model on ``device`` (the card unless the
    caller asks for the CPU), its weights drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``."""
    from repro_torch.core.detect import resolve_device
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return LM(cfg, gen, dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# parameter trees: the port's layout and the reference's
# ---------------------------------------------------------------------------


def _module_tree(m: nn.Module) -> dict:
    out: dict = {}
    for name, p in m.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p
    return out


def param_tree(model: LM) -> dict:
    """The model's parameters as a tree in the port's layout."""
    t = {k: getattr(model, k) for k in ("embed", "final_norm", "head",
                                         "enc_norm") if hasattr(model, k)}
    t["layers"] = [_module_tree(l) for l in model.layers]
    if hasattr(model, "encoder"):
        t["encoder"] = [_module_tree(l) for l in model.encoder]
    return t


def _stack_layers(layers: list, stack) -> dict:
    return {k: _stack_layers([l[k] for l in layers], stack)
            if isinstance(layers[0][k], dict) else stack([l[k] for l in layers])
            for k in layers[0]}


def _take_layer(tree: dict, i: int) -> dict:
    return {k: _take_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack(leaves)


def to_reference(tree: dict, cfg, stack=_stack) -> dict:
    """A tree in the port's layout -> the reference's (layer leaves
    stacked over the groups)."""
    gs = blocks.group_size(cfg)
    out = {k: v for k, v in tree.items() if k not in ("layers", "encoder")}
    out["groups"] = tuple(_stack_layers(tree["layers"][j::gs], stack)
                          for j in range(gs))
    if "encoder" in tree:
        out["encoder"] = (_stack_layers(tree["encoder"], stack),)
    return out


def from_reference(tree: dict, cfg) -> dict:
    """The inverse of :func:`to_reference` (layer ``gi * gs + j`` is entry
    ``gi`` of ``groups[j]``)."""
    gs = blocks.group_size(cfg)
    out = {k: v for k, v in tree.items() if k not in ("groups", "encoder")}
    groups = tree["groups"]
    n = len(tree_leaves(groups[0])[0])
    out["layers"] = [_take_layer(groups[i % gs], i // gs)
                     for i in range(n * gs)]
    if "encoder" in tree:
        enc = tree["encoder"][0]
        out["encoder"] = [_take_layer(enc, i)
                          for i in range(len(tree_leaves(enc)[0]))]
    return out


def abstract_params(cfg, dtype=torch.float32) -> dict:
    """The parameters as meta tensors in the reference's layout (its
    ``jax.eval_shape`` of ``init_params``), without allocating."""
    with torch.device("meta"):
        model = LM(cfg, None, dtype=dtype)
    return to_reference(tree_map(lambda t: t.detach(), param_tree(model)),
                        cfg)


def lm_params_to_numpy(model: LM) -> dict:
    """The model's parameters as a reference-layout tree of numpy arrays
    (copies)."""
    return to_reference(numpy_tree(param_tree(model)), model.cfg)


def numpy_tree(t):
    """A tree of tensors as numpy arrays (copies), same structure."""
    if isinstance(t, dict):
        return {k: numpy_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(numpy_tree(v) for v in t)
    return t.detach().cpu().numpy().copy()


def lm_params_from_numpy(tree: dict, cfg, device) -> LM:
    """A model on ``device`` holding a reference-layout tree's weights
    (numpy arrays, or tensors) exactly.  Raises on a missing, extra or
    misshapen leaf."""
    with torch.device("meta"):
        model = LM(cfg, None)
    model = model.to_empty(device=torch.device(device))
    load_tree(model, from_reference(tree, cfg))
    return model


@torch.no_grad()
def load_tree(model: LM, tree: dict):
    """Copy a port-layout tree (numpy arrays or tensors) into the model's
    parameters, leaf by leaf."""
    want = dict(tree_items(param_tree(model)))
    got = dict(tree_items(tree))
    if want.keys() != got.keys():
        raise KeyError(f"tree leaves differ from the model's: missing "
                       f"{sorted(want.keys() - got.keys())[:4]}, extra "
                       f"{sorted(got.keys() - want.keys())[:4]}")
    for name, p in want.items():
        src = got[name] if isinstance(got[name], torch.Tensor) \
            else torch.from_numpy(np.array(got[name]))
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(src.to(p.dtype))


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(model: LM, tokens, compute_dtype):
    # rows gathered first, then cast: the same values as the reference's
    # cast-then-gather, without a compute-dtype copy of the whole table
    return model.embed[tokens.long()].to(compute_dtype)


def unembed(model: LM, x):
    w = model.embed.T if model.cfg.tie_embeddings else model.head
    return x @ w.to(x.dtype)


def _assemble_inputs(model: LM, batch, compute_dtype):
    """Token / frontend fusion -> (x, loss_mask, tokens_for_loss): a
    vision prefix of patch embeddings, masked out of the loss."""
    if model.cfg.frontend == "vision":
        text = batch["tokens"]  # (b, s_text)
        patches = batch["patch_embeds"].to(compute_dtype)  # (b, nf, d)
        xt = embed_tokens(model, text, compute_dtype)
        x = torch.cat([patches, xt], dim=1)
        b, nf = patches.shape[:2]
        pad = torch.zeros((b, nf), dtype=text.dtype, device=text.device)
        tokens_full = torch.cat([pad, text], dim=1)
        mask = torch.cat([torch.zeros((b, nf), dtype=torch.bool,
                                      device=text.device),
                          torch.ones_like(text, dtype=torch.bool)], dim=1)
        return x, mask, tokens_full
    tokens = batch["tokens"]
    x = embed_tokens(model, tokens, compute_dtype)
    return x, torch.ones_like(tokens, dtype=torch.bool), tokens


# ---------------------------------------------------------------------------
# encoder (enc-dec archs)
# ---------------------------------------------------------------------------


def encode(model: LM, frame_embeds, *, remat=False):
    x, _ = blocks.run_backbone(model.encoder, frame_embeds, model.cfg,
                               mode="train", causal=False, remat=remat)
    return rmsnorm(x, model.enc_norm, model.cfg.norm_eps)


def cross_kv_stack(model: LM, enc_out) -> list:
    """Cross-attention K/V of every decoder layer, precomputed."""
    cfg = model.cfg
    b, s, _ = enc_out.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    dt = enc_out.dtype
    return [((enc_out @ l.cross.wk.to(dt)).reshape(b, s, kvh, hd),
             (enc_out @ l.cross.wv.to(dt)).reshape(b, s, kvh, hd))
            for l in model.layers]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def forward_train(model: LM, batch, *, compute_dtype=torch.bfloat16,
                  remat=True):
    """The scalar LM loss of one batch (a dict of tensors on the model's
    device)."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        enc_out = encode(model, batch["frame_embeds"].to(compute_dtype),
                         remat=remat)
        ckv = cross_kv_stack(model, enc_out)
        tgt = batch["tgt_tokens"]
        x = embed_tokens(model, tgt, compute_dtype)
        x, _ = blocks.run_backbone(model.layers, x, cfg, mode="train",
                                   cross_kv=ckv, remat=remat)
        x = rmsnorm(x, model.final_norm, cfg.norm_eps)
        return causal_lm_loss(unembed(model, x), tgt)
    x, mask, tokens = _assemble_inputs(model, batch, compute_dtype)
    x, _ = blocks.run_backbone(model.layers, x, cfg, mode="train",
                               remat=remat)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return causal_lm_loss(unembed(model, x), tokens, mask=mask)


def forward_prefill(model: LM, batch, *, compute_dtype=torch.bfloat16,
                    max_len: Optional[int] = None):
    """Prefill: consume the prompt, return (last_logits, decode_state).

    The state is ``{"caches": one cache a layer, "index": the prompt's
    length, ["cross": cross K/V a layer]}``.  ``max_len`` (prompt plus
    the decode steps to come) gives the attention caches room for the
    decode steps' K/V (:func:`attention.extend_cache`); without it the
    caches hold the prompt alone, as the reference's do.
    """
    cfg = model.cfg
    state = {}
    if cfg.is_encoder_decoder:
        enc_out = encode(model, batch["frame_embeds"].to(compute_dtype))
        state["cross"] = cross_kv_stack(model, enc_out)
        x = embed_tokens(model, batch["tgt_tokens"], compute_dtype)
    else:
        x, _, _ = _assemble_inputs(model, batch, compute_dtype)
    x, caches = blocks.run_backbone(model.layers, x, cfg, mode="prefill",
                                    cross_kv=state.get("cross"))
    if max_len is not None:
        caches = [attention.extend_cache(cfg, c, max_len) if "k" in c
                  else c for c in caches]
    state.update(caches=caches, index=x.shape[1])
    x = rmsnorm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return unembed(model, x), state


def forward_decode(model: LM, tokens, state, *,
                   compute_dtype=torch.bfloat16):
    """One decode step.  tokens: (b, 1).  Returns (logits, new_state); the
    state passed in is not written."""
    cfg = model.cfg
    x = embed_tokens(model, tokens, compute_dtype)
    x, new_caches = blocks.run_backbone(
        model.layers, x, cfg, mode="decode", caches=state["caches"],
        cache_index=state["index"], cross_kv=state.get("cross"))
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    return unembed(model, x), dict(state, caches=new_caches,
                                   index=state["index"] + 1)


# ---------------------------------------------------------------------------
# abstract inputs for the dry-run (meta tensors: no storage)
# ---------------------------------------------------------------------------


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg, shape, *, compute_dtype=torch.bfloat16) -> dict:
    """Abstract model inputs for an (arch, shape) cell.

    train/prefill -> {"batch": ...}; decode -> {"tokens", "state"}: one
    new token against a KV cache of ``seq_len``; the audio and vision
    frontends give precomputed embeddings.
    """
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    i32 = torch.int32
    if shape.mode in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            tgt = max(64, s // 8)
            batch = {"frame_embeds": sds((b, s, d), compute_dtype),
                     "tgt_tokens": sds((b, tgt), i32)}
        elif cfg.frontend == "vision":
            nf = cfg.n_frontend_tokens
            batch = {"tokens": sds((b, s - nf), i32),
                     "patch_embeds": sds((b, nf, d), compute_dtype)}
        else:
            batch = {"tokens": sds((b, s), i32)}
        return {"batch": batch}
    state = abstract_decode_state(cfg, b, s, compute_dtype)
    return {"tokens": sds((b, 1), i32), "state": state}


def abstract_decode_state(cfg, b, s, compute_dtype=torch.bfloat16) -> dict:
    """The decode state in the reference's layout: ``caches`` a tuple over
    the in-group positions, each leaf stacked over the ``ng`` groups
    (bf16 caches), a scalar int32 ``index`` and, encoder-decoder, the
    stacked cross K/V in ``compute_dtype``."""
    ng = blocks.n_groups(cfg)
    caches = []
    for i in range(blocks.group_size(cfg)):
        if cfg.layer_kind(i) == "attn":
            proto = attention.empty_cache(cfg, b, s, torch.bfloat16,
                                          device="meta")
        else:
            proto = ssm_lib.empty_ssm_cache(cfg, b, torch.bfloat16,
                                            device="meta")
        caches.append({k: sds((ng,) + tuple(v.shape), v.dtype)
                       for k, v in proto.items()})
    state = {"caches": tuple(caches), "index": sds((), torch.int32)}
    if cfg.is_encoder_decoder:
        kvh, hd = cfg.n_kv_heads, cfg.head_dim
        state["cross"] = (sds((ng, b, s, kvh, hd), compute_dtype),
                          sds((ng, b, s, kvh, hd), compute_dtype))
    return state


def decode_state_from_reference(state: dict, cfg, index=None) -> dict:
    """A reference-layout decode state -> the port's (one cache a layer,
    layer ``gi * gs + j`` being entry ``gi`` of ``caches[j]``; the cross
    K/V a (k, v) pair a layer).  ``index`` (an int) replaces the state's
    own, which must be one on a real device."""
    gs = blocks.group_size(cfg)
    ng = blocks.n_groups(cfg)
    if index is None:
        index = int(state["index"])
    out = {"caches": [_take_layer(state["caches"][i % gs], i // gs)
                      for i in range(ng * gs)], "index": index}
    if "cross" in state:
        k, v = state["cross"]
        out["cross"] = [(k[i], v[i]) for i in range(ng)]
    return out


def decode_state_to_reference(state: dict, cfg, stack=_stack) -> dict:
    """The inverse of :func:`decode_state_from_reference` (the index
    kept as it is)."""
    gs = blocks.group_size(cfg)
    caches = state["caches"]
    out = {"caches": tuple(_stack_layers(caches[j::gs], stack)
                           for j in range(gs)), "index": state["index"]}
    if "cross" in state:
        out["cross"] = tuple(stack([kv[t] for kv in state["cross"]])
                             for t in (0, 1))
    return out
