"""Attention of the LM seed code (counterpart of
``repro.models.attention``): GQA with an optional sliding window, the
blocked (flash-style) online softmax for train and prefill, and the
single-token decode against a KV cache.

The reference computes attention itself, and so does the port: the same
blocks, the same ``NEG_INF`` masking and the same float32 contract —
scores and the ``p @ V`` sums in float32 from operands in the storage
dtype (the reference's ``preferred_element_type=float32``).  A bf16
matmul in PyTorch returns bf16, so each block is upcast to float32 on
its own before its two matmuls (never the whole K/V at once); ``p`` is
rounded to V's dtype first, as the reference rounds it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def blocked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      kv_len=None, q_block=512, kv_block=512,
                      causal_skip=True):
    """q: (b, sq, h, hd); k/v: (b, skv, kvh, hd).  GQA via head grouping.

    ``q_offset``: absolute position of q[0] (for prefill continuation).
    ``kv_len``: number of valid kv entries (int, 0-d tensor or None =
    all).  ``causal_skip``: skip the KV blocks above the diagonal of each
    Q block (the reference's static bound, which ignores ``q_offset``).
    """
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    rep = h // kvh
    scale = hd ** -0.5
    dev = q.device

    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    sq_p = -(-sq // q_block) * q_block
    skv_p = -(-skv // kv_block) * kv_block
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
    qp, kp, vp = pad(q, sq_p - sq), pad(k, skv_p - skv), pad(v, skv_p - skv)
    nq, nkv = sq_p // q_block, skv_p // kv_block

    qb = qp.reshape(b, nq, q_block, kvh, rep, hd)
    kb = kp.reshape(b, nkv, kv_block, kvh, hd)
    vb = vp.reshape(b, nkv, kv_block, kvh, hd)
    q_pos = q_offset + torch.arange(sq_p, device=dev).reshape(nq, q_block)
    kv_pos = torch.arange(skv_p, device=dev).reshape(nkv, kv_block)
    valid_kv = skv if kv_len is None else kv_len

    outs = []
    for qi in range(nq):  # per-block KV bounds differ
        qblk = qb[:, qi].float()  # (b, qb, kvh, rep, hd)
        qpos = q_pos[qi]
        m = torch.full((b, q_block, kvh, rep), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, q_block, kvh, rep), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, q_block, kvh, rep, hd), dtype=torch.float32,
                          device=dev)
        if causal and causal_skip:
            hi = max(min(nkv, ((qi + 1) * q_block + kv_block - 1)
                         // kv_block), 1)
        else:
            hi = nkv
        for ki in range(hi):
            kpos = kv_pos[ki]
            s = torch.einsum("bqgrd,bkgd->bqgrk", qblk,
                             kb[:, ki].float()) * scale
            mask = kpos[None, :] < valid_kv
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            vblk = vb[:, ki]
            acc = acc * corr[..., None] + torch.einsum(
                "bqgrk,bkgd->bqgrd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs, dim=1)  # (b, nq, qb, kvh, rep, hd)
    out = out.reshape(b, sq_p, h, hd)[:, :sq]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, cache_len, window=0,
                     positions=None):
    """One-step decode.  q: (b, 1, h, hd); caches: (b, S, kvh, hd).

    ``cache_len``: number of valid entries.  ``positions``: the absolute
    position of each cache slot (b, S) for a ring buffer (SWA), -1 for an
    empty slot; None means slot i holds position i.
    """
    b, _, h, hd = q.shape
    _, S, kvh, _ = k_cache.shape
    rep = h // kvh
    scale = hd ** -0.5
    qf = q.reshape(b, kvh, rep, hd).to(k_cache.dtype)
    s = torch.einsum("bgrd,bkgd->bgrk", qf.float(), k_cache.float()) * scale
    if positions is None:
        mask = torch.arange(S, device=q.device)[None, :] < cache_len
    else:
        q_pos = cache_len - 1
        mask = (positions <= q_pos) & (positions >= 0)
        if window:
            mask = mask & (positions > q_pos - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# full attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """The projections of one attention layer (``init_attn``)."""

    def __init__(self, gen: torch.Generator, cfg, dtype=torch.float32):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        self.wq = dense_init(gen, (d, h * hd), dtype=dtype)
        self.wk = dense_init(gen, (d, kvh * hd), dtype=dtype)
        self.wv = dense_init(gen, (d, kvh * hd), dtype=dtype)
        self.wo = dense_init(gen, (h * hd, d), dtype=dtype)


def _set_slot(cache: torch.Tensor, slot: int, val: torch.Tensor
              ) -> torch.Tensor:
    """A copy of ``cache`` (b, S, ...) with slot ``slot`` set to ``val``;
    a slot past the end is dropped, as the reference's scatter drops it
    (``cache`` itself comes back)."""
    if slot >= cache.shape[1]:
        return cache
    out = cache.clone()
    out[:, slot] = val
    return out


def attn_forward(p: Attention, x, cfg, *, mode, cache=None,
                 cache_index=None, positions=None, cross_kv=None,
                 causal=True):
    """Returns (out, new_cache).

    mode: 'train' | 'prefill' | 'decode'.
    cache: {"k": (b,S,kvh,hd), "v": ..., ["pos": (b,S)]} for decode; the
    cache that comes back is new (the one passed in is not written).
    cache_index: the decode step's position, an int.
    cross_kv: precomputed (k, v) for cross-attention (enc-dec); no rope.
    """
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p.wq.to(dt)).reshape(b, s, h, hd)
    if cross_kv is not None:
        k, v = cross_kv
        out = blocked_attention(q, k, v, causal=False) if mode != "decode" \
            else decode_attention(q, k, v, cache_len=k.shape[1])
        return out.reshape(b, s, h * hd) @ p.wo.to(dt), cache

    k = (x @ p.wk.to(dt)).reshape(b, s, kvh, hd)
    v = (x @ p.wv.to(dt)).reshape(b, s, kvh, hd)
    if positions is None:
        base = 0 if cache_index is None else cache_index
        positions = base + torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        S = cache["k"].shape[1]
        if cfg.sliding_window and cfg.sliding_window < S:
            raise ValueError("SWA cache must be <= window")
        slot = (cache_index % S) if cfg.sliding_window else cache_index
        new_cache = {"k": _set_slot(cache["k"], slot, k[:, 0]),
                     "v": _set_slot(cache["v"], slot, v[:, 0])}
        if cfg.sliding_window:
            # ring buffer: the position each slot holds, tracked
            pos = _set_slot(cache["pos"], slot, positions[:, 0].to(
                cache["pos"].dtype)) if "pos" in cache else None
            out = decode_attention(q, new_cache["k"], new_cache["v"],
                                   cache_len=cache_index + 1,
                                   window=cfg.sliding_window, positions=pos)
            if pos is not None:
                new_cache["pos"] = pos
        else:
            out = decode_attention(q, new_cache["k"], new_cache["v"],
                                   cache_len=cache_index + 1)
    else:
        out = blocked_attention(q, k, v, causal=causal,
                                window=cfg.sliding_window)
        new_cache = None
        if mode == "prefill":
            new_cache = make_prefill_cache(cfg, k, v, positions)
    out = out.reshape(b, s, h * hd) @ p.wo.to(dt)
    return out, new_cache


def make_prefill_cache(cfg, k, v, positions):
    """Turn prefill K/V into a decode cache (ring-compressed for SWA: the
    last W entries at slots pos % W, empty slots at position -1)."""
    b, s, kvh, hd = k.shape
    ones = torch.ones((b, 1), dtype=torch.int32, device=k.device)
    if cfg.sliding_window and s > cfg.sliding_window:
        W = cfg.sliding_window
        kw, vw = k[:, -W:], v[:, -W:]
        pw = positions[:, -W:].to(torch.int32) * ones
        slots = (pw[0] % W).long()
        kr = torch.zeros_like(kw)
        kr[:, slots] = kw
        vr = torch.zeros_like(vw)
        vr[:, slots] = vw
        pr = torch.full((b, W), -1, dtype=torch.int32, device=k.device)
        pr[:, slots] = pw
        return {"k": kr, "v": vr, "pos": pr}
    cache = {"k": k, "v": v}
    if cfg.sliding_window:
        cache["pos"] = positions.to(torch.int32) * ones
    return cache


def extend_cache(cfg, cache: dict, max_len: int) -> dict:
    """A prefill cache with room for ``max_len`` positions in all: the
    contiguous cache (and an SWA cache shorter than its window) padded
    with zero slots, empty ring slots at position -1.  The reference's
    prefill cache holds the prompt alone, so each decode step after it
    drops its own K/V (``_set_slot``); a cache extended first keeps them."""
    S = cache["k"].shape[1]
    want = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    if want < S:
        if cfg.sliding_window:
            return cache  # a full ring already
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    n = want - S
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))
    out = {"k": pad(cache["k"]), "v": pad(cache["v"])}
    if "pos" in cache:
        out["pos"] = torch.nn.functional.pad(cache["pos"], (0, n), value=-1)
    return out


def empty_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    S = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, S, cfg.n_kv_heads, cfg.head_dim)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.sliding_window:
        c["pos"] = torch.full((batch, S), -1, dtype=torch.int32,
                              device=device)
    return c
