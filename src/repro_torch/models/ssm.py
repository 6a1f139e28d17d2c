"""Mamba-2 (SSD — state-space duality) block (counterpart of
``repro.models.ssm``), in the chunked matmul form: intra-chunk work as
dense einsums, the chunk boundary states as a short recurrence over
seq / chunk steps.  Everything inside the scan is float32, as in the
reference.

Shapes: x (b, l, d); internally d_inner = expand*d, heads nh = d_inner/hp,
state n = d_state, groups g (B/C shared per group, heads split g*hg = nh).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, rmsnorm, zeros_param

NEG_INF = -1e30


class SSM(nn.Module):
    """The Mamba-2 block's weights (``init_ssm``): A uniform in [1, 16],
    dt log-uniform in [1e-3, 1e-1] and ``dt_bias`` its inverse softplus."""

    def __init__(self, gen: torch.Generator, cfg, dtype=torch.float32):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        di = s.expand * d
        nh = di // s.head_dim
        conv_dim = di + 2 * s.n_groups * s.d_state
        self.in_proj = dense_init(
            gen, (d, 2 * di + 2 * s.n_groups * s.d_state + nh), dtype=dtype)
        self.conv_w = dense_init(gen, (s.conv_width, conv_dim), scale=0.1,
                                 dtype=dtype)
        draw = (lambda: torch.rand(nh, generator=gen)) if gen is not None \
            else (lambda: torch.empty(nh))
        A = 1.0 + 15.0 * draw()
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * draw())
        dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
        self.A_log = nn.Parameter(torch.log(A).to(dtype))
        self.D = nn.Parameter(torch.ones(nh, dtype=dtype))
        self.dt_bias = nn.Parameter(dt_bias.to(dtype))
        self.norm = zeros_param(di, dtype=dtype)
        self.out_proj = dense_init(gen, (di, d), dtype=dtype)


def _segsum(x):
    """x: (..., T) -> (..., T, T); out[i, j] = sum_{j < k <= i} x[k]."""
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    T = x.shape[-1]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, NEG_INF)


def _split(p, x, cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    nh = di // s.head_dim
    zxbcdt = x @ p.in_proj.to(x.dtype)
    z, xBC, dt = torch.tensor_split(zxbcdt, [di, 2 * di + 2 * gn], dim=-1)
    return z, xBC, dt, di, gn, nh


def ssd_chunked(x, dt, A, B, C, chunk, initial_state=None):
    """Chunked SSD scan, all float32.

    x: (b, l, g, hg, p) [dt-weighting not applied yet]; dt: (b, l, g, hg);
    A: (h,) negative reals; B, C: (b, l, g, n).
    Returns y (b, l, g, hg, p) and the final state (b, g, hg, p, n).
    """
    b, l, g, hg, p = x.shape
    n = B.shape[-1]
    cl = min(chunk, l)
    nc = l // cl
    if l % cl:
        raise ValueError(f"seq {l} not divisible by chunk {cl}")

    xc = x.reshape(b, nc, cl, g, hg, p)
    dtc = dt.reshape(b, nc, cl, g, hg)
    Bc = B.reshape(b, nc, cl, g, n)
    Cc = C.reshape(b, nc, cl, g, n)
    dA = dtc * A.reshape(g, hg)  # (b,nc,cl,g,hg)
    dA_cs = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]

    # 1) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(torch.movedim(dA, 2, -1)))  # (b,nc,g,hg,cl,cl)
    scores = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    att = scores[:, :, :, None] * L
    y = torch.einsum("bcghls,bcsghp->bclghp", att, xdt)

    # 2) each chunk's contribution to its boundary state
    decay_states = torch.exp(dA_cs[:, :, -1:] - dA_cs)  # (b,nc,cl,g,hg)
    states = torch.einsum("bcsgn,bcsgh,bcsghp->bcghpn", Bc, decay_states,
                          xdt)

    # 3) inter-chunk recurrence over the boundary states
    chunk_decay = torch.exp(dA_cs[:, :, -1])  # (b,nc,g,hg)
    S = torch.zeros((b, g, hg, p, n), dtype=torch.float32, device=x.device) \
        if initial_state is None else initial_state.float()
    prev = []
    for c in range(nc):
        prev.append(S)  # the state carried into chunk c
        S = S * chunk_decay[:, c][..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,nc,g,hg,p,n)

    # 4) the carried-in state's contribution to each position
    out_decay = torch.exp(dA_cs)
    y_off = torch.einsum("bclgn,bcghpn,bclgh->bclghp", Cc, prev_states,
                         out_decay)
    return (y + y_off).reshape(b, l, g, hg, p), S


def _causal_conv(xBC, w):
    """Depthwise causal conv, width cw.  xBC: (b, l, c); w: (cw, c)."""
    cw = w.shape[0]
    out = torch.zeros_like(xBC)
    for i in range(cw):
        shift = cw - 1 - i
        xs = F.pad(xBC, (0, 0, shift, 0))[:, :xBC.shape[1]]
        out = out + xs * w[i].to(xBC.dtype)
    return out


def ssm_forward(p: SSM, x, cfg, *, mode, cache=None):
    """Mamba-2 block.  x: (b, l, d) -> (b, l, d).  Returns (y, new_cache).

    cache (decode): {"conv": (b, cw-1, conv_dim), "state": (b,g,hg,p,n)};
    prefill returns it in bf16, as the reference does.
    """
    s = cfg.ssm
    b, l, d = x.shape
    dt_ = x.dtype
    z, xBC, dt, di, gn, nh = _split(p, x, cfg)
    g, hp = s.n_groups, s.head_dim
    hg = nh // g
    n = s.d_state
    A = -torch.exp(p.A_log.float())
    dt = F.softplus(dt.float() + p.dt_bias.float())
    D = p.D.float().reshape(g, hg)[..., None]

    if mode == "decode":
        window = torch.cat([cache["conv"].to(dt_), xBC], dim=1)
        conv_out = torch.einsum("bwc,wc->bc", window.float(),
                                p.conv_w.float())
        xBC_t = F.silu(conv_out).to(dt_)  # (b, conv_dim)
        xs, B, C = torch.tensor_split(xBC_t, [di, di + gn], dim=-1)
        xh = xs.reshape(b, g, hg, hp).float()
        B = B.reshape(b, g, n).float()
        C = C.reshape(b, g, n).float()
        dt1 = dt[:, 0].reshape(b, g, hg)
        dA = torch.exp(dt1 * A.reshape(g, hg))  # (b,g,hg)
        S = cache["state"].float()
        S = S * dA[..., None, None] + torch.einsum(
            "bghp,bgn,bgh->bghpn", xh, B, dt1)
        y = torch.einsum("bghpn,bgn->bghp", S, C) + xh * D
        y = y.reshape(b, 1, di).to(dt_)
        new_cache = {"conv": window[:, 1:].to(cache["conv"].dtype),
                     "state": S.to(cache["state"].dtype)}
    else:
        conv_in = xBC
        xBC = F.silu(_causal_conv(xBC, p.conv_w))
        # pad seq to a chunk multiple; padded steps get dt = 0 (no decay,
        # no contribution), so the final state is exact
        cl = min(s.chunk, l)
        lp = -(-l // cl) * cl
        if lp != l:
            xBC = F.pad(xBC, (0, 0, 0, lp - l))
            dt = F.pad(dt, (0, 0, 0, lp - l))
            dt = dt * (torch.arange(lp, device=x.device) < l)[None, :, None]
        xs, B, C = torch.tensor_split(xBC, [di, di + gn], dim=-1)
        xh = xs.reshape(b, lp, g, hg, hp).float()
        B = B.reshape(b, lp, g, n).float()
        C = C.reshape(b, lp, g, n).float()
        dth = dt.reshape(b, lp, g, hg)
        y, final = ssd_chunked(xh, dth, A, B, C, s.chunk)
        y = y[:, :l] + xh[:, :l] * D
        y = y.reshape(b, l, di).to(dt_)
        new_cache = None
        if mode == "prefill":
            # the last cw-1 pre-conv activations seed the decode conv
            new_cache = {"conv": conv_in[:, -(s.conv_width - 1):].to(
                torch.bfloat16), "state": final.to(torch.bfloat16)}

    y = y * F.silu(z)
    y = rmsnorm(y, p.norm, cfg.norm_eps)
    return y @ p.out_proj.to(dt_), new_cache


def empty_ssm_cache(cfg, batch, dtype=torch.bfloat16, device=None):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    g = s.n_groups
    conv_dim = di + 2 * g * s.d_state
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, g, nh // g, s.head_dim, s.d_state),
                             dtype=dtype, device=device),
    }
