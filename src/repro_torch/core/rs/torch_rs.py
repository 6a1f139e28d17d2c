"""Batched, branch-free Reed-Solomon decode and encode in torch tensor
ops, for any code (counterpart of ``repro.core.rs.jax_rs``).

The reference computes this outside any Pallas kernel, as plain JAX
ops; here it is plain torch ops on the bits' device, every row of the
batch in each step:

* GF(2^m) arithmetic: XOR and log/exp table gathers, the tables'
  indices normalised as JAX's gathers normalise them (a negative index
  counts from the end, then the index is clamped to the table), so
  symbols outside the field decode as in the reference;
* Berlekamp-Welch's elimination with masked pivoting over the fixed
  (n, 2t + k + 1) system: a Python loop over the columns, the pivot
  the first eligible row, the nullspace vector from the first free
  column;
* the message from the k first error-free positions (a stable sort)
  by Lagrange interpolation, evaluated at all n points.

Integer state is int64 holding int32 values, wrapped where the
reference's int32 arithmetic wraps (the symbol sums).  The default code
has its own kernel (``kernels.rs_decode``); this decoder serves every
other code on any device.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.rs import gf as gf_np
from repro_torch.core.rs.codec import RSCode


def _wrap32(a: torch.Tensor) -> torch.Tensor:
    return ((a + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with JAX's gather semantics: negative indices count
    from the end, then every index is clamped into the table."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


@functools.lru_cache(maxsize=None)
def _consts_np(code: RSCode):
    """exp, log tables, the evaluation points and their powers X_i^j for
    Q (t + 1 columns) and N (t + k columns)."""
    exp, log = gf_np.tables(code.m)
    xs = exp[: code.n].astype(np.int64)
    nq, nn = code.t + 1, code.t + code.k
    g = gf_np.GF(code.m)
    powsQ = np.ones((code.n, nq), np.int64)
    powsN = np.ones((code.n, nn), np.int64)
    for i in range(code.n):
        for j in range(1, nq):
            powsQ[i, j] = g.mul(powsQ[i, j - 1], int(xs[i]))
        for j in range(1, nn):
            powsN[i, j] = g.mul(powsN[i, j - 1], int(xs[i]))
    return exp.astype(np.int64), log.astype(np.int64), xs, powsQ, powsN


class _Field:
    """The code's tables on one device, and GF multiply / inverse."""

    def __init__(self, code: RSCode, device):
        exp, log, xs, powsQ, powsN = (torch.as_tensor(a, device=device)
                                      for a in _consts_np(code))
        self.exp, self.log, self.xs = exp, log, xs
        self.powsQ, self.powsN = powsQ, powsN
        self.q = 1 << code.m

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = self.exp[_take(self.log, a) + _take(self.log, b)]
        return torch.where((a == 0) | (b == 0), 0, out)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """inv(0) := 0 (callers mask it)."""
        q = self.q
        return torch.where(
            a == 0, 0, self.exp[(q - 1 - _take(self.log, a)) % (q - 1)])


@functools.lru_cache(maxsize=16)
def field(code: RSCode, device: torch.device) -> _Field:
    """The code's tables on ``device``, made once."""
    return _Field(code, device)


def bits_to_symbols(bits: torch.Tensor, m: int) -> torch.Tensor:
    """(..., s*m) integer or bool bits -> (..., s) symbols, MSB first,
    each bit cast to int32 and the weighted sum wrapped to int32 as the
    reference computes it (int64 values)."""
    b = bits.to(torch.int32).to(torch.int64)
    b = b.reshape(*b.shape[:-1], -1, m)
    w = 1 << torch.arange(m - 1, -1, -1, device=bits.device)
    return _wrap32((b * w).sum(-1))


def symbols_to_bits(sym: torch.Tensor, m: int) -> torch.Tensor:
    """(..., s) symbols -> (..., s*m) int32 bits, MSB first."""
    sh = torch.arange(m - 1, -1, -1, device=sym.device)
    return ((sym[..., None] >> sh) & 1).reshape(
        *sym.shape[:-1], -1).to(torch.int32)


def _prod(f: _Field, v: torch.Tensor) -> torch.Tensor:
    """GF product along the last axis, in index order from 1."""
    out = torch.ones(v.shape[:-1], dtype=torch.int64, device=v.device)
    for j in range(v.shape[-1]):
        out = f.mul(out, v[..., j])
    return out


def _nullspace_masked(f: _Field, A: torch.Tensor) -> torch.Tensor:
    """(B, rows, cols) systems -> (B, cols) nullspace vectors: RREF with
    masked pivoting (the pivot the first eligible row, a swap by select,
    every other row eliminated), then x = 1 at the first free column and
    x[pivot column of row r] = A[r, free]."""
    B, rows, cols = A.shape
    dev = A.device
    row_idx = torch.arange(rows, device=dev)
    pivot_col = torch.full((B, rows), cols, dtype=torch.int64, device=dev)
    r = torch.zeros(B, dtype=torch.int64, device=dev)
    for c in range(cols):
        eligible = (row_idx[None] >= r[:, None]) & (A[:, :, c] != 0)
        has = eligible.any(dim=1)
        pr = torch.argmax(eligible.to(torch.int32), dim=1)
        at_r = (row_idx[None] == r[:, None]) & has[:, None]
        at_p = (row_idx[None] == pr[:, None]) & has[:, None]
        bi = torch.arange(B, device=dev)
        Ar = A[bi, r.clamp(max=rows - 1)]
        Ap = A[bi, pr]
        A = torch.where(at_p[..., None], Ar[:, None, :], A)
        A = torch.where(at_r[..., None], Ap[:, None, :], A)
        piv = Ap[:, c]                      # A[r, c] after the swap
        Arow = f.mul(Ap, f.inv(piv)[:, None])
        A = torch.where(at_r[..., None], Arow[:, None, :], A)
        factors = torch.where(~at_r & has[:, None], A[:, :, c], 0)
        A = A ^ f.mul(factors[..., None], Arow[:, None, :])
        pivot_col = torch.where(at_r, c, pivot_col)
        r = torch.clamp(r + has.to(torch.int64), max=rows)
    col_ids = torch.arange(cols, device=dev)
    scatter = pivot_col[:, :, None] == col_ids[None, None, :]
    is_pivot = scatter.any(dim=1)
    free = torch.argmin(is_pivot.to(torch.int64), dim=1)   # first False
    x = (col_ids[None] == free[:, None]).to(torch.int64)
    vals = torch.gather(A, 2, free[:, None, None].expand(B, rows, 1))[..., 0]
    return torch.where(is_pivot, (scatter * vals[:, :, None]).sum(1), x)


def _lagrange_eval(f: _Field, xs_sel: torch.Tensor, ys_sel: torch.Tensor,
                   x_eval: torch.Tensor) -> torch.Tensor:
    """The interpolant through (xs_sel, ys_sel), both (B, k), at x_eval
    (p,): P(x) = XOR_i y_i inv(prod_{j != i} (X_i ^ X_j))
    prod_{j != i} (x ^ X_j)."""
    k = xs_sel.shape[1]
    eye = torch.eye(k, dtype=torch.bool, device=xs_sel.device)
    diff = torch.where(eye, 1, xs_sel[:, :, None] ^ xs_sel[:, None, :])
    wgt = f.mul(ys_sel, f.inv(_prod(f, diff)))                  # (B, k)
    xd = x_eval[None, :, None] ^ xs_sel[:, None, :]             # (B, p, k)
    # numerators prod_{j != i} (x ^ X_j), j in index order, without the
    # (B, p, k, k) tensor of factors
    num = torch.ones_like(xd)
    for j in range(k):
        num = f.mul(num, torch.where(eye[j], 1, xd[:, :, j:j + 1]))
    terms = f.mul(wgt[:, None, :], num)                         # (B, p, k)
    out = torch.zeros(terms.shape[:-1], dtype=torch.int64,
                      device=terms.device)
    for i in range(k):
        out = out ^ terms[..., i]
    return out


def make_decoder(code: RSCode) -> Callable[[torch.Tensor],
                                           Dict[str, torch.Tensor]]:
    """decode(bits (B, n*m) integer or bool) -> dict(message_bits
    (B, k*m) int32, codeword_bits (B, n*m) int32, n_corrected (B,)
    int32, -1 on failure, ok (B,) bool), on the bits' device; a failed
    word keeps the received symbols."""
    n, k, t, m = code.n, code.k, code.t, code.m
    nq = t + 1

    def decode(bits: torch.Tensor) -> Dict[str, torch.Tensor]:
        f = field(code, bits.device)
        R = bits_to_symbols(bits, m)                            # (B, n)
        B = R.shape[0]
        A = torch.cat([f.mul(R[:, :, None], f.powsQ[None]),
                       f.powsN[None].expand(B, -1, -1)], dim=2)
        Q = _nullspace_masked(f, A)[:, :nq]
        qx = torch.zeros_like(R)
        for j in range(nq - 1, -1, -1):
            qx = f.mul(qx, f.xs[None]) ^ Q[:, j:j + 1]
        q_any = (Q != 0).any(dim=1)
        err = (qx == 0) & q_any[:, None]
        sel = torch.argsort(err.to(torch.int32), dim=1, stable=True)[:, :k]
        P_at = _lagrange_eval(f, f.xs[sel], torch.gather(R, 1, sel), f.xs)
        n_err = (P_at != R).sum(dim=1)
        ok = (n_err <= t) & q_any
        cw = torch.where(ok[:, None], P_at, R)
        return {"message_bits": symbols_to_bits(cw[:, :k], m),
                "codeword_bits": symbols_to_bits(cw, m),
                "n_corrected": torch.where(ok, n_err, -1).to(torch.int32),
                "ok": ok}

    return decode


def make_batch_decoder(code: RSCode):
    """The batched decoder (``make_decoder`` already takes a batch; the
    reference vmaps its one-word decoder)."""
    return make_decoder(code)


def make_encoder(code: RSCode) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched systematic encoder: message bits (B, k*m) -> codeword bits
    (B, n*m) int32, the interpolant through the first k points."""
    k, m = code.k, code.m

    def encode(message_bits: torch.Tensor) -> torch.Tensor:
        f = field(code, message_bits.device)
        M = bits_to_symbols(message_bits, m)                    # (B, k)
        xs_k = f.xs[:k].expand(M.shape[0], k)
        cw = _lagrange_eval(f, xs_k, M, f.xs)
        cw[:, :k] = M
        return symbols_to_bits(cw, m)

    return encode
