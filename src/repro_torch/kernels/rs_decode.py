"""Batched Reed-Solomon t = 1 decode, RS(15,12) over GF(16)
(counterpart of ``repro.kernels.rs_decode.rs_decode_batch``).

* :func:`rs_decode_plain` — the reference kernel's branch-free batched
  algorithm, op for op, in PyTorch integer tensors: carry-less GF(16)
  multiply, masked-pivot RREF unrolled over the 15 columns, nullspace
  vector from the first free column, error locations from Q's zeros,
  the first K error-free positions by rank prefix-sum, Lagrange
  re-interpolation;
* :func:`rs_decode_cuda` — the hand-written CUDA kernel
  (``csrc/rs_decode.cu``), a closed-form t = 1 syndrome decoder, one
  warp a codeword, for words in {0, 1} (the argument that it equals the
  Berlekamp-Welch reference there is in the source's note;
  ``tests/test_torch_rs.py`` holds a numpy model of its arithmetic to
  JAX's Pallas kernel and to the plain version); a word with any other
  entry is decoded in the same launch by the reference's algorithm,
  step for step in its int32 arithmetic.

Both map integer (or bool) bits (B, 60), cast to int32 first as the
reference casts them, to dict(message_bits (B, 48) int32,
codeword_bits (B, 60) int32, ok (B,) bool, n_corrected (B,) int32);
on failure the codeword is the received word and n_corrected is -1.
The outputs are integers and equal the reference's exactly on every
input, tie-breaks, degenerate words and entries outside {0, 1}
included.  Both are specialised to the default code; ``ops.rs_decode``
sends every other code to ``core.rs.torch_rs``, as the reference sends
it to ``jax_rs``.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch.core.rs import gf as gf_np
from repro_torch.core.rs.codec import RSCode
from repro_torch.kernels import _build

M, N, K = 4, 15, 12
T = (N - K) // 2  # = 1
NQ = T + 1        # deg(Q) <= t      -> 2 coefficients
NN = T + K        # deg(Nu) <= t+k-1 -> 13 coefficients
COLS = NQ + NN    # 15 unknowns: [q_0, q_1, nu_0 .. nu_12]


def is_kernel_code(code: RSCode) -> bool:
    """True for the code the kernel and its plain version are
    specialised for, RS(15,12) over GF(16); any other code decodes
    through the batched ``torch_rs``."""
    return (code.m, code.n, code.k) == (M, N, K)


def _wrap32(a: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range, as the reference's int32
    arithmetic wraps them."""
    return ((a + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _gf16_mul(a: torch.Tensor, b) -> torch.Tensor:
    """Carry-less GF(16) multiply, elementwise, argument order as in the
    reference (bits of ``b`` select shifted copies of ``a``), wrapped to
    int32: out-of-range symbols shift bits past bit 31, which the
    reference's int32 shifts drop."""
    res = torch.zeros_like(a)
    for i in range(M):
        res = res ^ torch.where(((b >> i) & 1) != 0, a << i, 0)
    for j in (6, 5, 4):
        res = torch.where(((res >> j) & 1) != 0,
                          res ^ (0b10011 << (j - 4)), res)
    return _wrap32(res)


def _gf16_inv(a: torch.Tensor) -> torch.Tensor:
    """a^-1 = a^14 (GF(16)* has order 15); inv(0) = 0."""
    a2 = _gf16_mul(a, a)
    a4 = _gf16_mul(a2, a2)
    a8 = _gf16_mul(a4, a4)
    return _gf16_mul(a8, _gf16_mul(a4, a2))


@functools.lru_cache(maxsize=None)
def _consts():
    """Evaluation points alpha^0..alpha^14 and their powers."""
    exp, _ = gf_np.tables(M)
    xs = exp[:N].astype(np.int32)
    powsQ = np.ones((N, NQ), np.int64)
    powsN = np.ones((N, NN), np.int64)
    g = gf_np.GF(M)
    for i in range(N):
        for j in range(1, NQ):
            powsQ[i, j] = g.mul(powsQ[i, j - 1], int(xs[i]))
        for j in range(1, NN):
            powsN[i, j] = g.mul(powsN[i, j - 1], int(xs[i]))
    return xs, powsQ.astype(np.int32), powsN.astype(np.int32)


def rs_decode_plain(bits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Any integer (or bool) bits are cast to int32 first, as the
    reference's ``astype(jnp.int32)``.  Integer state is int64 (torch's
    sums and cumsums of int32 promote to it), wrapped to the int32 range
    wherever the reference's int32 arithmetic wraps (symbol sums and
    carry-less products), so every integer input decodes as in the
    reference; the outputs are cast to int32 at the end."""
    dev = bits.device
    bits = bits.to(torch.int32).to(torch.int64)
    B = bits.shape[0]
    xs_np, powsQ_np, powsN_np = _consts()
    xs, powsQ, powsN = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                        for a in (xs_np, powsQ_np, powsN_np))

    w = 1 << (M - 1 - torch.arange(M, device=dev))
    R = _wrap32((bits.reshape(B, N, M) * w).sum(-1))  # (B, N)
    A = torch.cat([_gf16_mul(R[:, :, None], powsQ[None]),
                   powsN[None].expand(B, N, NN)], dim=2)

    row_idx = torch.arange(N, device=dev)
    pivot_col = torch.full((B, N), COLS, dtype=torch.int64, device=dev)
    r = torch.zeros(B, dtype=torch.int64, device=dev)
    for c in range(COLS):
        colv = A[:, :, c]
        eligible = (row_idx[None] >= r[:, None]) & (colv != 0)
        has = eligible.any(dim=1)
        pr = torch.argmax(eligible.to(torch.int32), dim=1)  # first row
        onehot_r = row_idx[None] == r[:, None]
        onehot_p = row_idx[None] == pr[:, None]
        Ar = (A * onehot_r[..., None]).sum(1)
        Ap = (A * onehot_p[..., None]).sum(1)
        swp = has[:, None, None]
        A = torch.where(swp & onehot_r[..., None], Ap[:, None, :], A)
        A = torch.where(swp & onehot_p[..., None] & ~onehot_r[..., None],
                        Ar[:, None, :], A)
        piv = (A[:, :, c] * onehot_r).sum(1)
        inv = _gf16_inv(piv)
        Arow = (A * onehot_r[..., None]).sum(1)
        Arow_n = _gf16_mul(Arow, inv[:, None])
        A = torch.where(swp & onehot_r[..., None], Arow_n[:, None, :], A)
        factors = torch.where((~onehot_r) & has[:, None], A[:, :, c], 0)
        Apiv = (A * onehot_r[..., None]).sum(1)
        A = A ^ _gf16_mul(factors[..., None], Apiv[:, None, :])
        pivot_col = torch.where(onehot_r & has[:, None], c, pivot_col)
        r = torch.clamp(r + has.to(torch.int64), max=N)

    col_ids = torch.arange(COLS, device=dev)
    scatter = pivot_col[:, :, None] == col_ids[None, None, :]  # (B,N,COLS)
    is_pivot = scatter.any(dim=1)
    free = torch.argmin(is_pivot.to(torch.int64), dim=1)  # first free
    x = (col_ids[None] == free[:, None]).to(torch.int64)
    vals = torch.gather(A, 2, free[:, None, None].expand(B, N, 1))[:, :, 0]
    x = x ^ (scatter * vals[:, :, None]).sum(1)

    Q = x[:, :NQ]
    qx = torch.zeros((B, N), dtype=torch.int64, device=dev)
    for j in range(NQ - 1, -1, -1):
        qx = _gf16_mul(qx, xs[None]) ^ Q[:, j:j + 1]
    q_nonzero = (Q != 0).any(dim=1)
    err = (qx == 0) & q_nonzero[:, None]

    okpos = (~err).to(torch.int64)
    rank = torch.cumsum(okpos, dim=1) - okpos
    sel = (okpos * (rank < K)) == 1
    slot = torch.where(sel, rank, K)
    perm = (slot[:, :, None] == torch.arange(K, device=dev)[None, None, :]
            ).to(torch.int64)  # (B, N, K)
    xs_sel = (perm * xs[None, :, None]).sum(1)  # (B, K)
    ys_sel = (perm * R[:, :, None]).sum(1)

    kk = torch.arange(K, device=dev)
    denom = torch.ones((B, K), dtype=torch.int64, device=dev)
    for j in range(K):
        d = xs_sel ^ xs_sel[:, j:j + 1]
        d = torch.where(kk[None] == j, 1, d)
        denom = _gf16_mul(denom, d)
    wgt = _gf16_mul(ys_sel, _gf16_inv(denom))
    P_at = torch.zeros((B, N), dtype=torch.int64, device=dev)
    for i in range(K):
        numer = torch.ones((B, N), dtype=torch.int64, device=dev)
        for j in range(K):
            if j != i:
                numer = _gf16_mul(numer, xs[None] ^ xs_sel[:, j:j + 1])
        P_at = P_at ^ _gf16_mul(numer, wgt[:, i:i + 1])

    n_err = (P_at != R).sum(dim=1)
    ok = (n_err <= T) & q_nonzero
    cw = torch.where(ok[:, None], P_at, R)
    sh = M - 1 - torch.arange(M, device=dev)
    cw_bits = ((cw[:, :, None] >> sh) & 1).reshape(B, N * M).to(
        torch.int32)
    return {"message_bits": cw_bits[:, :K * M].contiguous(),
            "codeword_bits": cw_bits,
            "ok": ok,
            "n_corrected": torch.where(ok, n_err, -1).to(torch.int32)}


def rs_decode_cuda(bits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The CUDA kernel: same contract as the plain version on every
    integer input.  Integer or bool bits of another dtype are cast to
    int32 first (one torch cast, as the reference's ``astype``); int32
    bits must be a contiguous, 8-byte aligned (B, 60) CUDA tensor, and
    then the kernel is the only launch."""
    if bits.device.type != "cuda" or bits.dim() != 2 or \
            bits.shape[1] != N * M or bits.dtype.is_floating_point or \
            bits.dtype.is_complex:
        raise ValueError(f"rs_decode_cuda needs integer or bool (B, {N * M}) "
                         f"CUDA bits, got {bits.dtype} {tuple(bits.shape)} "
                         f"on {bits.device}")
    if bits.dtype != torch.int32:
        bits = bits.to(torch.int32)
    if not bits.is_contiguous() or bits.data_ptr() % 8:
        raise ValueError("rs_decode_cuda needs contiguous, 8-byte aligned "
                         "int32 bits")
    B = bits.shape[0]
    msg = torch.empty((B, K * M), dtype=torch.int32, device=bits.device)
    cw = torch.empty((B, N * M), dtype=torch.int32, device=bits.device)
    ok = torch.empty((B,), dtype=torch.bool, device=bits.device)
    ncorr = torch.empty((B,), dtype=torch.int32, device=bits.device)
    if B:
        err = _build.library().qr_rs_decode(
            bits.data_ptr(), msg.data_ptr(), cw.data_ptr(), ok.data_ptr(),
            ncorr.data_ptr(), B, _build.current_stream(bits.device))
        _build.check("qr_rs_decode", err)
        _build.count("rs_decode")
    return {"message_bits": msg, "codeword_bits": cw, "ok": ok,
            "n_corrected": ncorr}
