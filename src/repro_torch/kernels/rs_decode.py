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
  warp a codeword.  On bits in {0, 1} it equals the Berlekamp-Welch
  reference on all four outputs (the argument is in the source's note;
  ``tests/test_torch_rs.py`` holds a numpy model of its arithmetic to
  JAX's Pallas kernel and to the plain version).

Both map bits (B, 60) -> dict(message_bits (B, 48) int32,
codeword_bits (B, 60) int32, ok (B,) bool, n_corrected (B,) int32);
on failure the codeword is the received word and n_corrected is -1.
The outputs are integers and equal the reference's exactly (the plain
version on any int input, tie-breaks and degenerate inputs included;
the kernel on {0, 1} bits).  Only the default code is ported; other
codes go to the batched ``jax_rs`` counterpart (ROADMAP queue 1
item 8).
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


def check_code(code: RSCode):
    if (code.m, code.n, code.k) != (M, N, K):
        raise NotImplementedError(
            f"RS code (m={code.m}, n={code.n}, k={code.k}): only the "
            f"default (4, 15, 12) code is ported; other codes need the "
            f"batched jax_rs counterpart (ROADMAP queue 1 item 8)")


def _gf16_mul(a: torch.Tensor, b) -> torch.Tensor:
    """Carry-less GF(16) multiply, elementwise, argument order as in the
    reference (bits of ``b`` select shifted copies of ``a``)."""
    res = torch.zeros_like(a)
    for i in range(M):
        res = res ^ torch.where(((b >> i) & 1) != 0, a << i, 0)
    for j in (6, 5, 4):
        res = torch.where(((res >> j) & 1) != 0,
                          res ^ (0b10011 << (j - 4)), res)
    return res


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
    """Integer state is int64 throughout (torch's sums and cumsums of
    int32 promote to it); the outputs are cast to int32 at the end."""
    dev = bits.device
    bits = bits.to(torch.int64)
    B = bits.shape[0]
    xs_np, powsQ_np, powsN_np = _consts()
    xs, powsQ, powsN = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                        for a in (xs_np, powsQ_np, powsN_np))

    w = 1 << (M - 1 - torch.arange(M, device=dev))
    R = (bits.reshape(B, N, M) * w).sum(-1)  # (B, N)
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
    """The CUDA kernel: same contract as the plain version on bits in
    {0, 1}, as the ``bits`` stage makes them (on other values the
    plain version's carry-less arithmetic is not modelled); ``bits``
    must be a contiguous, 8-byte aligned int32 (B, 60) CUDA tensor.
    Launches the kernel and nothing else."""
    if bits.device.type != "cuda" or bits.dtype != torch.int32 or \
            bits.dim() != 2 or bits.shape[1] != N * M or \
            not bits.is_contiguous() or bits.data_ptr() % 8:
        raise ValueError(f"rs_decode_cuda needs contiguous, 8-byte aligned "
                         f"int32 (B, {N * M}) CUDA bits, got {bits.dtype} "
                         f"{tuple(bits.shape)} on {bits.device}")
    B = bits.shape[0]
    msg = torch.empty((B, K * M), dtype=torch.int32, device=bits.device)
    cw = torch.empty((B, N * M), dtype=torch.int32, device=bits.device)
    ok = torch.empty((B,), dtype=torch.bool, device=bits.device)
    ncorr = torch.empty((B,), dtype=torch.int32, device=bits.device)
    if B:
        err = _build.library().qr_rs_decode(
            bits.data_ptr(), msg.data_ptr(), cw.data_ptr(), ok.data_ptr(),
            ncorr.data_ptr(), B,
            torch.cuda.current_stream(bits.device).cuda_stream)
        _build.check("qr_rs_decode", err)
        _build.launch_counts["rs_decode"] += 1
    return {"message_bits": msg, "codeword_bits": cw, "ok": ok,
            "n_corrected": ncorr}
