"""Systematic evaluation-based Reed-Solomon codec (paper Appendix A).

Encoding: Lagrange-interpolate P(x) (deg < k) through (X_i, M_i) for the
first k evaluation points, then evaluate at all n points — systematic:
C_i = M_i for i < k.  Decoding: Berlekamp-Welch via Gaussian elimination
over GF(2^m) (O(n^3), "smaller in practice"), returning the corrected
message bits, full codeword bits, and the number of symbols corrected.

Copied from ``repro.core.rs.codec`` (numpy only) so the port never
imports the JAX package: the scalar numpy REFERENCE, and the exact
oracle the port's batched RS kernel (``kernels/rs_decode.py``) is
tested against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.rs.gf import (GF, bits_to_symbols, symbols_to_bits,
                                   tables)


@dataclasses.dataclass(frozen=True)
class RSCode:
    m: int          # bits per symbol
    n: int          # codeword symbols (<= 2^m - 1)
    k: int          # message symbols

    def __post_init__(self):
        assert self.n <= (1 << self.m) - 1, "RS length bound n_max = 2^m-1"
        assert 0 < self.k <= self.n

    @property
    def t(self) -> int:
        return (self.n - self.k) // 2

    @property
    def message_bits(self) -> int:
        return self.k * self.m

    @property
    def codeword_bits(self) -> int:
        return self.n * self.m

    @property
    def eval_points(self) -> np.ndarray:
        # alpha^0 .. alpha^{n-1}: pairwise distinct, never 0
        exp, _ = tables(self.m)
        return exp[: self.n].copy()


# default code from the paper: GF(16), n=15, k=12 -> 48-bit payload, t=1
DEFAULT_CODE = RSCode(m=4, n=15, k=12)


def _lagrange_coeffs(gf: GF, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Coefficients of the unique P (deg < len(xs)) with P(xs)=ys. O(k^2)."""
    kk = len(xs)
    poly = np.zeros(kk, np.int32)
    for i in range(kk):
        if ys[i] == 0:
            continue
        # basis ell_i(x) = prod_{j != i} (x - X_j) / (X_i - X_j)
        basis = np.array([1], np.int32)
        denom = 1
        for j in range(kk):
            if j == i:
                continue
            basis = gf.poly_mul(basis, [xs[j], 1])  # (x + X_j) in char 2
            denom = int(gf.mul(denom, gf.add(xs[i], xs[j])))
        scale = gf.mul(ys[i], gf.inv(denom))
        contrib = gf.mul(np.int32(scale), basis)
        poly[: len(contrib)] ^= contrib
    return poly


def rs_encode(code: RSCode, message_bits) -> np.ndarray:
    """message_bits (k*m,) -> codeword bits (n*m,).  Systematic."""
    gf = GF(code.m)
    msg = bits_to_symbols(message_bits, code.m)
    assert len(msg) == code.k
    xs = code.eval_points
    poly = _lagrange_coeffs(gf, xs[: code.k], msg)
    cw = gf.poly_eval(poly, xs)
    cw[: code.k] = msg  # exact systematic property
    return symbols_to_bits(cw, code.m)


@dataclasses.dataclass
class DecodeResult:
    message_bits: np.ndarray      # corrected k*m bits
    codeword_bits: np.ndarray     # corrected n*m bits
    n_corrected: int              # symbol errors fixed (-1 if failed)
    ok: bool


def rs_decode(code: RSCode, received_bits) -> DecodeResult:
    """Berlekamp-Welch decode of an n*m bit string."""
    gf = GF(code.m)
    R = bits_to_symbols(received_bits, code.m)
    n, k, t = code.n, code.k, code.t
    xs = code.eval_points

    # Fast path: received word may already be a codeword
    poly = _lagrange_coeffs(gf, xs[:k], R[:k])
    if np.array_equal(gf.poly_eval(poly, xs), R):
        return DecodeResult(symbols_to_bits(R[:k], code.m),
                            np.asarray(received_bits), 0, True)

    # B-W: N(X_i) = R_i Q(X_i); unknowns [q_0..q_t, n_0..n_{t+k-1}]
    nq, nn = t + 1, t + k
    A = np.zeros((n, nq + nn), np.int32)
    for i in range(n):
        xp = 1
        for j in range(nq):
            A[i, j] = gf.mul(R[i], xp)
            xp = int(gf.mul(xp, xs[i]))
        xp = 1
        for j in range(nn):
            A[i, nq + j] = xp  # char 2: -X^j == X^j
            xp = int(gf.mul(xp, xs[i]))

    sol = _gf_nullspace(gf, A)
    if sol is None:
        return DecodeResult(symbols_to_bits(R[:k], code.m),
                            np.asarray(received_bits), -1, False)
    Q, N = sol[:nq], sol[nq:]
    if not Q.any():
        return DecodeResult(symbols_to_bits(R[:k], code.m),
                            np.asarray(received_bits), -1, False)
    P, rem = gf.poly_divmod(N, Q)
    if rem.any():
        return DecodeResult(symbols_to_bits(R[:k], code.m),
                            np.asarray(received_bits), -1, False)
    P = P[:k] if len(P) >= k else np.pad(P, (0, k - len(P)))
    cw = gf.poly_eval(P, xs)
    n_err = int(np.sum(cw != R))
    ok = n_err <= t
    msg = gf.poly_eval(P, xs[:k])
    return DecodeResult(symbols_to_bits(msg, code.m),
                        symbols_to_bits(cw, code.m),
                        n_err if ok else -1, ok)


def _gf_nullspace(gf: GF, A: np.ndarray) -> Optional[np.ndarray]:
    """A non-trivial nullspace vector of A (rows x cols, cols = rows+1)."""
    A = A.copy()
    rows, cols = A.shape
    pivot_col_of_row = [-1] * rows
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivots = np.nonzero(A[r:, c])[0]
        if len(pivots) == 0:
            continue
        pr = r + pivots[0]
        A[[r, pr]] = A[[pr, r]]
        A[r] = gf.mul(A[r], gf.inv(A[r, c]))
        for rr in range(rows):
            if rr != r and A[rr, c]:
                A[rr] = gf.add(A[rr], gf.mul(A[rr, c], A[r]))
        pivot_col_of_row[r] = c
        r += 1
    pivot_cols = set(pivot_col_of_row[:r])
    free = [c for c in range(cols) if c not in pivot_cols]
    if not free:
        return None
    f = free[0]
    x = np.zeros(cols, np.int32)
    x[f] = 1
    for rr in range(r):
        x[pivot_col_of_row[rr]] = A[rr, f]  # char 2: -a == a
    return x
