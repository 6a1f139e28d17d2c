"""Reed-Solomon RS(15, 12) over GF(16), in numpy: the encoder the traffic
uses and a syndrome decoder that corrects one symbol.

The code is the evaluation code of the detector: a 48-bit message is 12
four-bit symbols (most significant bit first), the coefficients-free
polynomial P of degree < 12 through (alpha^i, m_i) for i < 12, and the
codeword is P at alpha^0 .. alpha^14 (so systematic).  GF(16) is built on
x^4 + x + 1.  A received word with a nonzero syndrome is corrected where
the syndrome is a multiple of one column of the parity-check matrix (one
symbol error); otherwise it fails, keeps its received symbols and reports
-1 corrections.
"""
from __future__ import annotations

import functools

import numpy as np

M, N, K = 4, 15, 12


@functools.lru_cache(maxsize=None)
def _tables():
    exp = np.zeros(30, np.int64)
    log = np.zeros(16, np.int64)
    x = 1
    for i in range(15):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 16:
            x ^= 0b10011
    exp[15:] = exp[:15]
    return exp, log


def gmul(a, b):
    exp, log = _tables()
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return np.where((a == 0) | (b == 0), 0, exp[(log[a] + log[b]) % 15])


def ginv(a):
    exp, log = _tables()
    return exp[(15 - log[np.asarray(a, np.int64)]) % 15]


def gdot(a, b):
    """Matrix product over GF(16): (..., n) x (n, m) -> (..., m)."""
    out = np.zeros(a.shape[:-1] + (b.shape[1],), np.int64)
    for i in range(a.shape[-1]):
        out ^= gmul(a[..., i:i + 1], b[i][None] if a.ndim > 1 else b[i])
    return out


@functools.lru_cache(maxsize=None)
def matrices():
    """(G (12, 15) generator, H (3, 15) parity check): row j of G is the
    codeword of the j-th unit message (the Lagrange basis polynomial of
    point j evaluated everywhere); H is the dual code, columns
    v_i * alpha^(i r) with v_i = 1 / prod_{j != i}(x_i - x_j)."""
    exp, _ = _tables()
    xs = exp[:N]
    G = np.zeros((K, N), np.int64)
    for j in range(K):
        for i in range(N):
            num, den = 1, 1
            for m in range(K):
                if m != j:
                    num = int(gmul(num, xs[i] ^ xs[m]))
                    den = int(gmul(den, xs[j] ^ xs[m]))
            G[j, i] = gmul(num, ginv(den))
    H = np.zeros((N - K, N), np.int64)
    for i in range(N):
        den = 1
        for j in range(N):
            if j != i:
                den = int(gmul(den, xs[i] ^ xs[j]))
        v = int(ginv(den))
        for r in range(N - K):
            H[r, i] = gmul(v, exp[(i * r) % 15])
    return G, H


def to_symbols(bits: np.ndarray) -> np.ndarray:
    b = np.asarray(bits, np.int64)
    return b.reshape(*b.shape[:-1], -1, M) @ (1 << np.arange(M - 1, -1, -1))


def to_bits(symbols: np.ndarray) -> np.ndarray:
    s = np.asarray(symbols, np.int64)
    return ((s[..., None] >> np.arange(M - 1, -1, -1)) & 1).reshape(
        *s.shape[:-1], -1)


def encode(message_bits: np.ndarray) -> np.ndarray:
    """(..., 48) bits -> (..., 60) codeword bits."""
    G, _ = matrices()
    return to_bits(gdot(to_symbols(message_bits), G))


def decode(bits: np.ndarray):
    """(b, 60) bits -> (message_bits (b, 48) int32, ok (b,) bool,
    n_corrected (b,) int32)."""
    _, H = matrices()
    r = to_symbols(bits)
    s = gdot(r, H.T)                                   # (b, 3) syndromes
    zero = ~s.any(axis=1)
    # one error of value e at position i: s = e * H[:, i], so s / H[:, i]
    # is one value e != 0 in every component
    e = gmul(s[:, None, :], ginv(H.T[None]))           # (b, 15, 3)
    single = (e[..., 0] != 0) & (e == e[..., :1]).all(axis=2)
    fixable = ~zero & single.any(axis=1)
    pos = np.argmax(single, axis=1)
    fixed = r.copy()
    rows = np.nonzero(fixable)[0]
    fixed[rows, pos[rows]] ^= e[rows, pos[rows], 0]
    ok = zero | fixable
    ncorr = np.where(zero, 0, np.where(fixable, 1, -1))
    return (to_bits(fixed[:, :K]).astype(np.int32), ok,
            ncorr.astype(np.int32))
