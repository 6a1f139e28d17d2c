"""Galois field GF(2^m) arithmetic via log/exp tables.

Numpy implementation, copied from ``repro.core.rs.gf`` so the port
never imports the JAX package — the scalar reference for the
paper-faithful CPU decoder and for the port's RS kernel tests.
"""
from __future__ import annotations

import functools

import numpy as np

# primitive polynomials (with the x^m term) per field size
PRIM_POLY = {2: 0b111, 3: 0b1011, 4: 0b10011, 8: 0b100011101}


@functools.lru_cache(maxsize=None)
def tables(m: int):
    """Returns (exp, log): exp[i] = alpha^i (len 2^m-1, doubled for wrap),
    log[a] for a in 1..2^m-1 (log[0] = 0 sentinel, must be masked)."""
    poly = PRIM_POLY[m]
    q = 1 << m
    exp = np.zeros(2 * (q - 1), dtype=np.int32)
    log = np.zeros(q, dtype=np.int32)
    x = 1
    for i in range(q - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & q:
            x ^= poly
    exp[q - 1:] = exp[: q - 1]  # wraparound so exp[i+j] needs no modulo
    return exp, log


class GF:
    """GF(2^m) scalar/vector ops on numpy int arrays."""

    def __init__(self, m: int):
        self.m = m
        self.q = 1 << m
        self.exp, self.log = tables(m)

    def add(self, a, b):
        return np.bitwise_xor(a, b)

    sub = add  # characteristic 2

    def mul(self, a, b):
        a = np.asarray(a, np.int32)
        b = np.asarray(b, np.int32)
        out = self.exp[(self.log[a] + self.log[b])]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a, np.int32)
        if np.any(a == 0):
            raise ZeroDivisionError("GF inverse of 0")
        return self.exp[(self.q - 1 - self.log[a]) % (self.q - 1)]

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow(self, a, e):
        a = np.asarray(a, np.int32)
        e = int(e)
        if e == 0:
            return np.ones_like(a)
        out = self.exp[(self.log[a] * e) % (self.q - 1)]
        return np.where(a == 0, 0, out)

    # -- polynomials (coefficient lists, index = power) --------------------
    def poly_eval(self, coeffs, x):
        """Horner evaluation.  coeffs: (..., deg+1) lowest power first."""
        coeffs = np.asarray(coeffs, np.int32)
        x = np.asarray(x, np.int32)
        acc = np.zeros(np.broadcast(coeffs[..., 0], x).shape, np.int32)
        for i in range(coeffs.shape[-1] - 1, -1, -1):
            acc = self.add(self.mul(acc, x), coeffs[..., i])
        return acc

    def poly_mul(self, a, b):
        out = np.zeros(len(a) + len(b) - 1, np.int32)
        for i, ai in enumerate(a):
            out[i:i + len(b)] ^= self.mul(ai, np.asarray(b, np.int32))
        return out

    def poly_divmod(self, num, den):
        """Polynomial long division: returns (quotient, remainder)."""
        num = list(np.asarray(num, np.int32))
        den = np.asarray(den, np.int32)
        dd = len(den) - 1
        while dd > 0 and den[dd] == 0:
            dd -= 1
        if dd == 0 and den[0] == 0:
            raise ZeroDivisionError("poly division by zero")
        inv_lead = self.inv(den[dd])
        q = [0] * max(len(num) - dd, 1)
        for i in range(len(num) - 1 - dd, -1, -1):
            c = self.mul(num[i + dd], inv_lead)
            q[i] = int(c)
            if c:
                for j in range(dd + 1):
                    num[i + j] ^= int(self.mul(c, den[j]))
        return np.array(q, np.int32), np.array(num[:dd] if dd else [0],
                                               np.int32)


# -- bit <-> symbol packing (MSB-first within each m-bit symbol) ------------


def bits_to_symbols(bits, m):
    bits = np.asarray(bits).astype(np.int32).reshape(-1, m)
    weights = 1 << np.arange(m - 1, -1, -1)
    return bits @ weights


def symbols_to_bits(symbols, m):
    symbols = np.asarray(symbols, np.int32)
    shifts = np.arange(m - 1, -1, -1)
    return ((symbols[..., None] >> shifts) & 1).reshape(
        *symbols.shape[:-1], -1)
