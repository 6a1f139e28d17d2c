"""Per-image keys and tile offsets, in numpy uint32 arithmetic.

The detector draws each image's tile from a counter-based key stream:
Threefry-2x32 (20 rounds), with ``key(seed) = (0, seed)``, ``fold_in(k, d)``
and key ``d`` of a split both ``threefry(k, (0, d))``, 32 random bits at
flat index ``i`` the XOR of ``threefry(k, (0, i))``'s two words, and
``randint`` / ``permutation`` as JAX's default (partitionable) stream
defines them.  Batch ``seq`` of a pipeline seeded ``s`` uses
``fold_in(key(s), seq)``, image ``i`` of it ``fold_in(batch_key, i)``.

The ``random_grid`` strategy picks one of the (img / tile)^2 grid cells
of the centre crop; an escalation plan of ``k`` tiles keeps that cell
first and takes the others from a permutation of the cells drawn from
``fold_in(image_key, 0x5AFE)``, with the first cell moved to its end.
"""
from __future__ import annotations

import math

import numpy as np

U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = U32(0x1BD11BDA)
ESCALATION_SALT = 0x5AFE


def _rotl(x, d: int):
    return (x << U32(d)) | (x >> U32(32 - d))


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, elementwise over broadcast uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, dtype=U32) for a in (k0, k1, x0, x1))
    k0, k1, x0, x1 = np.broadcast_arrays(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """The root key of a pipeline seed (a 32-bit signed integer)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit signed integer")
    return np.array([0, seed & 0xFFFFFFFF], dtype=U32)


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """keys (..., 2), data broadcast against (...) -> keys (..., 2)."""
    data = np.asarray(data, dtype=np.int64) & 0xFFFFFFFF
    y0, y1 = threefry(keys[..., 0], keys[..., 1], 0, data.astype(U32))
    return np.stack([y0, y1], axis=-1)


def _bits(keys: np.ndarray, n: int) -> np.ndarray:
    """(..., 2) keys -> (..., n) words: bits at flat index 0..n-1."""
    count = np.arange(n, dtype=U32)
    y0, y1 = threefry(keys[..., 0:1], keys[..., 1:2], 0, count)
    return y0 ^ y1


def randint_scalar(keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """One int in [lo, hi) a key: the two halves of a split each give 32
    bits, folded into the span with uint32 wraparound."""
    span = hi - lo
    higher = _bits(fold_in(keys, 0), 1)[..., 0].astype(np.uint64)
    lower = _bits(fold_in(keys, 1), 1)[..., 0].astype(np.uint64)
    mult = ((2 ** 16 % span) ** 2) % span
    off = ((higher % span) * mult + lower % span) % 2 ** 32 % span
    return (lo + off).astype(np.int64)


def permutation(keys: np.ndarray, n: int) -> np.ndarray:
    """keys (b, 2) -> (b, n) permutations of arange(n): each round sorts
    by 32 random bits drawn from the second key of a split (stable)."""
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))
    x = np.broadcast_to(np.arange(n), keys.shape[:-1] + (n,)).copy()
    for _ in range(rounds):
        keys, sub = fold_in(keys, 0), fold_in(keys, 1)
        order = np.argsort(_bits(sub, n), axis=-1, kind="stable")
        x = np.take_along_axis(x, order, axis=-1)
    return x


def image_keys(seed: int, seq: int, b: int) -> np.ndarray:
    """(b, 2) keys of the images of batch ``seq``."""
    batch = fold_in(key(seed), seq)
    return fold_in(np.broadcast_to(batch, (b, 2)), np.arange(b))


def grid_plan(keys: np.ndarray, img: int, tile: int, k: int) -> np.ndarray:
    """(b, k, 2) (y, x) offsets in the centre crop: column 0 the image's
    one-tile pick, then k - 1 more distinct cells."""
    g = img // tile
    c0 = randint_scalar(keys, 0, g * g)
    cells = [c0[:, None]]
    if k > 1:
        perm = permutation(fold_in(keys, ESCALATION_SALT), g * g)
        order = np.argsort(perm == c0[:, None], axis=1, kind="stable")
        cells.append(np.take_along_axis(perm, order, axis=1)[:, :k - 1])
    c = np.concatenate(cells, axis=1)
    return np.stack([c // g, c % g], axis=-1) * tile
