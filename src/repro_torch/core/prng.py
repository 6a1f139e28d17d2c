"""Counter-based key stream: the slice of ``jax.random`` the detection
path uses, reproduced bit for bit in torch integer ops.

The JAX package draws its tile offsets from threefry2x32 keys
(``jax.random.key`` -> ``fold_in`` per batch and per image ->
``randint``), so the port has to produce the very same 32-bit words or
it picks other tiles and no end-to-end result can be compared.  This
module matches JAX's default configuration: the ``threefry2x32``
implementation with ``jax_threefry_partitionable=True`` and 64-bit mode
off, where

* ``key(seed)`` is the word pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(k, d)`` and key ``i`` of ``split(k, n)`` are both
  ``threefry2x32(k, (0, d))`` — the "fold-like" split;
* 32 random bits of shape ``s`` at flat index ``i`` are
  ``y0 ^ y1`` of ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
* ``randint`` splits its key into two, draws 32 bits from each and
  folds them into the span with uint32 arithmetic (JAX's
  ``random._randint``);
* ``permutation(k, n)`` sorts ``arange(n)`` by 32 random bits a round,
  ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each on the second key of a
  split (JAX's ``random._shuffle``).

A key is a ``(..., 2)`` int64 tensor holding two uint32 words (torch's
``uint32`` lacks the arithmetic ops, so every op masks to 32 bits).
Every function is batched over the leading dimensions of the key
tensor and runs on whatever device the keys live on; there is no
global generator state.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 words held in int64, without the
    int64 overflow a plain product of two 32-bit words can hit."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcast uint32 words: key (k0, k1), counter (x0, x1) -> (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device: Union[str, torch.device] = "cpu"
        ) -> torch.Tensor:
    """``jax.random.key(seed)`` as raw key data: a (2,) int64 tensor.
    With 64-bit mode off JAX takes the seed as int32, so the high word
    is 0 and the low word is the seed's two's-complement bits."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit int32 (JAX's seed "
                         f"type with 64-bit mode off)")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=device)


def _counter_hash(keys: torch.Tensor, count: torch.Tensor):
    """threefry2x32(keys, (count >> 32, count & MASK)) with the count
    axes appended after the key batch axes."""
    shape = (*keys.shape[:-1], *([1] * count.dim()))
    k0 = keys[..., 0].reshape(shape)
    k1 = keys[..., 1].reshape(shape)
    return threefry2x32(k0, k1, count >> 32, count & MASK32)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys (..., 2) and uint32 data broadcast
    against the key batch shape -> new keys (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=keys.device) & MASK32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable, fold-like): keys (..., 2)
    -> (..., num, 2)."""
    count = torch.arange(num, dtype=torch.int64, device=keys.device)
    y0, y1 = _counter_hash(keys, count)
    return torch.stack([y0, y1], dim=-1)


def _shape(shape: Shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """32 random bits per element (partitionable form, ``bits1 ^
    bits2``): keys (..., 2) -> uint32 words in int64 of shape
    (..., *shape)."""
    shape = _shape(shape)
    n = 1
    for d in shape:
        n *= d
    count = torch.arange(n, dtype=torch.int64,
                         device=keys.device).reshape(shape)
    y0, y1 = _counter_hash(keys, count)
    return y0 ^ y1


def randint(keys: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` at its default int32 dtype: keys (..., 2)
    -> int32 values in [minval, maxval) of shape (..., *shape).  The two
    32-bit draws and the span/multiplier arithmetic follow
    ``jax._src.random._randint`` word for word (uint32 wraparound)."""
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    minval = min(max(int(minval), lo32), hi32)
    maxval = min(max(int(maxval), lo32), hi32)
    k = split(keys, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = 1 if maxval <= minval else (maxval - minval) & MASK32
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (_mul32(higher % span, torch.full_like(higher, multiplier))
              + (lower % span)) & MASK32
    offset = offset % span
    value = (minval + offset + 2 ** 31) % 2 ** 32 - 2 ** 31
    return value.to(torch.int32)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for an integer ``n``: keys
    (..., 2) -> int32 permutations of ``arange(n)``, (..., n).  Each
    round splits the key, draws 32 bits an element from the second half
    and sorts (bits, values) by the bits.  XLA's sort is not declared
    stable, so the sort here is stable and only equal draws (two 32-bit
    words that collide) could order differently."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(2 ** 32 - 1)))
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(
        *keys.shape[:-1], n)
    for _ in range(rounds):
        k = split(keys, 2)
        keys, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x.to(torch.int32)
