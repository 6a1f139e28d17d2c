"""Escalation plans drawn on the card (no counterpart among the JAX
package's Pallas kernels: it draws its plans with ``jax.random`` under
XLA).

* the plain version is :func:`repro_torch.core.tiling.escalation_offsets`
  itself: Threefry-2x32 in int64 torch ops on the keys' device;
* :func:`escalation_plan_cuda` — the hand-written CUDA kernel
  (``csrc/tile_plan.cu``), one launch a plan, bit for bit the plain
  version's plan.  It exists because the plain version costs ~2,100
  small CPU ops a plan, which the detection lanes' threads run beside
  one another's; the kernel is bound by its launch.

Both take per-image keys (n, 2) int64 (uint32 words, ``core.prng``) and
return (n, k, 2) int32 offsets.  :func:`check` holds the arguments to
what both take, before either runs.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng, tiling
from repro_torch.kernels import _build

# the kernel's strategy codes (csrc/tile_plan.cu: kFixed, kRandom, kGrid)
STRATEGY_CODES = {"fixed": 0, "random": 1, "random_grid": 2}
# a ``random_grid`` row's bits and two position arrays, 4 bytes a cell
# each, stay in shared memory up to the opt-in 227 KB of a block less
# the kernel's static words; larger grids take a device scratch buffer
# of at most SCRATCH_ROWS rows
SMEM_LIMIT = 232448 - 16
SCRATCH_ROWS = 264
_INT32_MAX = 2 ** 31 - 1


def check(strategy: str, keys: torch.Tensor, image_hw, tile: int, k: int):
    """Raise ValueError unless ``keys`` is (n, 2) int64, the strategy is
    known, ``k`` is within its cap (:func:`tiling.check_escalation_k`,
    the plain version's own error) and the geometry is one the plain
    version draws: a grid strategy needs a tile no wider than the image
    (the plain version divides by the grid's columns), and every size
    fits the kernel's 32-bit arguments."""
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be (n, 2) int64, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if strategy not in STRATEGY_CODES:
        raise ValueError(f"unknown tiling strategy {strategy!r}")
    H, W = (int(d) for d in image_hw)
    if not 1 <= int(tile) <= _INT32_MAX or not (
            0 <= H <= _INT32_MAX and 0 <= W <= _INT32_MAX):
        raise ValueError(f"tile {tile} on {H}x{W} is outside the kernel's "
                         f"range")
    tiling.check_escalation_k(strategy, (H, W), tile, k)
    if strategy != "random" and W // tile == 0:
        raise ValueError(f"strategy {strategy!r} needs tile {tile} <= "
                         f"width {W}")
    if (H // tile) * (W // tile) > _INT32_MAX or \
            keys.shape[0] > _INT32_MAX:
        raise ValueError("plan too large for the kernel's 32-bit sizes")


def escalation_plan_cuda(strategy: str, keys: torch.Tensor, image_hw,
                         tile: int, k: int) -> torch.Tensor:
    """The CUDA kernel: same contract as the plain version.  The keys
    must be a contiguous CUDA tensor; the plan is allocated on their
    device and drawn on its current stream."""
    check(strategy, keys, image_hw, tile, k)
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"escalation_plan_cuda needs CUDA keys, got {dev}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    H, W, tile, k = (int(d) for d in (*image_hw, tile, k))
    n = keys.shape[0]
    plan = torch.empty((n, k, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return plan
    cells = (H // tile) * (W // tile)
    scratch, scratch_rows = None, 0
    if strategy == "random_grid" and k > 1 and 12 * cells > SMEM_LIMIT:
        scratch_rows = min(n, SCRATCH_ROWS)
        scratch = torch.empty(scratch_rows * 3 * cells, dtype=torch.int32,
                              device=dev)
    _build.check("qr_escalation_plan", _build.library().qr_escalation_plan(
        keys.data_ptr(), plan.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, k,
        STRATEGY_CODES[strategy], H, W, tile,
        prng.permutation_rounds(cells), scratch_rows,
        _build.current_stream(dev)))
    _build.count("escalation_plan")
    return plan
