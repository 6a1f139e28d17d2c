"""The detection batch's data-parallel split (counterpart of
``repro.sharding.planner.shard_detection_batch``) and the LM training
plan's accounting (counterpart of ``make_plan``).

The reference places a padded batch on a 1-D ``data`` mesh with a
``NamedSharding`` and lets ``jit`` propagate it through the per-image
stages.  PyTorch has no such propagation: the batch is cut into one
contiguous chunk a device, each uploaded to its device, and
``DetectionPipeline.run_batch`` runs each chunk on its own device.

``make_plan`` keeps the reference's arithmetic — the gradient-
accumulation microbatches that fit the activation budget, and whether
the float32 master weights need FSDP — over a data size and a model size
instead of a JAX mesh.  The reference's partition-spec functions
(``param_specs``, ``opt_specs``, ``batch_specs``, ``decode_state_specs``,
``to_shardings``) feed its 512-device dry-run; they belong to ROADMAP
queue 1 item 16b.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lanes import upload


def shard_detection_batch(devices: Sequence[torch.device], batch
                          ) -> List[Tuple[torch.device, torch.Tensor, slice]]:
    """A (padded) batch whose size the device count divides -> one
    (device, chunk on that device, its rows in the batch) a device, in
    order: contiguous chunks of equal size."""
    batch = np.asarray(batch)
    n = len(devices)
    if n == 0 or batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split "
                         f"evenly over {n} devices")
    per = batch.shape[0] // n
    out = []
    for i, dev in enumerate(devices):
        rows = slice(i * per, (i + 1) * per)
        out.append((dev, upload(batch[rows], torch.device(dev)), rows))
    return out


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The LM's plan over ``data_size`` x ``model_size`` devices."""
    data_size: int
    model_size: int
    fsdp: bool            # the weights would shard on the data axes too
    n_micro: int          # gradient-accumulation microbatches (train)

    @property
    def n_chips(self) -> int:
        return self.data_size * self.model_size


def make_plan(cfg, shape, data_size: int = 1, model_size: int = 1, *,
              act_budget_bytes: float = 1.0e9,
              param_budget_bytes: float = 2.0e9,
              n_micro: Optional[int] = None,
              fsdp: Optional[bool] = None) -> MeshPlan:
    """``fsdp`` when the float32 weights over the model axis exceed
    ``param_budget_bytes``; ``n_micro`` doubled (while it divides the
    global batch) until the bf16 residual stream of every layer, spread
    over the chips, fits ``act_budget_bytes``."""
    n_chips = data_size * model_size
    total_params = cfg.param_counts()["total"]
    if fsdp is None:
        fsdp = (total_params * 4 / model_size) > param_budget_bytes
    if n_micro is None:
        n_micro = 1
        if shape.mode == "train":
            carry_bytes = cfg.n_layers * shape.tokens * cfg.d_model * 2
            while (carry_bytes / n_micro / n_chips > act_budget_bytes
                   and n_micro < shape.global_batch
                   and shape.global_batch % (n_micro * 2) == 0):
                n_micro *= 2
    return MeshPlan(data_size=data_size, model_size=model_size, fsdp=fsdp,
                    n_micro=n_micro)
