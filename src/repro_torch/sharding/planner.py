"""The detection batch's data-parallel split (counterpart of
``repro.sharding.planner.shard_detection_batch``).

The reference places a padded batch on a 1-D ``data`` mesh with a
``NamedSharding`` and lets ``jit`` propagate it through the per-image
stages.  PyTorch has no such propagation: the batch is cut into one
contiguous chunk a device, each uploaded to its device, and
``DetectionPipeline.run_batch`` runs each chunk on its own device.  The
rest of the reference planner (model, optimizer and decode-cache
sharding of the LM seed code) belongs to ROADMAP queue 1 item 16.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

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
