"""Batch shaping (counterpart of part of ``repro.serving.batcher``):
:class:`AdmissionError` and :func:`pad_to_bucket`, which the offline
``DetectionService`` pads ragged work with.  The dynamic micro-batcher
itself (``BatcherConfig``, ``MicroBatcher``, SLO classes) comes with the
online server, ROADMAP queue 1 item 13.

Bit-identity: padding rows repeat the last image and are sliced off
after RS, and every image carries its own key, so a padded batch gives
its real rows the results of the unpadded one.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class AdmissionError(RuntimeError):
    """Request rejected at admission (invalid, or queue depth bound)."""


def pad_to_bucket(raw: np.ndarray, bucket: int = 0) -> Tuple[np.ndarray, int]:
    """Pad a ragged batch up to a shape bucket: the next power of two
    when ``bucket`` is 0, else the next multiple of ``bucket``.  Returns
    (padded batch, true size).  Empty batches are rejected — there is no
    row to repeat and no work to do."""
    b = raw.shape[0]
    if b == 0:
        raise AdmissionError(
            "pad_to_bucket: empty batch (b == 0) — reject empty "
            "requests at admission instead of padding nothing")
    if bucket > 0:
        target = -(-b // bucket) * bucket
    else:
        target = 1
        while target < b:
            target *= 2
    if target == b:
        return raw, b
    return np.concatenate(
        [raw, np.repeat(raw[-1:], target - b, axis=0)]), b
