"""Inter-Batch Workload Interleaving (counterpart of
``repro.core.interleave``; QRMark §6.1, RAP-style).

Each input batch B_k splits into a host *preparation region* P_k (decode
/ layout / device placement) and a device *kernel region* K_k.  While
the device runs K_k, a background thread prepares P_{k+1}.

``PrefetchIterator`` is the single-stage special case of the N-lane
stage-graph executor in :mod:`repro_torch.core.lanes`: one "prepare"
stage, one lane, a depth-deep bounded queue.  Its device placement (the
reference's ``jax.device_put``) is two steps on a card: the batch is
copied into pinned host memory, then copied to the device without
blocking on the prefetch lane's own stream, with an event that the
consumer's stream waits on before it reads the batch.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.lanes import (LaneExecutor, LaneStreams, Stage,
                                    receive, upload)


def to_device(tree, device: torch.device):
    """Arrays and tensors of a tree of dicts, tuples and lists on
    ``device`` (other leaves as they are), each through
    :func:`lanes.upload`."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(t, device) for t in tree)
    if not isinstance(tree, (np.ndarray, torch.Tensor)):
        return tree
    return upload(tree, device)


class PrefetchIterator:
    """Wrap an iterator of host batches; prepare + place on the device
    ahead.  ``device`` defaults to the card (``"cuda"``, which must
    exist); a CPU run passes ``device="cpu"``."""

    def __init__(self, it: Iterable, prepare: Optional[Callable] = None,
                 depth: int = 2, device_put: bool = True, device=None):
        from repro_torch.core.detect import resolve_device
        prep = prepare or (lambda x: x)
        self._dev = dev = resolve_device(device) if device_put else None

        def fn(item):
            out = prep(item)
            if dev is not None:
                out = to_device(out, dev)
            return {"item": out}

        if dev is not None:
            fn = LaneStreams(dev).wrap(fn)
        self._ex = LaneExecutor(
            [Stage("prefetch", fn, lanes=1, depth=depth)], name="prefetch")
        self._gen = self._ex.run(it)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        p = next(self._gen)
        if self._dev is not None and self._dev.type == "cuda":
            # the consumer reads the batch on its own current stream
            receive(p, torch.cuda.current_stream(self._dev))
        return p["item"]

    def close(self):
        self._ex.close()


def interleaved(it, prepare=None, depth: int = 2, enabled: bool = True,
                device=None):
    """Convenience: returns a prefetching iterator (or passthrough)."""
    if not enabled:
        return iter((prepare or (lambda x: x))(b) for b in it)
    return PrefetchIterator(it, prepare=prepare, depth=depth, device=device)
