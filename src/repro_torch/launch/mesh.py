"""The detection pipeline's device set (counterpart of
``repro.launch.mesh.make_detection_mesh``).

The reference builds a 1-D ``data`` mesh of JAX devices; the port's
data-parallel ``run_batch`` takes the devices themselves, in order.  The
LM seed code's production meshes belong to ROADMAP queue 1 item 16.
"""
from __future__ import annotations

from typing import List

import torch


def make_detection_mesh(devices=None) -> List[torch.device]:
    """The devices ``run_batch`` splits a batch over: ``devices`` as
    ``torch.device`` s, or by default every visible CUDA device (raising
    if there is none: a CPU run names its devices)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("make_detection_mesh: no devices given")
        return devs
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass the devices (e.g. "
            "['cpu']) to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]
