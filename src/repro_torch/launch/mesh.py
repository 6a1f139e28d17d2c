"""Device sets (counterpart of ``repro.launch.mesh``'s
``make_detection_mesh`` and ``make_local_mesh``).

The reference builds JAX meshes; the port's data-parallel ``run_batch``
takes the devices themselves, in order, and the LM's local mesh is the
devices with the reference's ``(data, model)`` sizes, which the training
plan's accounting reads.  ``make_production_mesh`` (the 256- and
512-chip meshes of the dry-run) belongs to ROADMAP queue 1 item 16b.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

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


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Devices as a (data, model) grid, data-major."""
    devices: Sequence[torch.device]
    data: int
    model: int


def make_local_mesh(model: int = 1, devices=None) -> LocalMesh:
    """``devices`` (default every visible CUDA device, raising if there
    is none) as a (len // model, model) mesh, as the reference lays this
    host's devices out."""
    devs = make_detection_mesh(devices)
    if len(devs) % model:
        raise ValueError(f"{len(devs)} devices do not split into a model "
                         f"axis of {model}")
    return LocalMesh(devices=devs, data=len(devs) // model, model=model)
