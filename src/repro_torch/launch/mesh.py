"""Meshes and device sets (counterpart of ``repro.launch.mesh``).

The reference builds JAX meshes; the port's data-parallel ``run_batch``
takes the devices themselves, in order, and the LM's local mesh is the
devices with the reference's ``(data, model)`` sizes, which the training
plan's accounting reads.  ``make_production_mesh`` gives the dry-run's
256- and 512-device meshes as shapes only (:class:`ShapeMesh`): the
dry-run traces on the ``meta`` device and needs no device behind them.

The roofline constants are one NVIDIA H100 SXM5 80 GB's, from its data
sheet at 700 W.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

# Roofline constants (NVIDIA H100 SXM5 80 GB data sheet, 700 W)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense BF16 tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
# bytes/s, one NDR InfiniBand link of 400 Gb/s a GPU (one ConnectX-7
# adapter a GPU).  NVLink joins the 8 GPUs of a node; every axis of a
# 16-wide mesh spans two or more nodes, so a ring over it crosses the
# network and the network link, not NVLink, bounds the collective.
ICI_LINK_BW = 50e9


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh as its axes and their sizes only (no devices)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """16x16 (256 devices) or 2x16x16 (512 devices), the reference's
    production meshes, as shapes."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


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
