"""Device meshes: named axes and their sizes.

A port of ``repro.launch.mesh``.  The port has no SPMD partitioner, so a
mesh here is a description, not a ``torch.distributed.DeviceMesh`` (which
needs a process group and buys nothing on one card): the sharding rules
(``launch.sharding``) and the sharding levers (``PerfOpts.mesh``) read
its axis names and sizes, and the dry run (``launch.dryrun``) divides a
cell's bytes and operations over it.  ``make_production_mesh`` gives the
reference's production meshes as such plans: 16x16 = 256 chips
("data", "model"), or 2 pods x 256 = 512 ("pod", "data", "model"), the
pod axis pure data parallelism.  ``make_host_mesh`` spans the devices
this host has.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``devices`` lists the devices it spans, and
    is empty for a plan with no devices behind it."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, as a plan."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, device: Optional[str] = None) -> Mesh:
    """(n // model, model) ("data", "model") over the CUDA devices present
    (default), or over one CPU device when ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    else:
        devices = (str(dev),)
    n = len(devices)
    model = min(model, n)
    n -= n % model                      # whole rows of the model axis
    return Mesh(("data", "model"), (n // model, model), devices[:n])
