"""Device meshes: named axes and their sizes, and the
``torch.distributed.DeviceMesh`` behind them.

A port of ``repro.launch.mesh``.  A ``Mesh`` names its axes and sizes:
the sharding rules (``launch.sharding``) and the sharding levers
(``PerfOpts.mesh``) read them.  ``Mesh.device_mesh`` builds the
``DeviceMesh`` with those axis names that a cell runs on as a DTensor
program (``launch.steps``):

  * a plan (``devices`` empty, as ``make_production_mesh`` gives)
    spans the first ``size`` ranks of a fake process group
    (``torch.testing._internal.distributed.fake_pg``, which issues no
    communication) with this process as rank 0; its local shards live
    on the ``meta`` device, so the reference's production meshes,
    16x16 = 256 ("data", "model") and 2 pods x 256 = 512 ("pod",
    "data", "model", the pod axis pure data parallelism), need no
    devices.  One fake group of ``PLAN_WORLD`` ranks holds both;
  * a host mesh (``make_host_mesh``) spans its real devices, one
    process each: NCCL on the cards (each rank on ``cuda:LOCAL_RANK``,
    so a world may span hosts of the same card count), gloo on the CPU
    (each rank one CPU device).  Under
    ``python -m torch.distributed.run`` its group starts from the
    environment (``env://``) at ``WORLD_SIZE`` ranks; a world of one
    starts over an in-process store; a live group of the mesh's size
    is used as it is.

A process has one default group, so ``plan_group`` starts the fake one
and destroys it on leaving, and refuses to start where another group
is live.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, Iterator, Optional, Tuple

import torch

from ..kernels.backend import resolve_device

#: ranks of the fake group that holds every production plan
PLAN_WORLD = 512


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

    @property
    def local_device(self) -> torch.device:
        """This process's device of a host mesh: ``devices[rank]``, the
        rank of the live group, else of the environment (0 outside
        ``torch.distributed.run``); on the cards that is
        ``cuda:LOCAL_RANK``."""
        if not self.devices:
            raise ValueError(f"the {self.name} plan has no devices")
        return torch.device(self.devices[_rank()])

    def device_mesh(self):
        """The ``torch.distributed.DeviceMesh`` of this mesh, with its
        axis names.  A plan needs the fake group (``plan_group``) and
        takes the "cuda" device type of the cluster it plans (a "cpu"
        mesh turns DTensor's all-to-alls into all-gathers; a "meta" one
        has no device handle for its sharding propagation); a host mesh
        starts its own group where none exists."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        ranks = torch.arange(self.size).reshape(self.axis_sizes)
        if not self.devices:
            if not dist.is_initialized() or \
                    dist.get_backend() != dist.Backend.FAKE:
                raise RuntimeError(
                    f"the {self.name} plan needs the fake process group: "
                    "build it inside launch.mesh.plan_group()")
            if dist.get_world_size() < self.size:
                raise RuntimeError(f"the fake group has "
                                   f"{dist.get_world_size()} ranks, the "
                                   f"{self.name} plan needs {self.size}")
            return DeviceMesh("cuda", ranks, mesh_dim_names=self.axis_names)
        kind = torch.device(self.devices[0]).type
        if kind == "cuda":
            torch.cuda.set_device(self.local_device)
        if not dist.is_initialized():
            backend = "nccl" if kind == "cuda" else "gloo"
            if self.size == 1:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            elif _world() != self.size:
                raise RuntimeError(
                    f"a {self.name} host mesh needs one process per "
                    f"device, {self.size} in all; this one runs in a world "
                    f"of {_world()}: launch it with python -m "
                    f"torch.distributed.run --nproc-per-node {self.size}")
            else:           # raises where the group cannot start
                dist.init_process_group(backend, init_method="env://")
        elif dist.get_world_size() != self.size:
            raise RuntimeError(f"the process group has "
                               f"{dist.get_world_size()} ranks, the "
                               f"{self.name} mesh {self.size}")
        return DeviceMesh(kind, ranks, mesh_dim_names=self.axis_names)


@contextlib.contextmanager
def plan_group(world: int = PLAN_WORLD) -> Iterator[None]:
    """A fake process group of ``world`` ranks, this process rank 0,
    for the plans' ``DeviceMesh``es; destroyed on leaving.  Inside an
    enclosing one it uses that group.  Raises where another group is
    live, or where this torch lacks the fake group."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() == dist.Backend.FAKE and \
                dist.get_world_size() >= world:
            yield                       # an enclosing plan_group's
            return
        raise RuntimeError(
            f"a {dist.get_backend()} process group is live: a plan's fake "
            "group needs a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"torch {torch.__version__} has no fake process group "
            "(torch.testing._internal.distributed.fake_pg): the SPMD dry "
            "run cannot build a plan") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, as a plan."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _world(key: str = "WORLD_SIZE") -> int:
    """The world size (or with ``key="LOCAL_WORLD_SIZE"``, this host's
    share of it) that ``torch.distributed.run`` gave this process (1
    outside it)."""
    return int(os.environ.get(key, os.environ.get("WORLD_SIZE", "1")))


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def make_host_mesh(model: int = 1, device: Optional[str] = None) -> Mesh:
    """(n // model, model) ("data", "model") over the CUDA devices present
    (default), or over CPU devices when ``device="cpu"``: one device per
    process.  Under ``torch.distributed.run`` n is ``WORLD_SIZE`` (each
    rank on ``cuda:LOCAL_RANK``, ranks numbered host by host as the
    launcher numbers them, or on the CPU), and ``model`` must divide it;
    otherwise the cards present (whole rows of the model axis), or one
    CPU."""
    dev = resolve_device(device)
    world, local = _world(), _world("LOCAL_WORLD_SIZE")
    if "WORLD_SIZE" in os.environ:
        if world % model:
            raise ValueError(f"a model axis of {model} does not divide "
                             f"the {world} ranks")
        if dev.type == "cuda" and local > torch.cuda.device_count():
            raise RuntimeError(f"{local} ranks on this host, "
                               f"{torch.cuda.device_count()} cards: a host "
                               "mesh needs a card per rank")
        devices = tuple(f"cuda:{r % local}" if dev.type == "cuda"
                        else str(dev) for r in range(world))
        return Mesh(("data", "model"), (world // model, model), devices)
    if dev.type == "cuda":
        devices = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    else:
        devices = (str(dev),)
    n = len(devices)
    model = min(model, n)
    n -= n % model                      # whole rows of the model axis
    return Mesh(("data", "model"), (n // model, model), devices[:n])
