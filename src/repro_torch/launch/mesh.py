"""Meshes and the process group (the port of ``repro/launch/mesh.py``).

The reference builds ``jax.sharding.Mesh`` objects over the devices of
every process.  Here a mesh is a description first: its axis names and
sizes, and the devices that back it where there are any.  The sharding
rules (``distributed/shardings.py``) and the activation policy
(``distributed/context.py``) read only the names and sizes, so the
production meshes can be described, and their specs checked, without the
cards they name.  ``Mesh.device_mesh()`` makes the description a
``DeviceMesh`` over the process group, one rank a device: the reference's
one program over all devices becomes one process a card under
``torchrun``, set up by ``init_distributed`` (the reference's
``jax.distributed.initialize``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# what torchrun sets for every process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class DistInfo:
    """This process's place in the process group: its rank among
    ``world``, its card's index on its node (``local_rank``), the node's
    index and the node count (the reference's ``jax.process_index()`` and
    ``jax.process_count()``: hosts, not devices), and its device."""
    rank: int
    world: int
    local_rank: int
    local_world: int
    node: int
    n_nodes: int
    device: torch.device
    backend: str


def init_distributed(backend: Optional[str] = None,
                     device_type: str = "cuda") -> DistInfo:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``GROUP_RANK`` or ``NODE_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    ``nccl`` over the cards, one a process (``cuda:LOCAL_RANK``), or
    ``gloo`` over the CPU for ``device_type="cpu"``.  Raises naming the
    variables that are missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            "the process group needs torchrun's environment; missing "
            + ", ".join(missing))
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local, local_world = int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    node = int(env.get("GROUP_RANK", env.get("NODE_RANK", "0")))
    backend = backend or ("gloo" if device_type == "cpu" else "nccl")
    if backend == "nccl":
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device(device_type)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, rank=rank, world_size=world,
            device_id=device if backend == "nccl" else None)
    return DistInfo(rank, world, local, local_world, node,
                    world // local_world, device, backend)


@dataclass(frozen=True)
class Mesh:
    """Axis names with their sizes, in order, and the devices behind them
    (empty for a description of a mesh this process cannot reach)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def device_mesh(self):
        """The ``DeviceMesh`` of this mesh's names and sizes over the
        process group, one rank a device (raises unless the group's world
        is the mesh's size).  Made once a process group and reused, so
        that every DTensor of one layout shares one ``DeviceMesh``."""
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.size:
            raise ValueError(f"a mesh of {self.size} devices "
                             f"{self.shape} over a world of {world} ranks")
        kind = self.devices[0].type if self.devices else "cuda"
        key = (self.axis_names, self.axis_sizes, kind)
        group = dist.distributed_c10d._get_default_group()
        made = _DEVICE_MESHES.get(key)
        if made is None or made[0] is not group:
            made = _DEVICE_MESHES[key] = (group, init_device_mesh(
                kind, self.axis_sizes, mesh_dim_names=self.axis_names))
        return made[1]


_DEVICE_MESHES: Dict[Tuple, Tuple] = {}   # (names, sizes, kind) -> (group,
                                          # DeviceMesh)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, described: 16 x 16 ('data',
    'model') per pod, (2, 16, 16) ('pod', 'data', 'model') across two."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_pipeline_mesh(n_stages: int, *, total: Optional[int] = None
                       ) -> Mesh:
    """The pipeline lowering's ('data', 'stage') mesh, described: the
    chips beyond one belt of ``n_stages`` become data-parallel replicas."""
    total = total or 256
    if total % n_stages:
        raise ValueError(f"{n_stages} stages do not divide {total} chips")
    return Mesh(("data", "stage"), (total // n_stages, n_stages))


def make_host_mesh(axes: Tuple[str, ...] = ("data", "model"),
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> Mesh:
    """A degenerate mesh over ``devices``: all of them on the first axis,
    1 on every other.  By default, under a process group, one device a
    rank over the world (``(world, 1)``, as the reference's ``(n, 1)``
    over all its devices; this rank's device stands for each), else the
    visible CUDA cards, else the CPU."""
    if devices is None and dist.is_initialized():
        mine = (torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == "nccl" else torch.device("cpu"))
        devices = [mine] * dist.get_world_size()
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    sizes = [1] * len(axes)
    sizes[0] = len(devices)
    return Mesh(tuple(axes), tuple(sizes), tuple(devices))


def pipeline_stages_for(n_layers: int, max_stages: int = 16) -> int:
    """Largest s <= max_stages with s | n_layers and s | 256."""
    for s in range(max_stages, 0, -1):
        if n_layers % s == 0 and 256 % s == 0:
            return s
    return 1


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-sharding axes of a mesh (everything except
    'model'/'stage')."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
