"""Mesh descriptions (the port of ``repro/launch/mesh.py``).

The reference builds ``jax.sharding.Mesh`` objects over real devices.  The
port runs on one card, so a mesh here is a plain description: its axis
names and sizes, and the devices that back it where there are any.  The
sharding rules (``distributed/shardings.py``) and the activation policy
(``distributed/context.py``) read only the names and sizes, so the
production meshes can be described, and their specs checked, without the
cards they name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


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
    """A degenerate mesh over ``devices`` (the visible CUDA cards by
    default, else the CPU): all of them on the first axis, 1 on every
    other."""
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
