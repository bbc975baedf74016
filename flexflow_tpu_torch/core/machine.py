"""Device meshes over torch.distributed process groups (counterpart of
flexflow_tpu/core/machine.py `MachineView` and `make_mesh`).

In the JAX package a mesh is an array of devices with named axes and one
program runs over all of them. Here each mesh position is one process of
the default process group: ranks are laid out row-major over the axes in
the JAX order (data, then model; search/unity.py mesh_axes_for), so rank
= data_index * model_size + model_index, and each axis of size > 1 gets
a process group over the ranks that differ only along it.

Ported axes: `data` and `model`. `seq`, `expert`, `attr` and `stage`
raise, naming ROADMAP A8.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

# the JAX order of the mesh axes (search/unity.py mesh_axes_for)
AXIS_ORDER = ("data", "model")
UNPORTED_AXES = {
    "seq": "sequence parallelism (ring / Ulysses attention)",
    "expert": "expert parallelism",
    "attr": "attribute (spatial) parallelism",
    "stage": "pipeline parallelism",
}


@dataclasses.dataclass(frozen=True)
class MachineView:
    """A device sub-grid: ordered (axis name, size) pairs and a start
    offset (flexflow_tpu/core/machine.py:31)."""

    axes: Tuple[Tuple[str, int], ...] = ()
    start_device_id: int = 0

    @property
    def num_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    def __str__(self):
        body = "x".join(f"{n}:{s}" for n, s in self.axes) or "1"
        return f"MV[{body}@{self.start_device_id}]"


class Mesh:
    """This process's position in a mesh: its coordinates and the process
    group of each axis of size > 1 (None for an axis of size 1)."""

    def __init__(self, view: MachineView, rank: int,
                 groups: Dict[str, object], device: torch.device):
        self.view = view
        self.rank = rank
        self.shape = view.axis_sizes
        self.groups = groups
        self.device = device
        self.coords: Dict[str, int] = {}
        rest = rank
        for name, size in reversed(view.axes):
            self.coords[name] = rest % size
            rest //= size

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.view}, rank={self.rank}, coords={self.coords})"


def check_axes(axis_sizes: Dict[str, int]) -> Dict[str, int]:
    """The axes of size > 1 in the JAX order; raises for an axis the port
    cannot run yet (naming ROADMAP A8) or does not know."""
    axes = {str(k): int(v) for k, v in axis_sizes.items()}
    for name, size in axes.items():
        if size < 1:
            raise ValueError(f"parallel_axes={axis_sizes}: axis {name!r} has "
                             f"size {size}")
        if name in UNPORTED_AXES and size > 1:
            raise NotImplementedError(
                f"parallel_axes={axis_sizes}: the {name!r} axis "
                f"({UNPORTED_AXES[name]}) is not ported yet (ROADMAP A8); "
                f"the port runs the {' and '.join(AXIS_ORDER)} axes")
        if name not in AXIS_ORDER and name not in UNPORTED_AXES:
            raise ValueError(f"parallel_axes={axis_sizes}: unknown mesh "
                             f"axis {name!r}")
    return {a: axes[a] for a in AXIS_ORDER if axes.get(a, 1) > 1}


def make_mesh(axis_sizes: Dict[str, int]) -> Mesh:
    """This process's Mesh over the default process group, which must hold
    exactly one process per mesh position. Every rank calls it, in the
    same order as any other group creation."""
    import torch.distributed as dist

    from ..runtime import distributed

    axes = check_axes(axis_sizes)
    if not distributed.is_initialized():
        raise NotImplementedError(
            f"parallel_axes={axis_sizes}: a mesh runs one process per "
            "position over torch.distributed, which this process has not "
            "joined (flexflow_tpu_torch.runtime.distributed.initialize; "
            "ROADMAP A8)")
    view = MachineView(axes=tuple(axes.items()))
    world = dist.get_world_size()
    if view.num_devices != world:
        raise ValueError(f"parallel_axes={axis_sizes} needs "
                         f"{view.num_devices} processes, one per mesh "
                         f"position; the process group has {world}")
    rank = dist.get_rank()
    mesh = Mesh(view, rank, {}, distributed.device())
    names = [n for n, _ in view.axes]
    sizes = [s for _, s in view.axes]
    for i, name in enumerate(names):
        # the ranks that share every other coordinate, for each setting of
        # those coordinates in row-major order: created by every rank
        stride = 1
        for s in sizes[i + 1:]:
            stride *= s
        others = [r for r in range(world) if (r // stride) % sizes[i] == 0]
        for base in others:
            ranks = [base + j * stride for j in range(sizes[i])]
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[name] = group
    return mesh
