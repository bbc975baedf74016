"""Device meshes over torch.distributed process groups (counterpart of
flexflow_tpu/core/machine.py `MachineView` and `make_mesh`).

In the JAX package a mesh is an array of devices with named axes and one
program runs over all of them. Here each mesh position is one process of
torch.distributed. A mesh is laid over a list of global ranks (the JAX
package's `device_ids`; by default every rank of the world): positions
row-major over the axes in the JAX order (data, model, expert, attr,
seq: search/unity.py mesh_axes_for; then stage, which the JAX package's
pipeline meshes put after data), so on a data x model mesh position =
data_index * model_size + model_index, and the rank at a position is
`ranks[position]`. Each axis of size > 1 gets a process group over the
ranks that differ only along it (`Mesh.groups`, and the group's ranks in
coordinate order in `Mesh.group_ranks`), and the mesh a group of its
own over all its ranks (`Mesh.group_all`, the default group when the
mesh is the world), which mesh-wide work uses (a checkpoint's barrier,
the reshard's maxima); its leader is the rank at position 0.

A mesh may be smaller than its rank list, as a searched plan's often is
(the JAX package builds its mesh over a prefix of the devices): it spans
the first prod(axes) ranks, and a rank past it holds no position
(`Mesh.holds_position`; its model trains nothing, FFModel.compile).

What runs over each axis: `data` cuts the batch, `model` shards the
weights of the tensor-parallel ops, `expert` the stacked expert weights,
`attr` cuts the H dim of NCHW activations, `seq` the position dim of
sequence activations, and `stage` splits the graph's repeated block into
pipeline stages (runtime/executor.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# the JAX order of the mesh axes (search/unity.py mesh_axes_for), then
# the pipeline's stage axis
AXIS_ORDER = ("data", "model", "expert", "attr", "seq", "stage")


@dataclasses.dataclass(frozen=True)
class MachineResource:
    """Total resources available (flexflow_tpu/core/machine.py:18)."""

    num_nodes: int = 1
    devices_per_node: int = 1
    start_device_id: int = 0

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.devices_per_node


@dataclasses.dataclass(frozen=True)
class MachineView:
    """A device sub-grid: ordered (axis name, size) pairs and a start
    offset (flexflow_tpu/core/machine.py:31). `hash` and `device_ids`
    are JAX's (the reference's MachineView::hash and start + row-major
    addressing of a contiguous grid); `hash` folds Python's string hash
    of each axis name, so it is stable within a process only, as JAX's."""

    axes: Tuple[Tuple[str, int], ...] = ()
    start_device_id: int = 0

    @property
    def ndims(self) -> int:
        return len(self.axes)

    @property
    def num_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    def device_ids(self) -> List[int]:
        return list(range(self.start_device_id,
                          self.start_device_id + self.num_devices))

    def hash(self) -> int:
        h = 17
        h = h * 31 + self.start_device_id
        for name, size in self.axes:
            h = h * 31 + hash(name) % (2**31)
            h = h * 31 + size
        return h & 0x7FFFFFFFFFFFFFFF

    def with_axis(self, name: str, size: int) -> "MachineView":
        return MachineView(self.axes + ((name, size),), self.start_device_id)

    def __str__(self):
        body = "x".join(f"{n}:{s}" for n, s in self.axes) or "1"
        return f"MV[{body}@{self.start_device_id}]"


class Mesh:
    """This process's position in a mesh laid over `ranks` (global,
    ascending; default 0 .. n - 1): its coordinates and the process group
    of each axis of size > 1 (None for an axis of size 1)."""

    def __init__(self, view: MachineView, rank: int,
                 groups: Dict[str, object], device: torch.device,
                 ranks: Optional[Sequence[int]] = None):
        self.view = view
        self.rank = rank
        self.ranks = (list(ranks) if ranks is not None
                      else list(range(view.num_devices)))
        self.shape = view.axis_sizes
        self.groups = groups
        # axis -> the global ranks of this position's group, in the order
        # of the axis coordinate
        self.group_ranks: Dict[str, list] = {}
        # the group over every rank of the mesh (None: the default group)
        self.group_all = None
        self.device = device
        self.coords: Dict[str, int] = {}
        rest = self.position if self.holds_position else rank
        for name, size in reversed(view.axes):
            self.coords[name] = rest % size
            rest //= size

    @property
    def mesh_ranks(self) -> list:
        """The global ranks of the mesh's positions, in position order."""
        return self.ranks[:self.view.num_devices]

    @property
    def holds_position(self) -> bool:
        """Whether this rank is one of the mesh's (ranks past a mesh
        smaller than its rank list are not)."""
        return self.rank in self.mesh_ranks

    @property
    def position(self) -> int:
        """This rank's position in the mesh (row-major over the axes)."""
        return self.mesh_ranks.index(self.rank)

    @property
    def leader(self) -> int:
        """The global rank at position 0: it writes the checkpoints."""
        return self.ranks[0]

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.view}, rank={self.rank}, coords={self.coords})"


def check_axes(axis_sizes: Dict[str, int]) -> Dict[str, int]:
    """The axes of size > 1 in the JAX order; raises for an axis it does
    not know."""
    axes = {str(k): int(v) for k, v in axis_sizes.items()}
    for name, size in axes.items():
        if size < 1:
            raise ValueError(f"parallel_axes={axis_sizes}: axis {name!r} has "
                             f"size {size}")
        if name not in AXIS_ORDER:
            raise ValueError(f"parallel_axes={axis_sizes}: unknown mesh "
                             f"axis {name!r}")
    return {a: axes[a] for a in AXIS_ORDER if axes.get(a, 1) > 1}


def make_mesh(axis_sizes: Dict[str, int],
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """This process's Mesh over the first prod(axes) of `ranks` (global,
    ascending; default every rank of the default process group), one
    process per mesh position. Every rank of `ranks` calls it, in the
    same order as any other group creation (a rank past the mesh takes
    part in making the groups, and holds no position); a rank outside
    `ranks` takes part in nothing."""
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
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if ranks != sorted(set(ranks)) or ranks[-1] >= world:
        raise ValueError(f"mesh ranks {ranks}: ascending ranks of the "
                         f"world of {world}, each once")
    if view.num_devices > len(ranks):
        raise ValueError(f"parallel_axes={axis_sizes} needs "
                         f"{view.num_devices} processes, one per mesh "
                         f"position; the process group has {len(ranks)}"
                         + (f" (ranks {ranks})" if len(ranks) < world
                            else ""))
    rank = dist.get_rank()
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not one of the mesh's ranks "
                         f"{ranks}")
    mesh = Mesh(view, rank, {}, distributed.device(), ranks)
    at = mesh.mesh_ranks
    mesh.group_all = distributed.group_of(at)
    names = [n for n, _ in view.axes]
    sizes = [s for _, s in view.axes]
    for i, name in enumerate(names):
        # the positions that share every other coordinate, for each
        # setting of those coordinates in row-major order: the group of
        # their ranks made by every rank
        stride = 1
        for s in sizes[i + 1:]:
            stride *= s
        others = [p for p in range(view.num_devices)
                  if (p // stride) % sizes[i] == 0]
        for base in others:
            group_ranks = [at[base + j * stride] for j in range(sizes[i])]
            group = dist.new_group(group_ranks)
            if rank in group_ranks:
                mesh.groups[name] = group
                mesh.group_ranks[name] = group_ranks
    return mesh
