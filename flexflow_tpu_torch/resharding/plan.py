"""Redistribution planner: diff two sharding plans, emit a bounded-memory
schedule of portable collectives.

The model of arXiv:2112.01075 (memory-efficient array redistribution via
portable collective communication): moving a live device array from one
layout to another decomposes into all-gather (a dim's partition degree
drops), dynamic-slice (a degree rises), and ppermute / point-to-point
transfer (the shard→device assignment changes) steps. The naive lowering
all-gathers every changed dim at once, materializing an intermediate of
``global_bytes / kept_degree`` per chip — fatal for a large model. The
planner here bounds that intermediate: when a move's round scratch would
exceed ``peak_bytes``, the move is split into chunked ROUNDS along the
data dim that admits the most splits (chunk extents stay divisible by
both layouts' degrees so every round is itself a clean redistribution),
trading dispatches for memory exactly like the paper's chained
gather/slice sequences.

Nothing here touches a device: the planner consumes *specs* (per-dim
partition degrees + mesh axes from two searched plans, the same
`ParallelTensorShape` vocabulary the Unity search emits) and produces a
`ReshardSchedule` — an analyzable, priceable artifact. The analysis gate
(`analysis.check_redistribution`, FFTA06x codes) proves a schedule legal
on the target mesh and inside the memory bound BEFORE the executor
(resharding/executor.py) applies it; the cost hook (resharding/cost.py)
prices it with the machine model's collective terms so the simulator can
price an elastic recovery or a serving mesh resize.

Scratch model: one round in flight holds (a) the source-side gathered
chunk and (b) the destination-side landing chunk, each bounded by
``chunk_bytes / kept_degree`` — so a round's ``scratch_bytes`` is twice
that, and the executor's instrumented peak (the per-chip bytes of the
intermediates it actually materializes) can never exceed it. Moves run
serially, round by round, so a schedule's peak is the max round, not a
sum.

The port's copy of flexflow_tpu/resharding/plan.py (numpy only). A
mesh's `device_ids` are torch.distributed ranks in the mesh's row-major
order (core/machine.py lays a mesh over the first prod(axes) of its rank
list, `FFConfig.device_ids`), and
`MeshSpec.from_model` and `plan_of` read the port's mesh and its ops'
weight shards (`Op.shards`); JAX's `jax_mesh` and `partition_spec` have
no counterpart. A `stage` mesh holds a different set of ops on each
stage's ranks, which no per-array spec describes: `plan_of` refuses it
(redistribute the gathered whole tree instead). The executor is
resharding/executor.py, over torch.distributed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# step kinds, in the order a round emits them
ALLGATHER = "allgather"    # a dim's degree drops: gather shards over its axis
TRANSFER = "transfer"      # shard→device assignment changes across meshes
PERMUTE = "permute"        # same layout, devices renumbered: pure ppermute
SLICE = "slice"            # a dim's degree rises: local dynamic-slice


class ReshardPlanError(ValueError):
    """The requested redistribution cannot be planned (shape/spec
    mismatch between the two plans). Distinct from an *illegal* schedule,
    which the analysis gate reports as FFTA06x diagnostics."""


# per-chip bytes one cross-tier TRANSFER round may ship over the
# OUTERMOST tier it spans (docs/resharding.md): moves whose transfer
# crosses a tier boundary (a 2-pod mesh's DCN) are chunked down to this
# even when scratch memory would allow bigger rounds, so the slow-tier
# transfer pipelines in bounded pieces instead of one multi-second
# monolith. Deliberately equal to the FFTA071 per-step DCN pressure
# threshold — the same "too much at once across the slow tier" judgment.
TRANSFER_TIER_CHUNK_BYTES = 64e6


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Device mesh of one plan: global ranks in mesh (row-major) order
    plus the ordered named axis sizes. axes == () is the mesh-less
    single-device case (everything on device_ids[0])."""

    device_ids: Tuple[int, ...]
    axes: Tuple[Tuple[str, int], ...] = ()

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def n_mesh_devices(self) -> int:
        """Devices actually inside the mesh grid (extras in device_ids
        beyond the axis-size product are outside it and hold nothing)."""
        need = 1
        for _, s in self.axes:
            need *= s
        return min(need, len(self.device_ids)) if self.device_ids else 0

    def coords(self, rank: int) -> Optional[Dict[str, int]]:
        """The mesh coordinates of global `rank` (axis -> index), None for
        a rank outside the mesh."""
        if not self.axes:
            return {} if self.device_ids and rank == self.device_ids[0] \
                else None
        if rank not in self.device_ids[:self.n_mesh_devices]:
            return None
        rest = self.device_ids.index(rank)
        out: Dict[str, int] = {}
        for name, size in reversed(self.axes):
            out[name] = rest % size
            rest //= size
        return out

    @classmethod
    def from_model(cls, model) -> "MeshSpec":
        """The port's mesh of a compiled model: its ranks and its live axes
        (core/machine.py). A mesh-less model compiled on several ranks
        (FFModel.live_ranks) is a whole copy on each: a `data` axis over
        them that no array is cut on. Else one device: the first of
        `config.device_ids` (JAX's rule), else rank 0."""
        mesh = model.mesh
        if mesh is None:
            live = getattr(model, "live_ranks", None) or ()
            if len(live) > 1:
                return cls(device_ids=tuple(live),
                           axes=(("data", len(live)),))
            ids = getattr(model.config, "device_ids", None)
            return cls(device_ids=(int(ids[0]) if ids else 0,))
        return cls(device_ids=tuple(mesh.mesh_ranks),
                   axes=tuple((str(k), int(v)) for k, v in mesh.view.axes))


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Sharding of one array: per-data-dim (degree, mesh axis). The same
    information ParallelTensorShape.partition_spec() lowers to a
    jax PartitionSpec — replica dims excluded, batch-first order."""

    degrees: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]

    def __post_init__(self):
        if len(self.degrees) != len(self.axes):
            raise ReshardPlanError(
                f"degrees {self.degrees} and axes {self.axes} differ in"
                " rank")
        for d, a in zip(self.degrees, self.axes):
            if d > 1 and a is None:
                raise ReshardPlanError(
                    f"partitioned dim (degree {d}) names no mesh axis")

    @classmethod
    def replicated(cls, ndim: int) -> "ArraySpec":
        return cls(degrees=(1,) * ndim, axes=(None,) * ndim)

    @classmethod
    def from_parallel_shape(cls, ps) -> "ArraySpec":
        dims = ps.dims
        return cls(degrees=tuple(int(d.degree) for d in dims),
                   axes=tuple(d.axis if d.degree > 1 else None
                              for d in dims))

    def total_degree(self) -> int:
        return int(np.prod(self.degrees)) if self.degrees else 1


@dataclasses.dataclass
class ShardingPlan:
    """One searched plan's placement: the mesh plus per-array specs.
    Arrays absent from `arrays` are replicated on the mesh (exactly what
    elastic.reshard_params assumes for unlisted leaves)."""

    mesh: MeshSpec
    arrays: Dict[str, ArraySpec] = dataclasses.field(default_factory=dict)

    def spec_for(self, path: str, ndim: int) -> ArraySpec:
        spec = self.arrays.get(path)
        if spec is None:
            return ArraySpec.replicated(ndim)
        if len(spec.degrees) != ndim:
            # a rank-mismatched entry (e.g. an optimizer scalar mirroring
            # a weight path) degrades to replicated rather than lying
            return ArraySpec.replicated(ndim)
        return spec


def plan_of(model) -> ShardingPlan:
    """Extract the ShardingPlan of a compiled FFModel: every sharded
    weight's spec (`Op.shards`) under ``params/<op>/<weight>``, optimizer
    moment trees mirroring the matching weight
    (``opt_state/<k>/<op>/<weight>``), everything else replicated by
    omission. A `stage` mesh raises ReshardPlanError (the module
    docstring)."""
    if getattr(model.executor, "pipeline_plan", None) is not None:
        raise ReshardPlanError(
            "a stage mesh's ranks hold different ops, which no per-array "
            "spec describes: redistribute the gathered tree "
            "(FFModel.gather_params) instead")
    mesh = MeshSpec.from_model(model)
    arrays: Dict[str, ArraySpec] = {}
    per_weight: Dict[str, Dict[str, ArraySpec]] = {}
    for op in model.graph.topo_order():
        for wname, ps in op.shards.items():
            spec = ArraySpec.from_parallel_shape(ps)
            arrays[f"params/{op.name}/{wname}"] = spec
            per_weight.setdefault(op.name, {})[wname] = spec
    for k, v in (model.opt_state or {}).items():
        if not isinstance(v, dict):
            continue  # scalars (step, lr): replicated by omission
        for op_name, entry in v.items():
            if not isinstance(entry, dict):
                continue
            for wname in entry:
                spec = per_weight.get(op_name, {}).get(wname)
                if spec is not None:
                    arrays[f"opt_state/{k}/{op_name}/{wname}"] = spec
    return ShardingPlan(mesh=mesh, arrays=arrays)


@dataclasses.dataclass(frozen=True)
class ReshardStep:
    """One collective of one round of one array's move."""

    kind: str                   # ALLGATHER | TRANSFER | PERMUTE | SLICE
    axis: Optional[str] = None  # mesh axis (allgather)
    dim: Optional[int] = None   # data dim (allgather/slice)
    participants: int = 1       # collective group size
    bytes_per_chip: int = 0     # bytes one chip ships this step
    scratch_bytes: int = 0      # per-chip intermediate this step holds


@dataclasses.dataclass
class ArrayMove:
    """The full schedule for one array: `rounds` chunked repetitions of
    the per-round `steps` along `chunk_dim`."""

    path: str
    shape: Tuple[int, ...]
    itemsize: int
    dtype: str
    old: ArraySpec
    new: ArraySpec
    rounds: int = 1
    chunk_dim: Optional[int] = None
    steps: List[ReshardStep] = dataclasses.field(default_factory=list)
    peak_scratch_bytes: int = 0  # max over rounds (they are uniform)
    infeasible_peak: bool = False  # no chunking meets the bound

    @property
    def noop(self) -> bool:
        return not self.steps

    @property
    def global_bytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.itemsize \
            if self.shape else self.itemsize

    def total_bytes_moved(self) -> int:
        return self.rounds * sum(s.bytes_per_chip for s in self.steps)


@dataclasses.dataclass
class ReshardSchedule:
    """Planner output for a whole tree: per-array moves plus the bound
    they were planned under. Moves execute serially (round by round), so
    the schedule's peak scratch is the max round, not a sum."""

    old_mesh: MeshSpec
    new_mesh: MeshSpec
    moves: List[ArrayMove]
    peak_bytes: int

    @property
    def peak_scratch_bytes(self) -> int:
        return max((m.peak_scratch_bytes for m in self.moves), default=0)

    @property
    def total_bytes_moved(self) -> int:
        return sum(m.total_bytes_moved() for m in self.moves)

    @property
    def n_noop(self) -> int:
        return sum(1 for m in self.moves if m.noop)

    def summary(self) -> Dict[str, object]:
        return {
            "arrays": len(self.moves),
            "noop": self.n_noop,
            "rounds": sum(m.rounds for m in self.moves if not m.noop),
            "total_bytes_moved": int(self.total_bytes_moved),
            "peak_scratch_bytes": int(self.peak_scratch_bytes),
            "peak_bytes_bound": int(self.peak_bytes),
            "old_devices": len(self.old_mesh.device_ids),
            "new_devices": len(self.new_mesh.device_ids),
        }


def _round_steps(shape: Sequence[int], itemsize: int, old: ArraySpec,
                 new: ArraySpec, same_mesh: bool, same_device_set: bool,
                 chunk_elems: int, kept_degree: int,
                 new_total: int) -> List[ReshardStep]:
    """The per-round collective sequence of one move (chunk_elems = the
    round's global element count)."""
    chunk_bytes = chunk_elems * itemsize
    scratch = 2 * _ceil_div(chunk_bytes, kept_degree)
    steps: List[ReshardStep] = []
    changed = [d for d in range(len(shape))
               if (old.degrees[d], old.axes[d]) != (new.degrees[d],
                                                    new.axes[d])]
    if not changed and same_mesh:
        return []
    if not changed:
        # layout identical, devices differ: a pure shard permutation when
        # the device set is the same (renumbered), a point-to-point
        # transfer when the set itself changed (elastic shrink/grow)
        steps.append(ReshardStep(
            kind=PERMUTE if same_device_set else TRANSFER,
            participants=max(2, new_total),
            bytes_per_chip=_ceil_div(chunk_bytes, old.total_degree()),
            scratch_bytes=scratch))
        return steps
    for d in changed:
        if old.degrees[d] > 1:
            steps.append(ReshardStep(
                kind=ALLGATHER, axis=old.axes[d], dim=d,
                participants=old.degrees[d],
                bytes_per_chip=_ceil_div(chunk_bytes, kept_degree
                                         * old.degrees[d])
                * (old.degrees[d] - 1),
                scratch_bytes=scratch))
    if not same_mesh:
        # each destination chip pulls its (new-layout) shard from a
        # source holder — cross-mesh, so point-to-point, not an in-mesh
        # collective
        steps.append(ReshardStep(
            kind=TRANSFER, participants=max(1, new_total),
            bytes_per_chip=_ceil_div(chunk_bytes, new_total),
            scratch_bytes=scratch))
    for d in changed:
        if new.degrees[d] > 1:
            steps.append(ReshardStep(
                kind=SLICE, axis=new.axes[d], dim=d,
                participants=new.degrees[d],
                bytes_per_chip=0,  # local carve-out, nothing on the wire
                scratch_bytes=scratch))
    return steps


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // max(1, int(b)))


def leaf_itemsize(dtype) -> int:
    """Bytes per element of a leaf's dtype (a numpy dtype, a torch dtype
    or either's name), bfloat16 included: THE one itemsize rule of the
    planner and the executor's instrumentation."""
    name = str(dtype).replace("torch.", "")
    if name == "bfloat16":
        return 2
    if hasattr(dtype, "itemsize"):
        return int(dtype.itemsize)
    return int(np.dtype(name).itemsize)


def _chunking(shape: Sequence[int], itemsize: int, kept_degree: int,
              old: ArraySpec, new: ArraySpec,
              peak_bytes: int) -> Tuple[int, Optional[int], int, bool]:
    """(rounds, chunk_dim, round_scratch, infeasible): the fewest rounds
    whose per-round scratch (2 * chunk_bytes / kept_degree) fits
    peak_bytes. Chunk extents stay multiples of lcm(old_deg, new_deg) on
    the chunk dim so every round is itself a clean redistribution."""
    global_bytes = int(np.prod(shape, dtype=np.int64)) * itemsize \
        if len(shape) else itemsize
    full = 2 * _ceil_div(global_bytes, kept_degree)
    if full <= peak_bytes:
        return 1, None, full, False
    best: Optional[Tuple[int, int, int]] = None  # (rounds, dim, scratch)
    for d in range(len(shape)):
        align = math.lcm(old.degrees[d], new.degrees[d])
        max_rounds = shape[d] // align
        if max_rounds <= 1:
            continue
        # smallest round count that fits the bound, among divisors of the
        # alignable extent (uniform rounds keep the executor's update
        # slices exact)
        want = _ceil_div(full, peak_bytes)
        rounds = None
        for r in range(want, max_rounds + 1):
            if max_rounds % r == 0:
                rounds = r
                break
        if rounds is None:
            rounds = max_rounds
        scratch = _ceil_div(full, rounds)
        if scratch <= peak_bytes and (best is None or rounds < best[0]):
            best = (rounds, d, scratch)
    if best is not None:
        return best[0], best[1], best[2], False
    # even maximal chunking cannot meet the bound: report the smallest
    # achievable scratch so the FFTA061 diagnostic can say by how much
    fallback: Tuple[int, Optional[int], int] = (1, None, full)
    for d in range(len(shape)):
        align = math.lcm(old.degrees[d], new.degrees[d])
        max_rounds = shape[d] // align
        if max_rounds > 1:
            scratch = _ceil_div(full, max_rounds)
            if scratch < fallback[2]:
                fallback = (max_rounds, d, scratch)
    return fallback[0], fallback[1], fallback[2], True


def transfer_chunk_bound(machine, n_devices: int, kept_degree: int,
                         new_total: int) -> Optional[int]:
    """The scratch-equivalent chunk bound a cross-tier TRANSFER adds
    (None when the machine is flat or the device group never leaves its
    innermost tier). A round ships chunk_bytes/new_total per chip across
    the outermost tier; bounding that at TRANSFER_TIER_CHUNK_BYTES
    translates to scratch = 2*chunk_bytes/kept <= 2*cap*new_total/kept
    — the planner's currency."""
    if machine is None or not hasattr(machine, "crosses_tier_boundary"):
        return None
    if n_devices <= 1 or not machine.crosses_tier_boundary(n_devices):
        return None
    return max(1, int(2 * TRANSFER_TIER_CHUNK_BYTES * max(1, new_total)
                      // max(1, kept_degree)))


def plan_move(path: str, shape: Tuple[int, ...], itemsize: int, dtype: str,
              old_plan: ShardingPlan, new_plan: ShardingPlan,
              peak_bytes: int, machine=None) -> ArrayMove:
    old = old_plan.spec_for(path, len(shape))
    new = new_plan.spec_for(path, len(shape))
    for d, size in enumerate(shape):
        for which, spec in (("old", old), ("new", new)):
            if spec.degrees[d] > 1 and size % spec.degrees[d] != 0:
                raise ReshardPlanError(
                    f"{path}: {which} degree {spec.degrees[d]} does not"
                    f" divide dim {d} (size {size})")
    same_mesh = old_plan.mesh == new_plan.mesh
    move = ArrayMove(path=path, shape=shape, itemsize=itemsize,
                     dtype=dtype, old=old, new=new)
    if same_mesh and old == new:
        return move  # noop
    # dims keeping BOTH degree and axis stay partitioned through the move
    kept = 1
    for d in range(len(shape)):
        if (old.degrees[d], old.axes[d]) == (new.degrees[d], new.axes[d]):
            kept *= old.degrees[d]
    effective_peak = peak_bytes
    if not same_mesh:
        # cross-mesh moves land through a TRANSFER step; when the target
        # group spans a tier boundary, chunk the rounds down so the slow
        # tier moves bounded pieces (best-effort: a bound no chunking
        # can meet falls back to the memory bound alone — the cap is a
        # pipelining preference, not a legality limit)
        cap = transfer_chunk_bound(
            machine, len(new_plan.mesh.device_ids), kept,
            new.total_degree())
        if cap is not None:
            effective_peak = min(peak_bytes, cap)
    rounds, chunk_dim, scratch, infeasible = _chunking(
        shape, itemsize, kept, old, new, effective_peak)
    if infeasible and effective_peak < peak_bytes:
        rounds, chunk_dim, scratch, infeasible = _chunking(
            shape, itemsize, kept, old, new, peak_bytes)
    chunk_elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if chunk_dim is not None:
        chunk_elems = chunk_elems // rounds
    move.rounds = rounds
    move.chunk_dim = chunk_dim
    move.peak_scratch_bytes = scratch
    move.infeasible_peak = infeasible
    same_devices = (sorted(old_plan.mesh.device_ids)
                    == sorted(new_plan.mesh.device_ids))
    move.steps = _round_steps(shape, itemsize, old, new, same_mesh,
                              same_devices, chunk_elems, kept,
                              new.total_degree())
    return move


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """'/'-joined flattening, the SAME key scheme runtime/checkpoint.py
    uses — so a plan path addresses the identical leaf in both the live
    tree and its checkpoint reference."""
    out: Dict[str, object] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix.rstrip("/")] = tree
    return out


def unflatten_tree(flat: Dict[str, object]):
    tree: Dict[str, object] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def plan_redistribution(tree, old_plan: ShardingPlan,
                        new_plan: ShardingPlan, *,
                        peak_bytes: int, machine=None) -> ReshardSchedule:
    """Schedule every leaf of `tree` (a nested dict of arrays) from
    old_plan's layout to new_plan's, each move bounded by `peak_bytes`
    per-chip scratch. A hierarchical `machine` additionally caps each
    cross-tier TRANSFER round at TRANSFER_TIER_CHUNK_BYTES over the
    outermost tier (see transfer_chunk_bound)."""
    if peak_bytes < 1:
        raise ValueError(f"peak_bytes={peak_bytes}: need >= 1")
    moves = []
    for path, leaf in flatten_tree(tree).items():
        arr = np.asarray(leaf) if not hasattr(leaf, "shape") else leaf
        shape = tuple(int(s) for s in arr.shape)
        moves.append(plan_move(path, shape, leaf_itemsize(arr.dtype),
                               str(arr.dtype).replace("torch.", ""),
                               old_plan, new_plan, peak_bytes,
                               machine=machine))
    return ReshardSchedule(old_mesh=old_plan.mesh, new_mesh=new_plan.mesh,
                           moves=moves, peak_bytes=int(peak_bytes))


def plan_slot_migration(kv_shapes: Dict[str, Tuple[Tuple[int, ...], int]],
                        old_slots: int, new_slots: int,
                        migrated_rows: int, *,
                        device_ids: Sequence[int] = (0,),
                        peak_bytes: Optional[int] = None) -> ReshardSchedule:
    """The serving mesh-resize schedule: the KV pool's slot-dense cache
    arrays are not same-shape redistributions (the slot dim itself grows
    or shrinks), so a resize is modeled as one TRANSFER move per cache
    array shipping the live sequences' owned rows into the new arrays.
    The resize executor (ContinuousBatcher._maybe_resize) materializes
    EVERY new cache array while EVERY old one is still live (the swap is
    atomic under the scheduler lock), so each move's scratch is the
    WHOLE transient footprint — sum of all old plus all new arrays'
    bytes — not one array's; the FFTA061 HBM gate must see what the
    chip actually holds mid-resize. `kv_shapes` maps array path to
    ((slots, rows, heads, dim), itemsize) of the OLD array. Priced and
    gated exactly like an elastic redistribution (FFTA06x)."""
    mesh = MeshSpec(device_ids=tuple(int(i) for i in device_ids))
    old_total = new_total = 0
    geom: Dict[str, Tuple[int, int]] = {}  # path -> (row_bytes, old_b)
    for path, (shape, itemsize) in kv_shapes.items():
        if not shape:
            raise ReshardPlanError(f"{path}: KV cache array has no shape")
        row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * itemsize \
            if len(shape) > 1 else itemsize
        old_total += int(np.prod(shape, dtype=np.int64)) * itemsize
        new_total += int(np.prod((new_slots,) + tuple(shape[1:]),
                                 dtype=np.int64)) * itemsize
        geom[path] = (row_bytes, itemsize)
    footprint = old_total + new_total
    moves: List[ArrayMove] = []
    for path, (shape, itemsize) in kv_shapes.items():
        row_bytes, _ = geom[path]
        spec = ArraySpec.replicated(len(shape))
        move = ArrayMove(
            path=path, shape=tuple(shape), itemsize=itemsize,
            dtype="kv", old=spec, new=spec, rounds=1,
            peak_scratch_bytes=footprint)
        move.steps = [ReshardStep(
            kind=TRANSFER, participants=1,
            bytes_per_chip=migrated_rows * row_bytes,
            scratch_bytes=footprint)]
        moves.append(move)
    bound = int(peak_bytes) if peak_bytes else max(1, footprint)
    return ReshardSchedule(old_mesh=mesh, new_mesh=mesh, moves=moves,
                           peak_bytes=max(1, bound))


# -- survivor coverage -----------------------------------------------------
def _mesh_grid_positions(mesh: MeshSpec) -> np.ndarray:
    """Mesh-grid coordinate array: positions 0..n-1 (indices into
    device_ids) reshaped row-major over the axis sizes — exactly how
    core.machine.make_mesh lays devices out."""
    sizes = tuple(s for _, s in mesh.axes) or (1,)
    n = int(np.prod(sizes))
    return np.arange(n).reshape(sizes)


def uncovered_arrays(plan: ShardingPlan, leaves: Dict[str, int],
                     lost_positions: Sequence[int]) -> List[Tuple[str, int]]:
    """Arrays whose live shards cannot be reassembled from the surviving
    devices: [(path, n_lost_shards)]. `leaves` maps path -> ndim for
    every leaf of the tree being recovered (plan-less leaves are
    replicated and covered iff ANY mesh device survives). A shard is
    covered when at least one device holding a replica of it survives —
    partitioned dims place exactly one copy per axis coordinate, so
    losing every device of a coordinate loses the shard."""
    lost = set(int(p) for p in lost_positions)
    out: List[Tuple[str, int]] = []
    if not plan.mesh.device_ids:
        return out
    grid = _mesh_grid_positions(plan.mesh)
    n_mesh = grid.size
    axis_names = [a for a, _ in plan.mesh.axes]
    survivors_in_mesh = [p for p in range(n_mesh) if p not in lost]
    for path, ndim in leaves.items():
        spec = plan.spec_for(path, ndim)
        used = sorted({a for a in spec.axes if a is not None},
                      key=lambda a: axis_names.index(a)
                      if a in axis_names else len(axis_names))
        if not used:
            # replicated: any surviving mesh device covers it (mesh-less
            # plans place everything on position 0)
            if not plan.mesh.axes:
                if 0 in lost:
                    out.append((path, 1))
            elif not survivors_in_mesh:
                out.append((path, 1))
            continue
        missing_axis = [a for a in used if a not in axis_names]
        if missing_axis:
            # spec names an axis the mesh lacks — let the FFTA060 gate
            # report it; coverage cannot be decided
            continue
        # group mesh positions by their coordinates along the used axes;
        # each group holds replicas of one shard
        axes_idx = tuple(axis_names.index(a) for a in used)
        other_idx = tuple(i for i in range(grid.ndim)
                          if i not in axes_idx)
        moved = np.transpose(grid, axes_idx + other_idx)
        shard_groups = moved.reshape(
            int(np.prod([grid.shape[i] for i in axes_idx])), -1)
        n_lost_shards = sum(
            1 for group in shard_groups
            if all(int(p) in lost for p in group))
        if n_lost_shards:
            out.append((path, n_lost_shards))
    return out
