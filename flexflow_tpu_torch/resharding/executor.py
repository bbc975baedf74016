"""Redistribution executor: apply a ReshardSchedule to the live tensors
of the ranks of a torch.distributed world (the port's counterpart of
flexflow_tpu/resharding/executor.py).

In the JAX package a tree holds global arrays and XLA moves their
shards. Here each rank holds its LOCAL shard of every leaf under the old
plan (`tree`: the same paths on every rank, each leaf this rank's piece;
a rank outside the old mesh passes leaves of the same local shape, which
are read for their shape alone), and gets back its local shard under the
new plan. Every taking-part rank calls `apply_schedule` (or
`redistribute`) with the same schedule, and issues the same collectives
in the same order: moves serially, each move's rounds serially, as the
planner's execution contract says. By default every rank of the world
takes part; a caller that names `ranks` and their `group` (the elastic
coordinator: the survivors of a rank loss, which hold the old mesh's
surviving shards and make up the new mesh) moves among those alone, and
a rank outside them (a lost one) neither sends nor receives. Per round:

 - a same-mesh pure all-gather (every changed dim goes degree d -> 1,
   the chunk dim not sharded) with the old mesh's process groups at hand
   (`mesh`, a core.machine.Mesh laid over the same axes) is an
   all-gather of the round's local piece over each gathered axis's group
   (`allgather_dims`, runtime/collectives.py);
 - every other round (a slice, a transfer to another mesh on the same
   ranks such as {"data": 4} -> {"data": 2, "model": 2}, a gather of a
   chunked sharded dim) is one point-to-point exchange: each rank's new
   shard of the round's chunk is cut into the pieces of the old shards
   it overlaps, and each piece comes from one rank that holds it (the
   receiving rank itself when it does, a local cut; else the first
   holder in rank order among the taking-part ranks; a piece no such
   rank holds raises ReshardPlanError). This is the round's all-gather
   and slice
   without the whole chunk on every rank: gathering the chunk over the
   world group would hold world x chunk bytes a rank, beyond the planned
   round scratch, where the exchange holds at most this rank's piece of
   the chunk sent (chunk / old degree) and its new piece received
   (chunk / new degree), within the planner's 2 x chunk / kept degree.

`observed_peak_bytes` is the largest round's bytes of the intermediates
a rank actually materialised (the gathered pieces; the send and receive
buffers of an exchange), the max over the ranks, so the FFTA061 promise
(observed <= the planned round scratch) is checkable. Under gloo a CUDA
tensor's sends and receives go through host memory (STAGED counts
them, as every collective's). Values are only moved, never transformed:
the result is bit-exact against slicing the whole array.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .plan import (ArrayMove, ArraySpec, MeshSpec, ReshardPlanError,
                   ReshardSchedule, ShardingPlan, flatten_tree,
                   plan_redistribution, unflatten_tree)

Box = Tuple[Tuple[int, int], ...]

_Leaf = collections.namedtuple("_Leaf", "shape dtype")


@dataclasses.dataclass
class ReshardResult:
    """Executor output: this rank's redistributed tree plus what actually
    happened (for spans, metrics, and the peak-bound property test)."""

    tree: object
    schedule: ReshardSchedule
    observed_peak_bytes: int
    bytes_moved: int
    wall_s: float
    allgather_rounds: int = 0  # rounds run as axis-group all-gathers
    transfer_rounds: int = 0   # rounds run as point-to-point exchanges
    # per-round measured wall timings as CollectiveCalibration rows,
    # collected only under apply_schedule(collect_timings=True)
    calibration_rows: list = dataclasses.field(default_factory=list)


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_box(spec: ArraySpec, mesh: MeshSpec, rank: int,
              shape: Sequence[int]) -> Optional[Box]:
    """The global index range, per dim, of the shard `rank` holds under
    `spec` on `mesh`; None for a rank outside the mesh."""
    coords = mesh.coords(rank)
    if coords is None:
        return None
    box = []
    for d, size in enumerate(shape):
        deg, axis = spec.degrees[d], spec.axes[d]
        n = size // deg
        c = coords.get(axis, 0) if deg > 1 else 0
        box.append((c * n, (c + 1) * n))
    return tuple(box)


def _meet(a: Box, b: Box) -> Optional[Box]:
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def _view(t: torch.Tensor, box: Box, origin: Box) -> torch.Tensor:
    """The part of `t` (which holds `origin`) at the global `box`."""
    for d, ((lo, hi), (o, _)) in enumerate(zip(box, origin)):
        t = t.narrow(d, lo - o, hi - lo)
    return t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _pure_gather_dims(move: ArrayMove) -> Optional[list]:
    """The gathered dims when a move is a same-mesh pure all-gather
    (every changed dim goes degree>1 -> 1); None otherwise."""
    dims = []
    for d in range(len(move.shape)):
        o = (move.old.degrees[d], move.old.axes[d])
        n = (move.new.degrees[d], move.new.axes[d])
        if o == n:
            continue
        if n[0] != 1 or o[0] <= 1:
            return None
        dims.append(d)
    return dims or None


def _groups_of(mesh, spec: MeshSpec):
    """`mesh`'s process groups when it is laid over `spec`'s ranks and
    axes, else None."""
    if mesh is None or not spec.axes:
        return None
    if tuple(mesh.view.axes) != tuple(spec.axes) or \
            tuple(spec.device_ids[:spec.n_mesh_devices]) != \
            tuple(mesh.mesh_ranks):
        return None
    return mesh


def _volume(box: Box) -> int:
    n = 1
    for lo, hi in box:
        n *= hi - lo
    return n


def _exchange(src: Optional[torch.Tensor], out: Optional[torch.Tensor],
              move: ArrayMove, schedule: ReshardSchedule, chunk: Box,
              ranks: Sequence[int], me: int, group=None) -> int:
    """One round's point-to-point exchange (the module docstring): this
    rank's new shard of `chunk` filled into `out` from the holders among
    `ranks` of the old shards it overlaps, over `group` (None: the
    default group). Returns the bytes of the buffers this rank
    materialised."""
    import torch.distributed as dist

    from ..runtime import distributed
    from ..runtime.collectives import _to_host

    shape = move.shape
    holders: Dict[Box, List[int]] = {}
    for r in ranks:
        b = shard_box(move.old, schedule.old_mesh, r, shape)
        if b is not None:
            holders.setdefault(b, []).append(r)
    old_box = shard_box(move.old, schedule.old_mesh, me, shape)
    new_box = shard_box(move.new, schedule.new_mesh, me, shape)
    sends: Dict[Box, torch.Tensor] = {}
    ops, landings, used = [], [], 0
    staged = out is not None and out.is_cuda or \
        src is not None and src.is_cuda
    staged = staged and distributed.host_staging()
    for q in ranks:
        tb = shard_box(move.new, schedule.new_mesh, q, shape)
        if tb is None:
            continue
        target = _meet(tb, chunk)
        if target is None:
            continue
        covered = 0
        for box, hs in holders.items():
            piece = _meet(box, target)
            if piece is None:
                continue
            covered += _volume(piece)
            sender = q if q in hs else hs[0]
            if sender == me and q == me:
                with torch.no_grad():
                    _view(out, piece, new_box).copy_(
                        _view(src, piece, old_box))
            elif sender == me:
                buf = sends.get(piece)
                if buf is None:
                    buf = _view(src, piece, old_box).contiguous()
                    used += _nbytes(buf)
                    if staged:
                        buf = _to_host(buf)
                    sends[piece] = buf
                ops.append(dist.P2POp(dist.isend, buf, q, group=group))
            elif q == me:
                dims = [hi - lo for lo, hi in piece]
                buf = torch.empty(dims, dtype=out.dtype,
                                  device="cpu" if staged else out.device)
                used += _nbytes(buf)
                ops.append(dist.P2POp(dist.irecv, buf, sender,
                                      group=group))
                landings.append((piece, buf))
        if covered != _volume(target):
            # the old shards' holders among the taking-part ranks miss
            # part of rank q's new shard (FFTA063 decides this before a
            # recovery reshards): never land uninitialised memory
            raise ReshardPlanError(
                f"{move.path}: rank {q}'s new shard {list(target)} is not "
                f"covered by the old shards of ranks {list(ranks)}")
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    with torch.no_grad():
        for piece, buf in landings:
            _view(out, piece, new_box).copy_(buf)
    return used


def _allgather_round(src: torch.Tensor, mesh, move: ArrayMove,
                     dims: List[int]) -> Tuple[torch.Tensor, int]:
    """A same-mesh pure gather's round: the local piece all-gathered over
    each gathered dim's axis group."""
    from ..runtime.collectives import allgather_dims

    got = allgather_dims(src, mesh, move.old.axes, dims)
    return got, _nbytes(src) + _nbytes(got)


def _transfer_tier(machine, n_devices: int) -> str:
    """The tier label a transfer's traffic rides: the outermost tier the
    target device group spans on a hierarchical machine, "mesh"
    otherwise."""
    if machine is None or not hasattr(machine, "tier_path"):
        return "mesh"
    path = machine.tier_path(max(1, n_devices))
    return path[-1][0].name if path else machine.tiers[0].name


def _max_over_ranks(value: int, n_ranks: int, group=None) -> int:
    import torch.distributed as dist

    if n_ranks == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def apply_schedule(tree, schedule: ReshardSchedule,
                   new_plan: ShardingPlan, machine=None,
                   collect_timings: bool = False,
                   mesh=None, ranks: Optional[Sequence[int]] = None,
                   group=None) -> ReshardResult:
    """Move every leaf of this rank's `tree` (its local shards under the
    old plan) per its scheduled ArrayMove; returns its local shards under
    the new plan (a rank outside the new mesh gets no leaves). Leaves and
    moves are matched by flattened path; a leaf without a move raises.
    `mesh`: the old mesh's core.machine.Mesh, whose axis groups a
    same-mesh gather uses. `ranks` and `group`: the taking-part ranks
    (ascending; they must hold the new mesh) and their process group
    (runtime/distributed.py group_of); default every rank of the world
    and the default group.

    Every non-noop move runs under an ``exec.transfer`` span and counts
    its rounds on ``ff_collective_lowered_total{strategy=transfer|
    allgather,tier=...}``; ``collect_timings=True`` also times each round
    (a device sync) into CollectiveCalibration rows, priced with
    `machine` when given."""
    from ..obs.calibration import CollectiveCalibration
    from ..obs.tracing import get_tracer
    from ..runtime.collectives import lowered_counter
    from .cost import step_cost_us

    t0 = time.perf_counter()
    me, world = _world()
    if ranks is None:
        ranks = sorted(set(range(world))
                       | set(schedule.old_mesh.device_ids)
                       | set(schedule.new_mesh.device_ids))
    else:
        ranks = sorted(int(r) for r in ranks)
        outside = set(schedule.new_mesh.device_ids) - set(ranks)
        if outside or me not in ranks:
            raise ValueError(
                f"taking-part ranks {ranks} must hold this rank ({me}) "
                f"and the new mesh's (missing {sorted(outside)})")
    flat = flatten_tree(tree)
    by_path: Dict[str, ArrayMove] = {m.path: m for m in schedule.moves}
    missing = set(flat) - set(by_path)
    if missing:
        raise ValueError(
            f"schedule has no move for leaves {sorted(missing)[:5]}"
            f" (+{max(0, len(missing) - 5)} more)")
    same_mesh = schedule.old_mesh == schedule.new_mesh
    groups = _groups_of(mesh, schedule.old_mesh) if same_mesh else None
    n_new_devices = len(schedule.new_mesh.device_ids)
    tier = _transfer_tier(machine, n_new_devices)
    tracer = get_tracer()
    counter = lowered_counter()
    rows: list = []
    out: Dict[str, object] = {}
    observed = 0
    n_allgather = n_transfer = 0
    for path, leaf in flat.items():
        move = by_path[path]
        old_box = shard_box(move.old, schedule.old_mesh, me, move.shape)
        new_box = shard_box(move.new, schedule.new_mesh, me, move.shape)
        src = leaf if old_box is not None else None
        if move.noop:
            if new_box is not None:
                out[path] = leaf
            continue
        dst = (torch.empty([hi - lo for lo, hi in new_box], dtype=leaf.dtype,
                           device=leaf.device)
               if new_box is not None else None)
        gather = _pure_gather_dims(move) if groups is not None else None
        if gather is not None and move.chunk_dim is not None and (
                move.old.degrees[move.chunk_dim] > 1):
            gather = None  # a chunk of a sharded dim is not a local slice
        rounds = 1 if move.chunk_dim is None else move.rounds
        strategy = "allgather" if gather is not None else "transfer"
        participants = n_new_devices
        move_tier = tier
        if gather is not None:
            participants = 1
            for d in gather:
                participants *= move.old.degrees[d]
            move_tier = _transfer_tier(machine, participants)
        predicted_round_us = (
            sum(step_cost_us(s, machine, n_devices=n_new_devices)
                for s in move.steps) if machine is not None
            else float("nan"))
        round_bytes = move.total_bytes_moved() / max(1, move.rounds)
        with tracer.span("exec.transfer", path=path, strategy=strategy,
                         tier=move_tier, rounds=rounds,
                         bytes=move.total_bytes_moved()):
            dim = move.chunk_dim
            extent = (move.shape[dim] // rounds) if dim is not None else 0
            for r in range(rounds):
                r0 = time.perf_counter()
                chunk = tuple(
                    (r * extent, (r + 1) * extent) if d == dim
                    else (0, size) for d, size in enumerate(move.shape))
                if gather is not None:
                    piece = src if dim is None else \
                        src.narrow(dim, r * extent, extent)
                    got, used = _allgather_round(piece, groups, move, gather)
                    with torch.no_grad():
                        (dst if dim is None else dst.narrow(
                            dim, r * extent, extent)).copy_(got)
                    n_allgather += 1
                else:
                    used = _exchange(src, dst, move, schedule, chunk, ranks,
                                     me, group)
                    n_transfer += 1
                observed = max(observed, used)
                if collect_timings:
                    if dst is not None and dst.is_cuda:
                        torch.cuda.synchronize(dst.device)
                    rows.append(CollectiveCalibration(
                        op=strategy, strategy=strategy, tier=move_tier,
                        bytes=round_bytes, participants=participants,
                        predicted_us=predicted_round_us,
                        measured_us=(time.perf_counter() - r0) * 1e6))
        if dst is not None:
            out[path] = dst
        counter.inc(rounds, strategy=strategy, tier=move_tier)
    return ReshardResult(
        tree=unflatten_tree(out), schedule=schedule,
        observed_peak_bytes=_max_over_ranks(int(observed), len(ranks),
                                            group),
        bytes_moved=int(schedule.total_bytes_moved),
        wall_s=time.perf_counter() - t0,
        allgather_rounds=n_allgather, transfer_rounds=n_transfer,
        calibration_rows=rows)


def global_shapes(tree, old_plan: ShardingPlan):
    """The tree of each leaf's global (shape, dtype), from this rank's
    local shards under `old_plan` (what the planner reads)."""
    out = {}
    for path, leaf in flatten_tree(tree).items():
        spec = old_plan.spec_for(path, leaf.dim())
        out[path] = _Leaf(tuple(int(s) * int(d) for s, d in
                                zip(leaf.shape, spec.degrees)), leaf.dtype)
    return unflatten_tree(out)


def redistribute(tree, old_plan: ShardingPlan, new_plan: ShardingPlan, *,
                 peak_bytes: int, machine=None, check: bool = True,
                 collect_timings: bool = False, mesh=None,
                 ranks: Optional[Sequence[int]] = None,
                 group=None) -> ReshardResult:
    """THE primitive: move this rank's local shards of a live tree from
    old_plan's layout to new_plan's under a per-chip scratch bound. Every
    taking-part rank calls it (`ranks` and `group`, apply_schedule). Plans the schedule from the leaves' global shapes,
    proves it through the FFTA06x analysis gate (when `check`, raising
    PlanAnalysisError on an illegal or over-budget schedule — pass
    `machine` so the memory-fit check has an HBM figure), then applies
    it."""
    schedule = plan_redistribution(global_shapes(tree, old_plan), old_plan,
                                   new_plan, peak_bytes=peak_bytes,
                                   machine=machine)
    if check:
        from ..analysis import check_redistribution

        check_redistribution(schedule, machine=machine)
    return apply_schedule(tree, schedule, new_plan, machine=machine,
                          collect_timings=collect_timings, mesh=mesh,
                          ranks=ranks, group=group)


def verify_live_tree(tree) -> Optional[str]:
    """Integrity check of a live state tree before trusting it for a
    zero-disk recovery: every floating leaf must be finite. Returns None
    when clean, else a human-readable reason naming the first bad
    leaf."""
    for path, leaf in flatten_tree(tree).items():
        t = leaf if torch.is_tensor(leaf) else torch.as_tensor(leaf)
        if not t.is_floating_point():
            continue
        if not bool(torch.isfinite(t).all()):
            return f"non-finite values in leaf {path!r}"
    return None


def live_tree(model):
    """A compiled model's live tree, this rank's shards: `params` and the
    optimizer state's moment trees (`opt_state/<k>`), as `plan_of` names
    them."""
    tree = {"params": model.params}
    moments = {k: v for k, v in (model.opt_state or {}).items()
               if isinstance(v, dict)}
    if moments:
        tree["opt_state"] = moments
    return tree


def load_live_tree(model, tree) -> None:
    """Copy a tree of this rank's local shards (`live_tree`'s layout, such
    as a `redistribute` result on the model's plan) into a compiled
    model's weights and optimizer moments, in place, checking every name
    and shape."""
    mine = flatten_tree(live_tree(model))
    got = flatten_tree(tree)
    if set(got) != set(mine):
        raise KeyError(
            "live tree names differ from the model's: missing "
            f"{sorted(set(mine) - set(got))[:5]}, unknown "
            f"{sorted(set(got) - set(mine))[:5]}")
    for path, t in mine.items():
        if tuple(got[path].shape) != tuple(t.shape):
            raise ValueError(f"{path}: shape {tuple(got[path].shape)}, this "
                             f"rank's shard is {tuple(t.shape)}")
    with torch.no_grad():
        for path, t in mine.items():
            t.copy_(got[path])
    for op in model.ops:
        op._cast.clear()


__all__ = ["ReshardResult", "apply_schedule", "global_shapes",
           "live_tree", "load_live_tree", "redistribute", "shard_box",
           "verify_live_tree"]
