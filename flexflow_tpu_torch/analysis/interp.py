"""Sharding-flow verifier: abstract interpretation of parallel plans plus
deadlock/uniformity model checking of the executed collective program
(FFTA09x, docs/analysis.md "Verifier"). The port's copy of
flexflow_tpu/analysis/interp.py: `tier_axis_groups` is the port's own
copy (runtime/collectives.py); the reshard programs read the port's
resharding/ schedules.

The FFTA00x-08x passes check per-op legality; nothing there *executes* a
plan symbolically. This module closes that gap — the correctness budget
ROADMAP item 4's dp x ap manual sync groups will spend:

 1. `ShardingFlowInterpreter` walks the PCG in topo order under a
    candidate plan, propagating an `AbstractLayout` per tensor (per-dim
    shard axis+degree, pending-reduction state) and checking that
    layouts compose EDGE-wise: the divisibility pass only validates each
    op's own outputs against its own strategy, so a rewrite that leaves
    a producer tensor inconsistent with its consumers' layouts is
    invisible to it (FFTA093), as is an in-place/donated buffer
    overwritten while a later consumer still reads it (FFTA094).
 2. `verify_grad_sync_program` model-checks the collective program an
    explicit `GradSyncLowering` will execute: every pending partial-sum
    gradient must be discharged by exactly the schedule's collectives
    (FFTA090), every event's `axis_index_groups` must partition the
    participants (FFTA091), and the interleaved per-participant programs
    must be SPMD-uniform and deadlock-free — a participant set whose
    members issue different collective sequences hangs real hardware
    (FFTA091 when the sequences diverge at a sync point, FFTA092 when
    the divergence is a cross-group ordering cycle).
 3. `verify_reshard_program` applies the same uniformity checking to an
    FFTA06x redistribution schedule's rounds (resharding/plan.py).

Everything here is pure Python over the graph/plan/schedule records —
no jax, nothing touches a device (the same contract as passes.py). The
model checker is exact for the programs this repo emits: collective
events are blocking group synchronizations, so the executed schedule is
deadlock-free iff the greedy simulation below drains every program.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.graph import Graph
from .diagnostics import Diagnostic, make_diag

# collective event kinds the checker models (mirrors lower_allreduce's
# lax.* calls plus the resharding TRANSFER/PERMUTE rounds)
PSUM = "psum"
PSUM_SCATTER = "psum_scatter"
ALL_GATHER = "all_gather"
TRANSFER = "transfer"


# ---------------------------------------------------------------------
# the abstract domain
# ---------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AbstractLayout:
    """Abstract state of one tensor under a plan: per data dim, the mesh
    axis sharding it and the degree (None = replicated along that dim),
    plus the set of mesh axes over which the value is a *pending partial
    sum* — correct only after a discharging all-reduce. The lattice is
    flat per dim (either a concrete (axis, degree) or replicated); joins
    never happen because the PCG assigns one producer per tensor."""

    dims: Tuple[Optional[Tuple[str, int]], ...]
    pending: frozenset = frozenset()

    @classmethod
    def replicated(cls, ndim: int) -> "AbstractLayout":
        return cls(dims=(None,) * ndim)

    @classmethod
    def of_strategy(cls, op, s, tensor) -> "AbstractLayout":
        """The layout `s` induces on `tensor` (an output of `op`) — one
        convention with FFModel._assign_strategy / AXIS_OF_FIELD."""
        from ..ffconst import OpType
        from ..search.simulator import AP_CAPABLE, TP_CAPABLE

        ndim = len(tensor.dims or ())
        dims: List[Optional[Tuple[str, int]]] = [None] * ndim
        if s is None or ndim == 0:
            return cls(dims=tuple(dims))
        if s.dp > 1:
            dims[0] = ("data", s.dp)
        if s.sp > 1 and ndim >= 3:
            dims[1] = ("seq", s.sp)
        if s.ap > 1 and op.op_type in AP_CAPABLE and ndim == 4:
            dims[2] = ("attr", s.ap)
        if s.tp > 1 and op.op_type in TP_CAPABLE and not s.tp_row:
            dims[-1] = ("model", s.tp)
        if getattr(s, "ep", 1) > 1 and op.op_type == OpType.EXPERTS:
            # expert weights shard over 'expert'; the routed activation
            # stays (data, seq)-sharded — nothing more to mark here
            pass
        # a row-parallel LINEAR's raw output is a pending partial sum
        # over the model axis until its all-reduce runs
        pending = frozenset({"model"}) if (s.tp > 1 and s.tp_row) \
            else frozenset()
        return cls(dims=tuple(dims), pending=pending)


def gradient_state(graph: Graph, strategies: Optional[Dict[int, object]]
                   ) -> Dict[str, frozenset]:
    """{op name: pending axes of its weight gradients} — the abstract
    backward state the executed grad-sync schedule must discharge. An op
    whose sync group (dp, x ap for spatial ops) is > 1 produces weight
    gradients that are partial sums over the 'data' axis; everything
    else is already global."""
    from ..search.simulator import AP_CAPABLE

    out: Dict[str, frozenset] = {}
    for op in graph.topo_order():
        if not op.weights:
            continue
        s = (strategies or {}).get(op.guid)
        if s is None:
            # no strategy pinned: conservatively pending (a compiled
            # model always has one; raw-graph callers get the safe side)
            out[op.name] = frozenset({"data"})
            continue
        sync = s.dp * (s.ap if op.op_type in AP_CAPABLE else 1)
        out[op.name] = frozenset({"data"}) if sync > 1 else frozenset()
    return out


# ---------------------------------------------------------------------
# the forward abstract interpreter (FFTA093 / FFTA094)
# ---------------------------------------------------------------------
class ShardingFlowInterpreter:
    """Symbolically execute the PCG under `strategies`: assign every
    tensor its AbstractLayout and check edge-wise composition. Checks
    are deliberately narrower than pass_divisibility's — FFTA093 fires
    only on edges where the INPUT tensor disagrees with the op's own
    output on the sharded dim (the post-rewrite inconsistency the
    output-only divisibility pass cannot see), so a plainly illegal
    plan keeps its one FFTA001 instead of double-reporting."""

    def __init__(self, graph: Graph,
                 strategies: Optional[Dict[int, object]] = None,
                 batch_size: Optional[int] = None):
        self.graph = graph
        self.strategies = strategies or {}
        self.batch_size = batch_size
        self.layouts: Dict[int, AbstractLayout] = {}

    def run(self) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        order = self.graph.topo_order()
        pos = {op.guid: i for i, op in enumerate(order)}
        consumers: Dict[int, List[Tuple[int, object]]] = {}
        for op in order:
            for t in op.inputs:
                consumers.setdefault(t.guid, []).append((pos[op.guid], op))
        for op in order:
            s = self.strategies.get(op.guid)
            for t in op.outputs:
                self.layouts[t.guid] = AbstractLayout.of_strategy(op, s, t)
            if s is not None:
                diags.extend(self._edge_checks(op, s))
            if (op.params or {}).get("inplace"):
                diags.extend(self._overwrite_checks(op, pos, consumers))
        return diags

    def _edge_checks(self, op, s) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        out = op.outputs[0] if op.outputs else None
        odims = tuple(out.dims) if (out is not None and out.dims) else ()
        weight_guids = {w.guid for w in op.weights
                        if getattr(w, "guid", None) is not None}
        for t in op.inputs:
            tdims = tuple(t.dims or ())
            if len(tdims) < 2 or t.guid in weight_guids:
                continue
            # batch-dim composition: the consumer shards dim 0 over
            # 'data'; an input whose leading dim drifted away from the
            # op's own (legal) output cannot be re-partitioned
            if (s.dp > 1 and odims and odims[0] % s.dp == 0
                    and tdims[0] != odims[0] and tdims[0] % s.dp):
                diags.append(make_diag(
                    "FFTA093",
                    f"input {t.name!r} has leading dim {tdims[0]}, not"
                    f" divisible by dp={s.dp}, while the op's own output"
                    f" ({odims[0]}) is — the edge no longer composes"
                    " (a rewrite left producer and consumer"
                    " inconsistent)", op,
                    hint="re-run the rewrite's shape propagation or"
                         " re-search the plan for the rewritten graph"))
            # sequence-dim composition, same shape of gap
            if (s.sp > 1 and len(tdims) >= 3 and len(odims) >= 3
                    and odims[1] % s.sp == 0 and tdims[1] != odims[1]
                    and tdims[1] % s.sp):
                diags.append(make_diag(
                    "FFTA093",
                    f"input {t.name!r} has sequence dim {tdims[1]}, not"
                    f" divisible by sp={s.sp}, while the op's own output"
                    f" ({odims[1]}) is — the edge no longer composes",
                    op))
        return diags

    def _overwrite_checks(self, op, pos, consumers) -> List[Diagnostic]:
        """FFTA094: an in-place op overwrites its first input's buffer;
        any consumer of that tensor scheduled AFTER this op reads a
        clobbered value. (Same hazard class as donation under the
        elastic retry wrapper — FFTA030 — but provable per-edge from
        the abstract state rather than a config-level warning.)"""
        diags: List[Diagnostic] = []
        if not op.inputs:
            return diags
        t = op.inputs[0]
        my_pos = pos[op.guid]
        for cpos, consumer in consumers.get(t.guid, ()):
            if cpos > my_pos:
                diags.append(make_diag(
                    "FFTA094",
                    f"op overwrites its input {t.name!r} in place, but"
                    f" {consumer.name!r} still reads that tensor later"
                    " in the schedule", op,
                    hint="drop the in-place/donation marking or"
                         " re-order so every reader runs first"))
        return diags


# ---------------------------------------------------------------------
# the collective-program model checker (FFTA090/091/092)
# ---------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One grouped collective of the executed schedule: all members of
    every group must issue it (same kind, same tag, same phase, same
    group) before any of them can proceed."""

    kind: str               # PSUM | PSUM_SCATTER | ALL_GATHER | TRANSFER
    tag: str                # sync key: op name, "bucket:<id>", move/round
    phase: int              # index within the tag's decomposition
    groups: Tuple[Tuple[int, ...], ...]


def _expand_allreduce(tag: str, strategy: str, degree: int,
                      sizes: Sequence[int]) -> List[CollectiveEvent]:
    """The event sequence lower_allreduce emits for one synced tensor
    (or fused bucket) — one event per lax.* call, in issue order."""
    from ..runtime.collectives import tier_axis_groups

    full = (tuple(range(degree)),)
    if strategy == "flat" or len(sizes) <= 1:
        return [CollectiveEvent(PSUM, tag, 0, full)]
    levels = [tuple(tuple(g) for g in lvl)
              for lvl in tier_axis_groups(degree, list(sizes))]
    if strategy == "hier_ring":
        return [CollectiveEvent(PSUM, tag, j, lvl)
                for j, lvl in enumerate(levels)]
    if strategy == "rs_ar_ag":
        ev = [CollectiveEvent(PSUM_SCATTER, tag, j, lvl)
              for j, lvl in enumerate(levels[:-1])]
        ev.append(CollectiveEvent(PSUM, tag, len(levels) - 1, levels[-1]))
        ev.extend(CollectiveEvent(ALL_GATHER, tag, len(levels) + j, lvl)
                  for j, lvl in enumerate(reversed(levels[:-1])))
        return ev
    raise ValueError(f"unknown reduction strategy {strategy!r}")


def build_grad_sync_program(lowering) -> List[CollectiveEvent]:
    """The global collective program a GradSyncLowering executes:
    entries in (topo) order, bucketed entries collapsed to ONE event
    sequence per bucket at the first member's position (sync_tree fuses
    bucket mates into one collective over their concatenated grads)."""
    events: List[CollectiveEvent] = []
    seen_buckets = set()
    for name, e in lowering.entries.items():
        bid = e.get("bucket")
        if bid is not None:
            if bid in seen_buckets:
                continue
            seen_buckets.add(bid)
            tag = f"bucket:{bid}"
        else:
            tag = name
        events.extend(_expand_allreduce(
            tag, str(e.get("strategy", "flat")), lowering.degree,
            list(e.get("sizes") or [lowering.degree])))
    return events


def check_event_partitions(events: Sequence[CollectiveEvent],
                           degree: Optional[int] = None,
                           full_cover: bool = True) -> List[Diagnostic]:
    """Static FFTA091 check: each event's groups must be pairwise
    disjoint with in-range members and (for grad-sync programs, where a
    tier level spans the whole axis) cover every participant — a member
    listed twice or a participant no group names issues a different
    collective sequence than its mates expect."""
    diags: List[Diagnostic] = []
    for ev in events:
        seen: set = set()
        dup = sorted({p for g in ev.groups for p in g
                      if p in seen or seen.add(p)})
        if dup:
            diags.append(make_diag(
                "FFTA091",
                f"{ev.kind} {ev.tag!r} phase {ev.phase}: participants"
                f" {dup} appear in more than one axis_index_group —"
                " overlapping groups race on the same program point"))
        if degree is not None:
            bad = sorted(p for p in seen if not 0 <= p < degree)
            if bad:
                diags.append(make_diag(
                    "FFTA091",
                    f"{ev.kind} {ev.tag!r} phase {ev.phase}: members"
                    f" {bad} outside the axis [0, {degree})"))
            if full_cover and not dup and not bad \
                    and seen != set(range(degree)):
                missing = sorted(set(range(degree)) - seen)
                diags.append(make_diag(
                    "FFTA091",
                    f"{ev.kind} {ev.tag!r} phase {ev.phase}: groups do"
                    f" not cover participants {missing} — the uncovered"
                    " chips never issue this collective and their group"
                    " mates block forever"))
    return diags


def participant_programs(events: Sequence[CollectiveEvent],
                         participants: Iterable[int]
                         ) -> Dict[int, List[tuple]]:
    """Project the global program to per-participant instruction lists:
    participant p's view of an event is (kind, tag, phase, its group).
    A participant no group names skips the event — legal for reshard
    programs (subset steps), caught by check_event_partitions for
    grad-sync ones."""
    programs: Dict[int, List[tuple]] = {p: [] for p in participants}
    for ev in events:
        for g in ev.groups:
            for p in g:
                if p in programs:
                    programs[p].append((ev.kind, ev.tag, ev.phase,
                                        tuple(g)))
    return programs


def check_program_uniformity(programs: Dict[int, List[tuple]]
                             ) -> List[Diagnostic]:
    """Dynamic deadlock/uniformity check: greedily run the blocking-
    collective semantics — an instruction fires when every member of its
    group sits at an IDENTICAL head — until the programs drain or no
    event is ready. Collective events are the only synchronization, so
    the greedy schedule is complete: if it gets stuck, every schedule
    does. Stuck-state triage: heads that disagree at the same sync tag
    are FFTA091 (non-uniform sequences); heads blocked on partners
    waiting inside a DIFFERENT tag form a wait-for graph whose cycle is
    FFTA092 (cross-group ordering deadlock)."""
    pc = {p: 0 for p in programs}
    diags: List[Diagnostic] = []
    while True:
        progressed = False
        for p in sorted(programs):
            if pc[p] >= len(programs[p]):
                continue
            head = programs[p][pc[p]]
            kind, tag, phase, group = head
            if p not in group:
                return [make_diag(
                    "FFTA091",
                    f"participant {p} issues {kind} {tag!r} phase"
                    f" {phase} over group {list(group)}, which excludes"
                    " it — it would block on a collective it is not a"
                    " member of")]
            if all(q in programs and pc[q] < len(programs[q])
                   and programs[q][pc[q]] == head for q in group):
                for q in group:
                    pc[q] += 1
                progressed = True
        if not progressed:
            break
    blocked = sorted(p for p in programs if pc[p] < len(programs[p]))
    if not blocked:
        return diags
    mismatched_tags = set()
    edges = set()
    for p in blocked:
        kind, tag, phase, group = programs[p][pc[p]]
        for q in group:
            if q == p:
                continue
            if q not in programs or pc[q] >= len(programs[q]):
                if tag not in mismatched_tags:
                    mismatched_tags.add(tag)
                    diags.append(make_diag(
                        "FFTA091",
                        f"participant {p} blocks on {kind} {tag!r}"
                        f" phase {phase} but group mate {q}'s program"
                        " ends without issuing it — the collective"
                        " never completes"))
                continue
            qk, qt, qp, qg = programs[q][pc[q]]
            if qt == tag:
                if (qk, qp, qg) != (kind, phase, group) \
                        and tag not in mismatched_tags:
                    mismatched_tags.add(tag)
                    diags.append(make_diag(
                        "FFTA091",
                        f"participants {p} and {q} disagree at sync"
                        f" point {tag!r}: {kind}/phase {phase} over"
                        f" {list(group)} vs {qk}/phase {qp} over"
                        f" {list(qg)} — non-uniform collective"
                        " sequences deadlock the group"))
            else:
                edges.add((tag, qt))
    cycle = _find_cycle(edges)
    if cycle:
        diags.append(make_diag(
            "FFTA092",
            "cross-group ordering cycle in the interleaved schedule: "
            + " -> ".join(repr(t) for t in cycle)
            + " — each sync point waits on a participant parked inside"
              " the next, so no group can ever complete",
            hint="issue the interleaved collectives in one global order"
                 " on every participant"))
    elif not diags:
        diags.append(make_diag(
            "FFTA091",
            f"participants {blocked} block with no ready collective —"
            " the executed program is not SPMD-uniform"))
    return diags


def _find_cycle(edges: set) -> Optional[List[str]]:
    """First cycle of the tag wait-for graph (DFS), as the tag list."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    state: Dict[str, int] = {}  # 1 = on stack, 2 = done
    stack: List[str] = []

    def visit(t: str) -> Optional[List[str]]:
        state[t] = 1
        stack.append(t)
        for u in adj.get(t, ()):
            if state.get(u) == 1:
                return stack[stack.index(u):] + [u]
            if state.get(u) is None:
                c = visit(u)
                if c:
                    return c
        stack.pop()
        state[t] = 2
        return None

    for t in sorted(adj):
        if state.get(t) is None:
            c = visit(t)
            if c:
                return c
    return None


def verify_grad_sync_program(lowering, graph: Optional[Graph] = None,
                             strategies: Optional[Dict[int, object]] = None
                             ) -> List[Diagnostic]:
    """Full verification of an explicit grad-sync schedule: FFTA090
    discharge (every pending weight gradient has a schedule entry),
    static group legality, then the uniformity/deadlock simulation.
    This is the mandatory gate plan_grad_sync_lowering runs before the
    lowering's collectives are ever jitted."""
    diags: List[Diagnostic] = []
    if graph is not None:
        pending = gradient_state(graph, strategies)
        ops_by_name = {op.name: op for op in graph.ops.values()}
        for name, axes in pending.items():
            if axes and name not in lowering.entries:
                diags.append(make_diag(
                    "FFTA090",
                    f"weight gradient of {name!r} is a pending partial"
                    f" sum over {sorted(axes)} but the executed schedule"
                    " never discharges it — the optimizer would apply"
                    " an unreduced gradient", ops_by_name.get(name),
                    hint="recompile so the lowering covers every synced"
                         " tensor of this graph"))
    try:
        events = build_grad_sync_program(lowering)
    except Exception as exc:
        diags.append(make_diag(
            "FFTA091",
            f"the executed collective program cannot be constructed:"
            f" {exc}"))
        return diags
    static = check_event_partitions(events, lowering.degree,
                                    full_cover=True)
    diags.extend(static)
    if not static:
        programs = participant_programs(events, range(lowering.degree))
        diags.extend(check_program_uniformity(programs))
    return diags


def semantic_reduction_diagnostics(ctx) -> List[Diagnostic]:
    """The semantic layer over FFTA072's name matching: interpret the
    graph's backward under the plan and require the EXECUTED schedule to
    discharge every pending gradient (FFTA090). Name/strategy/bucket
    drift stays FFTA072's domain (append-only code contract); this check
    catches the case both records dropped — a synced tensor neither the
    priced plan nor the lowering covers interprets to an undischarged
    partial sum, which no name comparison can see."""
    executed = getattr(ctx, "executed_reductions", None)
    if executed is None:
        return []
    diags: List[Diagnostic] = []
    pending = gradient_state(ctx.graph, ctx.strategies)
    ops_by_name = {op.name: op for op in ctx.graph.ops.values()}
    for name, axes in pending.items():
        if axes and name not in executed:
            diags.append(make_diag(
                "FFTA090",
                f"weight gradient of {name!r} interprets to a partial"
                f" sum pending over {sorted(axes)}, and the executed"
                " collective schedule never discharges it",
                ops_by_name.get(name),
                hint="recompile so the lowering and the plan derive"
                     " from the same graph"))
    return diags


# ---------------------------------------------------------------------
# redistribution schedules (FFTA06x rounds as a collective program)
# ---------------------------------------------------------------------
def _mesh_axis_groups(mesh, axis: str) -> Tuple[Tuple[int, ...], ...]:
    """Device groups of `mesh` along named `axis` (row-major device
    order, last axis fastest — MeshSpec's convention): each group holds
    the devices whose coordinates agree everywhere but on `axis`."""
    names = [a for a, _ in mesh.axes]
    sizes = [s for _, s in mesh.axes]
    j = names.index(axis)
    n = min(mesh.n_mesh_devices, len(mesh.device_ids))
    groups: Dict[tuple, List[int]] = {}
    for posn in range(n):
        rem, coords = posn, []
        for s in reversed(sizes):
            coords.append(rem % s)
            rem //= s
        coords.reverse()
        key = tuple(c for i, c in enumerate(coords) if i != j)
        groups.setdefault(key, []).append(int(mesh.device_ids[posn]))
    return tuple(tuple(g) for _, g in sorted(groups.items()))


def build_reshard_program(schedule) -> Tuple[List[CollectiveEvent],
                                             List[int]]:
    """Project a ReshardSchedule onto the collective-program model:
    moves run serially, each move's rounds serially, each round's steps
    in order (resharding/plan.py's execution contract). ALLGATHER steps
    group the OLD mesh along their axis; TRANSFER/PERMUTE rounds are one
    synchronization over every involved device; SLICE is chip-local and
    emits no event. Returns (events, all participant ids)."""
    from ..resharding.plan import ALLGATHER as RS_ALLGATHER
    from ..resharding.plan import PERMUTE as RS_PERMUTE
    from ..resharding.plan import TRANSFER as RS_TRANSFER

    devices = sorted(set(int(d) for d in schedule.old_mesh.device_ids)
                     | set(int(d) for d in schedule.new_mesh.device_ids))
    all_group = (tuple(devices),)
    events: List[CollectiveEvent] = []
    for move in schedule.moves:
        for r in range(max(1, int(move.rounds))):
            for i, step in enumerate(move.steps):
                tag = f"{move.path}/r{r}/s{i}"
                if step.kind == RS_ALLGATHER and step.axis \
                        and step.axis in schedule.old_mesh.axis_sizes:
                    groups = _mesh_axis_groups(schedule.old_mesh,
                                               step.axis)
                    events.append(CollectiveEvent(ALL_GATHER, tag, 0,
                                                  groups))
                elif step.kind in (RS_TRANSFER, RS_PERMUTE):
                    events.append(CollectiveEvent(TRANSFER, tag, 0,
                                                  all_group))
    return events, devices


def verify_reshard_program(schedule) -> List[Diagnostic]:
    """Uniformity/deadlock verification of a live-resharding schedule's
    collective rounds — the FFTA06x analog of verify_grad_sync_program
    (legality and memory stay redistribution_diagnostics' domain)."""
    events, devices = build_reshard_program(schedule)
    # subset participation is legal here (an allgather only involves
    # the old mesh), so no full-cover requirement
    diags = check_event_partitions(events, degree=None, full_cover=False)
    if not diags:
        diags = check_program_uniformity(
            participant_programs(events, devices))
    return diags


# ---------------------------------------------------------------------
# the pipeline pass ("flow" in PASS_REGISTRY / CHEAP_PASSES)
# ---------------------------------------------------------------------
def pass_sharding_flow(ctx) -> List[Diagnostic]:
    """The layout-only verifier subset that rides the compile gate:
    forward abstract interpretation (FFTA093/FFTA094) plus — when the
    context carries an executed schedule — the semantic FFTA090
    discharge check. Machine-model-free and strategy-optional, so it is
    safe in CHEAP_PASSES; the full program model checker runs where the
    schedule exists (plan_grad_sync_lowering / check_redistribution)."""
    interp = ShardingFlowInterpreter(ctx.graph, ctx.strategies,
                                     batch_size=ctx.batch_size)
    diags = interp.run()
    diags.extend(semantic_reduction_diagnostics(ctx))
    return diags
