"""Static analysis passes over (PCG, strategies, machine).

Each pass is a pure function `AnalysisContext -> List[Diagnostic]` covering
one family of plan-legality properties:

 1. divisibility/degree   — every partition degree divides the dimension it
    shards and can actually be realized by the strategy assignment;
 2. memory fit            — per-chip bytes (params + optimizer state +
    saved activations, via CostModel.op_memory_bytes) vs HBM capacity;
 3. collective legality   — one degree per mesh axis, legal reduction
    (row-parallel) pairings, no reshard ping-pong, mesh fits the devices;
 4. aliasing/donation     — donation hazards under the elastic retry
    wrapper (the hazard that disabling train-step donation avoids);
 5. graph hygiene         — dangling producers, stale tensor_aliases
    chains, unreachable ops, mixed-dtype elementwise boundaries.

The passes never mutate the graph and never import jax. The Unity search
prunes with the still-cheaper `factorization_diagnostics` below, which
checks a mesh tuple without needing per-op strategies.

The port's copy of flexflow_tpu/analysis/passes.py: `pass_moe` reads the
port's ops/moe.py helpers; `redistribution_diagnostics` and
`survivor_diagnostics` read the port's resharding/ schedules and plans.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from ..core.graph import Graph
from ..ffconst import OpType
from .diagnostics import Diagnostic, make_diag

# strategy field -> the mesh axis it shards over (one convention with
# unity.mesh_axes_for and FFModel._assign_strategy)
AXIS_OF_FIELD = {"dp": "data", "tp": "model", "ep": "expert",
                 "ap": "attr", "sp": "seq"}

_EW_BINARY = {OpType.EW_ADD, OpType.EW_SUB, OpType.EW_MUL, OpType.EW_DIV,
              OpType.EW_MAX, OpType.EW_MIN}


@dataclasses.dataclass
class AnalysisContext:
    """Inputs of one pipeline run. `strategies` maps op guid -> OpStrategy
    (None entries fall back to the replicated default); `machine` may be
    None, in which case the memory-fit pass is skipped."""

    graph: Graph
    strategies: Optional[Dict[int, object]] = None
    mesh_axes: Optional[Dict[str, int]] = None
    machine: Optional[object] = None
    config: Optional[object] = None
    batch_size: Optional[int] = None
    n_devices: Optional[int] = None
    final_guid: Optional[int] = None
    # per-tier reduction decomposition the plan carries (SearchResult
    # .reduction_strategies / FFModel._reduction_plan) for the FFTA07x
    # pass. None = the plan does not pin one yet and compile() will
    # synthesize it (checked against the machine's own choice); a dict
    # missing an op means that op's sync is UN-decomposed (flat) — what a
    # plan searched under a flat machine model carries.
    reduction_strategies: Optional[Dict[str, dict]] = None
    # what the explicit collective lowering ACTUALLY lowered ({op name:
    # strategy}, GradSyncLowering.executed_plan()). None = GSPMD runs
    # the schedule, nothing to compare. When set, the FFTA072 check
    # fails loudly on any plan entry the lowering dropped/renamed —
    # analysis of an explicit-lowered plan must describe the executed
    # schedule, not the record (docs/analysis.md).
    executed_reductions: Optional[Dict[str, str]] = None
    # the executed BUCKET schedule ({op name: bucket id or None},
    # GradSyncLowering.executed_buckets()) — the extended FFTA072 check
    # compares it against the priced plan's bucket assignment
    # (docs/machine.md "Overlap"): a lowering that regrouped, split, or
    # dropped a priced bucket executes a schedule the overlap term
    # never priced. None = no bucket comparison (GSPMD, or a
    # pre-bucketing caller).
    executed_buckets: Optional[Dict[str, Optional[int]]] = None

    def strategy_of(self, op):
        if not self.strategies:
            return None
        return self.strategies.get(op.guid)


def default_strategies_for(graph: Graph, mesh_axes: Dict[str, int],
                           batch_size: Optional[int]) -> Dict[int, object]:
    """Per-op strategies a mesh-wide default assignment realizes — mirrors
    FFModel._assign_strategy's guards, so analyzing a no-search compile
    sees the degrees that will actually apply."""
    from ..search.simulator import (AP_CAPABLE, OpStrategy, TP_CAPABLE,
                                    sp_shardable)
    from ..search.unity import _ap_divides, _tp_divides

    dp = mesh_axes.get("data", 1)
    tp = mesh_axes.get("model", 1)
    ap = mesh_axes.get("attr", 1)
    sp = mesh_axes.get("seq", 1)
    ep = mesh_axes.get("expert", 1)
    out: Dict[int, object] = {}
    for op in graph.ops.values():
        t = op.outputs[0] if op.outputs else None
        op_dp = dp if (dp > 1 and t is not None and t.dims
                       and t.dims[0] == batch_size
                       and t.dims[0] % dp == 0) else 1
        op_tp = tp if (tp > 1 and op.op_type in TP_CAPABLE
                       and _tp_divides(op, tp)) else 1
        op_ap = ap if (ap > 1 and op.op_type in AP_CAPABLE
                       and _ap_divides(op, ap)) else 1
        # mirror _assign_strategy's attention-dropout exception: the SP
        # kernels have no attention-prob dropout, so that op stays
        # unsharded — without this the memory pass would size its
        # activations divided by sp and miss a real per-chip overflow
        op_sp = sp if (sp_shardable(op, sp)
                       and not (op.op_type == OpType.MULTIHEAD_ATTENTION
                                and op.params.get("dropout", 0.0) > 0)) \
            else 1
        op_ep = ep if (ep > 1 and op.op_type == OpType.EXPERTS
                       and op.params["n"] % ep == 0) else 1
        out[op.guid] = OpStrategy(dp=op_dp, tp=op_tp, ep=op_ep, ap=op_ap,
                                  sp=op_sp)
    return out


# ---------------------------------------------------------------------
# pass 1: divisibility / degree
# ---------------------------------------------------------------------
def pass_divisibility(ctx: AnalysisContext) -> List[Diagnostic]:
    from ..search.simulator import AP_CAPABLE, TP_CAPABLE, sp_capability
    from ..search.unity import _ap_divides, _tp_divides

    diags: List[Diagnostic] = []
    if not ctx.strategies:
        return diags
    batch = ctx.batch_size
    for op in ctx.graph.ops.values():
        s = ctx.strategy_of(op)
        if s is None:
            continue
        if ctx.n_devices and s.degree > ctx.n_devices:
            diags.append(make_diag(
                "FFTA003",
                f"strategy degree {s.degree} (dp={s.dp} tp={s.tp} ep={s.ep}"
                f" ap={s.ap} sp={s.sp}) exceeds the {ctx.n_devices}-device"
                " machine", op,
                hint="shrink the strategy or grow the device pool"))
        if s.dp > 1:
            t = op.outputs[0] if op.outputs else None
            if t is None or not t.dims:
                diags.append(make_diag(
                    "FFTA002", f"dp={s.dp} on an op with no batched output",
                    op))
            elif batch is not None and t.dims[0] != batch:
                diags.append(make_diag(
                    "FFTA002",
                    f"dp={s.dp} requested but the leading dim is"
                    f" {t.dims[0]}, not the batch ({batch}); the op runs"
                    " replicated", op,
                    hint="the cost model over-promises here; prefer dp=1"))
            elif t.dims[0] % s.dp:
                diags.append(make_diag(
                    "FFTA001",
                    f"dp={s.dp} does not divide the batch dim {t.dims[0]}",
                    op, hint=f"choose a divisor of {t.dims[0]}"))
        if s.tp > 1:
            if op.op_type not in TP_CAPABLE:
                diags.append(make_diag(
                    "FFTA002",
                    f"tp={s.tp} on a non-tensor-parallel op"
                    f" ({op.op_type.value})", op))
            elif not _tp_divides(op, s.tp):
                diags.append(make_diag(
                    "FFTA001",
                    f"tp={s.tp} does not divide the op's sharded channel"
                    " dim (out_dim/heads)", op,
                    hint="choose a divisor of the channel dimension"))
        if s.ep > 1:
            if op.op_type != OpType.EXPERTS:
                diags.append(make_diag(
                    "FFTA002", f"ep={s.ep} on a non-EXPERTS op", op))
            elif op.params["n"] % s.ep:
                diags.append(make_diag(
                    "FFTA001",
                    f"ep={s.ep} does not divide the expert count"
                    f" {op.params['n']}", op))
        if s.ap > 1:
            if op.op_type not in AP_CAPABLE:
                diags.append(make_diag(
                    "FFTA002", f"ap={s.ap} on a non-spatial op", op))
            elif not _ap_divides(op, s.ap):
                diags.append(make_diag(
                    "FFTA001",
                    f"ap={s.ap} does not divide the spatial (H) dims or"
                    " breaks stride alignment", op))
        if s.sp > 1:
            if not sp_capability(op):
                diags.append(make_diag(
                    "FFTA002",
                    f"sp={s.sp} on an op with no position dim", op))
            elif op.outputs[0].dims[1] % s.sp:
                diags.append(make_diag(
                    "FFTA001",
                    f"sp={s.sp} does not divide the sequence dim"
                    f" {op.outputs[0].dims[1]}", op))
    return diags


_UNSET = object()


def factorization_diagnostics(graph: Graph, config, batch_size: int,
                              factorization, sp_pred=_UNSET,
                              expert_counts=None,
                              has_spatial=None,
                              pod_degree=None) -> List[Diagnostic]:
    """Cheap legality of one (dp, tp, ep, ap, sp) mesh factorization —
    exactly the feasibility conditions GraphSearchHelper._parallelize
    enforces, expressed as diagnostics so the search can prune (and count)
    infeasible candidates before the cost simulator sees them. sp_pred /
    expert_counts / has_spatial: precomputed make_sp_feasible result and
    graph-scan facts, so a caller sweeping many tuples does not rebuild
    them per tuple. pod_degree (multi-tier machines only): degree of the
    innermost tier — the expert-parallel group, whose device span is
    ep x its inner stride (sp x ap, the axes nested inside it), must fit
    within it so the per-step routing all_to_all never touches DCN
    (FFTA085, docs/moe.md "Search")."""
    from ..search.simulator import AP_CAPABLE
    from ..search.unity import make_sp_feasible

    dp, tp, ep, ap, sp = factorization
    diags: List[Diagnostic] = []
    if batch_size % dp:
        diags.append(make_diag(
            "FFTA001", f"dp={dp} does not divide the batch {batch_size}"))
    if ep > 1:
        if expert_counts is None:
            expert_counts = {op.params["n"] for op in graph.ops.values()
                             if op.op_type == OpType.EXPERTS}
        if not expert_counts:
            diags.append(make_diag(
                "FFTA004", f"ep={ep}: the graph has no EXPERTS ops"))
        elif any(n % ep for n in expert_counts):
            diags.append(make_diag(
                "FFTA001",
                f"ep={ep} does not divide every expert count"
                f" ({sorted(expert_counts)})"))
        if pod_degree and ep > 1 and ep * ap * sp > pod_degree:
            diags.append(make_diag(
                "FFTA085",
                f"ep={ep} spans {ep * ap * sp} devices (inner stride"
                f" ap*sp={ap * sp}) but the pod holds {pod_degree}: the"
                " routing all_to_all would cross DCN"))
    if ap > 1:
        if has_spatial is None:
            has_spatial = any(op.op_type in AP_CAPABLE
                              for op in graph.ops.values())
        if not (config.enable_attribute_parallel and has_spatial):
            diags.append(make_diag(
                "FFTA004",
                f"ap={ap}: attribute parallelism disabled or no spatial"
                " ops"))
    if sp > 1:
        pred = make_sp_feasible(graph, config) if sp_pred is _UNSET else sp_pred
        if pred is None or not pred(sp):
            diags.append(make_diag(
                "FFTA004",
                f"sp={sp}: sequence parallelism infeasible (disabled, no"
                " attention, dropout-carrying attention, or lengths/heads"
                " do not divide)"))
    return diags


# ---------------------------------------------------------------------
# pass 2: memory fit
# ---------------------------------------------------------------------
def plan_memory_bytes(graph: Graph, machine, config=None, strategies=None,
                      optimizer_state_factor: Optional[float] = None):
    """Per-chip bytes of a plan (sharded weights x optimizer-state factor +
    saved activations) via CostModel.op_memory_bytes. Returns
    (total_bytes, worst_op, worst_op_bytes). Shared by the FFTA010/011
    memory-fit gate below and the serving KV-pool sizing
    (serving/sched/kvpool.py), so "what fits in HBM" has ONE definition.
    optimizer_state_factor=1.0 sizes an inference deployment (weights
    only, no optimizer moments)."""
    from ..search.simulator import CostModel, OpStrategy

    cost = CostModel(machine, config)
    if optimizer_state_factor is not None:
        cost.opt_state_factor = float(optimizer_state_factor)
    default = OpStrategy()
    total = 0.0
    worst_op, worst_bytes = None, -1.0
    for op in graph.ops.values():
        s = (strategies or {}).get(op.guid) or default
        try:
            b = cost.op_memory_bytes(op, s)
        except Exception:
            continue  # exotic op the cost model can't size: not a verdict
        total += b
        if b > worst_bytes:
            worst_op, worst_bytes = op, b
    return total, worst_op, worst_bytes


def pass_memory_fit(ctx: AnalysisContext) -> List[Diagnostic]:
    if ctx.machine is None:
        return []
    from .diagnostics import Severity

    total, worst_op, worst_bytes = plan_memory_bytes(
        ctx.graph, ctx.machine, ctx.config, ctx.strategies)
    cap = ctx.machine.memory_budget_bytes()
    # an explicitly set --memory-budget is authoritative, the way the
    # memory-aware Unity/MCMC searches treat it — the gate and the search
    # must agree on what fits (a host-RAM run can legitimately exceed the
    # nominal chip spec). The untouched class default defers to the
    # machine spec, so a shrunken/small machine still gates correctly.
    if ctx.config is not None:
        budget_mb = getattr(ctx.config, "memory_budget_mb", None)
        default_mb = getattr(type(ctx.config), "memory_budget_mb", None)
        if budget_mb is not None and budget_mb != default_mb:
            cap = budget_mb * 1e6
    if cap <= 0:
        return []
    # pipeline ('stage') sharding lives outside OpStrategy — the GPipe
    # region shards weights/opt-state S-ways, which this per-op sum cannot
    # see. A memory-motivated pipeline plan would be wrongly rejected, so
    # overflow degrades to a warning under a stage axis.
    stages = (ctx.mesh_axes or {}).get("stage", 1)
    if total > cap:
        return [make_diag(
            "FFTA010",
            f"plan needs {total / 1e9:.2f} GB/chip but HBM is"
            f" {cap / 1e9:.2f} GB (largest op:"
            f" {worst_op.name if worst_op else '?'} at"
            f" {worst_bytes / 1e9:.2f} GB)"
            + (f"; estimate ignores {stages}-way stage sharding"
               if stages > 1 else ""),
            hint="shard weights (tp/ep), raise --memory-budget, or relax"
                 " the gate with --plan-analysis warn",
            severity=Severity.WARNING if stages > 1 else None)]
    if total > 0.85 * cap:
        return [make_diag(
            "FFTA011",
            f"plan needs {total / 1e9:.2f} GB/chip, above 85% of the"
            f" {cap / 1e9:.2f} GB HBM — fragmentation/workspace may OOM")]
    return []


# ---------------------------------------------------------------------
# pass 3: collective legality
# ---------------------------------------------------------------------
def pass_collectives(ctx: AnalysisContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    axes = ctx.mesh_axes or {}
    if axes and ctx.n_devices:
        need = 1
        for v in axes.values():
            need *= v
        if need > ctx.n_devices:
            diags.append(make_diag(
                "FFTA023",
                f"mesh axes {axes} need {need} devices, have"
                f" {ctx.n_devices}"))
    if not ctx.strategies:
        return diags
    for op in ctx.graph.ops.values():
        s = ctx.strategy_of(op)
        if s is None:
            continue
        for field, axis in AXIS_OF_FIELD.items():
            deg = getattr(s, field)
            if deg <= 1:
                continue
            have = axes.get(axis)
            if have is None:
                if axes:  # no declared axes at all -> nothing to conflict
                    diags.append(make_diag(
                        "FFTA002",
                        f"{field}={deg} but the mesh has no {axis!r} axis;"
                        " the degree degrades to replicated", op))
            elif have != deg:
                diags.append(make_diag(
                    "FFTA021",
                    f"{field}={deg} conflicts with mesh axis"
                    f" {axis!r}={have}: one axis cannot carry two degrees",
                    op,
                    hint="all ops sharding an axis must use its full size"))
        if s.tp_row:
            if op.op_type != OpType.LINEAR:
                diags.append(make_diag(
                    "FFTA020",
                    "row-parallel (reduction) strategy on a non-LINEAR op",
                    op))
            elif s.tp > 1 and op.inputs and op.inputs[0].dims \
                    and op.inputs[0].dims[-1] % s.tp:
                diags.append(make_diag(
                    "FFTA020",
                    f"row-parallel tp={s.tp} does not divide the input"
                    f" feature dim {op.inputs[0].dims[-1]}", op))
    # reshard ping-pong: producer gathered to a coarser degree only for a
    # consumer to re-partition back (legal, but two collectives that a
    # degree-consistent chain avoids)
    for op in ctx.graph.topo_order():
        s = ctx.strategy_of(op)
        if s is None:
            continue
        finer_producer = any(
            (ctx.strategy_of(t.owner_op) is not None
             and ctx.strategy_of(t.owner_op).dp > s.dp)
            for t in op.inputs
            if t.owner_op is not None and t.owner_op.guid in ctx.graph.ops)
        if not finer_producer:
            continue
        for con in ctx.graph.successors(op):
            cs = ctx.strategy_of(con)
            if cs is not None and cs.dp > s.dp:
                diags.append(make_diag(
                    "FFTA022",
                    f"dp degree dips to {s.dp} here between finer-sharded"
                    f" producer and consumer (dp={cs.dp}): gather followed"
                    " by re-partition", op,
                    hint="keep the chain at one dp degree"))
                break
    return diags


# ---------------------------------------------------------------------
# pass 6 (FFTA07x): cross-tier collective legality
# ---------------------------------------------------------------------
# per-step collectives pushing more than this across the OUTERMOST tier
# (the DCN on a multi-pod spec) draw an FFTA071 warning — at DCN-class
# bandwidth (a few GB/s) 64 MB is already ~20 ms of per-step exposure
DCN_STEP_BYTES_WARN = 64e6


def check_executed_reductions(ctx: AnalysisContext) -> List[Diagnostic]:
    """FFTA072: with an explicit collective lowering active, the priced
    reduction plan and the executed schedule must describe the same
    tensors the same way — an op the lowering dropped or renamed, a
    strategy it substituted, or a BUCKET it regrouped (docs/machine.md
    "Overlap"), means every FFTA07x verdict (and the cost model's
    grad-sync/overlap price) talks about a schedule that never ran."""
    import math as _math

    diags: List[Diagnostic] = []
    executed = ctx.executed_reductions
    if executed is None or ctx.reduction_strategies is None:
        return diags
    ops_by_name = {op.name: op for op in ctx.graph.ops.values()}
    for name, entry in ctx.reduction_strategies.items():
        planned = (entry or {}).get("strategy", "flat")
        ran = executed.get(name)
        # the lowering's DOCUMENTED conservative fallback is legal: when
        # the plan's tier groups do not multiply to the sync degree
        # (tier_path's round-up on a non-factoring mesh), the entry
        # cannot be expressed as axis groups and syncs flat, un-bucketed
        # — that is the lowering working as specified, not
        # plan<->execution drift
        groups = [int(t.get("group", 0))
                  for t in (entry or {}).get("tiers", [])]
        degree = int((entry or {}).get("degree") or 0)
        expressible = bool(groups) and degree > 0 \
            and _math.prod(groups) == degree
        if ran is None:
            diags.append(make_diag(
                "FFTA072",
                f"reduction plan names {name!r} ({planned}) but the"
                " explicit lowering dropped or renamed it — the"
                " executed schedule never syncs this tensor",
                ops_by_name.get(name),
                hint="recompile so the lowering and the plan come from"
                     " the same graph; a rewrite that renames ops must"
                     " re-synthesize the reduction plan"))
            continue
        if ran != planned:
            if ran == "flat" and not expressible:
                continue
            diags.append(make_diag(
                "FFTA072",
                f"reduction plan prices {name!r} as {planned} but the"
                f" lowering executed {ran} — the analysis would judge a"
                " schedule that never ran", ops_by_name.get(name)))
            continue
        # bucket-schedule check (docs/machine.md "Overlap"): the bucket
        # the overlap term priced this tensor into must be the bucket
        # the lowering fuses it into — a regrouped/split/dropped bucket
        # overlaps differently than priced
        if ctx.executed_buckets is not None:
            planned_b = (entry or {}).get("bucket")
            ran_b = ctx.executed_buckets.get(name)
            # the ONLY legal divergence is the non-factoring flat
            # fallback, which drops the bucket to None along with the
            # decomposition — a non-expressible entry regrouped into a
            # DIFFERENT bucket is still drift
            if planned_b != ran_b and not (ran_b is None
                                           and not expressible):
                diags.append(make_diag(
                    "FFTA072",
                    f"reduction plan buckets {name!r} into"
                    f" {planned_b!r} but the lowering fused it into"
                    f" {ran_b!r} — the executed bucket schedule"
                    " diverges from the priced overlap schedule",
                    ops_by_name.get(name),
                    hint="recompile so plan and lowering derive the"
                         " bucket schedule from the same graph and"
                         " --grad-bucket-bytes"))
    return diags


def pass_tier_collectives(ctx: AnalysisContext) -> List[Diagnostic]:
    """Hierarchical-machine legality (docs/machine.md):

     - FFTA070 (error): a synced tensor whose reduction group spans a
       tier boundary is pinned to a NON-tier-decomposable (flat)
       strategy — a flat ring across the DCN serializes every step on
       the slowest link; the plan must carry rs_ar_ag or hier_ring
       there. Plans that carry no decomposition yet (ctx
       .reduction_strategies is None) are checked against the machine's
       own synthesized choice, which is always decomposable.
     - FFTA071 (warning): a per-step collective (gradient sync or a
       tensor-parallel activation collective) pushes more than
       DCN_STEP_BYTES_WARN across the outermost tier — legal, but the
       cross-DCN traffic will dominate the step.
     - FFTA072 (error, check_executed_reductions): the explicit
       lowering's executed schedule diverges from the priced plan —
       checked whenever ctx.executed_reductions is set, on flat
       machines too (the lowering runs wherever a 'data' axis does).

    The tier checks no-op on flat machine models."""
    diags: List[Diagnostic] = list(check_executed_reductions(ctx))
    machine = ctx.machine
    if machine is None or not hasattr(machine, "tier_path"):
        return diags
    from ..search.simulator import (AP_CAPABLE, CostModel, OpStrategy,
                                    TP_CAPABLE)
    strategies = ctx.strategies or {}
    reds = ctx.reduction_strategies
    cost = CostModel(machine, ctx.config)
    # axis strides come from the realized mesh, exactly as the simulator
    # prices them (an op replicated over the model axis still has its dp
    # groups strided across it)
    cost.set_mesh_context(strategies)
    default = OpStrategy()
    outer_name = machine.tiers[-1].name
    for op in ctx.graph.ops.values():
        s = strategies.get(op.guid) or default
        # gradient sync over the dp (x ap) group
        sync = s.dp * (s.ap if op.op_type in AP_CAPABLE else 1)
        if sync > 1 and op.weights:
            inner = cost._sync_inner(op, s)
            path = machine.tier_path(sync, inner)
            wb = cost._grad_sync_bytes(op, s)
            if machine.crosses_tier_boundary(sync, inner):
                if len(path) > 1:
                    # a multi-tier path can (and must) decompose
                    if reds is None:
                        strat, _, _ = machine.reduction_choice(
                            wb, sync, inner=inner)
                    else:
                        strat = (reds.get(op.name) or {}).get("strategy",
                                                              "flat")
                    boundary = "->".join(t.name for t, _ in path)
                    if strat == "flat":
                        diags.append(make_diag(
                            "FFTA070",
                            f"gradient sync (degree {sync}, "
                            f"{wb / 1e6:.2f} MB) spans tier boundary"
                            f" {boundary} with a flat all-reduce", op,
                            hint="use a tier-decomposable reduction"
                                 " (rs_ar_ag/hier_ring); re-search under"
                                 " the hierarchical machine spec"))
                else:
                    # the whole group lives ON an outer tier (one member
                    # per pod): flat is the only — and legal — shape,
                    # but its traffic still rides the slow tier
                    strat = "flat"
                dcn = machine.dcn_step_bytes(wb, sync, inner=inner,
                                             strategy=strat)
                if dcn > DCN_STEP_BYTES_WARN:
                    diags.append(make_diag(
                        "FFTA071",
                        f"gradient sync pushes {dcn / 1e6:.1f} MB/step"
                        f" across the {outer_name!r} tier"
                        f" (strategy {strat})", op,
                        hint="shard the weight (tp/ep) or accumulate"
                             " gradients over more steps"))
        # tensor-parallel activation collectives cannot decompose — a
        # model axis that escapes the innermost tiers is per-layer
        # latency on the slowest link, worth a warning on its own
        if s.tp > 1 and op.op_type in TP_CAPABLE and op.outputs:
            tp_inner = cost._axis_inner(s, "tp")
            if machine.crosses_tier_boundary(s.tp, tp_inner):
                out = op.outputs[0]
                act = (out.num_elements() * cost.op_dtype_bytes(op)
                       / max(1, s.dp))
                if act > DCN_STEP_BYTES_WARN:
                    diags.append(make_diag(
                        "FFTA071",
                        f"tp={s.tp} activation collective"
                        f" ({act / 1e6:.1f} MB) crosses a tier boundary"
                        " every layer", op,
                        hint="keep the model axis inside one"
                             " pod/ICI domain"))
    return diags


# ---------------------------------------------------------------------
# pass 4: aliasing / donation safety
# ---------------------------------------------------------------------
def pass_donation(ctx: AnalysisContext) -> List[Diagnostic]:
    cfg = ctx.config
    if cfg is None or getattr(cfg, "elastic_step_wrapper", None) is None:
        return []
    # the executor already strips donate_argnums from the train/multi steps
    # when a step wrapper is installed (the PR-1 dodge); what remains unsafe
    # to retry is the gradient-accumulation path, whose add/update closures
    # donate their operands unconditionally
    return [make_diag(
        "FFTA030",
        "elastic retry wrapper active: fit(accum_steps>1) donates the"
        " accumulator and consumed params/opt_state, so a retried dispatch"
        " would re-read donated buffers",
        hint="keep accum_steps=1 under the elastic runtime, or checkpoint"
             " before accumulation windows")]


# ---------------------------------------------------------------------
# pass 5: graph hygiene
# ---------------------------------------------------------------------
def pass_hygiene(ctx: AnalysisContext) -> List[Diagnostic]:
    graph = ctx.graph
    diags: List[Diagnostic] = []
    for op in graph.ops.values():
        for t in op.inputs:
            if t.owner_op is not None and t.owner_op.guid not in graph.ops:
                diags.append(make_diag(
                    "FFTA040",
                    f"input tensor {t.name!r} is produced by"
                    f" {t.owner_op.name!r}, which is not in the graph", op,
                    hint="a rewrite removed the producer without rewiring"
                         " its consumers"))
    for old_guid, repl in graph.tensor_aliases.items():
        final = graph.resolve_tensor(repl)
        if final.owner_op is not None and final.owner_op.guid not in graph.ops:
            diags.append(make_diag(
                "FFTA041",
                f"tensor_aliases[{old_guid}] resolves to {final.name!r}"
                f" whose producer {final.owner_op.name!r} left the graph",
                hint="Graph.remove_op drops dangling alias targets; this"
                     " chain predates the removal"))
    if ctx.final_guid is not None and ctx.final_guid in graph.ops:
        live = _ancestors(graph, ctx.final_guid)
        for guid, op in graph.ops.items():
            if guid not in live:
                diags.append(make_diag(
                    "FFTA042",
                    "op does not feed the final output (dead subgraph)",
                    op, hint="remove it or export its output explicitly"))
    for op in graph.ops.values():
        if op.op_type in _EW_BINARY and len(op.inputs) >= 2:
            dtypes = {t.dtype for t in op.inputs}
            if len(dtypes) > 1:
                diags.append(make_diag(
                    "FFTA043",
                    "elementwise op mixes input dtypes"
                    f" ({', '.join(sorted(d.value for d in dtypes))}):"
                    " implicit upcast at the boundary", op,
                    hint="insert an explicit cast() to pin the compute"
                         " dtype"))
    return diags


def _ancestors(graph: Graph, guid: int) -> Set[int]:
    seen = {guid}
    stack = [guid]
    while stack:
        op = graph.ops[stack.pop()]
        for t in op.inputs:
            o = t.owner_op
            if o is not None and o.guid in graph.ops and o.guid not in seen:
                seen.add(o.guid)
                stack.append(o.guid)
    return seen


# -- live resharding (FFTA06x) --------------------------------------------
def redistribution_diagnostics(schedule, machine=None) -> List[Diagnostic]:
    """Legality + memory fit of a resharding.ReshardSchedule (the
    redistribution analog of pass_collectives + pass_memory_fit):

     - FFTA060: a move's target spec names a mesh axis the target mesh
       lacks, its degree mismatches the axis size or does not divide the
       dim, or the target layout needs more devices than the mesh has;
     - FFTA061: a move's planned peak scratch exceeds the requested
       bound (the planner could not chunk it down) or the machine's
       per-chip HBM;
     - FFTA062: peak scratch above 85% of HBM — legal but one fragment
       away from an OOM during recovery, worth a log line.

    Pure function of (schedule, machine); never touches a device.
    """
    diags: List[Diagnostic] = []
    axis_sizes = schedule.new_mesh.axis_sizes
    n_devices = max(1, len(schedule.new_mesh.device_ids))
    for move in schedule.moves:
        spec = move.new
        for d, (deg, axis) in enumerate(zip(spec.degrees, spec.axes)):
            if deg <= 1:
                continue
            if axis not in axis_sizes:
                diags.append(make_diag(
                    "FFTA060",
                    f"{move.path}: dim {d} shards over mesh axis"
                    f" {axis!r}, absent from the target mesh"
                    f" (axes: {sorted(axis_sizes) or 'none'})",
                    hint="re-run the search for the target topology"))
                continue
            if axis_sizes[axis] != deg:
                diags.append(make_diag(
                    "FFTA060",
                    f"{move.path}: dim {d} degree {deg} != target mesh"
                    f" axis {axis!r} size {axis_sizes[axis]}",
                    hint="degrees must equal their axis extent to lower"
                         " to a NamedSharding"))
            if move.shape and move.shape[d] % deg != 0:
                diags.append(make_diag(
                    "FFTA060",
                    f"{move.path}: degree {deg} does not divide dim {d}"
                    f" (size {move.shape[d]})"))
        if spec.total_degree() > n_devices:
            diags.append(make_diag(
                "FFTA060",
                f"{move.path}: target layout needs"
                f" {spec.total_degree()} devices, mesh has {n_devices}"))
        if move.infeasible_peak:
            diags.append(make_diag(
                "FFTA061",
                f"{move.path}: no chunking meets the"
                f" {schedule.peak_bytes} B bound (best achievable"
                f" {move.peak_scratch_bytes} B over {move.rounds}"
                " rounds)",
                hint="raise peak_bytes or shard the move's kept dims"))
    cap = machine.memory_budget_bytes() if machine is not None else None
    if cap:
        peak = schedule.peak_scratch_bytes
        if peak > cap:
            diags.append(make_diag(
                "FFTA061",
                f"schedule peak scratch {peak / 1e9:.2f} GB exceeds"
                f" per-chip HBM {cap / 1e9:.2f} GB"))
        elif peak > 0.85 * cap:
            diags.append(make_diag(
                "FFTA062",
                f"schedule peak scratch {peak / 1e9:.2f} GB is"
                f" {peak / cap:.0%} of per-chip HBM"
                f" ({cap / 1e9:.2f} GB)"))
    return diags


def survivor_diagnostics(old_plan, leaves: Dict[str, int],
                         lost_positions) -> List[Diagnostic]:
    """FFTA063 findings: arrays of a live tree whose shards cannot be
    reassembled from the surviving devices of `old_plan`'s mesh (every
    holder of some shard is among `lost_positions`). The elastic
    coordinator consults this BEFORE attempting a zero-disk recovery —
    any finding forces the checkpoint fallback."""
    from ..resharding.plan import uncovered_arrays

    diags: List[Diagnostic] = []
    for path, n_lost in uncovered_arrays(old_plan, leaves, lost_positions):
        diags.append(make_diag(
            "FFTA063",
            f"{path}: {n_lost} shard(s) held only by lost devices"
            f" {sorted(int(p) for p in lost_positions)}",
            hint="recover from the newest verified checkpoint instead"))
    return diags


# ---------------------------------------------------------------------
# pass 8: mixture-of-experts legality (FFTA08x, docs/moe.md)
# ---------------------------------------------------------------------
def pass_moe(ctx: AnalysisContext) -> List[Diagnostic]:
    """MoE-specific plan legality: degenerate capacity roundings (the
    moe_capacity clamp silently raising the effective capacity factor),
    expert-count/ep divisibility, aux-loss wiring, router dtype. Runs on
    EXPERTS (fused) and GROUP_BY (unfused dispatch) ops; graphs without
    them produce no findings, so the pass is safe in every pipeline."""
    from ..ops.moe import moe_capacity, moe_capacity_degenerate, moe_tokens
    from .diagnostics import Severity

    diags: List[Diagnostic] = []
    mesh_ep = (ctx.mesh_axes or {}).get("expert", 1)
    for op in ctx.graph.ops.values():
        if op.op_type not in (OpType.EXPERTS, OpType.GROUP_BY):
            continue
        n = op.params["n"]
        alpha = op.params.get("alpha", 1.0)
        x = op.inputs[0]
        if op.op_type == OpType.EXPERTS:
            assign = op.inputs[2]
        else:
            assign = op.inputs[1]
        tokens = moe_tokens(x.dims)
        k = assign.dims[-1]
        if moe_capacity_degenerate(tokens, k, n, alpha):
            cap = moe_capacity(tokens, k, n, alpha)
            diags.append(make_diag(
                "FFTA080",
                f"capacity factor {alpha} x {tokens} tokens / {n} experts"
                f" rounds below top-k={k}; moe_capacity clamps to {cap},"
                f" an effective factor of {cap * n / (k * tokens):.2f}",
                op,
                hint="raise alpha (or shrink n) so the requested capacity"
                     " is the one that runs"))
        elif alpha < 1.0:
            diags.append(make_diag(
                "FFTA084",
                f"capacity factor {alpha} < 1.0: even a perfectly"
                f" balanced router overflows the per-expert buffers and"
                " drops tokens every step", op,
                hint="alpha >= 1.0 keeps a balanced router drop-free"))
        # ep divisibility: a pinned strategy with a non-dividing ep is an
        # illegal plan; a mesh expert axis the op cannot use (default
        # assignment degrades it to ep=1) is legal but buys nothing — the
        # axis's devices idle through the expert FFN, so warn
        s = ctx.strategy_of(op)
        sep = getattr(s, "ep", 1) if s is not None else 1
        if op.op_type == OpType.EXPERTS:
            if sep > 1 and n % sep:
                diags.append(make_diag(
                    "FFTA081",
                    f"ep={sep} does not divide the expert count {n}; the"
                    " stacked expert weights cannot shard over the"
                    " 'expert' axis", op,
                    hint=f"choose ep from the divisors of {n}"))
            elif sep == 1 and mesh_ep > 1 and n % mesh_ep:
                diags.append(make_diag(
                    "FFTA081",
                    f"mesh 'expert' axis of {mesh_ep} does not divide the"
                    f" expert count {n}: the op degrades to replicated"
                    " and the axis's devices idle through the expert FFN",
                    op, severity=Severity.WARNING,
                    hint=f"size the expert axis to a divisor of {n}"))
        if op.op_type == OpType.EXPERTS:
            lambda_bal = op.params.get("lambda_bal", 0.0)
            if lambda_bal and len(op.inputs) <= 3:
                diags.append(make_diag(
                    "FFTA082",
                    f"lambda_bal={lambda_bal} but no full_gate input:"
                    " the load-balance loss needs the full gate"
                    " distribution and lowering will fail", op,
                    hint="pass full_gate= (FFModel.moe wires it for"
                         " fused=True)"))
            if (ctx.config is not None
                    and getattr(ctx.config, "allow_mixed_precision",
                                False)):
                diags.append(make_diag(
                    "FFTA083",
                    "mixed precision stores the router's softmax in"
                    " bf16 between ops: near-tied expert selections can"
                    " flip vs the f32 reference", op,
                    hint="keep router-sensitive runs at f32, or accept"
                         " assignment jitter under bf16"))
    return diags
