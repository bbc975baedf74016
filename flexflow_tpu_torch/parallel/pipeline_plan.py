"""Pipeline-parallel planning over the PCG (a host-only copy of
flexflow_tpu/parallel/pipeline_plan.py over the port's graph).

Maps a PCG onto GPipe stages (kernels/pipeline.py). This is a
beyond-reference capability: upstream FlexFlow reserves an OP_PIPELINE enum
(include/flexflow/ffconst.h:159) but never implements it — there is no
pipeline op, no stage partitioner, no schedule.

Design: the GPipe kernel runs homogeneous stages, each rank of the
'stage' mesh axis holding one stage's weights (the JAX package stacks
them into a tree with a leading stage dim; the port's ranks walk their
own stage's ops). The stages must be structurally identical, so the
planner's job is to find the maximal run of consecutive
isomorphic segments of the PCG — exactly the repeated-block body of a
transformer — and split it into S stages. Ops before/after the run (token
embedding, classifier head) execute as ordinary ops outside the
pipeline, replicated over the stages. This mirrors how production
pipelining works (stacked blocks), rather than the reference's per-op
placement model, which cannot express software pipelining at all.

Segments come from the graph's bottleneck nodes (core/graph.py
bottleneck_nodes — reference: graph.cc find_bottleneck_node), the same
segmentation the Unity sequence-split DP uses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ..core.graph import Graph
from ..core.op import Op, _freeze
from ..core.tensor import Tensor
from ..ffconst import OpType

# Ops that cannot run inside the pipelined stage body: graph sources,
# stateful ops (BN running stats advance per-microbatch in ways the stage
# loop cannot express per-stage), and the MoE family (aux load-balance
# losses + expert-axis collectives don't compose with the stage loop).
PIPELINE_EXCLUDED = {
    OpType.INPUT,
    OpType.WEIGHT,
    OpType.BATCHNORM,
    OpType.EXPERTS,
    OpType.GROUP_BY,
    OpType.AGGREGATE,
    OpType.AGGREGATE_SPEC,
    OpType.CACHE,
    OpType.REPARTITION,
    OpType.COMBINE,
    OpType.REPLICATE,
    OpType.REDUCTION,
    OpType.FUSED_PARALLEL,
}


@dataclasses.dataclass
class PipelinePlan:
    """A validated mapping of a PCG region onto S pipeline stages."""

    segments: List[List[Op]]   # R consecutive isomorphic segments (topo order)
    n_stages: int              # S; S divides R
    segs_per_stage: int        # R // S
    region_guids: Set[int]     # op guids inside the pipelined region
    region_input: Tensor       # produced by the prefix, feeds segment 0
    region_output: Tensor      # last segment's bottleneck output
    entries: List[Tensor]      # per segment: its entry tensor
    first_op_guid: int         # trigger: first region op in topo order


def _segments_of(graph: Graph) -> List[List[Op]]:
    """Topo-ordered ops split after each bottleneck node (core/graph.py
    segments — one implementation shared with the Unity sequence-split DP)."""
    return graph.segments()


def _entry_tensor(prev_seg: List[Op]) -> Optional[Tensor]:
    """The tensor crossing from prev_seg into the next segment: the
    bottleneck op's single output."""
    last = prev_seg[-1]
    if len(last.outputs) != 1:
        return None
    return last.outputs[0]


def _segment_signature(seg: List[Op], entry_guid: Optional[int]):
    """Structural isomorphism key: op types, params (minus names), weight
    shapes, and the internal wiring encoded as relative producer indices.
    Two segments with equal signatures compute the same function up to
    their weight values — the condition for stacking their parameters."""
    idx_of: Dict[int, int] = {}   # tensor guid -> (producer index, out slot)
    slot_of: Dict[int, int] = {}
    for i, op in enumerate(seg):
        for j, t in enumerate(op.outputs):
            idx_of[t.guid] = i
            slot_of[t.guid] = j
    sig = []
    for op in seg:
        ins = []
        for t in op.inputs:
            if t.guid in idx_of:
                ins.append(("op", idx_of[t.guid], slot_of[t.guid]))
            elif entry_guid is not None and t.guid == entry_guid:
                ins.append(("entry",))
            else:
                return None  # external input other than the entry: not pipelineable
        params = {k: v for k, v in op.params.items()
                  if k not in ("name",)}
        weights = tuple(
            (w._weight_spec.name, tuple(w.dims), w.dtype)
            for w in op.weights
        )
        sig.append((op.op_type, _freeze(params), weights, tuple(ins),
                    tuple(tuple(t.dims) for t in op.outputs)))
    return tuple(sig)


def _pipelineable(seg: List[Op]) -> bool:
    return all(
        op.op_type not in PIPELINE_EXCLUDED and not op.state_vars
        for op in seg
    )


MAX_PERIOD = 8  # segments per repeated block tried by the run finder


def find_isomorphic_run(
    graph: Graph,
) -> Tuple[int, List[List[Op]], List[Tensor]]:
    """Maximal run of consecutive isomorphic, pipelineable GROUPS of
    segments whose entry tensors all share one shape/dtype (the stage
    carry constraint: every stage's input and output must be the same buffer
    shape).

    A repeated block usually spans SEVERAL bottleneck segments — a
    transformer layer is two (attention half, FFN half), so consecutive
    single segments alternate signatures and never repeat. The finder
    therefore tries group periods p = 1..MAX_PERIOD: a group is p
    consecutive segments flattened into one op list; the run is consecutive
    isomorphic groups. Coverage (ops inside the run) is maximized;
    ties prefer more groups (finer stage granularity).

    Returns (run_length_in_groups, groups, entry_tensors); 0 when the graph
    has no pipelineable repeated structure.
    """
    segs = _segments_of(graph)
    n = len(segs)
    best: Tuple[int, List[List[Op]], List[Tensor]] = (0, [], [])
    best_score = (-1, -1)  # (ops covered, groups)
    # tensor guid -> consumer op guids, computed once (the per-candidate
    # escape check below would otherwise rescan every op's inputs)
    consumers_of: Dict[int, Set[int]] = {}
    for c in graph.ops.values():
        for t in c.inputs:
            consumers_of.setdefault(t.guid, set()).add(c.guid)

    for p in range(1, min(MAX_PERIOD, max(1, (n - 1) // 2)) + 1):
        for i in range(1, n):  # segment 0 holds graph inputs: never in a run
            if i + 2 * p > n:
                break
            run: List[List[Op]] = []
            entries: List[Tensor] = []
            shape = None
            first_sig = None
            k = i
            while k + p <= n:
                group = [op for s in segs[k:k + p] for op in s]
                entry = _entry_tensor(segs[k - 1])
                if entry is None or not _pipelineable(group):
                    break
                if shape is None:
                    shape = (tuple(entry.dims), entry.dtype)
                elif (tuple(entry.dims), entry.dtype) != shape:
                    break
                # the group entry must be consumed only inside the group —
                # a residual skipping a whole stage cannot ride the carry
                gset = {op.guid for op in group}
                if not consumers_of.get(entry.guid, set()) <= gset:
                    break
                sig = _segment_signature(group, entry.guid)
                if sig is None:
                    break
                if first_sig is None:
                    first_sig = sig
                elif sig != first_sig:
                    break
                run.append(group)
                entries.append(entry)
                k += p
            # the run's OUTPUT must also match the carry shape
            while run:
                out = _entry_tensor(run[-1][-1:])
                if out is not None and (tuple(out.dims),
                                        out.dtype) == shape:
                    break
                run.pop()
                entries.pop()
            if len(run) >= 2:
                score = (sum(len(g) for g in run), len(run))
                if score > best_score:
                    best_score = score
                    best = (len(run), run, entries)
    return best


def max_pipeline_stages(graph: Graph) -> int:
    """Largest usable stage count (the run length); search feasibility."""
    return find_isomorphic_run(graph)[0]


def stage_placement_options(machine, dp: int, pp: int) -> List[Dict]:
    """Candidate nestings of a (data, stage) mesh on `machine`, for the
    Unity search's pipeline candidates (docs/machine.md "Overlap").

    Mesh axes are row-major (core/machine.make_mesh), so the FIRST axis
    varies slowest and owns contiguous device blocks:

     - ``stage_inner`` (the historical layout): ``(data, stage)`` — a
       stage's members are strided `pp` apart across the whole machine;
       its dp groups stride across every tier `dp * pp` spans.
     - ``stage_outer`` (tiered machines only): ``(stage, data)`` — each
       stage owns a contiguous `dp`-device block, so when the innermost
       tier's degree divides `dp` the stage CUT lands on a tier (pod)
       boundary: the slow outer tier carries only the thin inter-stage
       activation hop while each stage's dp weight syncs stay inside
       the fast tier.

    Each option reports `hop_inner` (the stage axis's device stride —
    what tier_path prices the boundary hop with), `dp_inner` (the dp
    sync group's stride inside a stage), `hop_tier` (the outermost tier
    the hop crosses; None on non-tiered machines), and
    `cut_on_tier_boundary`. One-tier hierarchies return only the
    legacy nesting so they keep pricing bit-for-bit like the flat
    models."""
    tiered = hasattr(machine, "tier_path")
    tiers = getattr(machine, "tiers", ())
    multi = tiered and len(tiers) > 1

    def info(order: str, axes, hop_inner: int, dp_inner: int) -> Dict:
        d = {"order": order, "axes": axes, "hop_inner": hop_inner,
             "dp_inner": dp_inner, "hop_tier": None,
             "cut_on_tier_boundary": False}
        if tiered:
            path = machine.tier_path(pp, inner=hop_inner)
            d["hop_tier"] = (path[-1][0].name if path
                             else tiers[0].name)
            if multi:
                d["cut_on_tier_boundary"] = (
                    order == "stage_outer"
                    and dp % tiers[0].degree == 0)
        return d

    legacy = info("stage_inner", (("data", dp), ("stage", pp)),
                  hop_inner=1, dp_inner=pp)
    if not multi:
        return [legacy]
    outer = info("stage_outer", (("stage", pp), ("data", dp)),
                 hop_inner=dp, dp_inner=1)
    return [outer, legacy]


def find_pipeline_plan(graph: Graph, n_stages: int) -> PipelinePlan:
    """Validated plan for `n_stages` stages, or a loud ValueError explaining
    why this graph cannot pipeline at that degree."""
    run_len, run, entries = find_isomorphic_run(graph)
    if run_len == 0:
        raise ValueError(
            "pipeline parallelism requires a run of consecutive isomorphic "
            "graph segments (a repeated-block body, e.g. transformer "
            "layers); this graph has none — remove 'stage' from "
            "parallel_axes or restructure the model"
        )
    if n_stages > run_len:
        raise ValueError(
            f"pipeline stages ({n_stages}) must divide into the isomorphic "
            f"segment run length ({run_len}) — this graph repeats only "
            f"{run_len} blocks"
        )
    # pipeline the largest multiple of n_stages groups; trailing groups run
    # sequentially after the pipeline (e.g. 7 repeated blocks on 2 stages
    # pipelines 6 and leaves 1)
    usable = (run_len // n_stages) * n_stages
    run, entries = run[:usable], entries[:usable]
    region_output = run[-1][-1].outputs[0]
    region_guids = {op.guid for seg in run for op in seg}
    return PipelinePlan(
        segments=run,
        n_stages=n_stages,
        segs_per_stage=usable // n_stages,
        region_guids=region_guids,
        region_input=entries[0],
        region_output=region_output,
        entries=entries,
        first_op_guid=run[0][0].guid,
    )
