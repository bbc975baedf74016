"""Unity-style joint strategy search.

Reference: GraphSearchHelper::graph_optimize (substitution.cc:1898) — recursive
sequence splits at bottleneck (post-dominator) nodes with memoization, and
base_optimize (substitution.cc:2229): best-first backtracking over candidate
graphs with alpha pruning and an iteration budget, candidate cost =
Graph::optimal_cost via the DP in graph.cc:1586.

TPU-native re-design: algebraic rewrites are applied greedily first
(substitution.py); the parallelization space is the per-op OpStrategy menu
(dp x tp over a global mesh factorization) costed by the Simulator. The
search:
 1. enumerate global mesh factorizations (dp, tp) of the device count;
 2. for each, seed every op with its best local strategy, split the graph at
    bottleneck nodes (sequence split — same post-dominator structure the
    reference uses) and optimize each segment independently (memoized);
 3. best-first refinement within the budget: a priority queue of
    (cost, strategy-delta) candidates, pruned at best_cost * alpha
    (reference: --search-alpha), stopping after --budget pops.
Memory-aware mode wraps the cost with runtime + lambda * overflow and binary
searches lambda to fit the per-chip HBM budget (reference: graph.cc:2075-2131).

The port's copy of flexflow_tpu/search/unity.py, host-only. As in the JAX
package, `unity_optimize` dispatches to the native core (the port's
libffcore, flexflow_tpu_torch/native) where it applies and
`use_native_search` is on; this Python path is the fallback and the
behavioral spec. It differs in one place: measured op costs are the
default when the config's device is a CUDA card (`_want_measured`), and
a measured search keeps this Python path, as JAX's accelerator default
does.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core.graph import Graph
from ..core.op import Op
from ..ffconst import OpType
from .machine_model import MachineModel
from .simulator import (AP_CAPABLE, OpStrategy, Simulator, TP_CAPABLE,
                        attn_sp_ulysses)

_log = logging.getLogger("flexflow_tpu_torch.search")


def _divisor_pairs(n: int) -> List[Tuple[int, int]]:
    out = []
    for dp in range(1, n + 1):
        if n % dp == 0:
            out.append((dp, n // dp))
    return out


def valid_strategies(op: Op, dp: int, tp: int, batch_size: int,
                     config, ep: int = 1, ap: int = 1,
                     sp: int = 1) -> List[OpStrategy]:
    """Strategy menu for one op under a (dp, tp[, ep, ap, sp]) mesh
    (reference: get_valid_machine_views, graph.h:205-210). sp is uniform —
    sequence sharding is graph-wide per factorization, so sp-shardable ops
    carry it unconditionally rather than as a per-op choice."""
    from .simulator import sp_shardable

    op_sp = sp if sp_shardable(op, sp) else 1
    menu = []
    dps = [d for d in (dp, 1) if batch_size % max(d, 1) == 0]
    if not dps:
        dps = [1]
    tps = [(1, False)]
    if (
        tp > 1
        and op.op_type in TP_CAPABLE
        and not config.only_data_parallel
    ):
        if _tp_divides(op, tp):
            tps = [(tp, False), (1, False)]
        # reduction/"parameter" parallelism: row-parallel linear (kernel
        # shards on in-features; reference: --enable-parameter-parallel)
        if (config.enable_parameter_parallel
                and op.op_type == OpType.LINEAR
                and op.inputs[0].dims[-1] % tp == 0):
            tps.append((tp, True))
    eps = [1]
    if (
        ep > 1
        and op.op_type == OpType.EXPERTS
        and op.params["n"] % ep == 0
        and not config.only_data_parallel
    ):
        eps = [ep, 1]
    aps = [1]
    if (
        ap > 1
        and op.op_type in AP_CAPABLE
        and config.enable_attribute_parallel
        and not config.only_data_parallel
        and _ap_divides(op, ap)
    ):
        aps = [ap, 1]
    for d in dps:
        for t, row in tps:
            for e in eps:
                for a in aps:
                    menu.append(OpStrategy(dp=d, tp=t, ep=e, ap=a,
                                           sp=op_sp, tp_row=row))
    return menu


def _ap_divides(op: Op, ap: int) -> bool:
    """Spatial split: input AND output H must divide evenly (the annotation
    in _assign_strategy shards the output H) and shards must stride-align."""
    x = op.inputs[0]
    if len(x.dims) != 4 or not op.outputs or len(op.outputs[0].dims) != 4:
        return False
    h = x.dims[2]
    out_h = op.outputs[0].dims[2]
    stride = op.params.get("stride_h", 1)
    return (h % ap == 0 and out_h % ap == 0
            and (h // ap) % max(1, stride) == 0)


def _tp_divides(op: Op, tp: int) -> bool:
    if op.op_type == OpType.LINEAR:
        return op.params["out_dim"] % tp == 0
    if op.op_type == OpType.MULTIHEAD_ATTENTION:
        return op.params["num_heads"] % tp == 0
    if op.op_type == OpType.EMBEDDING:
        return op.params["out_dim"] % tp == 0
    if op.op_type == OpType.BATCHMATMUL:
        return True
    return False


def make_sp_feasible(graph: Graph, config):
    """Sequence-parallel feasibility for this graph, or None when SP is not
    searchable at all (--enable-sequence-parallel off, no attention, an
    attention op carries prob-dropout — the SP kernels have none — or
    only_data_parallel). Returns a predicate sp -> bool checking that every
    attention op's q AND k/v sequence lengths divide (cross-attention has
    distinct lengths) and ulysses-mode heads divide. NEW vs the reference,
    which has no SP axis; shared by the Python and native searches."""
    attn_seq_lens = set()
    sp_head_caps = []  # per-op extra divisibility (ulysses heads)
    sp_blocked = False
    for op in graph.ops.values():
        if op.op_type != OpType.MULTIHEAD_ATTENTION:
            continue
        if not op.inputs or len(op.inputs[0].dims) < 3:
            continue
        if op.params.get("dropout", 0.0) > 0:
            sp_blocked = True  # SP kernels have no attention dropout
        for t in op.inputs[:3]:
            if len(t.dims) >= 3:
                attn_seq_lens.add(t.dims[1])
        if attn_sp_ulysses(op):  # one mode predicate: cost + feasibility
            sp_head_caps.append(op.params.get("num_heads", 1))
    if (not getattr(config, "enable_sequence_parallel", False)
            or not attn_seq_lens or sp_blocked
            or config.only_data_parallel):
        return None

    def sp_feasible(sp: int) -> bool:
        return (all(seq_len % sp == 0 for seq_len in attn_seq_lens)
                and all(h % sp == 0 for h in sp_head_caps))

    return sp_feasible


def feasible_sp_values(graph: Graph, config, n_devices: int) -> List[int]:
    """Concrete sp candidates (always includes 1) — the native search's
    `sps` protocol line."""
    pred = make_sp_feasible(graph, config)
    out = [1]
    if pred is not None:
        out += [sp for sp in range(2, n_devices + 1)
                if n_devices % sp == 0 and pred(sp)]
    return out


def feasible_ep_values(graph: Graph, config, n_devices: int) -> List[int]:
    """Concrete ep candidates (always includes 1) — the native search's
    `eps` protocol line. Mirrors _parallelize's ep gate: ep must divide
    every EXPERTS op's expert count and the device count."""
    expert_counts = [op.params["n"] for op in graph.ops.values()
                     if op.op_type == OpType.EXPERTS]
    out = [1]
    if expert_counts and not config.only_data_parallel:
        out += [ep for ep in range(2, n_devices + 1)
                if n_devices % ep == 0
                and all(n % ep == 0 for n in expert_counts)]
    return out


def feasible_ap_values(graph: Graph, config, n_devices: int) -> List[int]:
    """Concrete ap candidates (always includes 1) — the native search's
    `aps` protocol line. Mirrors _parallelize's ap gate: the flag must be
    on and some spatial op must divide (per-op divisibility re-checked
    native-side via the node ap fields)."""
    out = [1]
    if (config.enable_attribute_parallel
            and not config.only_data_parallel):
        out += [ap for ap in range(2, n_devices + 1)
                if n_devices % ap == 0
                and any(op.op_type in AP_CAPABLE and _ap_divides(op, ap)
                        for op in graph.ops.values())]
    return out


@dataclasses.dataclass
class SearchResult:
    strategies: Dict[int, OpStrategy]
    mesh_axes: Dict[str, int]
    cost_us: float
    memory_bytes: float
    log: List[str]
    # the simulator's predicted per-step cost for the SELECTED plan —
    # recorded so post-compile calibration (obs/calibration.py) can put
    # prediction and measured step wall time side by side. Set by the
    # search entry points from cost_us; a separate field because cost_us
    # may later carry objective terms (lambda * memory) that are not time
    predicted_step_us: Optional[float] = None
    # graph rewrites the search MATERIALIZED before choosing strategies —
    # exported so the --import path can replay them and op names match
    # (reference analog: the imported strategy file keys by guid hashes
    # that encode the rewritten graph, model.cc:3609-3617)
    applied_rewrites: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)
    greedy_search_rules: bool = False
    # plan-sanitizer pruning accounting (analysis/passes.py): mesh
    # factorizations the cost simulator priced vs ones the cheap static
    # passes rejected first
    candidates_simulated: int = 0
    candidates_pruned: int = 0
    # per-tier reduction decomposition synthesized for synced tensors on a
    # hierarchical machine (CostModel.reduction_plan, docs/machine.md):
    # {op name: {strategy, degree, bytes, tiers, time_us}} — exported in
    # the strategy JSON ("reductions") and checked by the FFTA07x family.
    # Empty on flat machine models. With bucketing active the entries
    # additionally carry the priced bucket schedule (bucket /
    # bucket_bytes / bucket_time_us — docs/machine.md "Overlap").
    reduction_strategies: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    # grad-sync overlap split of the selected plan's predicted step
    # (docs/machine.md "Overlap"): overlapped = bucketed/async reduction
    # time the two-stream schedule hid under the remaining backward,
    # exposed = the tail that extends the step past compute. Replaces
    # the all-or-nothing search_overlap_backward_update discount as the
    # search's overlap quantity (the legacy knob=False forces
    # exposed == total, the blocking pricing). None when the plan was
    # never simulated python-side (plain native path).
    overlapped_sync_us: Optional[float] = None
    exposed_sync_us: Optional[float] = None
    sync_buckets: int = 0
    # tier-aware placement of a pipeline ('stage') candidate:
    # {"order": stage_outer|stage_inner, "hop_tier", "hop_us",
    # "cut_on_tier_boundary", "sync_us"} (pipeline_plan
    # .stage_placement_options); None for non-pipeline plans
    pipeline_placement: Optional[Dict[str, Any]] = None
    # search provenance (docs/search.md): content hashes of the
    # PRE-rewrite graph and the overlaid machine this plan was searched
    # for — the plan-cache key legs, exported so `analyze` can warn
    # when a strategy JSON is applied to a different graph/machine than
    # the one that produced it
    graph_hash: Optional[str] = None
    machine_hash: Optional[str] = None
    # how this result was produced and how long it took:
    # "cold" = full enumeration, "warm" = cached-seed local refinement,
    # "hit" = plan-cache adoption (enumeration skipped entirely)
    cache_mode: str = "cold"
    search_wall_ms: Optional[float] = None
    # False: do not store this result in the plan cache — set by the
    # warm path when the plan-distance term biased the choice beyond
    # the cost tolerance; such a plan is right for THIS live state but
    # wrong to hand a future live-less lookup as an exact hit
    cache_store: bool = True


class GraphSearchHelper:
    """Mirrors the reference class of the same name (substitution.h:249)."""

    def __init__(self, graph: Graph, config, machine: MachineModel,
                 simulator: Optional[Simulator] = None):
        self.graph = graph
        self.config = config
        self.machine = machine
        self.sim = simulator or Simulator(machine, config)
        self._memo: Dict[Tuple, Dict[int, OpStrategy]] = {}
        self.log: List[str] = []
        # per-op-type TP degrees a loaded TASO rule file proposes
        # (None = no file: every type may TP at any mesh degree)
        self._tp_menu = None
        # plan-sanitizer pruning accounting (totals across probes/segments)
        self.candidates_simulated = 0
        self.candidates_pruned = 0

    def _load_tp_candidates(self, spec, parsed=None) -> None:
        """Distill a parsed TASO RuleCollection (--substitution-json) into
        per-op-type candidate TP degrees (reference role: create_xfers
        building GraphXfers from loaded rules, substitution.h:119-121)."""
        from .substitution_loader import (
            rules_from_spec,
            summarize,
            tp_candidates_from_rules,
        )

        rules = parsed if parsed is not None else rules_from_spec(spec)
        self._tp_menu = {t: set(degs)
                         for t, degs in tp_candidates_from_rules(rules).items()}
        self.log.append(
            f"substitution rules: {summarize(rules)}; TP proposed for "
            + str({t.value: sorted(d) for t, d in self._tp_menu.items()}))

    def _tp_ok(self, op: Op, s: OpStrategy) -> bool:
        """A strategy honors the rule file iff it is TP-free or the file
        proposes that op type at that degree."""
        if s.tp <= 1 or self._tp_menu is None:
            return True
        return s.tp in self._tp_menu.get(op.op_type, ())

    # -- sequence split (reference: generic_sequence_optimize, memoized) --
    def _segments(self, graph: Optional[Graph] = None) -> List[List[Op]]:
        graph = graph if graph is not None else self.graph
        return graph.segments()

    def _segment_cost(self, seg_graph: Graph, strategies: Dict[int, OpStrategy],
                      lam: float = 0.0) -> float:
        cost = self.sim.simulate(seg_graph, strategies)
        if lam:
            cost += lam * self.sim.memory_bytes(seg_graph, strategies)
        return cost

    def _optimize_segment(self, seg: List[Op], dp: int, tp: int,
                          batch: int, ep: int = 1, ap: int = 1,
                          sp: int = 1,
                          lam: float = 0.0) -> Dict[int, OpStrategy]:
        key = (tuple(op.guid for op in seg), dp, tp, ep, ap, sp,
               round(lam, 15))
        if key in self._memo:
            return self._memo[key]
        seg_graph = Graph(seg)
        # tiered machines: seed pricing strides axes by THIS candidate
        # factorization (simulate() re-derives from realized strategies)
        self.sim.cost.set_mesh_degrees(tp=tp, sp=sp, ep=ep, ap=ap)
        # seed: per-op greedy best in isolation (memory-weighted under lam)
        strategies = {}
        for op in seg:
            menu = [s for s in valid_strategies(op, dp, tp, batch, self.config,
                                                ep=ep, ap=ap, sp=sp)
                    if self._tp_ok(op, s)]
            strategies[op.guid] = min(
                menu, key=lambda s: (self.sim.op_step_time_us(op, s)
                                     + lam * self.sim.cost.op_memory_bytes(op, s))
            )
        # base_optimize: best-first over single-op strategy flips
        best = self._best_first_flips(
            seg, strategies,
            lambda st: self._segment_cost(seg_graph, st, lam),
            dp, tp, batch, ep, ap, sp)
        self._memo[key] = best
        return best

    def _best_first_flips(self, ops: List[Op],
                          strategies: Dict[int, OpStrategy],
                          cost_fn, dp: int, tp: int, batch: int,
                          ep: int, ap: int,
                          sp: int = 1) -> Dict[int, OpStrategy]:
        """Best-first refinement over single-op strategy flips with alpha
        pruning and the iteration budget (reference: base_optimize,
        substitution.cc:2229-2311) — shared by the per-segment DP and the
        whole-graph cross-segment pass."""
        budget = max(0, self.config.search_budget)
        alpha = self.config.search_alpha
        best = dict(strategies)
        best_cost = cost_fn(best)
        counter = itertools.count()
        pq: List[Tuple[float, int, Dict[int, OpStrategy]]] = [
            (best_cost, next(counter), best)
        ]
        pops = 0
        while pq and pops < budget:
            cost, _, cur = heapq.heappop(pq)
            pops += 1
            if cost > best_cost * alpha:
                continue  # prune (reference: substitution.cc:2278)
            for op in ops:
                for s in valid_strategies(op, dp, tp, batch, self.config,
                                          ep=ep, ap=ap, sp=sp):
                    if s == cur.get(op.guid):
                        continue
                    if not self._tp_ok(op, s):
                        continue  # rule file doesn't propose this TP
                    cand = dict(cur)
                    cand[op.guid] = s
                    c = cost_fn(cand)
                    if c < best_cost:
                        best, best_cost = cand, c
                    if c < cost * alpha:
                        heapq.heappush(pq, (c, next(counter), cand))
        return best

    # -- top level --------------------------------------------------------
    def graph_optimize(self, batch_size: int, n_devices: int,
                       memory_budget_bytes: Optional[float] = None,
                       rule_spec=None, warm_seed=None,
                       live_plan=None) -> SearchResult:
        from ..obs.tracing import get_tracer

        with get_tracer().span("search", n_devices=n_devices,
                               batch_size=batch_size) as sp:
            result = self._graph_optimize_inner(batch_size, n_devices,
                                                memory_budget_bytes,
                                                rule_spec,
                                                warm_seed=warm_seed,
                                                live_plan=live_plan)
            sp.set(cost_us=result.cost_us, axes=result.mesh_axes,
                   simulated=result.candidates_simulated,
                   pruned=result.candidates_pruned,
                   cache=result.cache_mode)
            return result

    def _graph_optimize_inner(self, batch_size: int, n_devices: int,
                              memory_budget_bytes: Optional[float] = None,
                              rule_spec=None, warm_seed=None,
                              live_plan=None) -> SearchResult:
        from .substitution import (
            apply_substitutions,
            load_rule_spec,
            rule_set_from_spec,
            search_rules_from_spec,
        )

        # rule_spec: optional pre-parsed (spec, is_taso[, taso_rules]) from
        # unity_optimize, avoiding re-reads/re-parses of a multi-MB rule file
        if rule_spec is None:
            rule_spec = load_rule_spec(self.config.substitution_json_path)
        spec, is_taso = rule_spec[0], rule_spec[1]
        taso_rules = rule_spec[2] if len(rule_spec) > 2 else None
        # strictly-shrinking rewrites (every application removes ops under
        # any strategy) are applied greedily to fixed point; trade-off
        # rewrites are joint-search actions below
        applied = apply_substitutions(self.graph, rule_set_from_spec(spec, is_taso))
        if applied:
            self.log.append(f"substitutions: {applied}")
        if is_taso:
            self._load_tp_candidates(spec, parsed=taso_rules)

        search_rules = search_rules_from_spec(spec, is_taso, parsed=taso_rules)
        joint = (getattr(self.config, "joint_search", True) and search_rules
                 and self.config.search_budget > 0)
        if not joint and search_rules and self.config.search_budget > 0:
            # joint_search=False: hand-written trade-off rewrites degrade to
            # the greedy fixed-point pass (the comparison baseline). Loaded
            # GraphXfers are excluded even here — greedy application of a
            # non-shrinking rewrite diverges — and the skip is logged so the
            # baseline isn't a silent no-op. joint_search=True with no
            # budget applies none — matching the native-path gate so native
            # availability never changes the compiled graph.
            applied2 = apply_substitutions(self.graph, search_rules)
            if applied2:
                self.log.append(f"greedy substitutions: {applied2}")
            skipped = [n for n, fn in search_rules.items()
                       if getattr(fn, "trade_off", False)]
            if skipped:
                self.log.append(
                    f"joint_search=False: {len(skipped)} loaded xfer rules "
                    "not applied (joint-search actions only)")
                _log.info(self.log[-1])
            self._greedy_search_rules_ran = bool(applied2)

        # warm start (docs/search.md): a cached near-miss plan — same
        # graph + knobs, shrunk/grown machine, refreshed profile, or
        # changed batch — seeds budgeted local refinement instead of the
        # full factorization enumeration; _warm_optimize returns None to
        # fall back to the cold search below
        if warm_seed is not None and self.config.search_budget > 0:
            warm = self._warm_optimize(warm_seed, batch_size, n_devices,
                                       memory_budget=memory_budget_bytes,
                                       live_plan=live_plan)
            if warm is not None:
                return self._finalize(warm)

        def select(lam: float, final: bool = True) -> SearchResult:
            if joint:
                # probes must not mutate the real graph (the lambda search
                # calls select repeatedly); only the final call replays the
                # winning rewrites onto it
                return self._joint_optimize(search_rules, batch_size,
                                            n_devices, lam=lam,
                                            materialize=final)
            return self._parallelize(self.graph, batch_size, n_devices,
                                     lam=lam)

        if memory_budget_bytes is not None:
            # non-joint probes are already final (nothing mutates), so the
            # lambda search can reuse them without a second pass
            best = self._lambda_search(select, memory_budget_bytes,
                                       probe_is_final=not joint)
        else:
            best = select(0.0)
        return self._finalize(best)

    def _finalize(self, best: SearchResult) -> SearchResult:
        """Shared epilogue of the cold and warm paths: logs, pruning
        counters, the calibration anchor, and the per-tier reduction
        synthesis for the CHOSEN strategies."""
        self.log.append(f"selected: {best.log[-1] if best.log else ''}")
        if self.sim.measured is not None:
            self.log.append(
                self.sim.measured.stats()
                + f"; {self.sim.analytic_fallbacks} analytic fallbacks"
            )
            _log.info(self.log[-1])
            self.sim.measured.save()
        best.log = self.log
        if getattr(self, "_greedy_search_rules_ran", False):
            best.greedy_search_rules = True
        best.candidates_simulated = self.candidates_simulated
        best.candidates_pruned = self.candidates_pruned
        # calibration anchor (obs/calibration.py): the selected plan's
        # predicted step cost, compared post-compile with measured steps
        best.predicted_step_us = best.cost_us
        # hierarchical machines: record the per-tier reduction strategy the
        # winning plan's synced tensors priced with, so export/analysis/
        # executor all see the same decomposition the simulator chose
        if hasattr(self.machine, "tier_path"):
            best.reduction_strategies = self.sim.cost.reduction_plan(
                self.graph, best.strategies)
        self.log.append(
            f"plan sanitizer: {self.candidates_simulated} factorization(s) "
            f"simulated, {self.candidates_pruned} pruned before costing")
        return best

    def _feasible_factorizations(self, graph: Graph, batch_size: int,
                                 n_devices: int) -> List[Tuple[int, ...]]:
        """Enumerate (dp, tp, ep, ap, sp) divisor tuples of the device
        count and prune the infeasible ones — shared by the cold
        enumeration (_parallelize) and the warm sweep (_warm_optimize).

        Plan-sanitizer pruning (analysis/passes.py): the cheap
        factorization pass rejects infeasible mesh tuples — non-dividing
        degrees, unusable axes — before the cost simulator prices them.
        analysis_prune=False simulates every divisor tuple instead (the
        unpruned baseline tests compare against): dp/tp/ep/ap degrade to
        replicated per op inside valid_strategies, and sp — the one axis
        whose graph-level blockers (SP disabled, dropout-carrying
        attention, ulysses heads) sp_shardable cannot see — is clamped to
        1 here, so both modes can only realize legal degrees. Pruning is
        accounted in the SearchResult counters, not the process-wide
        diagnostic counters — those mean "a plan was rejected", and
        skipping a candidate the search never chose is not a rejection."""
        from ..analysis import factorization_diagnostics
        from ..obs.tracing import get_tracer

        sp_feasible = make_sp_feasible(graph, self.config)
        prune = getattr(self.config, "analysis_prune", True)
        expert_counts = {op.params["n"] for op in graph.ops.values()
                         if op.op_type == OpType.EXPERTS}
        has_spatial = any(op.op_type in AP_CAPABLE
                          for op in graph.ops.values())
        # multi-tier machines: experts must stay pod-resident — the ep
        # group's span (ep x the axes nested inside it) may not cross the
        # innermost tier, or every step's routing all_to_all rides DCN
        # (FFTA085). Flat machines have no slow tier to protect.
        tiers = getattr(self.machine, "tiers", None)
        pod_degree = int(tiers[0].degree) if tiers and len(tiers) > 1 \
            else None
        tuples = [
            (dp, tp, ep, ap, sp)
            for dp, rest in _divisor_pairs(n_devices)
            for tp, rest2 in _divisor_pairs(rest)
            for ep, rest3 in _divisor_pairs(rest2)
            for ap, sp in _divisor_pairs(rest3)
        ]
        if self.config.only_data_parallel:
            tuples = [(n_devices, 1, 1, 1, 1)]
        feasible = []
        with get_tracer().span("search.enumerate", n_devices=n_devices,
                               candidates=len(tuples)) as _sp_enum:
            for fact in tuples:
                if prune:
                    if factorization_diagnostics(
                            graph, self.config, batch_size, fact,
                            sp_pred=sp_feasible,
                            expert_counts=expert_counts,
                            has_spatial=has_spatial,
                            pod_degree=pod_degree):
                        self.candidates_pruned += 1
                        continue
                elif fact[4] > 1 and (sp_feasible is None
                                      or not sp_feasible(fact[4])):
                    fact = fact[:4] + (1,)
                feasible.append(fact)
            _sp_enum.set(feasible=len(feasible),
                         pruned=len(tuples) - len(feasible))
        return feasible

    def _parallelize(self, graph: Graph, batch_size: int, n_devices: int,
                     lam: float = 0.0, quiet: bool = False) -> SearchResult:
        """Best parallelization of a fixed graph under the runtime +
        lam * memory objective: enumerate mesh factorizations, segment-DP
        each (reference: Graph::optimal_cost via the DP in graph.cc:1586;
        lam is the lambda of the memory-aware search, graph.cc:2075)."""
        from ..obs.tracing import get_tracer

        tracer = get_tracer()
        candidates: List[SearchResult] = []
        feasible = self._feasible_factorizations(graph, batch_size,
                                                 n_devices)
        # Stage 1 (cheap): per-segment DP + one full-graph simulate per mesh
        # factorization. Stage 2 (expensive): the cross-segment best-first
        # refinement — O(budget x boundary-ops x menu x simulate) — runs
        # only on the top-K stage-1 candidates. Sweeping refinement over
        # every factorization made a 24-layer/256-device search take
        # minutes for factorizations that were never going to win
        # (reference analog: graph.cc's memoized DP exists precisely to
        # keep the 100+-op x many-machine-view regime tractable).
        seeded = []
        with tracer.span("search.simulate", factorizations=len(feasible)):
            for dp, tp, ep, ap, sp in feasible:
                self.candidates_simulated += 1
                strategies: Dict[int, OpStrategy] = {}
                for seg in self._segments(graph):
                    strategies.update(
                        self._optimize_segment(seg, dp, tp, batch_size,
                                               ep=ep, ap=ap, sp=sp,
                                               lam=lam))
                cost = self.sim.simulate(graph, strategies)
                mem = self.sim.memory_bytes(graph, strategies)
                seeded.append((cost + lam * mem, (dp, tp, ep, ap, sp),
                               strategies, cost, mem))
        seeded.sort(key=lambda x: x[0])
        top_k = max(1, int(getattr(self.config, "refine_top_k", 4)))
        for rank, (obj, (dp, tp, ep, ap, sp), strategies, cost,
                   mem) in enumerate(seeded):
            if rank < top_k:
                # cross-segment refinement: per-segment DP cannot see
                # reshard costs across segment boundaries (e.g. the
                # column->row TP pairing on a chain, where every node is
                # its own segment) — re-optimize single-op flips against
                # the FULL-graph simulate
                with tracer.span("search.refine",
                                 factorization=f"dp={dp},tp={tp},ep={ep},"
                                               f"ap={ap},sp={sp}"):
                    strategies = self._refine_global(
                        graph, strategies, dp, tp, batch_size, ep, ap,
                        lam, sp=sp)
                cost = self.sim.simulate(graph, strategies)
                mem = self.sim.memory_bytes(graph, strategies)
            candidates.append(
                SearchResult(strategies,
                             self._axes(dp, tp, strategies, ep, ap, sp),
                             cost, mem,
                             [f"dp={dp} tp={tp} ep={ep} ap={ap} sp={sp} "
                              f"cost={cost:.1f}us mem={mem/1e9:.2f}GB"
                              + ("" if rank < top_k else " (unrefined)")])
            )
        candidates.extend(
            self._pipeline_candidates(graph, batch_size, n_devices))
        if not candidates:
            raise ValueError("no feasible mesh factorization")
        candidates = self._verify_candidate_plans(graph, batch_size,
                                                  candidates)
        best = min(candidates, key=lambda r: r.cost_us + lam * r.memory_bytes)
        # grad-sync overlap split of the winner (docs/machine.md
        # "Overlap"): pipeline candidates computed theirs inline;
        # re-simulate mesh winners once (memoized op costs — cheap) so
        # the recorded stats describe THIS strategy set, not whichever
        # candidate the simulator priced last
        if best.exposed_sync_us is None and "stage" not in best.mesh_axes:
            self.sim.simulate(graph, best.strategies)
            st = self.sim.last_sync_stats or {}
            best.overlapped_sync_us = st.get("overlapped_sync_us")
            best.exposed_sync_us = st.get("exposed_sync_us")
            best.sync_buckets = len(st.get("buckets") or [])
        if not quiet:
            self.log.extend(c.log[0] for c in candidates)
        return best

    def _verify_candidate_plans(self, graph: Graph, batch_size: int,
                                candidates: List[SearchResult]
                                ) -> List[SearchResult]:
        """Opt-in FFTA09x search prune (--verify-candidates,
        docs/analysis.md "Verifier"): symbolically execute each
        candidate plan through the sharding-flow interpreter's cheap
        layout subset and drop the ones it rejects BEFORE the winner is
        chosen — a failing plan would only bounce off the compile gate
        later, after the search already spent its budget on it. A slate
        the verifier rejects wholesale is returned unfiltered (the
        compile gate gives the real, attributed error)."""
        if not getattr(self.config, "verify_candidates", False):
            return candidates
        from ..analysis.diagnostics import Severity
        from ..analysis.interp import ShardingFlowInterpreter

        kept: List[SearchResult] = []
        rejected = 0
        for r in candidates:
            diags = ShardingFlowInterpreter(
                graph, r.strategies, batch_size=batch_size).run()
            if any(d.severity is Severity.ERROR for d in diags):
                rejected += 1
                continue
            kept.append(r)
        self.candidates_verify_rejected = rejected
        if rejected:
            self.log.append(
                f"verify-candidates: sharding-flow verifier rejected"
                f" {rejected}/{len(candidates)} candidate plan(s)")
        return kept or candidates

    def _pipeline_candidates(self, graph: Graph, batch_size: int,
                             n_devices: int) -> List[SearchResult]:
        """Pipeline-parallel mesh candidates (JAX `_pipeline_candidates`; the
        reference's OP_PIPELINE enum ffconst.h:159 is unused): a (dp, pp)
        mesh routes the graph's repeated-block region through the GPipe
        kernel (kernels/pipeline.py). Priced
        as region_cost * (M+S-1)/(M*S) — the bubble-inclusive GPipe
        schedule length — plus 2(M+S-1) activation ppermute hops, with
        region weights/optimizer state sharded S-ways (the memory win the
        lambda search can buy when dp replication does not fit).

        Tier-aware placement (docs/machine.md "Overlap"): on a
        multi-tier hierarchical machine each (dp, pp) split is priced
        under BOTH stage-axis nestings (pipeline_plan
        .stage_placement_options) — stage OUTERMOST puts every stage on
        a contiguous device block, so when dp covers whole inner-tier
        groups the stage cut lands on a pod edge: DCN carries only the
        thin inter-stage activation hops while each stage's dp
        weight syncs stay on ICI. Stage-boundary hops are priced on
        the tier path (ring_hop_time_us with the placement's stage
        stride), not the flat innermost p2p term, and weight-gradient
        syncs (region: per-stage dp group; rest: the whole mesh) are
        priced with the bucket/overlap model — only the exposed tail
        is charged when overlap is on."""
        if (not getattr(self.config, "enable_pipeline_parallel", False)
                or self.config.only_data_parallel):
            return []
        from ..parallel.pipeline_plan import (find_isomorphic_run,
                                              stage_placement_options)

        # the lambda search re-enters per probe with an unchanged graph:
        # cache the run finder rather than re-scanning. Only the REAL graph
        # is cached (keyed by its op-guid set, which every rewrite changes);
        # joint-search probe clones are transient and caching them would
        # pin every discarded clone in memory for the helper's lifetime
        if graph is self.graph:
            if not hasattr(self, "_pp_run_cache"):
                self._pp_run_cache = {}
            key = frozenset(graph.ops)
            if key not in self._pp_run_cache:
                self._pp_run_cache.clear()  # rewrites invalidated the old
                self._pp_run_cache[key] = find_isomorphic_run(graph)
            run_len, run, entries = self._pp_run_cache[key]
        else:
            run_len, run, entries = find_isomorphic_run(graph)
        if run_len < 2:
            return []
        m = max(1, getattr(self.config, "pipeline_microbatches", 4))
        if batch_size % m:
            return []
        # pipeline candidates are dp-only: reset any tiered mesh context
        # a previous factorization's seeding installed
        self.sim.cost.set_mesh_degrees()
        entry = entries[0]
        import numpy as np

        act_elems = int(np.prod(entry.dims[1:]))  # per-sample activation
        act_bytes_el = 2 if self.config.allow_mixed_precision else 4
        overlap = bool(self.config is None
                       or self.config.search_overlap_backward_update)
        bucket_bytes = (float(getattr(self.config, "grad_bucket_bytes", 0)
                              or 0) if overlap else 0.0)
        # the weight-sync term below is priced only where the overlap
        # model is active at all: a MULTI-tier machine with the overlap
        # knob on. Flat and one-tier machines keep the historical
        # compute+hop pipeline pricing bit-for-bit, and
        # search_overlap_backward_update=False keeps the legacy
        # blocking path untouched (config.grad_bucket_bytes is
        # documented inert in both cases)
        multi = (hasattr(self.machine, "tier_path")
                 and len(getattr(self.machine, "tiers", ())) > 1)
        sync_active = multi and overlap
        out: List[SearchResult] = []
        for dp, pp in _divisor_pairs(n_devices):
            if pp <= 1 or pp > run_len:
                continue
            if batch_size % dp or (batch_size // m) % dp:
                continue
            # the executor pipelines the largest multiple of pp groups and
            # runs the rest sequentially (pipeline_plan truncation) — price
            # the same split
            usable = (run_len // pp) * pp
            region = {op.guid for g in run[:usable] for op in g}
            strategies = {guid: OpStrategy(dp=dp, tp=1)
                          for guid in graph.ops}
            region_cost = rest_cost = 0.0
            mem = region_w = rest_w = 0.0
            region_wbs: List[float] = []
            rest_wbs: List[float] = []
            for guid, op in graph.ops.items():
                t = self.sim.op_step_time_us(op, strategies[guid])
                om = self.sim.cost.op_memory_bytes(op, strategies[guid])
                wb = sum(w.num_elements() * w.dtype.np_dtype.itemsize
                         for w in op.weights)
                if guid in region:
                    region_cost += t
                    mem += om / pp
                    region_w += wb
                    if wb:
                        region_wbs.append(wb)
                else:
                    rest_cost += t
                    mem += om
                    rest_w += wb
                    if wb:
                        rest_wbs.append(wb)
            hop_bytes = (batch_size // m // dp) * act_elems * act_bytes_el
            ticks = m + pp - 1
            compute_us = rest_cost + region_cost * ticks / (m * pp)
            for place in stage_placement_options(self.machine, dp, pp):
                if self.sim.cost.tiered:
                    # the stage hop crosses the tiers the stage axis
                    # actually spans at this nesting — a pod-aligned cut
                    # pays DCN for the thin activation, never the
                    # innermost p2p price
                    hop_us = self.machine.ring_hop_time_us(
                        hop_bytes, pp, inner=place["hop_inner"])
                else:
                    hop_us = self.machine.p2p_time_us(hop_bytes)
                # weight-gradient sync: region weights sync over each
                # stage's OWN dp group (concurrent across stages -> one
                # stage's 1/pp share at the placement's dp stride); rest
                # weights replicate across stages and sync mesh-wide.
                # Bucketed into grad_bucket_bytes chunks; with overlap
                # on, the backward window (bwd = 2x fwd -> 2/3 of
                # compute) hides what fits and only the exposed tail is
                # charged — blocking pricing charges it all.
                sync_us = 0.0
                n_buckets = 0
                if sync_active:
                    # region weights sync concurrently across stages
                    # (conc=pp, one stage's share); rest weights sync
                    # mesh-wide. grad_bucket_bytes=0 prices true
                    # per-tensor issue — one latency payment per
                    # tensor, matching simulate()'s un-bucketed path —
                    # not one fused collective
                    for wbs, total, n, inner, conc in (
                            (region_wbs, region_w, dp,
                             place["dp_inner"], pp),
                            (rest_wbs, rest_w, dp * pp, 1, 1)):
                        if n <= 1 or total <= 0:
                            continue
                        if bucket_bytes:
                            share = total / conc
                            k = max(1, int(-(-share // bucket_bytes)))
                            sync_us += k * self.sim.cost._allreduce_us(
                                share / k, n, inner)
                            n_buckets += k
                        else:
                            sync_us += sum(
                                self.sim.cost._allreduce_us(wb, n, inner)
                                for wb in wbs) / conc
                            n_buckets += len(wbs)
                window = (2.0 / 3.0) * compute_us if sync_active else 0.0
                exposed = max(0.0, sync_us - window)
                cost = compute_us + 2.0 * ticks * hop_us + exposed
                axes = {name: size for name, size in place["axes"]
                        if name != "data" or dp > 1}
                placement = {"order": place["order"],
                             "hop_tier": place["hop_tier"],
                             "hop_us": hop_us,
                             "cut_on_tier_boundary":
                                 place["cut_on_tier_boundary"],
                             "sync_us": sync_us}
                out.append(SearchResult(
                    dict(strategies), axes, cost, mem,
                    [f"dp={dp} pp={pp} m={m} place={place['order']}"
                     + (f" hop={place['hop_tier']}"
                        if place["hop_tier"] else "")
                     + f" cost={cost:.1f}us mem={mem/1e9:.2f}GB"],
                    overlapped_sync_us=(sync_us - exposed
                                        if sync_active else None),
                    exposed_sync_us=exposed if sync_active else None,
                    sync_buckets=n_buckets,
                    pipeline_placement=placement))
        return out

    def _boundary_ops(self, graph: Graph) -> List[Op]:
        """Ops with an edge crossing a segment boundary — the only ops whose
        flips the per-segment DP mis-costed."""
        seg_of: Dict[int, int] = {}
        for i, seg in enumerate(self._segments(graph)):
            for op in seg:
                seg_of[op.guid] = i
        seen = set()
        uniq: List[Op] = []

        def add(op):
            if op.guid not in seen:
                seen.add(op.guid)
                uniq.append(op)

        for op in graph.topo_order():
            # cross-segment producers in input order (deterministic — the
            # native core iterates its edge list the same way)
            cross = [t.owner_op for t in op.inputs
                     if t.owner_op is not None
                     and t.owner_op.guid in graph.ops
                     and seg_of.get(t.owner_op.guid) != seg_of.get(op.guid)]
            if not cross:
                continue
            add(op)
            for src in cross:
                add(src)
        return uniq

    def _refine_global(self, graph: Graph, strategies: Dict[int, OpStrategy],
                       dp: int, tp: int, batch: int, ep: int = 1,
                       ap: int = 1, lam: float = 0.0,
                       sp: int = 1) -> Dict[int, OpStrategy]:
        """Whole-graph best-first refinement, costed by the event-driven
        full-graph simulate — the pass that sees cross-segment edge
        interactions the per-segment DP cannot (reference: base_optimize
        runs its flips against Graph::optimal_cost of the whole graph,
        substitution.cc:2229). Flip candidates are restricted to
        segment-boundary ops: interior flips were already optimal under the
        segment DP, so sweeping them against the (much costlier) full-graph
        simulate only burns budget."""
        budget = max(0, self.config.search_budget)
        ops = self._boundary_ops(graph)
        if budget == 0 or not ops:
            return strategies
        key = (tuple(sorted(graph.ops)), dp, tp, ep, ap, sp,
               round(lam, 15), "global")
        if key in self._memo:
            return self._memo[key]

        def cost_of(st):
            c = self.sim.simulate(graph, st)
            if lam:
                c += lam * self.sim.memory_bytes(graph, st)
            return c

        best = self._best_first_flips(ops, strategies, cost_of,
                                      dp, tp, batch, ep, ap, sp)
        self._memo[key] = best
        return best

    # -- warm-started refinement (docs/search.md) --------------------------
    def _warm_optimize(self, seed: Dict[str, Any], batch_size: int,
                       n_devices: int,
                       memory_budget: Optional[float] = None,
                       live_plan=None) -> Optional[SearchResult]:
        """Budgeted local refinement seeded from a cached near-miss plan
        (same graph + knobs; the machine shrank/grew, the fitted profile
        refreshed, or the batch changed) instead of the cold
        factorization enumeration:

         1. QUICK SWEEP: every feasible factorization priced ONCE by
            transplanting the cached per-op strategies into its legal
            menus (a structural clamp — nearest by log-2 axis distance,
            no per-candidate pricing) and running one full-graph
            simulate — the cost floor the tolerance fallback compares
            against, at a fraction of the cold stage-1's per-segment
            flip DP;
         2. RANK: the sweep's best factorizations plus the one nearest
            the seed's axes are ranked by simulated cost (plus the
            plan-distance term below);
         3. REFINE the winner with `_best_first_flips` — the same
            budgeted pass the cold search's global refinement uses —
            over only the ops worth budget: ones whose clamp BROKE the
            seed's sharding pattern (an axis the op used no longer
            divides) and CONTESTED ones whose locally-best strategy on
            the NEW machine disagrees with the transplanted choice (the
            machine move changed the op's trade-off — e.g. a dp sync
            that crossed DCN on the old machine but stays on ICI now);
         4. PLAN DISTANCE: with a LIVE plan present (elastic/drift
            re-plans), each candidate's ranking adds the predicted
            redistribution cost of moving the live weights onto it
            (plan_cache.plan_distance_us, priced via resharding/cost.py)
            weighted by --replan-distance-weight, so a marginally-
            cheaper step never triggers a massive reshard.

        Returns None — fall back to the cold search — when the seed
        carries graph rewrites (replaying them here and then falling
        back would leave the graph half-rewritten), is a pipeline plan
        (local flips have no pipeline moves), does not cover this
        graph's ops, exceeds --warm-fallback-tolerance x the sweep
        floor (checked only without a live plan: a distance-weighted
        winner may legitimately trade step time for reshard bytes, and
        the cold path prices no distance), or misses the memory budget
        (the lambda search is a cold-path capability)."""
        import math as _math

        from ..obs.tracing import get_tracer

        if seed.get("applied_rewrites") or seed.get("greedy_search_rules"):
            self.log.append(
                "warm start declined: cached plan carries graph rewrites")
            return None
        sa = seed.get("mesh_axes") or {}
        if "stage" in sa:
            self.log.append(
                "warm start declined: pipeline seed (no local moves)")
            return None
        ops_entry = seed.get("ops") or {}
        by_name = {op.name: op for op in self.graph.ops.values()}
        missing = set(by_name) - set(ops_entry)
        if missing:
            self.log.append(
                f"warm start declined: cached plan missing"
                f" {len(missing)} op(s)")
            return None
        facts = self._feasible_factorizations(self.graph, batch_size,
                                              n_devices)
        if not facts:
            return None
        tracer = get_tracer()
        seed_fact = (sa.get("data", 1), sa.get("model", 1),
                     sa.get("expert", 1), sa.get("attr", 1),
                     sa.get("seq", 1))

        def axdist(f, g) -> float:
            return sum(abs(_math.log2(max(1, a)) - _math.log2(max(1, b)))
                       for a, b in zip(f, g))

        def clamp(fact):
            """Transplant the seed's per-op strategies into `fact`'s
            legal menus — purely structural (no per-candidate pricing):
            nearest by axis distance, preferring a matching tp_row, menu
            order as the deterministic tie-break. Returns (strategies,
            broken) where `broken` lists ops whose seed SHARDING PATTERN
            (which axes the op actually uses) did not survive — the only
            ops worth spending refinement budget on."""
            dp, tp, ep, ap, sp = fact
            strategies: Dict[int, OpStrategy] = {}
            broken: List[Op] = []
            for op in self.graph.ops.values():
                menu = [s for s in valid_strategies(
                    op, dp, tp, batch_size, self.config, ep=ep, ap=ap,
                    sp=sp) if self._tp_ok(op, s)]
                e = ops_entry[op.name]
                want = (e.get("dp", 1), e.get("tp", 1), e.get("ep", 1),
                        e.get("ap", 1), e.get("sp", 1))
                want_row = bool(e.get("tp_row", False))
                chosen = min(enumerate(menu), key=lambda it: (
                    axdist((it[1].dp, it[1].tp, it[1].ep, it[1].ap,
                            it[1].sp), want)
                    + (0.0 if it[1].tp_row == want_row else 0.5),
                    it[0]))[1]
                strategies[op.guid] = chosen
                if ([d > 1 for d in (chosen.dp, chosen.tp, chosen.ep,
                                     chosen.ap, chosen.sp)]
                        != [d > 1 for d in want]
                        or chosen.tp_row != want_row):
                    broken.append(op)
            return strategies, broken

        quick = []
        with tracer.span("search.warm_sweep", factorizations=len(facts)):
            for fact in facts:
                self.candidates_simulated += 1
                dp, tp, ep, ap, sp = fact
                self.sim.cost.set_mesh_degrees(tp=tp, sp=sp, ep=ep, ap=ap)
                st, broken = clamp(fact)
                quick.append((self.sim.simulate(self.graph, st), fact,
                              st, broken))
        quick.sort(key=lambda x: (x[0], x[1]))
        sweep_floor = quick[0][0]
        near_fact = min(facts, key=lambda f: (axdist(f, seed_fact), f))
        cand = quick[:2] + [q for q in quick if q[1] == near_fact]
        seen_facts = set()
        candidates = []
        for q in cand:
            if q[1] not in seen_facts:
                seen_facts.add(q[1])
                candidates.append(q)
        weight = float(getattr(self.config, "replan_distance_weight", 1.0))

        # the candidate's devices: the re-plan config's actual survivor
        # ids when they match the searched count — identical layouts
        # must price as noops, not as cross-mesh transfers, when the
        # running ids are not 0..n-1 (e.g. the first pod already died)
        cand_ids = getattr(self.config, "device_ids", None)
        if not cand_ids or len(cand_ids) != n_devices:
            cand_ids = list(range(n_devices))

        def distance_of(strategies, axes):
            if live_plan is None or weight <= 0:
                return 0.0
            from .plan_cache import plan_distance_us

            try:
                return plan_distance_us(self.graph, live_plan,
                                        strategies, axes, self.machine,
                                        n_devices, device_ids=cand_ids)
            except Exception as exc:  # noqa: BLE001 — pricing the
                # distance term must never kill a re-plan; without it
                # the candidate ranks on runtime alone
                self.log.append(
                    "warm: plan-distance pricing failed"
                    f" ({type(exc).__name__}: {exc}); term dropped")
                return 0.0

        best = None
        best_rank = float("inf")
        for cost, fact, start, broken in candidates:
            dp, tp, ep, ap, sp = fact
            axes = self._axes(dp, tp, start, ep, ap, sp)
            dist_us = distance_of(start, axes)
            rank = cost + weight * dist_us
            self.log.append(
                f"warm dp={dp} tp={tp} ep={ep} ap={ap} sp={sp}"
                f" cost={cost:.1f}us"
                + (f" reshard={dist_us:.1f}us"
                   if live_plan is not None else ""))
            if rank < best_rank:
                best_rank = rank
                best = (fact, start, broken, dist_us)
        fact, start, broken, dist_us = best
        dp, tp, ep, ap, sp = fact
        self.sim.cost.set_mesh_degrees(tp=tp, sp=sp, ep=ep, ap=ap)
        # refinement budget goes to the WINNER only: pattern-broken ops
        # plus contested ones (locally-best != transplanted on the new
        # machine) — the ops the machine move actually put in play
        flip_ops: List[Op] = list(broken)
        seen_guids = {op.guid for op in broken}
        for op in self.graph.ops.values():
            menu = [s for s in valid_strategies(
                op, dp, tp, batch_size, self.config, ep=ep, ap=ap,
                sp=sp) if self._tp_ok(op, s)]
            local_best = min(
                menu, key=lambda s: self.sim.op_step_time_us(op, s))
            if (local_best != start[op.guid]
                    and op.guid not in seen_guids):
                seen_guids.add(op.guid)
                flip_ops.append(op)

        def cost_of(st):
            return self.sim.simulate(self.graph, st)

        with tracer.span("search.warm_refine", flips=len(flip_ops),
                         factorization=f"dp={dp},tp={tp},ep={ep},"
                                       f"ap={ap},sp={sp}"):
            refined = (self._best_first_flips(
                flip_ops, start, cost_of, dp, tp, batch_size, ep, ap,
                sp) if flip_ops else start)
        cost = self.sim.simulate(self.graph, refined)
        if refined != start and live_plan is not None:
            # the flip pass optimizes pure step time — it must not be
            # allowed to UNDO the reshard-aware choice (a marginal
            # simulate win that re-shards a weight). Re-rank the
            # refined plan with its own distance and keep whichever of
            # (start, refined) ranks better.
            r_axes = self._axes(dp, tp, refined, ep, ap, sp)
            r_dist = distance_of(refined, r_axes)
            if cost + weight * r_dist > best_rank:
                self.log.append(
                    f"warm: refinement reverted — {cost:.1f}us +"
                    f" {r_dist:.1f}us reshard ranks worse than the"
                    " transplanted plan")
                refined = start
                cost = self.sim.simulate(self.graph, refined)
            else:
                dist_us = r_dist
        mem = self.sim.memory_bytes(self.graph, refined)
        axes = self._axes(dp, tp, refined, ep, ap, sp)
        best = SearchResult(
            refined, axes, cost, mem,
            [f"warm dp={dp} tp={tp} ep={ep} ap={ap} sp={sp}"
             f" cost={cost:.1f}us mem={mem/1e9:.2f}GB"
             + (f" reshard={dist_us:.1f}us"
                if live_plan is not None else "")])
        self.log.append(best.log[0])
        tol = float(getattr(self.config, "warm_fallback_tolerance", 1.05))
        if best.cost_us > tol * sweep_floor:
            if live_plan is None:
                # the refined winner drifted too far from the sweep's
                # cost floor: the topology changed more than local
                # refinement can absorb
                self.log.append(
                    "warm start fell back to cold: refined"
                    f" {best.cost_us:.1f}us > {tol:.2f} x sweep floor"
                    f" {sweep_floor:.1f}us")
                return None
            # WITH a live plan the winner may legitimately trade step
            # time for reshard bytes — falling back to a cold search
            # (which prices no distance) would re-create the
            # massive-reshard choice the term exists to prevent. Keep
            # the plan for THIS re-plan, but do not cache it: a future
            # live-less lookup must not adopt a reshard-biased plan as
            # an exact hit.
            best.cache_store = False
            self.log.append(
                f"warm: keeping reshard-biased plan ({best.cost_us:.1f}us"
                f" > {tol:.2f} x floor {sweep_floor:.1f}us paid to avoid"
                f" {dist_us:.1f}us of redistribution); not cached")
        if memory_budget is not None and best.memory_bytes > memory_budget:
            self.log.append(
                "warm start fell back to cold: refined plan exceeds the"
                " memory budget (the lambda search is cold-path)")
            return None
        # overlap split of the winner: the simulate that priced `cost`
        # above already left last_sync_stats describing THESE strategies
        st = self.sim.last_sync_stats or {}
        best.overlapped_sync_us = st.get("overlapped_sync_us")
        best.exposed_sync_us = st.get("exposed_sync_us")
        best.sync_buckets = len(st.get("buckets") or [])
        best.cache_mode = "warm"
        self.log.append(
            f"warm start: refined {len(candidates)} candidate(s) near"
            f" seed axes {dict(sa)}; sweep floor {sweep_floor:.1f}us")
        return best

    def _lambda_search(self, select, budget: float,
                       probe_is_final: bool = True) -> SearchResult:
        """Binary-search the lambda of the runtime + lambda*memory objective
        until the selected strategy fits the per-chip HBM budget, keeping
        the smallest (fastest) fitting lambda (reference: the lambda binary
        search of graph.cc:2075-2131). probe_is_final: probes don't mutate
        (non-joint path) and can be returned directly."""

        def finalize(lam: float, probe: SearchResult) -> SearchResult:
            return probe if probe_is_final else select(lam)

        r = select(0.0, final=probe_is_final)
        if r.memory_bytes <= budget:
            self.log.append(
                f"lambda search: lam=0 fits ({r.memory_bytes/1e9:.2f}GB"
                f" <= {budget/1e9:.2f}GB)")
            return finalize(0.0, r)
        lam = 1e-12
        fit_lam = None
        for _ in range(40):
            r = select(lam, final=probe_is_final)
            if r.memory_bytes <= budget:
                fit_lam = lam
                break
            lam *= 4.0
        else:
            lam /= 4.0  # last probed value
        if fit_lam is None:
            best = finalize(lam, r)
            self.log.append(
                "lambda search: no strategy fits the budget; returning the "
                f"most memory-lean selection ({best.memory_bytes/1e9:.2f}GB)")
            return best
        hi_lam = fit_lam
        hi_r = r
        lo = hi_lam / 4.0
        for _ in range(10):
            mid = (lo + hi_lam) / 2.0
            rm = select(mid, final=probe_is_final)
            if rm.memory_bytes <= budget:
                hi_lam, hi_r = mid, rm
            else:
                lo = mid
        best = finalize(hi_lam, hi_r)
        self.log.append(
            f"lambda search: lam={hi_lam:.3g} fits "
            f"(cost={best.cost_us:.1f}us mem={best.memory_bytes/1e9:.2f}GB)")
        return best

    def _joint_optimize(self, rules, batch_size: int, n_devices: int,
                        lam: float = 0.0, materialize: bool = True
                        ) -> SearchResult:
        """Joint substitution x parallelization search (reference:
        GraphSearchHelper::base_optimize, substitution.cc:2229-2311):
        best-first over candidate *graphs* — each neighbor is one rewrite
        application — where a candidate's cost is its optimal parallelization
        (_parallelize) under the runtime + lam*memory objective. Candidates
        are deduplicated by graph hash; the segment-DP memo is shared across
        candidates because clones preserve op guids, so only rewritten
        segments re-cost."""

        def objective(r: SearchResult) -> float:
            return r.cost_us + lam * r.memory_bytes

        base = self.graph
        best_res = self._parallelize(base, batch_size, n_devices, lam=lam)
        best_cost = objective(best_res)
        # (rule name, structural match key, description) per applied rewrite
        best_seq: List[Tuple[str, Any, str]] = []
        self.log.append(f"joint: base cost={best_cost:.1f}us")
        visited = {base.hash()}
        counter = itertools.count()
        pq = [(best_cost, next(counter), base, [])]
        pops = 0
        budget = max(0, self.config.search_budget)
        alpha = self.config.search_alpha
        while pq and pops < budget:
            cost, _, g, seq = heapq.heappop(pq)
            pops += 1
            if cost > best_cost * alpha:
                continue  # prune (reference: substitution.cc:2278)
            apps = []
            for fn in rules.values():
                apps.extend(fn(g))
            for app in apps:
                g2 = g.clone()
                match = self._find_app(g2, rules, app.rule, app.match_key)
                if match is None:
                    continue
                match.apply()
                h = g2.hash()
                if h in visited:
                    continue
                visited.add(h)
                try:
                    r2 = self._parallelize(g2, batch_size, n_devices,
                                           lam=lam, quiet=True)
                except Exception as exc:  # infeasible rewrite: skip, log
                    self.log.append(
                        f"joint: {app.rule}({app.description}) infeasible: {exc}")
                    continue
                c2 = objective(r2)
                seq2 = seq + [(app.rule, app.match_key, app.description)]
                self.log.append(
                    f"joint: {app.rule}({app.description}) -> {c2:.1f}us")
                if c2 < best_cost:
                    best_cost, best_res, best_seq = c2, r2, seq2
                if c2 < cost * alpha:
                    heapq.heappush(pq, (c2, next(counter), g2, seq2))
        if best_seq and materialize:
            # materialize the winning rewrites on the real graph, then
            # re-cost it so strategies key to the real (fresh) op guids
            for rule_name, mkey, desc in best_seq:
                match = self._find_app(self.graph, rules, rule_name, mkey,
                                       description=desc)
                if match is None:
                    raise RuntimeError(
                        f"joint search: rewrite {rule_name}({desc}) did not "
                        "re-match on the original graph")
                match.apply()
            self.log.append(
                f"joint: applied {[(r, d) for r, _, d in best_seq]}")
            best_res = self._parallelize(self.graph, batch_size, n_devices,
                                         lam=lam, quiet=True)
            best_res.applied_rewrites = [(r, d) for r, _, d in best_seq]
            self.log.append(
                f"joint: post-rewrite {best_res.log[0] if best_res.log else ''}")
        return best_res

    @staticmethod
    def _find_app(graph: Graph, rules, rule_name: str, match_key,
                  description: Optional[str] = None):
        """Re-match a rewrite on another graph by its structural key — the
        matched ops' guids, which clones preserve — falling back to the
        description. The fallback matters for CHAINED rewrites at
        materialization: an op created by an earlier rewrite gets a fresh
        guid on the real graph (clone-time guids don't replay), but its
        name — and hence the description — is deterministic."""
        apps = rules[rule_name](graph)
        for a in apps:
            if a.match_key == match_key:
                return a
        if description is not None:
            for a in apps:
                if a.description == description:
                    return a
        return None

    def _axes(self, dp: int, tp: int, strategies: Dict[int, OpStrategy],
              ep: int = 1, ap: int = 1, sp: int = 1) -> Dict[str, int]:
        return mesh_axes_for(dp, tp, strategies, ep, ap, sp)


def mesh_axes_for(dp: int, tp: int, strategies: Dict[int, OpStrategy],
                  ep: int = 1, ap: int = 1, sp: int = 1) -> Dict[str, int]:
    """Mesh axes a strategy set actually uses (an axis is only included when
    some op shards over it) — shared by the Unity and MCMC searches so their
    exported mesh_axes follow one convention."""
    axes = {}
    if dp > 1 and any(s.dp > 1 for s in strategies.values()):
        axes["data"] = dp
    if tp > 1 and any(s.tp > 1 for s in strategies.values()):
        axes["model"] = tp
    if ep > 1 and any(s.ep > 1 for s in strategies.values()):
        axes["expert"] = ep
    if ap > 1 and any(s.ap > 1 for s in strategies.values()):
        axes["attr"] = ap
    if sp > 1 and any(s.sp > 1 for s in strategies.values()):
        axes["seq"] = sp
    return axes


def _want_measured(config) -> bool:
    """Measured-cost mode: an explicit `config.measure_op_costs` wins;
    otherwise costs are measured when the config's device is a CUDA card
    (the JAX package asks its default backend), so CPU searches (tests,
    dry runs) stay analytic."""
    explicit = getattr(config, "measure_op_costs", None)
    if explicit is not None:
        return explicit
    return str(getattr(config, "device", "cpu")).startswith("cuda")


def unity_optimize(graph: Graph, config, machine: MachineModel,
                   batch_size: int, n_devices: int,
                   simulator: Optional[Simulator] = None,
                   cache_graph_hash: Optional[str] = None) -> SearchResult:
    """Entry point (reference: FFModel::graph_optimize, substitution.cc:3589).

    Dispatches to the native C++ core (flexflow_tpu_torch/csrc/ffcore,
    loaded via ctypes) when available; the pure-Python path below is the
    fallback and the behavioral spec. A custom simulator (e.g. measured
    costs, the default on a CUDA config) forces the Python path.

    Plan cache (docs/search.md): unless disabled, the search is keyed by
    a content hash over (pre-rewrite graph, overlaid machine, batch,
    devices, search knobs). An exact hit adopts the cached plan —
    enumeration skipped entirely, the analysis gate still run — and a
    near-miss (same graph + knobs) seeds warm-started refinement.
    `cache_graph_hash` overrides the graph leg: the background
    pre-planner searches a POST-rewrite graph clone and passes the
    original pre-rewrite hash so its entry lands where the event-time
    fresh-graph lookup will look. Measured-cost searches bypass the
    cache — their answers depend on the mutable measured-cost cache,
    not just the key's content legs."""
    from . import plan_cache as _pc
    from .substitution import (
        apply_substitutions,
        load_rule_spec,
        rule_set_from_spec,
    )

    t_start = time.perf_counter()
    # measured op costs (reference: the simulator profiles real kernels,
    # simulator.cc:489,537): on by default when a real accelerator is the
    # backend; the process-wide cache persists across compiles
    measured = simulator is not None
    if simulator is None and _want_measured(config):
        from .simulator import get_op_cost_cache

        simulator = Simulator(config=config, machine=machine,
                              measured=get_op_cost_cache(config))
        measured = True

    cache = None if measured else _pc.get_plan_cache(config)
    key = None
    warm_seed = None
    if not measured:
        key = _pc.plan_key(graph, config, machine, batch_size, n_devices,
                           graph_hash=cache_graph_hash)
    if cache is not None and key is not None:
        from ..obs.tracing import get_tracer

        entry = cache.get_entry(key)
        if entry is not None:
            tier, data = entry
            with get_tracer().span("search", backend="cache",
                                   n_devices=n_devices,
                                   batch_size=batch_size) as sp:
                result = _adopt_cached_plan(graph, config, machine, data,
                                            batch_size, n_devices)
                if result is not None:
                    # counted only now: an entry that fails to bind or
                    # validate is a MISS, whatever the lookup found
                    cache.note_hit(tier)
                    sp.set(cost_us=result.cost_us, axes=result.mesh_axes,
                           simulated=0, pruned=0, cache="hit")
                    return _finish_search(result, key, None, t_start,
                                          graph)
                sp.set(cache="stale")
            # the entry no longer binds/validates on this graph/machine:
            # drop it and search cold
            cache.invalidate(key)
        cache.note_miss()
        if (getattr(config, "search_warm_start", True)
                and config.search_budget > 0):
            warm_seed = cache.get_warm(key)

    spec, is_taso = load_rule_spec(config.substitution_json_path)
    # a TASO rule file constrains the TP menu; the lambda memory search,
    # pipeline parallelism, and the joint substitution search are
    # Python-search capabilities — the native core covers the per-op axis
    # space (dp, tp incl. row/Megatron pairs, sp, ep, ap)
    from .substitution import search_rules_from_spec
    # parse TASO Rule objects once; threaded to every consumer below
    taso_rules = None
    if is_taso:
        from .substitution_loader import rules_from_spec

        taso_rules = rules_from_spec(spec)
    # trade-off rewrites (joint-search actions, or the greedy fallback when
    # joint_search=False) only exist on the Python path — route there
    # whenever any rewrite matches, so native availability never changes
    # which graph a config compiles
    rewrites_applicable = (
        config.search_budget > 0
        and any(fn(graph)
                for fn in search_rules_from_spec(
                    spec, is_taso, parsed=taso_rules).values())
    )
    if (simulator is None and not is_taso
            and not rewrites_applicable
            and not config.memory_search  # lambda search is Python-only
            and not getattr(config, "enable_pipeline_parallel", False)
            # hierarchical machines are Python-only: the native core's line
            # protocol carries chip scalars, not tiers, so it would price a
            # cross-DCN all-reduce like a neighbor hop
            and not hasattr(machine, "tier_path")
            and getattr(config, "use_native_search", True)):
        from .. import native

        if native.available():
            from ..obs.tracing import get_tracer

            # the native core runs enumerate/prune/simulate internally;
            # one "search" span still marks the phase in the trace
            with get_tracer().span("search", backend="native",
                                   n_devices=n_devices) as sp:
                applied = apply_substitutions(
                    graph, rule_set_from_spec(spec, is_taso))
                result = native.optimize_strategy(
                    graph, config, machine, batch_size, n_devices
                )
                sp.set(cost_us=result.cost_us, axes=result.mesh_axes)
            if applied:
                result.log.append(f"substitutions: {applied}")
            result.predicted_step_us = result.cost_us
            # the native core prices from the chip scalars alone — the
            # fitted latency/step-scale coefficients a profile overlay
            # sets (obs/refit.py) don't cross the line protocol, and
            # neither does the kernel tier's pricing (kernel_time_factor).
            # When either is active, re-price the CHOSEN plan with the
            # fully-overlaid Python simulator so predicted_step_us (what
            # calibration and the drift detector compare against)
            # reflects them; the native ranking stands
            sim = Simulator(machine, config)
            tier_active = any(
                sim.cost.kernel_time_factor(
                    op, result.strategies.get(op.guid, OpStrategy())) != 1.0
                for op in graph.ops.values())
            if (getattr(machine, "step_time_scale", 1.0) != 1.0
                    or getattr(machine, "dispatch_overhead_us", 1.0) != 1.0
                    or getattr(machine, "collective_latency_us", 1.0)
                    != 1.0
                    or tier_active):
                repriced = sim.simulate(graph, result.strategies)
                result.log.append(
                    f"{'kernel-tier' if tier_active else 'fitted-profile'}"
                    f" reprice: native {result.cost_us:.1f}"
                    f"us -> {repriced:.1f}us predicted")
                result.predicted_step_us = repriced
                st = sim.last_sync_stats or {}
                result.overlapped_sync_us = st.get("overlapped_sync_us")
                result.exposed_sync_us = st.get("exposed_sync_us")
                result.sync_buckets = len(st.get("buckets") or [])
            return _finish_search(result, key, cache, t_start, graph)
    helper = GraphSearchHelper(graph, config, machine, simulator)
    budget = None
    if config.memory_search:
        budget = config.memory_budget_mb * 1e6
    result = helper.graph_optimize(
        batch_size, n_devices, budget,
        rule_spec=(spec, is_taso, taso_rules), warm_seed=warm_seed,
        live_plan=getattr(config, "replan_live_plan", None))
    return _finish_search(result, key, cache, t_start, graph)


def _finish_search(result: SearchResult, key, cache, t_start: float,
                   graph: Graph) -> SearchResult:
    """Shared unity_optimize epilogue: stamp provenance + wall time,
    observe the mode-labeled wall histogram, count warm starts, and
    store cold/warm results in the plan cache (hits are already there)."""
    from .plan_cache import count_warm_start, observe_search_wall

    result.search_wall_ms = (time.perf_counter() - t_start) * 1e3
    if key is not None:
        result.graph_hash = key.graph_hash
        result.machine_hash = key.machine_hash
    observe_search_wall(result.search_wall_ms, result.cache_mode)
    if result.cache_mode == "warm":
        count_warm_start()
    if (cache is not None and key is not None
            and result.cache_mode != "hit" and result.cache_store):
        cache.put(key, result_to_dict(result, graph))
    return result


def _adopt_cached_plan(graph: Graph, config, machine, data: Dict[str, Any],
                       batch_size: int,
                       n_devices: int) -> Optional[SearchResult]:
    """Adopt a plan-cache entry onto (a rebuild of) its graph: replay
    the same rewrite pipeline the exporting search ran (greedy
    substitutions, then the recorded trade-off rewrites via
    import_strategy), bind strategies by op NAME, and re-validate the
    plan through the analysis gate (FFTA pipeline) before use. Returns
    None — the caller treats the entry as a miss — when anything fails
    to bind or validate; enumeration is skipped entirely on success
    (candidates_simulated == 0)."""
    from ..analysis import PlanAnalysisError, check_plan
    from .substitution import (apply_substitutions, load_rule_spec,
                               rule_set_from_spec, search_rules_from_spec)

    spec, is_taso = load_rule_spec(config.substitution_json_path)
    applied = apply_substitutions(graph, rule_set_from_spec(spec, is_taso))
    try:
        strategies, axes = import_strategy(
            graph, "<plan-cache>",
            rules=search_rules_from_spec(spec, is_taso), spec=data)
    except PlanAnalysisError:
        return None
    if set(strategies) != set(graph.ops):
        return None  # an op fell back to defaults: not this graph
    result = _result_of(strategies, axes, data, [])
    result.cache_mode = "hit"
    if applied:
        result.log.append(f"substitutions: {applied}")
    gate_off = getattr(config, "plan_analysis", "error") == "off"
    result.log.append(
        "plan cache: hit — enumeration skipped, "
        + ("analysis gate off: adopted WITHOUT re-validation" if gate_off
           else "plan re-validated through the analysis gate"))
    if not gate_off:
        try:
            # record=False: this is the ADOPTION gate; compile()'s
            # pre-flight gate still runs (and records) downstream, so
            # counting here would double every diagnostic on a hit
            check_plan(graph, record=False, strategies=strategies,
                       mesh_axes=dict(axes), machine=machine,
                       config=config, batch_size=batch_size,
                       n_devices=n_devices,
                       reduction_strategies=result.reduction_strategies
                       or None)
        except PlanAnalysisError as exc:
            _log.warning(
                "plan cache: cached plan failed re-validation (%s);"
                " falling back to cold search", exc)
            return None
    return result


def result_from_dict(graph: Graph, config, data: Dict[str, Any],
                     log: Optional[List[str]] = None) -> SearchResult:
    """The SearchResult `result_to_dict` serialized, adopted onto `graph`
    (a rebuild of the searched graph): the greedy rewrite pass and the
    recorded trade-off rewrites replayed, strategies bound by op name.
    How the ranks other than the searching one adopt its plan
    (FFModel._search: one plan on every rank). Raises PlanAnalysisError
    on a malformed plan and ValueError when an op of `graph` is left
    without a strategy (a plan of another graph)."""
    strategies, axes = rewrite_and_import_strategy(
        graph, config, "<broadcast plan>", spec=data,
        check_provenance=False)
    missing = sorted(op.name for g, op in graph.ops.items()
                     if g not in strategies)
    if missing:
        raise ValueError(f"the plan names no strategy for {missing[:5]}")
    prov = data.get("provenance") or {}
    result = _result_of(strategies, axes, data, list(log or []))
    result.graph_hash = prov.get("graph_hash")
    result.machine_hash = prov.get("machine_hash")
    result.candidates_simulated = int(prov.get("candidates_simulated") or 0)
    result.candidates_pruned = int(prov.get("candidates_pruned") or 0)
    result.cache_mode = prov.get("cache_mode") or "cold"
    result.search_wall_ms = prov.get("search_wall_ms")
    return result


def _result_of(strategies, axes, data: Dict[str, Any],
               log: List[str]) -> SearchResult:
    """A SearchResult of bound strategies and the rest of a
    `result_to_dict` plan: its costs, rewrites and the informational
    reduction and overlap records."""
    result = SearchResult(
        strategies=strategies, mesh_axes=dict(axes),
        cost_us=float(data.get("cost_us", 0.0)),
        memory_bytes=float(data.get("memory_bytes", 0.0)), log=log)
    result.predicted_step_us = data.get("predicted_step_us",
                                        result.cost_us)
    result.applied_rewrites = [tuple(x)
                               for x in data.get("applied_rewrites", [])]
    result.greedy_search_rules = bool(data.get("greedy_search_rules"))
    result.reduction_strategies = dict(data.get("reductions") or {})
    ov = data.get("overlap") or {}
    if ov:
        result.overlapped_sync_us = ov.get("overlapped_sync_us")
        result.exposed_sync_us = ov.get("exposed_sync_us")
        result.sync_buckets = int(ov.get("sync_buckets") or 0)
        result.pipeline_placement = ov.get("pipeline_placement")
    return result


def result_to_dict(result: SearchResult, graph: Graph) -> Dict[str, Any]:
    """The serialized-plan dict shared by export_strategy and the plan
    cache — strategies keyed by op NAME (guids are process-local), the
    informational reduction/overlap records, and the search provenance
    (the cache-key content hashes plus the enumeration counters)."""
    return {
        "mesh_axes": result.mesh_axes,
        "cost_us": result.cost_us,
        "memory_bytes": result.memory_bytes,
        "predicted_step_us": result.predicted_step_us,
        # rewrites the search materialized: the import path replays these
        # (by rule + description) so op names in "ops" resolve
        "applied_rewrites": list(result.applied_rewrites),
        "greedy_search_rules": result.greedy_search_rules,
        # per-tier reduction decomposition (hierarchical machines only):
        # informational for import — reduction strategies are a property
        # of the machine the plan compiles onto, so compile() re-derives
        # them — but the tier decomposition stays visible in the exported
        # artifact (docs/machine.md)
        **({"reductions": result.reduction_strategies}
           if result.reduction_strategies else {}),
        # overlap split of the predicted step (docs/machine.md
        # "Overlap") — informational, like "reductions": compile()
        # re-derives it for the machine the plan lands on
        **({"overlap": {
            "overlapped_sync_us": result.overlapped_sync_us,
            "exposed_sync_us": result.exposed_sync_us,
            "sync_buckets": result.sync_buckets,
            **({"pipeline_placement": result.pipeline_placement}
               if result.pipeline_placement else {}),
        }} if result.exposed_sync_us is not None else {}),
        # search provenance (docs/search.md): which graph/machine this
        # plan was produced for, and what the search actually did —
        # `analyze` warns when the hashes don't match the target
        "provenance": {
            "graph_hash": result.graph_hash,
            "machine_hash": result.machine_hash,
            "candidates_simulated": result.candidates_simulated,
            "candidates_pruned": result.candidates_pruned,
            "cache_mode": result.cache_mode,
            "search_wall_ms": result.search_wall_ms,
        },
        "ops": {
            graph.ops[guid].name: {"dp": s.dp, "tp": s.tp, "ep": s.ep,
                                   "ap": s.ap, "sp": s.sp,
                                   "tp_row": s.tp_row}
            for guid, s in result.strategies.items()
            if guid in graph.ops
        },
    }


def rewrite_and_import_strategy(graph: Graph, config, path: str,
                                spec: Optional[dict] = None,
                                check_provenance: bool = True):
    """compile()'s --import preamble, shared with the analyze CLI so the
    two paths cannot drift: the exporting search ran the greedy rewrite
    pass before choosing strategies, so op names in the file refer to the
    REWRITTEN graph (e.g. fuse_parallel_ops' merged names) — re-run the
    same deterministic pass before matching names. Trade-off (search-rule)
    rewrites the exporting search materialized are recorded in the file
    and replayed by import_strategy via the rules registry. Returns
    (strategies, mesh_axes); raises PlanAnalysisError on a malformed
    file.

    Provenance: the PRE-rewrite graph hash and this config's machine
    hash are computed here and checked against the file's recorded
    provenance — a strategy JSON silently applied to a different graph
    or machine than the one that produced it now warns (FFTA052).
    check_provenance=False skips that (the analyze CLI runs its own
    check so the mismatch lands in ITS printed report, not twice in
    the process counters)."""
    from .plan_cache import graph_fingerprint, machine_fingerprint
    from .substitution import (apply_substitutions, load_rule_spec,
                               rule_set_from_spec, search_rules_from_spec)

    expect_graph = expect_machine = None
    if check_provenance:
        expect_graph = graph_fingerprint(graph)
        try:
            from .machine_model import make_machine_model

            expect_machine = machine_fingerprint(
                make_machine_model(config, config.total_devices))
        except Exception:  # noqa: BLE001 — a spec-less config must
            # still import; the machine leg of the check just disarms
            pass
    rule_spec, is_taso = load_rule_spec(config.substitution_json_path)
    apply_substitutions(graph, rule_set_from_spec(rule_spec, is_taso))
    return import_strategy(graph, path, spec=spec,
                           rules=search_rules_from_spec(rule_spec, is_taso),
                           expect_graph_hash=expect_graph,
                           expect_machine_hash=expect_machine)


def export_strategy(result: SearchResult, graph: Graph, path: str) -> None:
    """Serialize the chosen strategy (reference: --export, model.cc:3609).
    The file carries search provenance (graph/machine content hashes +
    enumeration counters) so importing it onto a DIFFERENT graph or
    machine warns (FFTA052) instead of silently applying."""
    with open(path, "w") as f:
        json.dump(result_to_dict(result, graph), f, indent=2)


def import_strategy(graph: Graph, path: str, rules=None,
                    spec: Optional[dict] = None,
                    expect_graph_hash: Optional[str] = None,
                    expect_machine_hash: Optional[str] = None
                    ) -> Tuple[Dict[int, OpStrategy], Dict[str, int]]:
    """Load a strategy exported by export_strategy (reference: --import).

    rules: the search-rule registry (search_rules_from_spec) — needed to
    replay the trade-off rewrites the exporting search materialized, so
    rule-created op names in the file resolve against this graph.
    spec: the already-parsed file contents, when the caller read the JSON
    itself (the analyze CLI also pulls "reductions" from it) — avoids a
    second read that could drift from this one.
    expect_graph_hash/expect_machine_hash: the importing side's content
    hashes (plan_cache.graph_fingerprint on the PRE-rewrite graph /
    machine_fingerprint) — when the file records provenance and it
    disagrees, an FFTA052 warning fires instead of the mismatch passing
    silently. Files without provenance (pre-provenance exports, hand-
    written strategies) are not warned about."""
    if spec is not None:
        data = spec
    else:
        with open(path) as f:
            data = json.load(f)
    if rules:
        from .substitution import apply_substitutions

        if data.get("greedy_search_rules"):
            apply_substitutions(graph, rules)
        for rule_name, desc in data.get("applied_rewrites", []):
            if rule_name not in rules:
                _log.warning("import_strategy: unknown rewrite rule %r "
                             "in strategy file", rule_name)
                continue
            hits = [a for a in rules[rule_name](graph)
                    if a.description == desc]
            if not hits:
                _log.warning(
                    "import_strategy: recorded rewrite %s(%s) did not "
                    "re-match on this graph — its op entries may fall "
                    "back to default strategies", rule_name, desc)
                continue
            if len(hits) > 1:
                # descriptions can collide (substitution.py Application):
                # the replay may pick a different match than the exporter
                _log.warning(
                    "import_strategy: rewrite %s(%s) matches %d sites — "
                    "applying the first; the exported strategy may refer "
                    "to a different one", rule_name, desc, len(hits))
            hits[0].apply()
    # validate with the plan sanitizer's diagnostics instead of failing
    # deep inside with a KeyError on a malformed/mismatched entry
    from ..analysis.diagnostics import (DiagnosticReport, PlanAnalysisError,
                                        make_diag, record_report)

    diags = []
    # provenance check (docs/search.md): warn when this strategy was
    # produced for a DIFFERENT graph or machine than the one importing it
    prov = data.get("provenance") or {}
    if (expect_graph_hash and prov.get("graph_hash")
            and prov["graph_hash"] != expect_graph_hash):
        diags.append(make_diag(
            "FFTA052",
            "strategy file was produced for a different graph (recorded"
            f" hash {prov['graph_hash'][:12]}..., this graph"
            f" {expect_graph_hash[:12]}...)",
            hint="op entries that still match by name apply; re-export"
                 " from the current model to clear this"))
    if (expect_machine_hash and prov.get("machine_hash")
            and prov["machine_hash"] != expect_machine_hash):
        diags.append(make_diag(
            "FFTA052",
            "strategy file was produced for a different machine (recorded"
            f" hash {prov['machine_hash'][:12]}..., this machine"
            f" {expect_machine_hash[:12]}...)",
            hint="the plan's degrees may be legal here but its costs were"
                 " priced elsewhere; re-search on this machine to clear"))
    ops_entry = data.get("ops")
    if not isinstance(ops_entry, dict):
        diags.append(make_diag(
            "FFTA050", f"strategy file {path!r} has no 'ops' mapping",
            hint="re-export with export_strategy"))
        ops_entry = {}
    axes = data.get("mesh_axes", {})
    if not (isinstance(axes, dict)
            and all(isinstance(v, int) and v >= 1 for v in axes.values())):
        diags.append(make_diag(
            "FFTA050", f"mesh_axes {axes!r} is not a name->degree mapping"))
        axes = {}
    by_name = {op.name: op for op in graph.ops.values()}
    strategies = {}
    for name, s in ops_entry.items():
        if not isinstance(s, dict):
            diags.append(make_diag(
                "FFTA050", f"op entry {name!r} is not a strategy object"))
            continue
        degrees = {f: s.get(f, 1) for f in ("dp", "tp", "ep", "ap", "sp")}
        bad = {f: v for f, v in degrees.items()
               if not isinstance(v, int) or v < 1}
        if bad:
            diags.append(make_diag(
                "FFTA050",
                f"op entry {name!r} has non-positive-integer degree(s)"
                f" {bad}", hint="degrees are ints >= 1"))
            continue
        if name not in by_name:
            diags.append(make_diag(
                "FFTA051",
                f"strategy entry {name!r} matches no op in the graph; it"
                " falls back to the default strategy",
                hint="the exporting graph was rewritten differently"))
            continue
        strategies[by_name[name].guid] = OpStrategy(
            tp_row=bool(s.get("tp_row", False)), **degrees)
    report = DiagnosticReport(diags, passes_run=("strategy-file",))
    record_report(report)
    for d in report.warnings():
        _log.warning("%s", d.format())
    if report.errors():
        raise PlanAnalysisError(report)
    return strategies, axes
