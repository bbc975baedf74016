"""GraphXfer: executable source→target rewrites built from loaded rule files.

Reference parity: the reference turns each loaded rule into a GraphXfer whose
source pattern is matched against the PCG and replaced by the target pattern
(include/flexflow/substitution_loader.h:94-187 feeding
GraphXfer::create_xfers, substitution.h:119-121; matching/replacement in
src/runtime/substitution.cc). Before this module, loaded rule files were
distilled into a per-op-type TP-degree menu only — the templates never
executed. Here a Rule becomes a real rewrite:

- **Match**: backtracking assignment of the rule's (topo-ordered) srcOp list
  onto graph ops — op types equal, internal tensor references consistent
  ((opId, tsId) wiring), external pattern inputs bound consistently, and
  parallel-op degree/dim params equal. Interior tensors may not escape the
  match (their consumers must be matched too), mirroring the reference's
  "no external consumer" constraint. TASO patterns list WEIGHTS as explicit
  pattern inputs (OP_LINEAR has (x, w)); our ops hold weights internally,
  so pattern inputs beyond an op's data arity bind to weight markers —
  consistently per (op, slot) — and rules whose dst graph would need a
  weight as a data tensor (e.g. partition-the-weight layouts) stay
  menu-only (tp_candidates_from_rules distills those).
- **Replace**: dst parallel ops (OP_PARTITION/COMBINE/REPLICATE) are created
  as explicit PCG parallel ops (parallel/parallel_ops.py — identity on
  values, sharding change under GSPMD); dst compute ops are PAIRED with the
  matched src op of the same type (first-come order) and REUSED with rewired
  inputs, so weights carry over — the same object identity trick the
  reference's create_xfers uses. mappedOutput entries rewire downstream
  consumers; unpaired src ops are removed.

Applications integrate with the joint search (search_rules) and the
import-strategy replay exactly like the hand-written algebraic rules.

The port's copy of flexflow_tpu/search/graph_xfer.py: the parallel ops a
target inserts are the port's (parallel/parallel_ops.py), built from the
matched op's model config (substitution._model_of).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..core.graph import Graph
from ..core.op import Op
from ..ffconst import OpType
from .substitution import Application, _rewire
from .substitution_loader import Rule

# dst parallel-op constructors: OpType -> (class path resolved lazily)
_PARALLEL_CLS = {
    OpType.REPARTITION: "RepartitionOp",
    OpType.COMBINE: "CombineOp",
    OpType.REPLICATE: "ReplicateOp",
}

_MATCH_LIMIT = 64  # applications returned per rule per graph scan


class _WeightRef:
    """External-binding marker for a pattern input that maps to an op's
    INTERNAL weight (TASO lists weights as pattern inputs; our ops don't)."""

    __slots__ = ("guid", "slot")

    def __init__(self, guid: int, slot: int):
        self.guid = guid
        self.slot = slot

    def __eq__(self, other):
        return (isinstance(other, _WeightRef)
                and (self.guid, self.slot) == (other.guid, other.slot))

    def __hash__(self):
        return hash(("_WeightRef", self.guid, self.slot))


class GraphXfer:
    """One executable rewrite compiled from a loaded Rule."""

    def __init__(self, rule: Rule):
        self.rule = rule
        self.name = f"xfer:{rule.name}"
        # pair dst compute ops with src compute ops by (type, occurrence)
        self.dst_pairing: Dict[int, int] = {}
        src_pool: Dict[OpType, List[int]] = {}
        for i, o in enumerate(rule.src_ops):
            if not o.is_parallel_op:
                src_pool.setdefault(o.op_type, []).append(i)
        supported = rule.is_supported and bool(rule.mapped_outputs)
        for j, o in enumerate(rule.dst_ops):
            if o.is_parallel_op:
                if o.op_type not in _PARALLEL_CLS:
                    supported = False  # e.g. OP_REDUCE targets: shape-changing
                continue
            pool = src_pool.get(o.op_type, [])
            if not pool:
                supported = False  # dst op with no src weights to reuse
                break
            self.dst_pairing[j] = pool.pop(0)
        self.supported = supported

    # -- matching ----------------------------------------------------------
    def find_applications(self, graph: Graph) -> List[Application]:
        if not self.supported:
            return []
        src = self.rule.src_ops
        by_type: Dict[OpType, List[Op]] = {}
        for op in graph.topo_order():
            by_type.setdefault(op.op_type, []).append(op)
        # tensor guid -> consumer guids, once per scan (escape checks)
        consumers_of: Dict[int, set] = {}
        for c in graph.ops.values():
            for t in c.inputs:
                consumers_of.setdefault(t.guid, set()).add(c.guid)
        self._consumers_of = consumers_of
        matches: List[Tuple[List[Op], Dict]] = []
        binding: List[Optional[Op]] = [None] * len(src)
        bound_guids = set()
        ext: Dict[Tuple[int, int], object] = {}

        def bt(i: int) -> None:
            if len(matches) >= _MATCH_LIMIT:
                return
            if i == len(src):
                if self._valid_match(graph, binding, ext):
                    matches.append((list(binding), dict(ext)))
                return
            pat = src[i]
            for op in by_type.get(pat.op_type, []):
                if op.guid in bound_guids:
                    continue
                if len(pat.inputs) > len(op.inputs) + len(op.weights):
                    continue
                # don't stack onto ANY xfer's output (own or a sibling
                # degree rule's): a compute op already fed by an
                # xfer-created parallel op would re-match forever
                # (replicate(replicate(...))) and re-applications would
                # recreate duplicate deterministic names
                if any(t.owner_op is not None
                       and getattr(t.owner_op, "xfer_created", False)
                       for t in op.inputs):
                    continue
                if pat.is_parallel_op and not self._params_match(pat, op):
                    continue
                saved = []
                ok = True
                for k, tx in enumerate(pat.inputs):
                    if k >= len(op.inputs):
                        # pattern slot beyond the op's data arity: one of
                        # the op's internal weights (TASO convention)
                        if not tx.is_external:
                            ok = False  # ops don't consume others' weights
                            break
                        key = (tx.op_id, tx.ts_id)
                        marker = _WeightRef(op.guid, k - len(op.inputs))
                        if key in ext:
                            if ext[key] != marker:
                                ok = False
                                break
                        else:
                            ext[key] = marker
                            saved.append(key)
                        continue
                    actual = op.inputs[k]
                    if tx.is_external:
                        key = (tx.op_id, tx.ts_id)
                        prev = ext.get(key)
                        if prev is not None:
                            if (isinstance(prev, _WeightRef)
                                    or prev.guid != actual.guid):
                                ok = False
                                break
                        else:
                            ext[key] = actual
                            saved.append(key)
                    else:
                        m = binding[tx.op_id]
                        if (m is None or tx.ts_id >= len(m.outputs)
                                or m.outputs[tx.ts_id].guid != actual.guid):
                            ok = False
                            break
                if ok:
                    binding[i] = op
                    bound_guids.add(op.guid)
                    bt(i + 1)
                    bound_guids.discard(op.guid)
                    binding[i] = None
                for key in saved:
                    del ext[key]

        bt(0)
        apps = []
        for bnd, ebnd in matches:
            apps.append(Application(
                rule=self.name,
                apply=(lambda b=bnd, e=ebnd: self._apply(graph, b, e)),
                description=f"{self.rule.name}("
                            f"{','.join(op.name for op in bnd)})",
                key=(self.name,) + tuple(op.guid for op in bnd),
            ))
        return apps

    @staticmethod
    def _params_match(pat, op: Op) -> bool:
        deg, dim = pat.parallel_degree, pat.parallel_dim
        if deg is not None and op.params.get("degree") != deg:
            return False
        if dim is not None and op.params.get("dim", 0) != dim:
            return False
        return True

    def _valid_match(self, graph: Graph, binding, ext) -> bool:
        """Interior outputs must not escape; dst partition degrees must
        divide the dims they shard (feasibility on the bound shapes)."""
        mapped = {(m.src_op_id, m.src_ts_id)
                  for m in self.rule.mapped_outputs}
        matched = {op.guid for op in binding}
        for i, op in enumerate(binding):
            for ts, t in enumerate(op.outputs):
                if (i, ts) in mapped:
                    continue
                if self._consumers_of.get(t.guid, set()) - matched:
                    return False  # interior tensor escapes the match
        # feasibility of dst partition/combine degrees against real shapes.
        # A _WeightRef external has no graph shape: legal only as a reused
        # compute op's own weight slot; a dst PARALLEL op over a weight
        # (partition-the-kernel layouts) cannot execute as a graph op here —
        # those rules stay TP-menu-only.
        dims_of: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        for j, o in enumerate(self.rule.dst_ops):
            ins = []
            for tx in o.inputs:
                if tx.is_external:
                    src_t = ext.get((tx.op_id, tx.ts_id))
                    if src_t is None:
                        return False
                    if isinstance(src_t, _WeightRef):
                        if o.is_parallel_op:
                            return False
                        src_op = binding[self.dst_pairing[j]]
                        if src_t.guid != src_op.guid:
                            return False  # cross-op weight sharing
                        ins.append(None)
                    else:
                        ins.append(tuple(src_t.dims))
                else:
                    shp = dims_of.get((tx.op_id, tx.ts_id))
                    if shp is None:
                        return False
                    ins.append(shp)
            if o.op_type == OpType.REPARTITION:
                d, k = o.parallel_dim or 0, o.parallel_degree or 1
                if ins[0] is None or d >= len(ins[0]) or ins[0][d] % k:
                    return False
                dims_of[(j, 0)] = ins[0]
            elif o.op_type in (OpType.COMBINE, OpType.REPLICATE):
                if ins[0] is None:
                    return False
                dims_of[(j, 0)] = ins[0]
            else:  # reused compute op: same inputs -> same outputs
                src_op = binding[self.dst_pairing[j]]
                arity = len(src_op.inputs)
                for k2, shp in enumerate(ins):
                    if k2 < arity:
                        if shp is None:
                            return False  # weight fed as a DATA input
                    elif shp is not None:
                        # a real tensor at a beyond-arity slot: the apply
                        # step could not wire it — reject rather than
                        # silently dropping the rewiring
                        return False
                if (ins and ins[0] is not None
                        and ins[0] != tuple(src_op.inputs[0].dims)):
                    return False  # rewiring would change the op's shape
                for ts, t in enumerate(src_op.outputs):
                    dims_of[(j, ts)] = tuple(t.dims)
        return True

    # -- replacement -------------------------------------------------------
    def _apply(self, graph: Graph, binding: List[Op], ext: Dict) -> None:
        from ..parallel import parallel_ops as P
        from .substitution import _model_of

        rule = self.rule
        model = _model_of(binding[0])
        dst_vals: Dict[Tuple[int, int], object] = {}
        new_guids = set()

        def resolve(tx):
            if tx.is_external:
                return ext[(tx.op_id, tx.ts_id)]
            return dst_vals[(tx.op_id, tx.ts_id)]

        for j, o in enumerate(rule.dst_ops):
            ins = [resolve(tx) for tx in o.inputs]
            if o.is_parallel_op:
                cls = getattr(P, _PARALLEL_CLS[o.op_type])
                kwargs = {"degree": o.parallel_degree or 1}
                if o.op_type != OpType.REPLICATE:
                    kwargs["dim"] = o.parallel_dim or 0
                # deterministic name from the match site: a replayed
                # rewrite (strategy --import) recreates the SAME names, so
                # exported per-op strategy entries resolve
                op_new = cls(model, [ins[0]],
                             name=f"xfer.{rule.name}.{j}.{binding[0].name}",
                             **kwargs)
                op_new.xfer_created = True  # anti-restacking marker
                graph.add_op(op_new)
                new_guids.add(op_new.guid)
            else:
                op_new = binding[self.dst_pairing[j]]
                for k, t in enumerate(ins):
                    # weight markers: the reused op's own internal weights,
                    # nothing to rewire (_valid_match guarantees every
                    # non-marker entry sits within the op's data arity)
                    if isinstance(t, _WeightRef):
                        continue
                    op_new.inputs[k] = t
                graph.invalidate_topo()  # in-place edge mutation
            for ts, t in enumerate(op_new.outputs):
                dst_vals[(j, ts)] = t

        # rewire mapped outputs to downstream consumers — but never into the
        # dst ops themselves (that would create a cycle through the rewrite)
        reused = {binding[i].guid for i in self.dst_pairing.values()}
        for m in rule.mapped_outputs:
            old = binding[m.src_op_id].outputs[m.src_ts_id]
            new = dst_vals[(m.dst_op_id, m.dst_ts_id)]
            if old.guid != new.guid:
                _rewire(graph, old, new, skip_guids=new_guids | reused)

        # drop src ops that were not reused as dst compute ops
        for i, op in enumerate(binding):
            if i not in self.dst_pairing.values():
                graph.remove_op(op)


def xfers_from_rules(rules: List[Rule]) -> Dict[str, Callable]:
    """Search-rule registry entries (name -> matcher) for every supported
    loaded rule — the executable complement of the TP-degree distillation."""
    out: Dict[str, Callable] = {}
    for r in rules:
        x = GraphXfer(r)
        if x.supported:
            def fn(graph, _x=x):
                return _x.find_applications(graph)

            # xfers insert parallel-op chains — a cost TRADE-OFF, not a
            # strict shrink: apply_substitutions' greedy fixed-point pass
            # must skip them (only the budgeted joint search applies them)
            fn.trade_off = True
            out[x.name] = fn
    return out
