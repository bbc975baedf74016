"""TASO-style substitution rule file loader.

reference parity: include/flexflow/substitution_loader.h:94-187 +
`GraphXfer::create_xfers` (substitution.h:119-121) — the `--substitution-json`
path that loads graph-rewrite rules (e.g. substitutions/graph_subst_3_v2.json,
640 rules) instead of the ~40 hand-written generators.

Schema (verbatim from the reference's files):
  {"_t": "RuleCollection", "rule": [
     {"_t": "Rule", "name": ..., "srcOp": [Operator...], "dstOp": [...],
      "mappedOutput": [{"srcOpId", "srcTsId", "dstOpId", "dstTsId"}]},
  ]}
  Operator: {"type": "OP_*", "input": [{"opId", "tsId"}...],
             "para": [{"key": "PM_*", "value": int}...]}
  input.opId < 0 encodes a pattern input (external tensor -opId-1... the
  reference uses opId=-1..-k for the k graph inputs); opId >= 0 refers to the
  output tsId of another operator in the same pattern.

Use here: the Unity search consumes loaded rules as extra rewrite candidates
(partition/replicate/combine/reduce chains around linear/concat/elementwise
ops express TP and reduction-parallel layouts); rules whose op types fall
outside our modeled set are parsed but reported unsupported.

The port's copy of flexflow_tpu/search/substitution_loader.py, whole.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..ffconst import OpType

# OP_* name → our OpType (None = parallel-op marker handled by the search)
OP_NAME_MAP: Dict[str, Optional[OpType]] = {
    "OP_LINEAR": OpType.LINEAR,
    "OP_CONCAT": OpType.CONCAT,
    "OP_SPLIT": OpType.SPLIT,
    "OP_RELU": OpType.RELU,
    "OP_EW_ADD": OpType.EW_ADD,
    "OP_EW_MUL": OpType.EW_MUL,
    "OP_CONV2D": OpType.CONV2D,
    "OP_POOL2D_MAX": OpType.POOL2D,
    "OP_POOL2D_AVG": OpType.POOL2D,
    "OP_FLAT": OpType.FLAT,
    "OP_SOFTMAX": OpType.SOFTMAX,
    "OP_MULTIHEAD_ATTENTION": OpType.MULTIHEAD_ATTENTION,
    "OP_EMBEDDING": OpType.EMBEDDING,
    "OP_BATCHMATMUL": OpType.BATCHMATMUL,
    # parallel ops (substitution targets, not compute)
    "OP_PARTITION": OpType.REPARTITION,
    "OP_COMBINE": OpType.COMBINE,
    "OP_REPLICATE": OpType.REPLICATE,
    "OP_REDUCE": OpType.REDUCTION,
    "OP_PIPELINE": OpType.PIPELINE,
}

PARALLEL_OPS = {OpType.REPARTITION, OpType.COMBINE, OpType.REPLICATE,
                OpType.REDUCTION}


@dataclass
class TensorX:
    """A tensor reference inside a rule pattern (substitution_loader.h Tensor)."""
    op_id: int   # < 0: external input; >= 0: index into the rule's op list
    ts_id: int

    @property
    def is_external(self) -> bool:
        return self.op_id < 0


@dataclass
class OperatorX:
    """One pattern operator (substitution_loader.h Operator)."""
    type_name: str
    op_type: Optional[OpType]
    inputs: List[TensorX]
    params: Dict[str, int]

    @property
    def is_parallel_op(self) -> bool:
        return self.op_type in PARALLEL_OPS

    @property
    def parallel_degree(self) -> Optional[int]:
        return self.params.get("PM_PARALLEL_DEGREE")

    @property
    def parallel_dim(self) -> Optional[int]:
        return self.params.get("PM_PARALLEL_DIM")


@dataclass
class MapOutput:
    src_op_id: int
    src_ts_id: int
    dst_op_id: int
    dst_ts_id: int


@dataclass
class Rule:
    name: str
    src_ops: List[OperatorX]
    dst_ops: List[OperatorX]
    mapped_outputs: List[MapOutput]

    @property
    def is_supported(self) -> bool:
        """All op types modeled, and the pattern is well-formed."""
        return all(o.op_type is not None
                   for o in self.src_ops + self.dst_ops)

    def compute_op_types(self) -> List[OpType]:
        """The non-parallel op types this rule rewrites around."""
        return [o.op_type for o in self.src_ops
                if o.op_type is not None and not o.is_parallel_op]

    def degrees(self) -> List[int]:
        return sorted({o.parallel_degree for o in self.src_ops + self.dst_ops
                       if o.parallel_degree})


def _parse_operator(d: dict) -> OperatorX:
    name = d["type"]
    return OperatorX(
        type_name=name,
        op_type=OP_NAME_MAP.get(name),
        inputs=[TensorX(t["opId"], t["tsId"]) for t in d.get("input", [])],
        params={p["key"]: p["value"] for p in d.get("para", [])},
    )


def _validate(rule: Rule) -> None:
    """Well-formedness (reference: substitution_loader's asserts): every
    internal tensor reference points at an earlier-declared op (so the
    pattern lists are topologically ordered — no cycles or forward refs);
    mapped outputs reference real ops."""
    for ops in (rule.src_ops, rule.dst_ops):
        for i, op in enumerate(ops):
            for t in op.inputs:
                if not t.is_external and not (0 <= t.op_id < i):
                    raise ValueError(
                        f"rule {rule.name}: op {i} references op {t.op_id} "
                        f"outside the pattern or not earlier-declared")
    for m in rule.mapped_outputs:
        if not (0 <= m.src_op_id < len(rule.src_ops)):
            raise ValueError(f"rule {rule.name}: bad mappedOutput src {m.src_op_id}")
        if not (0 <= m.dst_op_id < len(rule.dst_ops)):
            raise ValueError(f"rule {rule.name}: bad mappedOutput dst {m.dst_op_id}")


def load_substitution_file(path: str) -> List[Rule]:
    """Parse a rule collection file; raises on malformed rules."""
    with open(path) as f:
        doc = json.load(f)
    return rules_from_spec(doc)


def rules_from_spec(doc) -> List[Rule]:
    """Parse an already-loaded rule collection (dict with "rule" or a bare
    list of rule dicts)."""
    rules_json = doc["rule"] if isinstance(doc, dict) else doc
    rules = []
    for rj in rules_json:
        rule = Rule(
            name=rj.get("name", f"rule_{len(rules)}"),
            src_ops=[_parse_operator(o) for o in rj.get("srcOp", [])],
            dst_ops=[_parse_operator(o) for o in rj.get("dstOp", [])],
            mapped_outputs=[
                MapOutput(m["srcOpId"], m["srcTsId"], m["dstOpId"], m["dstTsId"])
                for m in rj.get("mappedOutput", [])
            ],
        )
        _validate(rule)
        rules.append(rule)
    return rules


def summarize(rules: List[Rule]) -> Dict[str, int]:
    supported = [r for r in rules if r.is_supported]
    return {
        "total": len(rules),
        "supported": len(supported),
        "unsupported": len(rules) - len(supported),
    }


def xfer_templates_from_rules(rules: List[Rule]) -> List[str]:
    """Map loaded TASO rules onto the implemented algebraic rewrite templates
    (search/substitution.py SEARCH_RULES). The reference interprets each rule
    as a GraphXfer; here rules are distilled: a rule family whose source
    pattern matches one of our rewrite templates activates that template as a
    joint-search action. Currently recognized:

    - merge_parallel_linears: rules fusing two OP_LINEARs through an
      OP_CONCAT (38 such rules in graph_subst_3_v2.json — the TASO
      matmul-fusion family).
    - merge_parallel_convs: rules fusing two OP_CONV2Ds through an
      OP_CONCAT (the Inception branch-merge family).
    """
    templates: List[str] = []
    for r in rules:
        if not r.is_supported:
            continue
        src_types = [o.op_type for o in r.src_ops]
        all_types = src_types + [o.op_type for o in r.dst_ops]
        if (src_types.count(OpType.LINEAR) >= 2
                and OpType.CONCAT in all_types
                and "merge_parallel_linears" not in templates):
            templates.append("merge_parallel_linears")
        if (src_types.count(OpType.CONV2D) >= 2
                and OpType.CONCAT in all_types
                and "merge_parallel_convs" not in templates):
            templates.append("merge_parallel_convs")
    return templates


def tp_candidates_from_rules(rules: List[Rule]) -> Dict[OpType, List[int]]:
    """Distill loaded rules into per-op-type candidate parallel degrees for
    the Unity search (the role GraphXfer candidates play in base_optimize:
    each partition/replicate-around-op rule proposes sharding that op at the
    rule's degree)."""
    out: Dict[OpType, List[int]] = {}
    for r in rules:
        if not r.is_supported:
            continue
        degs = r.degrees()
        if not degs:
            continue
        for ot in r.compute_op_types():
            cur = out.setdefault(ot, [])
            for d in degs:
                if d not in cur:
                    cur.append(d)
    return {k: sorted(v) for k, v in out.items()}
