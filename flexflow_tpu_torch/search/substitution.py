"""Algebraic graph substitutions (TASO/Unity-style rewrites).

Reference: src/runtime/substitution.cc — GraphXfer source→target rewrite rules
with parameter matching (OpX/TensorX), ~40 generators (generate_all_pcg_xfers
substitution.cc:1726-1868) plus JSON rule files (substitution_loader.h).

TPU-native split of responsibilities: the reference's xfer set mixes two
kinds of rules —
 1. *parallelization* rewrites (partition_linear_combine, replicate_attention
    reduce, …): here these are OpStrategy choices explored by unity.py, since
    sharding is a tensor annotation rather than graph surgery;
 2. *algebraic* rewrites (linear+relu fusion, mapping xfers): implemented
    below as peephole rules on the PCG. XLA refuses most hand-fusions anyway
    (it fuses elementwise into GEMMs itself), so the rules kept are the ones
    that change what the tracer emits.

Rules are pure functions Graph -> list of Application; apply() mutates the
graph (rewiring consumer inputs). A JSON rule list (--substitution-json) can
enable/disable rules by name.

The port's copy of flexflow_tpu/search/substitution.py. Rewrites run
before compile draws any weight (FFModel._compile_inner), so an op a rule
creates (a merged linear or conv) draws its weights once, at its final
shape. The port's ops keep their model's config, not the model
(core/op.py), so a created op is built from that (`_model_of`). The
parallel ops a rule creates are parallel/parallel_ops.py's.
"""
from __future__ import annotations

import dataclasses
import json
import types
from typing import Callable, Dict, List, Optional

from ..core.graph import Graph
from ..core.op import Op
from ..ffconst import ActiMode, OpType


@dataclasses.dataclass
class Application:
    rule: str
    apply: Callable[[], None]
    description: str = ""
    # structural identity: guids of the matched ops. The joint search replays
    # a winning rewrite on a clone/the original graph by re-matching on this
    # key (clones preserve guids); descriptions are for logs only and may
    # collide when two matches involve same-named ops.
    key: Optional[tuple] = None

    @property
    def match_key(self):
        return self.key if self.key is not None else self.description


def _model_of(op: Op):
    """The `model` argument of an op a rewrite creates beside `op`: an op
    constructor reads only the model's config."""
    return types.SimpleNamespace(config=op.model_config)


def _consumers(graph: Graph, op: Op) -> List[Op]:
    out_guids = {t.guid for t in op.outputs}
    return [
        o for o in graph.ops.values()
        if any(t.guid in out_guids for t in o.inputs)
    ]


def _rewire(graph: Graph, old_tensor, new_tensor, skip_guids=()) -> None:
    """Point every consumer of old_tensor at new_tensor (and record the
    alias for resolve_tensor). skip_guids: ops whose inputs were already
    wired explicitly — e.g. a rewrite's own created ops, which must keep
    consuming the old tensor or the rewrite would cycle through itself."""
    for o in graph.ops.values():
        if o.guid in skip_guids:
            continue
        for i, t in enumerate(o.inputs):
            if t.guid == old_tensor.guid:
                o.inputs[i] = new_tensor
    graph.tensor_aliases[old_tensor.guid] = new_tensor
    graph.invalidate_topo()


_ACT_OF = {
    OpType.RELU: ActiMode.AC_MODE_RELU,
    OpType.SIGMOID: ActiMode.AC_MODE_SIGMOID,
    OpType.TANH: ActiMode.AC_MODE_TANH,
    OpType.GELU: ActiMode.AC_MODE_GELU,
}


def rule_fuse_linear_activation(graph: Graph) -> List[Application]:
    """linear -> relu/sigmoid/tanh/gelu  ==>  linear(activation=...)
    (reference: create_linear_relu_merge, substitution.cc)."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type not in (OpType.LINEAR, OpType.CONV2D):
            continue
        if op.params.get("activation", ActiMode.AC_MODE_NONE) != ActiMode.AC_MODE_NONE:
            continue
        cons = _consumers(graph, op)
        if len(cons) != 1 or cons[0].op_type not in _ACT_OF:
            continue
        act_op = cons[0]
        if len(_consumers(graph, op)) != 1:
            continue

        def apply(op=op, act_op=act_op):
            op.params["activation"] = _ACT_OF[act_op.op_type]
            _rewire(graph, act_op.outputs[0], op.outputs[0])
            graph.remove_op(act_op)

        apps.append(Application("fuse_linear_activation", apply,
                                f"{op.name}+{act_op.name}"))
    return apps


def rule_merge_adjacent_reshape(graph: Graph) -> List[Application]:
    """reshape(reshape(x)) ==> reshape(x)."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type != OpType.RESHAPE:
            continue
        src = op.inputs[0].owner_op
        if src is None or src.op_type != OpType.RESHAPE or src.guid not in graph.ops:
            continue
        if len(_consumers(graph, src)) != 1:
            continue

        def apply(op=op, src=src):
            op.inputs[0] = src.inputs[0]
            graph.remove_op(src)

        apps.append(Application("merge_adjacent_reshape", apply,
                                f"{src.name}->{op.name}"))
    return apps


def rule_cancel_transpose_pair(graph: Graph) -> List[Application]:
    """transpose(transpose(x, p), q) ==> x when q∘p == identity."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type != OpType.TRANSPOSE:
            continue
        src = op.inputs[0].owner_op
        if src is None or src.op_type != OpType.TRANSPOSE or src.guid not in graph.ops:
            continue
        p, q = src.params["perm"], op.params["perm"]
        if tuple(p[qi] for qi in q) != tuple(range(len(p))):
            continue
        if len(_consumers(graph, src)) != 1:
            continue

        def apply(op=op, src=src):
            _rewire(graph, op.outputs[0], src.inputs[0])
            graph.remove_op(op)
            graph.remove_op(src)

        apps.append(Application("cancel_transpose_pair", apply,
                                f"{src.name}->{op.name}"))
    return apps


def rule_merge_scalar_chain(graph: Graph) -> List[Application]:
    """scalar_multiply(scalar_multiply(x, a), b) ==> scalar_multiply(x, a*b);
    same for scalar_add."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type not in (OpType.SCALAR_MULTIPLY, OpType.SCALAR_ADD):
            continue
        src = op.inputs[0].owner_op
        if src is None or src.op_type != op.op_type or src.guid not in graph.ops:
            continue
        if len(_consumers(graph, src)) != 1:
            continue

        def apply(op=op, src=src):
            if op.op_type == OpType.SCALAR_MULTIPLY:
                op.params["scalar"] = op.params["scalar"] * src.params["scalar"]
            else:
                op.params["scalar"] = op.params["scalar"] + src.params["scalar"]
            op.inputs[0] = src.inputs[0]
            graph.remove_op(src)

        apps.append(Application("merge_scalar_chain", apply,
                                f"{src.name}->{op.name}"))
    return apps


def rule_drop_identity(graph: Graph) -> List[Application]:
    """identity/noop nodes are dropped (their consumers rewire to the source)."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type not in (OpType.IDENTITY, OpType.NOOP):
            continue
        if op.inputs[0].owner_op is None:
            continue

        def apply(op=op):
            _rewire(graph, op.outputs[0], op.inputs[0])
            graph.remove_op(op)

        apps.append(Application("drop_identity", apply, op.name))
    return apps


def rule_merge_parallel_linears(graph: Graph) -> List[Application]:
    """Two LINEAR ops sharing the same input tensor ==> one wider linear +
    split (the TASO matmul-fusion pattern; reference: the fuse_
    two-matmuls-into-concat rules in substitutions/graph_subst_3_v2.json and
    create_xfers around OP_LINEAR/OP_CONCAT/OP_SPLIT).

    NOT always beneficial: one wide GEMM tiles the MXU better, but the merged
    out_dim constrains tensor parallelism to strategies that divide the SUM
    of the two widths — so this is a *search action* explored jointly with
    parallelization (unity._joint_optimize), never applied greedily."""
    apps = []
    by_input: Dict[int, List[Op]] = {}
    for op in graph.topo_order():
        if op.op_type != OpType.LINEAR:
            continue
        if op.params.get("activation", ActiMode.AC_MODE_NONE) != ActiMode.AC_MODE_NONE:
            continue
        if op.params.get("kernel_initializer") or op.params.get("bias_initializer"):
            continue  # user-pinned init: widths are load-bearing
        by_input.setdefault(op.inputs[0].guid, []).append(op)
    for ops in by_input.values():
        for i in range(len(ops)):
            for j in range(i + 1, len(ops)):
                a, b = ops[i], ops[j]
                if a.params.get("use_bias", True) != b.params.get("use_bias", True):
                    continue
                if a.params.get("dtype") != b.params.get("dtype"):
                    continue

                def apply(a=a, b=b):
                    from ..core.op import OP_REGISTRY
                    from ..ffconst import OpType as OT

                    da, db = a.params["out_dim"], b.params["out_dim"]
                    merged = OP_REGISTRY[OT.LINEAR](
                        _model_of(a), [a.inputs[0]], f"{a.name}+{b.name}",
                        out_dim=da + db,
                        activation=ActiMode.AC_MODE_NONE,
                        use_bias=a.params.get("use_bias", True),
                        dtype=a.params.get("dtype"),
                        kernel_initializer=None, bias_initializer=None,
                    )
                    split = OP_REGISTRY[OT.SPLIT](
                        _model_of(a), [merged.outputs[0]],
                        f"{a.name}+{b.name}_split",
                        sizes=[da, db], axis=-1,
                    )
                    graph.add_op(merged)
                    graph.add_op(split)
                    _rewire(graph, a.outputs[0], split.outputs[0])
                    _rewire(graph, b.outputs[0], split.outputs[1])
                    graph.remove_op(a)
                    graph.remove_op(b)

                apps.append(Application("merge_parallel_linears", apply,
                                        f"{a.name}+{b.name}",
                                        key=(a.guid, b.guid)))
    return apps


def rule_cancel_split_concat(graph: Graph) -> List[Application]:
    """concat(split(x, sizes, axis), axis) in original order ==> x
    (the reference's combine/partition cancellation family)."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type != OpType.CONCAT:
            continue
        srcs = [t.owner_op for t in op.inputs]
        if not srcs or any(s is None or s.op_type != OpType.SPLIT
                           or s.guid not in graph.ops for s in srcs):
            continue
        split = srcs[0]
        if any(s is not split for s in srcs):
            continue
        if op.params.get("axis") != split.params.get("axis"):
            continue
        # every split output consumed exactly once, in order, by this concat
        if [t.guid for t in op.inputs] != [t.guid for t in split.outputs]:
            continue
        if any(c is not op for c in _consumers(graph, split)):
            continue

        def apply(op=op, split=split):
            _rewire(graph, op.outputs[0], split.inputs[0])
            graph.remove_op(op)
            graph.remove_op(split)

        apps.append(Application("cancel_split_concat", apply,
                                f"{split.name}->{op.name}"))
    return apps


def rule_drop_zero_dropout(graph: Graph) -> List[Application]:
    """dropout(x, rate=0) ==> x (a no-op in both train and eval)."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type != OpType.DROPOUT or op.params.get("rate", 0.5) > 0.0:
            continue
        if op.inputs[0].owner_op is None:
            continue

        def apply(op=op):
            _rewire(graph, op.outputs[0], op.inputs[0])
            graph.remove_op(op)

        apps.append(Application("drop_zero_dropout", apply, op.name))
    return apps


def rule_drop_noop_cast(graph: Graph) -> List[Application]:
    """cast(x, dtype_of_x) ==> x."""
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type != OpType.CAST:
            continue
        if op.params.get("dtype") != op.inputs[0].dtype:
            continue
        if op.inputs[0].owner_op is None:
            continue

        def apply(op=op):
            _rewire(graph, op.outputs[0], op.inputs[0])
            graph.remove_op(op)

        apps.append(Application("drop_noop_cast", apply, op.name))
    return apps


def rule_fuse_parallel_ops(graph: Graph) -> List[Application]:
    """Two consecutive parallel ops ==> one FusedParallelOp carrying both
    descriptor chains (reference: src/parallel_ops/fused_parallel_op.cc —
    the reference's graph optimizer emits FusedParallelOp for chained
    reshards so data is forwarded once). Strictly shrinking and
    value-identity (every absorbed op is an identity on values), so it runs
    in the greedy pass; re-matching to fixed point collapses chains of any
    length."""
    from ..parallel.parallel_ops import descriptors_of

    FUSABLE = {OpType.REPARTITION, OpType.COMBINE, OpType.REPLICATE,
               OpType.FUSED_PARALLEL}
    apps = []
    for op in list(graph.ops.values()):
        if op.op_type not in FUSABLE:
            continue
        src = op.inputs[0].owner_op
        if src is None or src.op_type not in FUSABLE or src.guid not in graph.ops:
            continue
        if len(_consumers(graph, src)) != 1:
            continue

        def apply(op=op, src=src):
            from ..core.op import OP_REGISTRY
            from ..ffconst import OpType as OT

            fused = OP_REGISTRY[OT.FUSED_PARALLEL](
                _model_of(op), [src.inputs[0]], f"{src.name}+{op.name}",
                descriptors=descriptors_of(src) + descriptors_of(op))
            graph.add_op(fused)
            _rewire(graph, op.outputs[0], fused.outputs[0])
            graph.remove_op(op)
            graph.remove_op(src)

        apps.append(Application("fuse_parallel_ops", apply,
                                f"{src.name}->{op.name}",
                                key=(src.guid, op.guid)))
    return apps


ALL_RULES: Dict[str, Callable[[Graph], List[Application]]] = {
    "fuse_linear_activation": rule_fuse_linear_activation,
    "merge_adjacent_reshape": rule_merge_adjacent_reshape,
    "cancel_transpose_pair": rule_cancel_transpose_pair,
    "merge_scalar_chain": rule_merge_scalar_chain,
    "drop_identity": rule_drop_identity,
    "cancel_split_concat": rule_cancel_split_concat,
    "drop_zero_dropout": rule_drop_zero_dropout,
    "drop_noop_cast": rule_drop_noop_cast,
    "fuse_parallel_ops": rule_fuse_parallel_ops,
}

# no 'dtype': model.conv2d takes none (unlike dense), so it would never
# discriminate and only inject a spurious params key into merged convs
_CONV_MATCH_KEYS = ("kernel_h", "kernel_w", "stride_h", "stride_w",
                    "padding_h", "padding_w", "groups", "activation",
                    "use_bias")


def rule_merge_parallel_convs(graph: Graph) -> List[Application]:
    """Two CONV2D ops on the same input with identical window/stride/padding
    ==> one conv with summed out_channels + channel split — the Inception
    branch pattern (reference: the conv-merge rules in
    substitutions/graph_subst_3_v2.json and create_combine_inception /
    create_mapping_xfers<Conv2D>, substitution.cc:1771-1797). Activation may
    be fused (elementwise: split∘act == act∘split).

    Like merge_parallel_linears this is a *search action*: one wider conv
    tiles the MXU better, but the merged out_channels constrains TP/attribute
    strategies to divisors of the sum."""
    apps = []
    by_input: Dict[int, List[Op]] = {}
    for op in graph.topo_order():
        if op.op_type != OpType.CONV2D:
            continue
        if op.params.get("groups", 1) != 1:
            continue
        if op.params.get("kernel_initializer") or op.params.get("bias_initializer"):
            continue  # user-pinned init: widths are load-bearing
        by_input.setdefault(op.inputs[0].guid, []).append(op)
    for ops in by_input.values():
        for i in range(len(ops)):
            for j in range(i + 1, len(ops)):
                a, b = ops[i], ops[j]
                if any(a.params.get(k) != b.params.get(k)
                       for k in _CONV_MATCH_KEYS):
                    continue

                def apply(a=a, b=b):
                    from ..core.op import OP_REGISTRY
                    from ..ffconst import OpType as OT

                    ca, cb = a.params["out_channels"], b.params["out_channels"]
                    merged_params = {k: a.params.get(k) for k in _CONV_MATCH_KEYS}
                    merged = OP_REGISTRY[OT.CONV2D](
                        _model_of(a), [a.inputs[0]], f"{a.name}+{b.name}",
                        out_channels=ca + cb,
                        kernel_initializer=None, bias_initializer=None,
                        **merged_params,
                    )
                    split = OP_REGISTRY[OT.SPLIT](
                        _model_of(a), [merged.outputs[0]],
                        f"{a.name}+{b.name}_split",
                        sizes=[ca, cb], axis=1,  # NCHW channel axis
                    )
                    graph.add_op(merged)
                    graph.add_op(split)
                    _rewire(graph, a.outputs[0], split.outputs[0])
                    _rewire(graph, b.outputs[0], split.outputs[1])
                    graph.remove_op(a)
                    graph.remove_op(b)

                apps.append(Application("merge_parallel_convs", apply,
                                        f"{a.name}+{b.name}",
                                        key=(a.guid, b.guid)))
    return apps


# Trade-off rewrites: benefit depends on the parallelization chosen, so they
# are *search actions* explored by unity._joint_optimize (reference:
# candidate graphs in base_optimize, substitution.cc:2229-2311), never part
# of the greedy fixed-point pass above.
SEARCH_RULES: Dict[str, Callable[[Graph], List[Application]]] = {
    "merge_parallel_linears": rule_merge_parallel_linears,
    "merge_parallel_convs": rule_merge_parallel_convs,
}


def search_rules_from_spec(spec, is_taso: bool, parsed=None) -> Dict[str, Callable]:
    """Joint-search rewrite actions for a parsed --substitution-json spec.
    No file: all built-in trade-off rules. TASO file: the templates its rules
    activate (substitution_loader.xfer_templates_from_rules; pass the
    pre-parsed Rule list via `parsed` to avoid re-parsing a multi-MB file).
    Name-list file: the named subset."""
    if spec is None:
        return dict(SEARCH_RULES)
    if is_taso:
        from .graph_xfer import xfers_from_rules
        from .substitution_loader import rules_from_spec, xfer_templates_from_rules

        rules = parsed if parsed is not None else rules_from_spec(spec)
        names = xfer_templates_from_rules(rules)
        out = {n: SEARCH_RULES[n] for n in names if n in SEARCH_RULES}
        # every supported loaded rule is ALSO an executable GraphXfer —
        # source->target matching/replacement, not just template activation
        # (reference: create_xfers, substitution.h:119-121)
        out.update(xfers_from_rules(rules))
        return out
    names = spec.get("rules", [])
    return {n: SEARCH_RULES[n] for n in names if n in SEARCH_RULES}


def load_rule_spec(json_path: Optional[str]):
    """Parse a --substitution-json file ONCE. Returns (spec, is_taso):
    is_taso is True for TASO rule files — a RuleCollection dict
    ({"_t": "RuleCollection", "rule": [...]}, the reference's
    substitutions/graph_subst_3_v2.json) or a bare top-level list of rule
    dicts. False for the simple name-list format
    {"rules": ["fuse_linear_activation", ...]} and for no file."""
    if not json_path:
        return None, False
    with open(json_path) as f:
        spec = json.load(f)
    if isinstance(spec, dict) and "rule" in spec:
        return spec, True
    if isinstance(spec, list):
        return spec, True
    return spec, False

def rule_set_from_spec(spec, is_taso: bool) -> Dict[str, Callable]:
    """Select algebraic rules for a parsed spec. TASO files parameterize the
    *parallelization* search (see unity._load_tp_candidates), so the
    algebraic rule set stays complete for them; a name list selects among
    the built-in rules."""
    if spec is None or is_taso:
        return dict(ALL_RULES)
    names = spec.get("rules", [])
    return {n: ALL_RULES[n] for n in names if n in ALL_RULES}


def load_rule_set(json_path: Optional[str]) -> Dict[str, Callable]:
    """One-shot convenience wrapper (reference: --substitution-json)."""
    spec, is_taso = load_rule_spec(json_path)
    return rule_set_from_spec(spec, is_taso)


def apply_substitutions(graph: Graph, rules: Optional[Dict[str, Callable]] = None,
                        max_passes: int = 1000) -> List[str]:
    """Greedy fixed-point application of always-beneficial rewrites
    (the reference explores rewrites via best-first search because its rules
    can be cost-neutral-or-worse locally; every rule here strictly shrinks
    the traced program, so greedy-to-fixed-point is optimal)."""
    # trade-off rewrites (fn.trade_off, e.g. loaded GraphXfers inserting
    # partition/combine chains) are NOT strictly shrinking: greedily
    # applying them diverges (each application re-matches its own output).
    # They are joint-search actions only; the greedy pass filters them out.
    rules = {n: fn for n, fn in (rules or ALL_RULES).items()
             if not getattr(fn, "trade_off", False)}
    applied: List[str] = []
    for _ in range(max_passes):
        apps: List[Application] = []
        for fn in rules.values():
            apps.extend(fn(graph))
        if not apps:
            break
        # apply the first application, then re-match (mutations invalidate
        # the other matches)
        apps[0].apply()
        applied.append(f"{apps[0].rule}({apps[0].description})")
    return applied
