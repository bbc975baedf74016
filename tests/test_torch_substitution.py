"""The graph rewrites of the port (search/substitution.py,
search/substitution_loader.py, search/graph_xfer.py, core/graph.py)
against the JAX package's, on the CPU: every rule of ALL_RULES and
SEARCH_RULES on a graph where it fires gives the same applications and
the same rewritten graph (op names, types, params, output dims and edges
by producer name), the graph algorithms give the same answers, and the
shipped TASO files (substitutions/*.json) give the same parse, summary,
templates, TP candidates and GraphXfer matches; a rule whose target
inserts parallel ops rewrites the graph as JAX's does. Adapted from
tests/test_graph_xfer.py and tests/test_substitution_loader.py.
"""
import os

import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.core.graph import Graph as JGraph
from flexflow_tpu.search import graph_xfer as jgx
from flexflow_tpu.search import plan_cache as jpc
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu.search import substitution_loader as jload
from flexflow_tpu_torch.core.graph import Graph as PGraph
from flexflow_tpu_torch.search import graph_xfer as pgx
from flexflow_tpu_torch.search import plan_cache as ppc
from flexflow_tpu_torch.search import substitution as psub
from flexflow_tpu_torch.search import substitution_loader as pload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULE_FILES = ["tp_rules.json", "graph_subst_3_v2.json"]


def _config(pkg):
    if pkg is pt:
        return pt.FFConfig(batch_size=4, device="cpu")
    c = ff.FFConfig()
    c.batch_size = 4
    return c


# one graph a rule fires on, built the same way in both packages
def _fuse_linear_activation(pkg, m):
    t = m.create_tensor([4, 8])
    t = m.relu(m.dense(t, 6))
    t = m.tanh(m.dense(t, 6))
    x = m.create_tensor([4, 3, 8, 8])
    m.sigmoid(m.conv2d(x, 4, 3, 3, 1, 1, 1, 1))


def _merge_adjacent_reshape(pkg, m):
    t = m.create_tensor([4, 8, 6])
    m.dense(m.reshape(m.reshape(t, [4, 48]), [4, 6, 8]), 3)


def _cancel_transpose_pair(pkg, m):
    t = m.create_tensor([4, 8, 6])
    t = m.transpose(m.transpose(t, [0, 2, 1]), [0, 2, 1])
    m.dense(t, 3)


def _merge_scalar_chain(pkg, m):
    t = m.create_tensor([4, 8])
    t = m.scalar_multiply(m.scalar_multiply(t, 2.0), 3.0)
    m.scalar_add(m.scalar_add(t, 1.0), 0.5)


def _drop_identity(pkg, m):
    t = m.create_tensor([4, 8])
    m.dense(m.identity(m.dense(t, 8)), 2)


def _cancel_split_concat(pkg, m):
    t = m.dense(m.create_tensor([4, 8]), 8)
    a, b = m.split(t, [3, 5], 1)
    m.dense(m.concat([a, b], 1), 2)


def _drop_zero_dropout(pkg, m):
    t = m.dense(m.create_tensor([4, 8]), 8)
    m.dense(m.dropout(t, 0.0), 2)


def _drop_noop_cast(pkg, m):
    t = m.dense(m.create_tensor([4, 8]), 8)
    m.dense(m.cast(t, pkg.DataType.DT_FLOAT), 2)


def _merge_parallel_linears(pkg, m):
    t = m.dense(m.create_tensor([4, 8]), 8)
    m.add(m.dense(t, 6), m.dense(t, 6))


def _merge_parallel_convs(pkg, m):
    x = m.create_tensor([4, 3, 8, 8])
    a = m.conv2d(x, 4, 3, 3, 1, 1, 1, 1)
    b = m.conv2d(x, 6, 3, 3, 1, 1, 1, 1)
    m.concat([a, b], 1)


CASES = {
    "fuse_linear_activation": _fuse_linear_activation,
    "merge_adjacent_reshape": _merge_adjacent_reshape,
    "cancel_transpose_pair": _cancel_transpose_pair,
    "merge_scalar_chain": _merge_scalar_chain,
    "drop_identity": _drop_identity,
    "cancel_split_concat": _cancel_split_concat,
    "drop_zero_dropout": _drop_zero_dropout,
    "drop_noop_cast": _drop_noop_cast,
    "merge_parallel_linears": _merge_parallel_linears,
    "merge_parallel_convs": _merge_parallel_convs,
}


def _build(pkg, case):
    m = pkg.FFModel(_config(pkg))
    CASES[case](pkg, m)
    return m, (PGraph if pkg is pt else JGraph)(m.ops)


def _sig(pkg, graph):
    """The graph by op name: type, params, output dims, and each input as
    (producer name, output index) or the input tensor's name."""
    canon = (ppc if pkg is pt else jpc)._canon
    out = {}
    for op in graph.topo_order():
        ins = [(t.owner_op.name, t.owner_idx) if t.owner_op is not None
               else (t.name, -1) for t in op.inputs]
        out[op.name] = (op.op_type.value, canon(dict(op.params)),
                        [tuple(t.dims) for t in op.outputs], ins)
    return out


def test_every_rule_has_a_case():
    assert set(psub.ALL_RULES) | set(psub.SEARCH_RULES) == \
        set(CASES) | {"fuse_parallel_ops"}
    assert set(psub.ALL_RULES) == set(jsub.ALL_RULES)
    assert set(psub.SEARCH_RULES) == set(jsub.SEARCH_RULES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_rewrites_like_jax(case):
    (jm, jg), (pm_, pg) = _build(ff, case), _build(pt, case)
    assert _sig(pt, pg) == _sig(ff, jg)
    rules = {**psub.ALL_RULES, **psub.SEARCH_RULES}
    jrules = {**jsub.ALL_RULES, **jsub.SEARCH_RULES}
    papps = rules[case](pg)
    japps = jrules[case](jg)
    assert papps, "the case must make the rule fire"
    assert [(a.rule, a.description) for a in papps] == \
        [(a.rule, a.description) for a in japps]
    # every rule to its fixed point, one application at a time
    applied = psub.apply_substitutions(pg, {case: rules[case]})
    assert applied == jsub.apply_substitutions(jg, {case: jrules[case]})
    assert _sig(pt, pg) == _sig(ff, jg)
    for m, g in ((pm_, pg), (jm, jg)):
        assert g.topo_order()  # acyclic


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_algorithms_like_jax(case):
    (_, jg), (_, pg) = _build(ff, case), _build(pt, case)

    def names(ops):
        return [op.name for op in ops]

    assert names(pg.roots()) == names(jg.roots())
    assert names(pg.leaves()) == names(jg.leaves())
    assert names(pg.bottleneck_nodes()) == names(jg.bottleneck_nodes())
    assert [names(s) for s in pg.segments()] == \
        [names(s) for s in jg.segments()]
    pn = {op.guid: op.name for op in pg.ops.values()}
    jn = {op.guid: op.name for op in jg.ops.values()}
    assert {pn[g]: sorted(pn[x] for x in s)
            for g, s in pg.post_dominators().items()} == \
        {jn[g]: sorted(jn[x] for x in s)
         for g, s in jg.post_dominators().items()}
    for pop in pg.topo_order():
        jop = next(o for o in jg.ops.values() if o.name == pop.name)
        assert names(pg.predecessors(pop)) == names(jg.predecessors(jop))
        assert names(pg.successors(pop)) == names(jg.successors(jop))
        assert [(pn[e.src], e.src_idx, e.dst_idx)
                for e in pg.in_edges(pop)] == \
            [(jn[e.src], e.src_idx, e.dst_idx) for e in jg.in_edges(jop)]
        assert len(pg.out_edges(pop)) == len(jg.out_edges(jop))
    mid = pg.topo_order()[len(pg.ops) // 2]
    pre, post = pg.split_at(mid)
    jmid = next(o for o in jg.ops.values() if o.name == mid.name)
    jpre, jpost = jg.split_at(jmid)
    assert (names(pre.topo_order()), names(post.topo_order())) == \
        (names(jpre.topo_order()), names(jpost.topo_order()))
    assert pg.hash() == pg.hash()


def test_clone_leaves_the_graph_and_copies_no_weights():
    m, g = _build(pt, "merge_parallel_linears")
    before = _sig(pt, g)
    c = g.clone()
    assert _sig(pt, c) == before
    assert psub.apply_substitutions(c, psub.SEARCH_RULES)
    assert _sig(pt, g) == before
    assert _sig(pt, c) != before
    # op shells: no weight drawn by the search, none copied
    assert not any(op._parameters for op in c.ops.values())
    # the rewrite created ops from the shell's config (a merged linear)
    merged = [op for op in c.ops.values() if "+" in op.name]
    assert merged and all(op.model_config is m.config for op in merged)


def test_fuse_parallel_ops_matches_jax_applications():
    """rule_fuse_parallel_ops finds JAX's applications: none on the
    cases' graphs, and on a parallel-op chain the same collapse."""
    for case in CASES:
        (_, jg), (_, pg) = _build(ff, case), _build(pt, case)
        assert psub.rule_fuse_parallel_ops(pg) == [] == \
            jsub.rule_fuse_parallel_ops(jg)

    def chain(pkg, m):
        t = m.create_tensor([4, 8])
        m.dense(m.replicate(m.combine(m.repartition(t, 0, 2), 0)), 3)

    graphs = []
    for pkg, G in ((ff, JGraph), (pt, PGraph)):
        m = pkg.FFModel(_config(pkg))
        chain(pkg, m)
        graphs.append(G(m.ops))
    jg, pg = graphs
    papps, japps = psub.rule_fuse_parallel_ops(pg), \
        jsub.rule_fuse_parallel_ops(jg)
    assert [(a.rule, a.description) for a in papps] == \
        [(a.rule, a.description) for a in japps] and papps
    rule = "fuse_parallel_ops"
    assert psub.apply_substitutions(pg, {rule: psub.rule_fuse_parallel_ops}) \
        == jsub.apply_substitutions(jg, {rule: jsub.rule_fuse_parallel_ops})
    assert _sig(pt, pg) == _sig(ff, jg)


def test_rewritten_model_compiles_and_trains(tmp_path):
    """A graph rewritten before compile draws its merged op's weights at
    their final shape and trains: merge_parallel_linears through an
    imported strategy that records it."""
    import json

    m, g = _build(pt, "merge_parallel_linears")
    names = {op.name for op in m.ops}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({
        "mesh_axes": {}, "ops": {n: {"dp": 1, "tp": 1} for n in names},
        "applied_rewrites": [["merge_parallel_linears",
                              "linear_1+linear_2"]]}))
    m.config.import_strategy_file = str(path)
    m.compile(optimizer=pt.SGDOptimizer(m, lr=0.1),
              loss_type=pt.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    merged = next(op for op in m.ops if op.name == "linear_1+linear_2")
    assert tuple(merged._parameters["kernel"].shape) == (8, 12)
    import numpy as np

    rng = np.random.RandomState(0)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randn(8, 6).astype(np.float32)
    hist = m.fit(x, y, batch_size=4, epochs=2)
    assert all(np.isfinite(h["loss"]) for h in hist)


# -- the TASO rule files -----------------------------------------------------
@pytest.mark.parametrize("name", RULE_FILES)
def test_rule_files_parse_like_jax(name):
    path = os.path.join(ROOT, "substitutions", name)
    pr, jr = pload.load_substitution_file(path), \
        jload.load_substitution_file(path)
    assert len(pr) == len(jr)
    assert pload.summarize(pr) == jload.summarize(jr)
    assert pload.xfer_templates_from_rules(pr) == \
        jload.xfer_templates_from_rules(jr)
    assert {t.value: d for t, d in
            pload.tp_candidates_from_rules(pr).items()} == \
        {t.value: d for t, d in jload.tp_candidates_from_rules(jr).items()}
    for a, b in zip(pr, jr):
        assert a.name == b.name
        assert [(o.type_name, o.op_type.value if o.op_type else None,
                 [(t.op_id, t.ts_id) for t in o.inputs], o.params)
                for o in a.src_ops + a.dst_ops] == \
            [(o.type_name, o.op_type.value if o.op_type else None,
              [(t.op_id, t.ts_id) for t in o.inputs], o.params)
             for o in b.src_ops + b.dst_ops]
    assert sorted(pgx.xfers_from_rules(pr)) == \
        sorted(jgx.xfers_from_rules(jr))


@pytest.mark.parametrize("name", RULE_FILES)
@pytest.mark.parametrize("case", ["merge_parallel_linears",
                                  "fuse_linear_activation",
                                  "merge_parallel_convs"])
def test_xfers_match_like_jax(name, case):
    """find_applications of every loaded GraphXfer: the same matches (by
    description and matched op names) on the same graph."""
    path = os.path.join(ROOT, "substitutions", name)
    px = pgx.xfers_from_rules(pload.load_substitution_file(path))
    jx = jgx.xfers_from_rules(jload.load_substitution_file(path))
    (_, jg), (_, pg) = _build(ff, case), _build(pt, case)
    pn = {op.guid: op.name for op in pg.ops.values()}
    jn = {op.guid: op.name for op in jg.ops.values()}
    total = 0
    for xname in sorted(px):
        papps, japps = px[xname](pg), jx[xname](jg)
        total += len(papps)
        assert [(a.description, tuple(pn.get(k, k) for k in (a.key or ())))
                for a in papps] == \
            [(a.description, tuple(jn.get(k, k) for k in (a.key or ())))
             for a in japps], xname
    if name == "tp_rules.json" and any(
            op.op_type == pt.OpType.LINEAR for op in pg.ops.values()):
        assert total > 0  # its replicate-linear-combine rules match


def test_parallel_op_target_rewrites_graph_as_jax():
    """Applying a rule whose target inserts parallel ops rewrites the
    graph as JAX's does: the same op names, types, params and edges (the
    replicate, the reused linear and the combine)."""
    path = os.path.join(ROOT, "substitutions", "tp_rules.json")
    px = pgx.xfers_from_rules(pload.load_substitution_file(path))
    jx = jgx.xfers_from_rules(jload.load_substitution_file(path))
    (_, jg), (_, pg) = _build(ff, "merge_parallel_linears"), \
        _build(pt, "merge_parallel_linears")
    name = next(n for n in px if "partition_linear_combine_d2" in n)
    papps, japps = px[name](pg), jx[name](jg)
    assert papps and len(papps) == len(japps)
    papps[0].apply()
    japps[0].apply()
    assert _sig(pt, pg) == _sig(ff, jg)
    types = {op.op_type for op in pg.ops.values()}
    assert {pt.OpType.REPLICATE, pt.OpType.COMBINE} <= types
    assert all(getattr(op, "xfer_created", False) for op in pg.ops.values()
               if op.op_type in (pt.OpType.REPLICATE, pt.OpType.COMBINE))


@pytest.mark.parametrize("name,n", [("tp_rules.json", 5),
                                    ("graph_subst_3_v2.json", 476)])
def test_rule_file_parallel_op_rules_apply_as_jax(name, n):
    """The rule files' parallel-op rules (5 and 476) are GraphXfers the
    port applies: each one's first application on the linear and conv
    graphs rewrites them as JAX's does."""
    path = os.path.join(ROOT, "substitutions", name)
    pr, jr = pload.load_substitution_file(path), \
        jload.load_substitution_file(path)
    par = [r.name for r in pr if any(o.is_parallel_op for o in r.dst_ops)]
    assert len(par) == n == len(
        [r for r in jr if any(o.is_parallel_op for o in r.dst_ops)])
    px, jx = pgx.xfers_from_rules(pr), jgx.xfers_from_rules(jr)
    applied = 0
    for case in ("merge_parallel_linears", "fuse_linear_activation"):
        for xname in sorted(px):
            (_, jg), (_, pg) = _build(ff, case), _build(pt, case)
            papps, japps = px[xname](pg), jx[xname](jg)
            assert len(papps) == len(japps), xname
            if papps:
                papps[0].apply()
                japps[0].apply()
                # by op, not in topo order: some of the file's rewrites
                # leave a cycle, in both packages alike
                assert _edges(pg) == _edges(jg), xname
                applied += 1
    assert applied > 0


def _edges(graph):
    """The graph by op name: type and each input's producer."""
    return {op.name: (op.op_type.value,
                      [(t.owner_op.name, t.owner_idx) if t.owner_op
                       else (t.name, -1) for t in op.inputs])
            for op in graph.ops.values()}
