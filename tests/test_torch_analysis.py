"""The plan analysis of the port (analysis/: diagnostics, passes, the
sharding-flow interpreter, the pipeline) against the JAX package's, on
the CPU: a table of plans, each built the same way in both packages and
analyzed with the same arguments, gives the same diagnostics (code,
severity, op, message and hint, in order) and the same passes run;
FFModel.analyze_plan and compile()'s gate (plan_analysis "error", "warn",
"off") behave as JAX's on the same illegal plans; the counters reach the
server's stats() and /metrics; the resharding checks raise naming ROADMAP
A8. Adapted from tests/test_analysis.py.

The port makes a mesh before its gate runs (a mesh needs its ranks, which
the JAX package's device list always has), so the compile-gate cases are
plans that are illegal on one device.
"""
import json

import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu import analysis as jan
from flexflow_tpu.core.graph import Graph as JGraph
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import simulator as jsim
from flexflow_tpu_torch import analysis as pan
from flexflow_tpu_torch.analysis import interp as pinterp
from flexflow_tpu_torch.core.graph import Graph as PGraph
from flexflow_tpu_torch.search import machine_model as pmm
from flexflow_tpu_torch.search import simulator as psim
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _parts(pkg):
    if pkg is pt:
        return pt, PGraph, pan, pmm, psim
    return ff, JGraph, jan, jmm, jsim


def _config(pkg, batch=64, **kw):
    if pkg is pt:
        c = pt.FFConfig(device="cpu")
    else:
        c = ff.FFConfig()
    c.batch_size = batch
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def build_mlp(pkg, batch=64, din=512, hidden=2048, classes=10, **kw):
    config = _config(pkg, batch, **kw)
    m = pkg.FFModel(config)
    t = m.dense(m.create_tensor([batch, din]), hidden,
                pkg.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, classes))
    return m, _parts(pkg)[1](m.ops), config


def _moe_graph(pkg, batch=32, n=4, k=2, alpha=None, lambda_bal=0.0,
               mixed=False):
    config = _config(pkg, batch, allow_mixed_precision=mixed)
    m = pkg.FFModel(config)
    out = m.moe(m.create_tensor([batch, 8]), n, k, 12,
                alpha=float(n) if alpha is None else alpha,
                lambda_bal=lambda_bal, fused=True, name="moe")
    m.dense(out, 3)
    return m, _parts(pkg)[1](m.ops), config


def op_named(graph, fragment):
    return next(op for op in graph.ops.values() if fragment in op.name)


# each case: pkg -> (graph, analyze_plan keyword arguments)
def _dp7(pkg):
    _, g, c = build_mlp(pkg)
    S = _parts(pkg)[4].OpStrategy
    return g, dict(strategies={op_named(g, "linear").guid: S(dp=7)},
                   mesh_axes={"data": 7}, batch_size=64, n_devices=8,
                   config=c)


def _tp3(pkg):
    _, g, c = build_mlp(pkg)
    S = _parts(pkg)[4].OpStrategy
    return g, dict(strategies={op_named(g, "linear").guid: S(tp=3)},
                   mesh_axes={"model": 3}, batch_size=64, n_devices=8,
                   config=c)


def _too_many(pkg):
    _, g, c = build_mlp(pkg)
    S = _parts(pkg)[4].OpStrategy
    return g, dict(strategies={op_named(g, "linear").guid: S(dp=8, tp=2)},
                   mesh_axes={"data": 8, "model": 2}, batch_size=64,
                   n_devices=8, config=c)


def _degraded(pkg):
    _, g, c = build_mlp(pkg)
    S = _parts(pkg)[4].OpStrategy
    return g, dict(strategies={op_named(g, "softmax").guid: S(tp=2)},
                   mesh_axes={"model": 2}, batch_size=64, n_devices=8,
                   config=c)


def _hbm(pkg, **mk):
    _, g, c = build_mlp(pkg, hidden=4096)
    mm = _parts(pkg)[3]
    for k, v in mk.pop("config", {}).items():
        setattr(c, k, v)
    return g, dict(strategies={}, machine=mm.SimpleMachineModel(
        4, mm.ChipSpec(hbm_gb=1e-4)), batch_size=64, n_devices=4, config=c,
        **mk)


def _near_capacity(pkg):
    _, g, c = build_mlp(pkg)
    _, _, _, mm, sim = _parts(pkg)
    probe = sim.CostModel(mm.SimpleMachineModel(4, mm.ChipSpec()), c)
    total = sum(probe.op_memory_bytes(op, sim.OpStrategy())
                for op in g.ops.values())
    return g, dict(strategies={}, machine=mm.SimpleMachineModel(
        4, mm.ChipSpec(hbm_gb=total / 0.9 / 1e9)), batch_size=64,
        n_devices=4, config=c)


def _row_on_softmax(pkg):
    _, g, c = build_mlp(pkg)
    S = _parts(pkg)[4].OpStrategy
    return g, dict(strategies={op_named(g, "softmax").guid:
                               S(tp=2, tp_row=True)},
                   mesh_axes={"model": 2}, batch_size=64, n_devices=8,
                   config=c)


def _row_non_dividing(pkg):
    _, g, c = build_mlp(pkg, din=510)
    S = _parts(pkg)[4].OpStrategy
    return g, dict(strategies={op_named(g, "linear").guid:
                               S(tp=4, tp_row=True)},
                   mesh_axes={"model": 4}, batch_size=64, n_devices=8,
                   config=c)


def _axis_conflict(pkg):
    _, g, c = build_mlp(pkg)
    S = _parts(pkg)[4].OpStrategy
    d1, d2 = [op for op in g.topo_order() if "linear" in op.name]
    return g, dict(strategies={d1.guid: S(dp=2), d2.guid: S(dp=4)},
                   mesh_axes={"data": 4}, batch_size=64, n_devices=8,
                   config=c)


def _mesh_too_big(pkg):
    _, g, c = build_mlp(pkg)
    return g, dict(strategies={}, mesh_axes={"data": 4, "model": 4},
                   batch_size=64, n_devices=8, config=c)


def _ping_pong(pkg):
    _, g, c = build_mlp(pkg)
    S = _parts(pkg)[4].OpStrategy
    inp, d1, d2, sm = g.topo_order()
    return g, dict(strategies={inp.guid: S(dp=4), d1.guid: S(dp=4),
                               d2.guid: S(dp=1), sm.guid: S(dp=4)},
                   mesh_axes={"data": 4}, batch_size=64, n_devices=8,
                   config=c)


def _elastic(pkg):
    _, g, c = build_mlp(pkg)
    c.elastic_step_wrapper = lambda fn: fn
    return g, dict(strategies={}, batch_size=64, n_devices=8, config=c)


def _dangling(pkg):
    _, g, c = build_mlp(pkg)
    del g.ops[op_named(g, "linear").guid]
    return g, dict(strategies={}, config=c)


def _stale_alias(pkg):
    _, g, c = build_mlp(pkg)
    sm = op_named(g, "softmax")
    del g.ops[sm.guid]
    g.tensor_aliases[999999] = sm.outputs[0]
    return g, dict(strategies={}, config=c)


def _unreachable(pkg):
    _, g, c = build_mlp(pkg)
    return g, dict(strategies={}, config=c,
                   final_guid=g.topo_order()[-2].guid)


def _mixed_dtype(pkg):
    c = _config(pkg, 8)
    m = pkg.FFModel(c)
    x, y = m.create_tensor([8, 16]), m.create_tensor([8, 16])
    m.add(x, y)
    g = _parts(pkg)[1](m.ops)
    y.dtype = pkg.DataType.DT_HALF
    return g, dict(strategies={}, config=c)


def _moe_capacity(pkg):
    _, g, c = _moe_graph(pkg, batch=32, n=64, alpha=0.1)
    return g, dict(batch_size=32, n_devices=1, config=c, passes=("moe",))


def _moe_ep3(pkg):
    _, g, c = _moe_graph(pkg, n=4)
    S = _parts(pkg)[4].OpStrategy
    return g, dict(strategies={op_named(g, "moe_experts").guid:
                               S(dp=2, ep=3)},
                   mesh_axes={"data": 2, "expert": 3}, batch_size=32,
                   n_devices=6, config=c, passes=("moe",))


def _moe_axis(pkg):
    _, g, c = _moe_graph(pkg, n=4)
    return g, dict(mesh_axes={"data": 2, "expert": 3}, batch_size=32,
                   n_devices=6, config=c, passes=("moe",))


def _moe_no_gate(pkg):
    _, g, c = _moe_graph(pkg, lambda_bal=0.05)
    experts = op_named(g, "moe_experts")
    experts.params["lambda_bal"] = 0.05
    experts.inputs = experts.inputs[:3]
    return g, dict(batch_size=32, n_devices=1, config=c, passes=("moe",))


def _moe_mixed(pkg):
    _, g, c = _moe_graph(pkg, mixed=True)
    return g, dict(batch_size=32, n_devices=1, config=c, passes=("moe",))


def _moe_sub_unit(pkg):
    _, g, c = _moe_graph(pkg, batch=64, n=4, alpha=0.5)
    return g, dict(batch_size=64, n_devices=1, config=c, passes=("moe",))


def _bert_tp(pkg):
    """The sharding-flow interpreter and the memory pass over a searched
    flagship-like plan: BERT at test width, dp 2 x tp 2, attention and a
    dense at tp 2, the embedding at dp 1."""
    from tests.test_torch_search import _model

    m = _model(pkg, "bert")
    g = _parts(pkg)[1](m.ops)
    S = _parts(pkg)[4].OpStrategy
    strategies = {}
    for op in g.topo_order():
        if op.name == "tok_emb":
            strategies[op.guid] = S(dp=1, tp=1)
        elif op.name in ("layer0_attn", "layer1_ff1"):
            strategies[op.guid] = S(dp=2, tp=2)
        else:
            strategies[op.guid] = S(dp=2, tp=1)
    return g, dict(strategies=strategies, mesh_axes={"data": 2, "model": 2},
                   batch_size=2, n_devices=4, config=m.config,
                   machine=_parts(pkg)[3].TpuPodModel(4),
                   final_guid=g.topo_order()[-1].guid)


CASES = {
    "FFTA001_dp": _dp7, "FFTA001_tp": _tp3, "FFTA003": _too_many,
    "FFTA002": _degraded, "FFTA010": _hbm,
    "FFTA010_budget": lambda p: _hbm(p, config={
        "memory_budget_mb": 64 * 1024.0}),
    "FFTA010_stage": lambda p: _hbm(p, mesh_axes={"data": 2, "stage": 2}),
    "FFTA011": _near_capacity, "FFTA020_softmax": _row_on_softmax,
    "FFTA020_row": _row_non_dividing, "FFTA021": _axis_conflict,
    "FFTA023": _mesh_too_big, "FFTA022": _ping_pong, "FFTA030": _elastic,
    "FFTA040": _dangling, "FFTA041": _stale_alias, "FFTA042": _unreachable,
    "FFTA043": _mixed_dtype, "FFTA080": _moe_capacity,
    "FFTA081_ep": _moe_ep3, "FFTA081_axis": _moe_axis,
    "FFTA082": _moe_no_gate, "FFTA083": _moe_mixed, "FFTA084": _moe_sub_unit,
    "bert_dp_tp": _bert_tp,
}


def _report(pkg, case):
    g, kw = CASES[case](pkg)
    return _parts(pkg)[2].analyze_plan(g, **kw)


def _flat(report):
    return ([(d.code, d.severity.value, d.op_name, d.message, d.hint)
             for d in report.diagnostics], list(report.passes_run),
            report.ok)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_diagnostics_match_jax(case):
    got, want = _flat(_report(pt, case)), _flat(_report(ff, case))
    assert got == want
    code = case.split("_")[0]
    if code.startswith("FFTA") and case != "FFTA010_budget":
        assert code in [c for c, *_ in got[0]]
    if case == "FFTA010_budget":  # an explicit budget clears the overflow
        assert "FFTA010" not in [c for c, *_ in got[0]]


def test_code_catalog_and_report_format_match_jax():
    def catalog(an):
        return {k: (v[0].value, v[1]) for k, v in an.CODE_CATALOG.items()}

    assert catalog(pan) == catalog(jan)
    p, j = _report(pt, "FFTA001_dp"), _report(ff, "FFTA001_dp")
    assert p.format() == j.format()

    def no_guids(text):  # op guids are per process and per package
        doc = json.loads(text)
        for d in doc["diagnostics"]:
            d.pop("op_guid", None)
        return doc

    assert no_guids(p.to_json()) == no_guids(j.to_json())


def test_factorization_diagnostics_match_jax():
    out = {}
    for pkg in (pt, ff):
        _, g, c = build_mlp(pkg)
        an = _parts(pkg)[2]
        rows = [an.factorization_diagnostics(g, c, 64, f)
                for f in ((3, 1, 1, 1, 1), (1, 1, 2, 1, 1), (1, 1, 1, 2, 1),
                          (1, 1, 1, 1, 2), (2, 2, 1, 1, 1))]
        _, gm, cm = _moe_graph(pkg, n=16)
        rows += [an.factorization_diagnostics(gm, cm, 32, f, pod_degree=p)
                 for f, p in (((2, 1, 8, 1, 1), 8), ((1, 1, 16, 1, 1), 8),
                              ((1, 1, 8, 1, 2), 8), ((1, 1, 16, 1, 1), None))]
        out[pkg] = [[(d.code, d.message) for d in r] for r in rows]
    assert out[pt] == out[ff]
    assert [r[0][0] if r else None for r in out[pt]][:5] == \
        ["FFTA001", "FFTA004", "FFTA004", "FFTA004", None]


def test_default_strategies_match_jax():
    got = {}
    for pkg in (pt, ff):
        c = _config(pkg, 2)
        m = pkg.FFModel(c)
        t = m.create_tensor([2, 32, 64])
        attn = m.multihead_attention(t, t, t, 64, 4, dropout=0.1)
        m.softmax(m.dense(attn, 4))
        g = _parts(pkg)[1](m.ops)
        s = _parts(pkg)[2].default_strategies_for(
            g, {"seq": 2, "data": 2}, batch_size=2)
        got[pkg] = {g.ops[k].name: (v.dp, v.tp, v.sp) for k, v in s.items()}
    assert got[pt] == got[ff]


def test_sharding_flow_interpreter_matches_jax():
    out = {}
    for pkg in (pt, ff):
        g, kw = _bert_tp(pkg)
        an = _parts(pkg)[2]
        interp = an.ShardingFlowInterpreter(g, kw["strategies"],
                                            batch_size=2)
        diags = interp.run()
        names = {op.guid: op.name for op in g.ops.values()}
        layouts = {names[t.owner_op.guid] + f".{t.owner_idx}": str(lay)
                   for op in g.ops.values() for t in op.outputs
                   for lay in [interp.layouts.get(t.guid)] if lay}
        grads = an.gradient_state(g, kw["strategies"])
        out[pkg] = ([d.format() for d in diags], layouts,
                    {names.get(k, k): sorted(v) for k, v in grads.items()})
    assert out[pt] == out[ff]


def test_tier_axis_groups_match_jax():
    from flexflow_tpu.runtime.collectives import tier_axis_groups as jt
    from flexflow_tpu_torch.runtime.collectives import tier_axis_groups

    for n, sizes in ((8, [4, 2]), (8, [2, 2, 2]), (6, [3, 2]), (4, [4])):
        assert tier_axis_groups(n, sizes) == jt(n, sizes)
    with pytest.raises(ValueError, match="multiply"):
        tier_axis_groups(8, [3, 2])


def test_resharding_checks_raise_naming_a8():
    """The five resharding checks give JAX's findings on a schedule that
    trips FFTA060 and FFTA061 and on a lost-shard plan (FFTA063);
    tests/test_torch_resharding.py holds the rest."""
    import numpy as np

    from flexflow_tpu import resharding as jrs
    from flexflow_tpu.analysis import interp as jinterp
    from flexflow_tpu_torch import resharding as prs

    out = {}
    for pkg, an, it, mm in ((jrs, jan, jinterp, jmm),
                            (prs, pan, pinterp, pmm)):
        mesh = pkg.MeshSpec(device_ids=tuple(range(8)),
                            axes=(("data", 4), ("model", 2)))
        old = pkg.ShardingPlan(mesh=mesh, arrays={
            "w": pkg.ArraySpec((4, 1), ("data", None))})
        new = pkg.ShardingPlan(mesh=mesh, arrays={
            "w": pkg.ArraySpec((1, 1), (None, None)),
            "x": pkg.ArraySpec((8, 1), ("expert", None))})
        tree = {"w": np.zeros((8, 4), np.float32),
                "x": np.zeros((8, 4), np.float32)}
        sched = pkg.plan_redistribution(tree, old, new, peak_bytes=8)
        machine = mm.SimpleMachineModel(8, mm.ChipSpec(hbm_gb=16.0))
        try:
            an.check_redistribution(sched, machine=machine, record=False)
            raised = None
        except Exception as exc:  # PlanAnalysisError of either package
            raised = sorted(d.code for d in exc.report.errors())
        out[pkg] = (
            [d.format() for d in an.redistribution_diagnostics(sched,
                                                               machine)],
            [(e.kind, e.tag, e.phase, e.groups)
             for e in it.build_reshard_program(sched)[0]],
            [d.format() for d in it.verify_reshard_program(sched)], raised,
            [d.format() for d in an.survivor_diagnostics(old, {"w": 2},
                                                         [6, 7])])
    assert out[prs] == out[jrs]
    assert "FFTA060" in out[prs][3] and "FFTA061" in out[prs][3]
    assert out[prs][4]


# -- strategy-file validation ------------------------------------------------
@pytest.mark.parametrize("entry,codes", [
    ({"mesh_axes": {"data": 2}, "ops": {"linear_0": {"dp": 0, "tp": "x"}}},
     ["FFTA050"]),
    ({"mesh_axes": {}}, ["FFTA050"]),
    ({"mesh_axes": {"data": "x"}, "ops": {}}, ["FFTA050"])])
def test_import_strategy_malformed_ffta050(tmp_path, entry, codes):
    from flexflow_tpu.search.unity import import_strategy as jimport
    from flexflow_tpu_torch.search.unity import import_strategy as pimport

    path = tmp_path / "bad.json"
    path.write_text(json.dumps(entry))
    got = {}
    for pkg, fn, an in ((pt, pimport, pan), (ff, jimport, jan)):
        _, g, _ = build_mlp(pkg)
        with pytest.raises(an.PlanAnalysisError) as exc:
            fn(g, str(path))
        got[pkg] = [(d.code, d.message) for d in exc.value.report.errors()]
    assert got[pt] == got[ff]
    assert [c for c, _ in got[pt]] == codes


def test_import_strategy_unmatched_name_ffta051(tmp_path):
    from flexflow_tpu_torch.search.unity import import_strategy

    pan.reset_counters()
    _, g, _ = build_mlp(pt)
    path = tmp_path / "unmatched.json"
    path.write_text(json.dumps({"mesh_axes": {"data": 2},
                                "ops": {"no_such_op": {"dp": 2, "tp": 1}}}))
    strategies, axes = import_strategy(g, str(path))
    assert strategies == {} and axes == {"data": 2}
    assert pan.diagnostic_counters().get("FFTA051") == 1


# -- FFModel.analyze_plan and compile()'s gate ----------------------------------
def _tiny(pkg, plan_analysis="error", **kw):
    c = _config(pkg, 8, plan_analysis=plan_analysis, num_devices=1, **kw)
    m = pkg.FFModel(c)
    m.softmax(m.dense(m.create_tensor([8, 16]), 8))
    return m


def _illegal_plan(tmp_path, pkg, **degrees):
    """An imported plan illegal on one device: the dense at `degrees`."""
    m = _tiny(pkg)
    path = tmp_path / f"plan_{'pt' if pkg is pt else 'jax'}.json"
    path.write_text(json.dumps({"mesh_axes": {}, "ops": {
        "linear_0": {"dp": 1, "tp": 1, **degrees}}}))
    m.config.import_strategy_file = str(path)
    return m


def test_analyze_plan_of_a_compiled_model_matches_jax():
    p, j = _tiny(pt), _tiny(ff)
    p.compile(optimizer=pt.SGDOptimizer(p, lr=0.01))
    j.compile(optimizer=ff.SGDOptimizer(j, lr=0.01))
    assert _flat(p.analyze_plan()) == _flat(j.analyze_plan())
    assert p.analyze_plan().ok
    assert _flat(p.analyze_plan(passes=("hygiene",))) == \
        _flat(j.analyze_plan(passes=("hygiene",)))


@pytest.mark.parametrize("degrees", [{"dp": 7}, {"tp": 3}, {"dp": 2,
                                                             "tp": 2}])
def test_compile_gate_rejects_the_same_plans_as_jax(tmp_path, degrees):
    got = {}
    for pkg, an, opt in ((pt, pan, pt.SGDOptimizer),
                         (ff, jan, ff.SGDOptimizer)):
        m = _illegal_plan(tmp_path, pkg, **degrees)
        with pytest.raises(an.PlanAnalysisError) as exc:
            m.compile(optimizer=opt(m, lr=0.01))
        got[pkg] = _flat(exc.value.report)
        # the gate runs before any weight is drawn
        if pkg is pt:
            assert not any(op._parameters for op in m.ops)
    assert got[pt] == got[ff]


def test_compile_gate_warn_mode_records_and_off_skips(tmp_path):
    m = _tiny(pt, plan_analysis="warn")
    m.config.elastic_step_wrapper = lambda fn: fn
    m.compile(optimizer=pt.SGDOptimizer(m, lr=0.01))
    kinds = [e.kind for e in m.analysis_events.events()]
    assert "analysis.warning" in kinds
    m = _illegal_plan(tmp_path, pt, dp=7)
    m.config.plan_analysis = "warn"
    m.compile(optimizer=pt.SGDOptimizer(m, lr=0.01))
    assert "analysis.error" in [e.kind for e in m.analysis_events.events()]
    m = _illegal_plan(tmp_path, pt, dp=7)
    m.config.plan_analysis = "off"
    m.compile(optimizer=pt.SGDOptimizer(m, lr=0.01))
    assert not hasattr(m, "analysis_events")


def test_server_exports_the_analysis_counters():
    from flexflow_tpu_torch.serving.server import InferenceServer

    pan.reset_counters()
    _, g, config = build_mlp(pt)
    with pytest.raises(pan.PlanAnalysisError):
        pan.check_plan(g, mesh_axes={"data": 4, "model": 4}, batch_size=64,
                       n_devices=8, config=config, strategies={})
    server = InferenceServer()
    text = server.prometheus_text()
    assert 'ff_plan_diagnostics_total{code="FFTA023"} 1' in text
    assert server.stats()["_analysis"]["FFTA023"] == 1
    pan.reset_counters()
    assert "ff_plan_diagnostics_total{" not in server.prometheus_text()
    assert "_analysis" not in server.stats()


@pytest.mark.parametrize("name", ["bert", "mlp_split", "resnet", "dlrm",
                                  "moe_encoder"])
def test_searched_plans_pass_the_analysis_like_jax(name):
    from flexflow_tpu.search.unity import unity_optimize as junity
    from flexflow_tpu_torch.search.unity import unity_optimize as punity
    from tests.test_torch_search import _batch, _model

    got = {}
    for pkg, un in ((pt, punity), (ff, junity)):
        m = _model(pkg, name, search_budget=2)
        g = _parts(pkg)[1](m.ops)
        mm = _parts(pkg)[3].make_machine_model(m.config, 4)
        r = un(g, m.config, mm, _batch(m), 4)
        rep = _parts(pkg)[2].analyze_plan(
            g, strategies=r.strategies, machine=mm, config=m.config,
            batch_size=_batch(m), n_devices=4, mesh_axes=r.mesh_axes,
            final_guid=g.topo_order()[-1].guid)
        got[pkg] = _flat(rep)
        assert not [d for d in rep.errors()], rep.format()
    assert got[pt] == got[ff]
