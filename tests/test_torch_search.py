"""The strategy search of the port (search/unity.py, search/mcmc.py)
against the JAX package's, on the CPU: the same graphs, built by the same
builder code in both packages at small widths, searched on the same
machine specs with the same knobs, both on their Python paths
(`use_native_search=False`), and with the default flags, where both
dispatch to their native cores (the same C++ core).

Each case compares the per-op strategies by op name, the mesh axes, the
applied rewrites and the candidates simulated and pruned (identical), and
cost_us, predicted_step_us and memory_bytes (1e-9 relative: the same float
expressions in the same order). Scenarios adapted from tests/test_search.py,
test_joint_search.py and test_sequence_parallel_search.py. The plan caches
of both packages are reset around each case, so every search runs cold
unless a case asks for the cache.

Then the TASO rules that insert parallel ops and the live plan's
distance term, against JAX's; compile(): the searched plan adopted, the
default data axis, and the search's and the analysis' modules imported
without jax.
"""
import json
import os
import subprocess
import sys

import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.core.graph import Graph as JGraph
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search import plan_cache as jpc
from flexflow_tpu.search import unity as junity
from flexflow_tpu_torch.core.graph import Graph as PGraph
from flexflow_tpu_torch.search import machine_model as pmm
from flexflow_tpu_torch.search import mcmc as pmcmc
from flexflow_tpu_torch.search import plan_cache as ppc
from flexflow_tpu_torch.search import unity as punity
from tests.test_torch_cost import GRAPHS as COST_GRAPHS
from tests.test_torch_cost import TIERED
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

REL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 8


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()
    yield
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()


def _mlp_split(pkg, m):
    """An MLP with separate activations (fuse_linear_activation fires in
    the greedy pass) and two heads on one input (merge_parallel_linears is
    a joint-search action)."""
    t = m.create_tensor([8, 16])
    t = m.relu(m.dense(t, 32))
    a = m.dense(t, 16)
    b = m.dense(t, 16)
    t = m.add(a, b)
    m.softmax(m.dense(t, 4))


GRAPHS = dict(COST_GRAPHS, mlp_split=_mlp_split)


def _config(pkg, native=False, **knobs):
    """The search's config; both packages on their Python paths unless
    `native`, which leaves `use_native_search` at its default."""
    if pkg is pt:
        c = pt.FFConfig(device="cpu", allow_mixed_precision=False)
    else:
        c = ff.FFConfig()
        c.allow_mixed_precision = False
    if not native:
        c.use_native_search = False
    c.batch_size = 8
    c.search_budget = BUDGET
    for k, v in knobs.items():
        setattr(c, k, v)
    return c


def _model(pkg, name, **knobs):
    m = pkg.FFModel(_config(pkg, **knobs))
    GRAPHS[name](pkg, m)
    return m


def _batch(model):
    return model.input_ops[0].outputs[0].dims[0]


def _machine(pkg, kind, n, tmp_path, config):
    mm = pmm if pkg is pt else jmm
    if kind == "simple":
        return mm.SimpleMachineModel(n, mm.CHIP_SPECS["tpu-v5e"])
    if kind == "pod":
        return mm.TpuPodModel(n)
    path = tmp_path / "tiered.json"
    path.write_text(json.dumps(TIERED))
    config.machine_model_file = str(path)
    return mm.make_machine_model(config, n)


def _summary(result, graph):
    ops = {graph.ops[g].name: (s.dp, s.tp, s.ep, s.ap, s.sp, s.tp_row)
           for g, s in result.strategies.items()}
    exact = {"axes": dict(result.mesh_axes), "ops": ops,
             "rewrites": [list(r) for r in result.applied_rewrites],
             "greedy": result.greedy_search_rules,
             "simulated": result.candidates_simulated,
             "pruned": result.candidates_pruned,
             "graph_ops": sorted(op.name for op in graph.ops.values())}
    floats = (result.cost_us, result.memory_bytes, result.predicted_step_us)
    return exact, floats


def _search_both(name, n, machine="pod", tmp_path=None, algo="unity",
                 **knobs):
    out = []
    for pkg, G, un, mc in ((ff, JGraph, junity, jmcmc),
                           (pt, PGraph, punity, pmcmc)):
        m = _model(pkg, name, **knobs)
        machine_model = _machine(pkg, machine, n, tmp_path, m.config)
        g = G(m.ops)
        fn = un.unity_optimize if algo == "unity" else mc.mcmc_search
        r = fn(g, m.config, machine_model, _batch(m), n)
        out.append((r, g))
    (jr, jg), (pr, pg) = out
    jx, jf = _summary(jr, jg)
    px, pf = _summary(pr, pg)
    assert px == jx
    for a, b in zip(pf, jf):
        assert a == pytest.approx(b, rel=REL, abs=0.0)
    return pr, pg


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("machine", ["simple", "pod"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_unity_matches_jax(name, machine, n, tmp_path):
    _search_both(name, n, machine, tmp_path)


@pytest.mark.parametrize("budget", [0, BUDGET])
@pytest.mark.parametrize("machine,n", [("simple", 4), ("pod", 8)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_unity_default_flags_match_jax(name, machine, n, budget, tmp_path):
    """With the default `use_native_search`, both packages' searches take
    the native core where it applies (where a rewrite applies, both the
    Python path): the same plan, cost and log."""
    r, _ = _search_both(name, n, machine, tmp_path, native=True,
                        search_budget=budget)
    rewrites = name == "mlp_split" and budget > 0
    assert (r.log[0] == "native ffcore search") != rewrites, r.log


@pytest.mark.parametrize("name", ["bert", "mlp_split", "resnet"])
def test_unity_matches_jax_on_a_tiered_machine(name, tmp_path):
    r, _ = _search_both(name, 8, "tiered", tmp_path)
    assert r.reduction_strategies or not r.mesh_axes.get("data")


KNOBS = {
    "parameter_parallel": ("mlp_split", dict(enable_parameter_parallel=True)),
    "sequence_parallel": ("bert", dict(enable_sequence_parallel=True)),
    "attribute_parallel": ("resnet", dict(enable_attribute_parallel=True)),
    "memory_search": ("bert", dict(memory_search=True,
                                   memory_budget_mb=0.05)),
    "no_joint_search": ("mlp_split", dict(joint_search=False)),
    "only_data_parallel": ("mlp_split", dict(only_data_parallel=True)),
    "no_analysis_prune": ("bert", dict(analysis_prune=False)),
    "verify_candidates": ("mlp_split", dict(verify_candidates=True)),
    "budget_100": ("bert", dict(search_budget=100)),
}


@pytest.mark.parametrize("case", sorted(KNOBS))
def test_unity_knobs_match_jax(case, tmp_path):
    name, knobs = KNOBS[case]
    r, g = _search_both(name, 4, "pod", tmp_path, **knobs)
    if case == "no_joint_search":
        assert r.greedy_search_rules
    if case == "sequence_parallel":
        assert any(s.sp > 1 for s in r.strategies.values()) or \
            "seq" not in r.mesh_axes


def test_name_list_substitution_file_matches_jax(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": ["fuse_linear_activation",
                                          "merge_parallel_linears"]}))
    r, g = _search_both("mlp_split", 4, "pod", tmp_path,
                        substitution_json_path=str(path))
    assert not any(op.op_type == pt.OpType.RELU for op in g.ops.values())


@pytest.mark.parametrize("name", ["bert", "mlp_split", "dlrm"])
def test_mcmc_matches_jax_with_the_same_seed(name, tmp_path):
    _search_both(name, 4, "pod", tmp_path, algo="mcmc", seed=3,
                 strategy_search="mcmc", mcmc_budget=40)


def test_want_measured_follows_the_device():
    assert not punity._want_measured(pt.FFConfig(device="cpu"))
    assert punity._want_measured(pt.FFConfig(device="cuda"))
    assert punity._want_measured(pt.FFConfig(device="cuda:1"))
    assert not punity._want_measured(pt.FFConfig(device="cuda",
                                                 measure_op_costs=False))
    assert punity._want_measured(pt.FFConfig(device="cpu",
                                             measure_op_costs=True))


def test_search_knob_fields_and_defaults_are_jax_s():
    jc, pc = ff.FFConfig(), pt.FFConfig()
    for f in jpc.SEARCH_KNOB_FIELDS + ("plan_cache", "plan_cache_dir",
                                       "plan_cache_capacity",
                                       "import_strategy_file",
                                       "export_strategy_file",
                                       "substitution_json_path",
                                       "replan_live_plan", "plan_analysis",
                                       "verify_candidates"):
        assert getattr(pc, f) == getattr(jc, f), f
    assert ppc.SEARCH_KNOB_FIELDS == jpc.SEARCH_KNOB_FIELDS
    argv = ["--budget", "7", "--alpha", "1.5", "--no-plan-cache",
            "--plan-cache-dir", "/x", "--plan-cache-capacity", "3",
            "--no-search-warm-start", "--warm-fallback-tolerance", "1.2",
            "--replan-distance-weight", "0.5", "--strategy-search", "mcmc",
            "--mcmc-budget", "9", "--mcmc-propagate",
            "--only-data-parallel", "--enable-parameter-parallel",
            "--enable-attribute-parallel", "--enable-sequence-parallel",
            "--enable-pipeline-parallel", "--pipeline-microbatches", "2",
            "--no-analysis-prune", "--verify-candidates",
            "--plan-analysis", "warn", "--memory-search",
            "--memory-budget", "12.5", "--measure-op-costs",
            "--substitution-json", "r.json", "--export", "e.json",
            "--import", "i.json", "--refine-top-k", "2",
            "--base-optimize-threshold", "5"]
    jc.parse_args(argv)
    pc.parse_args(argv)
    for f in jpc.SEARCH_KNOB_FIELDS + ("plan_cache", "plan_cache_dir",
                                       "plan_cache_capacity",
                                       "import_strategy_file",
                                       "export_strategy_file",
                                       "substitution_json_path",
                                       "plan_analysis", "verify_candidates"):
        assert getattr(pc, f) == getattr(jc, f), f
    with pytest.raises(ValueError, match="plan-analysis"):
        pt.FFConfig().parse_args(["--plan-analysis", "loud"])
    with pytest.raises(ValueError, match="strategy-search"):
        pt.FFConfig().parse_args(["--strategy-search", "greedy"])


def test_pipeline_candidates_raise(tmp_path):
    """The pipeline candidates are ported (parallel/pipeline_plan.py): the
    search under enable_pipeline_parallel gives JAX's plan and log, on the
    flat pod and on a tiered machine, where the (data, stage) nestings
    are priced."""
    from flexflow_tpu.parallel.pipeline_plan import \
        max_pipeline_stages as jmax
    from flexflow_tpu_torch.parallel.pipeline_plan import \
        max_pipeline_stages as pmax

    for machine in ("pod", "tiered"):
        _search_both("bert", 4, machine, tmp_path,
                     enable_pipeline_parallel=True)
    stages = pmax(PGraph(_model(pt, "bert").ops))
    assert stages > 1
    assert stages == jmax(JGraph(_model(ff, "bert").ops))


# -- the TASO rules that insert parallel ops, and the live plan -------------


@pytest.mark.parametrize("algo", ["unity", "mcmc"])
@pytest.mark.parametrize("name", ["mlp_split", "bert"])
def test_taso_file_with_parallel_op_rules_searches_as_jax(name, algo):
    """The search under substitutions/graph_subst_3_v2.json (476 of its
    640 rules insert parallel ops) gives JAX's plan, rewrites and log
    counts, unity and mcmc alike."""
    path = os.path.join(ROOT, "substitutions", "graph_subst_3_v2.json")
    _search_both(name, 4, "pod", algo=algo, substitution_json_path=path)


def _live_plan(pkg, graph, axes, tp):
    """A live plan of `graph`'s weights at tp (dp the rest) on `axes`."""
    pcache, sim = (ppc, __import__("flexflow_tpu_torch.search.simulator",
                                   fromlist=["x"])) if pkg is pt else \
        (jpc, __import__("flexflow_tpu.search.simulator", fromlist=["x"]))
    strategies = {op.guid: sim.OpStrategy(dp=4 // tp, tp=tp)
                  for op in graph.topo_order()}
    return pcache._candidate_weight_plan(graph, strategies, axes,
                                         list(range(4))), strategies


def plan_distance_both():
    """plan_distance_us of a {data 2, model 2} live plan onto a {data 4}
    candidate and onto itself, in both packages."""
    got = {}
    for pkg, G, pcache, mm in ((ff, JGraph, jpc, jmm), (pt, PGraph, ppc,
                                                         pmm)):
        g = G(_model(pkg, "bert").ops)
        live, same = _live_plan(pkg, g, {"data": 2, "model": 2}, 2)
        _, cand = _live_plan(pkg, g, {"data": 4}, 1)
        machine = mm.TpuPodModel(4)
        got[pkg] = (pcache.plan_distance_us(g, live, cand, {"data": 4},
                                            machine, 4),
                    pcache.plan_distance_us(g, live, same,
                                            {"data": 2, "model": 2},
                                            machine, 4))
    assert got[pt][0] > 0 and got[pt][1] == 0.0
    for a, b in zip(got[pt], got[ff]):
        assert a == pytest.approx(b, rel=REL, abs=0.0)


def test_plan_distance_with_a_live_plan_raises():
    """The plan distance of a live plan is priced as JAX's, and a warm
    re-plan off a live plan (the distance term in its ranking) gives
    JAX's plan."""
    plan_distance_both()
    out = []
    for pkg, G, un, mm in ((ff, JGraph, junity, jmm),
                           (pt, PGraph, punity, pmm)):
        seed_model = _model(pkg, "bert")
        un.unity_optimize(G(seed_model.ops), seed_model.config,
                          mm.TpuPodModel(8), 2, 8)
        m = _model(pkg, "bert")
        g = G(m.ops)
        m.config.replan_live_plan = _live_plan(
            pkg, g, {"data": 2, "model": 2}, 2)[0]
        r = un.unity_optimize(g, m.config, mm.TpuPodModel(4), 2, 4)
        out.append(_summary(r, g))
    (jx, jf), (px, pf) = out
    assert px == jx
    for a, b in zip(pf, jf):
        assert a == pytest.approx(b, rel=REL, abs=0.0)


# -- compile(): the searched plan -------------------------------------------
def test_compile_searches_on_a_multi_device_machine_and_keeps_the_plan():
    """num_devices > 1 in one process: compile searches (as JAX's does),
    and a plan whose mesh is one device trains here; a wider mesh needs
    the ranks (the process group) and says so."""
    m = _model(pt, "mlp_split", num_devices=4, search_budget=BUDGET)
    jm = _model(ff, "mlp_split", num_devices=4, search_budget=BUDGET)
    jm.compile(optimizer=ff.SGDOptimizer(jm, lr=0.01))
    if jm.parallel_axes:
        with pytest.raises(NotImplementedError, match="torch.distributed"):
            m.compile(optimizer=pt.SGDOptimizer(m, lr=0.01))
    else:
        m.compile(optimizer=pt.SGDOptimizer(m, lr=0.01))
    assert m.search_result is not None
    assert m.parallel_axes == jm.parallel_axes
    got = {m.graph.ops[g].name: (s.dp, s.tp)
           for g, s in m._op_strategies.items()}
    want = {jm.graph.ops[g].name: (s.dp, s.tp)
            for g, s in jm._op_strategies.items()}
    assert got == want
    assert [op.name for op in m.ops] == [op.name for op in jm.ops]


def test_compile_on_one_device_searches_nothing_and_analyzes():
    m = _model(pt, "bert")
    m.compile()
    assert m.search_result is None and m.parallel_axes == {}
    report = m.analyze_plan()
    jm = _model(ff, "bert", num_devices=1)
    jm.compile()
    want = jm.analyze_plan()
    assert [d.format() for d in report.diagnostics] == \
        [d.format() for d in want.diagnostics]
    assert report.passes_run == want.passes_run


@pytest.mark.parametrize("field,value", [
    ("tp_row", True), ("sp", 2), ("ep", 2), ("ap", 2)])
def test_unported_plans_raise_before_any_weight(tmp_path, field, value):
    """An imported plan that needs tp_row, sp, ep or ap (and so a seq,
    expert or attr axis) is executable now (tests/test_torch_axes.py runs
    such plans on ranks): compile takes it as far as the mesh, which
    raises for want of a process group, before any weight is drawn."""
    name = {"tp_row": "mlp_split", "sp": "bert", "ep": "moe",
            "ap": "resnet"}[field]
    m = _model(pt, name)
    axis = {"tp_row": "model", "sp": "seq", "ep": "expert",
            "ap": "attr"}[field]
    target = {"tp_row": "linear_1", "sp": "layer0_attn", "ep": None,
              "ap": None}[field]
    ops = {}
    for op in m.ops:
        s = {"dp": 1, "tp": 1}
        if op.name == target or (target is None and field in ("ep", "ap")):
            s[field if field != "tp_row" else "tp"] = 2
            if field == "tp_row":
                s["tp_row"] = True
        ops[op.name] = s
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"mesh_axes": {axis: 2}, "ops": ops}))
    m.config.import_strategy_file = str(path)
    m.config.plan_analysis = "off"
    with pytest.raises(NotImplementedError, match=f"'{axis}'.*has not "
                       "joined"):
        m.compile()
    assert not any(op._parameters for op in m.ops)


def test_imported_stage_axis_raises_naming_a8(tmp_path):
    """An imported pipeline plan is executable now (tests/
    test_torch_pipeline.py): compile takes it as far as the mesh, which
    raises for want of a process group, before any weight is drawn; a
    stage axis beside a model axis still raises, naming ROADMAP A8."""
    m = _model(pt, "bert")
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"mesh_axes": {"stage": 2}, "ops": {
        op.name: {"dp": 1, "tp": 1} for op in m.ops}}))
    m.config.import_strategy_file = str(path)
    with pytest.raises(NotImplementedError, match="'stage'.*has not joined"):
        m.compile()
    assert not any(op._parameters for op in m.ops)
    m = _model(pt, "bert")
    with pytest.raises(NotImplementedError, match="stage axis beside.*A8"):
        m.compile(parallel_axes={"stage": 2, "model": 2})
    assert not any(op._parameters for op in m.ops)


def test_imported_row_parallel_linear_raises_naming_a8(tmp_path):
    """A plan's row-parallel (tp_row) linear is executable now (the
    Megatron pair of tests/test_torch_axes.py): compile takes it as far
    as the mesh, which raises for want of a process group."""
    m = _model(pt, "mlp_split")
    ops = {op.name: {"dp": 1, "tp": 1} for op in m.ops}
    ops["linear_1"] = {"dp": 1, "tp": 2, "tp_row": True}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"mesh_axes": {"model": 2}, "ops": ops}))
    m.config.import_strategy_file = str(path)
    m.config.plan_analysis = "off"
    with pytest.raises(NotImplementedError, match="has not joined"):
        m.compile()


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import flexflow_tpu_torch\n"
        "import flexflow_tpu_torch.search.unity, "
        "flexflow_tpu_torch.search.mcmc, "
        "flexflow_tpu_torch.search.plan_cache, "
        "flexflow_tpu_torch.search.substitution, "
        "flexflow_tpu_torch.search.substitution_loader, "
        "flexflow_tpu_torch.search.graph_xfer, "
        "flexflow_tpu_torch.analysis, flexflow_tpu_torch.analysis.interp, "
        "flexflow_tpu_torch.analysis.passes, "
        "flexflow_tpu_torch.analysis.pipeline, "
        "flexflow_tpu_torch.analysis.diagnostics, "
        "flexflow_tpu_torch.tools.tp_train\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flexflow_tpu' or m.startswith('flexflow_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

