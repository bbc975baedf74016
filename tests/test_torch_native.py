"""The port's native core (flexflow_tpu_torch/native over its own copy of
the C++ core, csrc/ffcore) on the CPU.

First tests/test_native_core.py's cases over the port's library and
graphs: the graph algorithms against the port's Python ones, the native
search against the port's Python search, the dispatch from
`unity_optimize`. Then the port held against the JAX package's
`flexflow_tpu.native` on the same graphs (tests/test_torch_search.py's
GRAPHS, built by the same builder code in both packages): the protocol
text byte for byte, the topological order and the bottlenecks, and the
native search's plan (axes and per-op (dp, tp, ep, ap, sp, tp_row)
equal, cost within 1e-9 relative) with and without MCMC; the cases where
JAX's default search (native) and its Python search part (C21), through
both packages' default `unity_optimize`. Last the build: where the
library lands, a missing compiler, two processes building at once.
"""
import dataclasses
import itertools
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu import native as jnative
from flexflow_tpu.core import op as jop
from flexflow_tpu.core.graph import Graph as JGraph
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import plan_cache as jpc
from flexflow_tpu.search import unity as junity
from flexflow_tpu_torch import native
from flexflow_tpu_torch.core import op as pop
from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.search import machine_model as pmm
from flexflow_tpu_torch.search import plan_cache as ppc
from flexflow_tpu_torch.search.machine_model import TpuPodModel
from flexflow_tpu_torch.search.simulator import Simulator
from flexflow_tpu_torch.search.unity import GraphSearchHelper, unity_optimize
from tests.test_torch_search import GRAPHS
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

REL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()
    yield
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()


def _cfg(**kw):
    c = pt.FFConfig(device="cpu")
    for k, v in kw.items():
        setattr(c, k, v)
    return c


# ---------------------------------------------------------------------
# tests/test_native_core.py's cases
# ---------------------------------------------------------------------
def build_mlp_model(n_dev=4, batch=32, tp_friendly=True):
    config = _cfg(batch_size=batch, num_devices=n_dev, search_budget=8)
    model = pt.FFModel(config)
    t = model.create_tensor([batch, 64], pt.DataType.DT_FLOAT)
    h = model.dense(t, 128 if tp_friendly else 126, pt.ActiMode.AC_MODE_RELU)
    h = model.dense(h, 128, pt.ActiMode.AC_MODE_RELU)
    out = model.dense(h, 10)
    out = model.softmax(out)
    return config, model


def branching_model():
    config = _cfg(batch_size=16)
    model = pt.FFModel(config)
    t = model.create_tensor([16, 32], pt.DataType.DT_FLOAT)
    a = model.dense(t, 32, name="branch_a")
    b = model.dense(t, 32, name="branch_b")
    m = model.add(a, b)
    model.dense(m, 8, name="join")
    return config, model


def test_version():
    assert native.version() == "ffcore-0.1.0"
    assert native.version() == jnative.version()


def test_topo_matches_python():
    config, model = branching_model()
    g = Graph(model.ops)
    assert native.topo_order(g) == [op.guid for op in g.topo_order()]


def test_bottlenecks_match_python():
    config, model = branching_model()
    g = Graph(model.ops)
    ours = native.bottlenecks(g)
    assert ours == [op.guid for op in g.bottleneck_nodes()]
    # the join dense and the add must be bottlenecks; the branches must not
    names = {g.ops[guid].name for guid in ours}
    assert "join" in names
    assert "branch_a" not in names


def _agrees_with_python(config, g, batch, n, fields):
    """The native search and the port's Python search: the same cost,
    axes and per-op `fields`; returns the Python result."""
    native_res = native.optimize_strategy(g, config, TpuPodModel(n), batch,
                                          n)
    config.use_native_search = False
    py_res = GraphSearchHelper(g, config, TpuPodModel(n)).graph_optimize(
        batch, n)
    assert native_res.cost_us == pytest.approx(py_res.cost_us, rel=1e-6)
    assert native_res.mesh_axes == py_res.mesh_axes
    for guid, s in py_res.strategies.items():
        ns = native_res.strategies[guid]
        assert [getattr(ns, f) for f in fields] == \
            [getattr(s, f) for f in fields], g.ops[guid].name
    return py_res


def test_search_agrees_with_python():
    config, model = build_mlp_model()
    _agrees_with_python(config, Graph(model.ops), 32, 4, ("dp", "tp"))


def test_unity_optimize_dispatches_to_native():
    config, model = build_mlp_model()
    res = unity_optimize(Graph(model.ops), config, TpuPodModel(4), 32, 4)
    assert res.log[0] == "native ffcore search"
    assert res.cost_us > 0


def test_native_memory_search_penalizes_overflow():
    config, model = build_mlp_model()
    g = Graph(model.ops)
    base = native.optimize_strategy(g, config, TpuPodModel(4), 32, 4)
    config.memory_search = True
    config.memory_budget_mb = 1e-3  # impossible budget -> penalty applies
    res = native.optimize_strategy(g, config, TpuPodModel(4), 32, 4)
    assert res.cost_us > base.cost_us


def test_native_mcmc_never_worse():
    config, model = build_mlp_model()
    g = Graph(model.ops)
    base = native.optimize_strategy(g, config, TpuPodModel(4), 32, 4)
    refined = native.optimize_strategy(g, config, TpuPodModel(4), 32, 4,
                                       mcmc_iters=200)
    assert refined.cost_us <= base.cost_us * (1 + 1e-9)


def test_compile_uses_native_search_end_to_end():
    """compile() on 4 devices in one process searches natively (the
    search span's backend); a plan of one device trains here."""
    from flexflow_tpu_torch.obs.tracing import (disable_tracing,
                                                enable_tracing)

    config = _cfg(batch_size=32, num_devices=4, search_budget=4,
                  allow_mixed_precision=False)
    model = pt.FFModel(config)
    t = model.create_tensor([32, 64], pt.DataType.DT_FLOAT)
    h = model.dense(t, 128, pt.ActiMode.AC_MODE_RELU)
    model.softmax(model.dense(h, 10))
    tracer = enable_tracing()
    tracer.clear()
    try:
        if_mesh = None
        try:
            model.compile(
                optimizer=pt.SGDOptimizer(model, lr=0.05),
                loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[pt.MetricsType.METRICS_ACCURACY])
        except NotImplementedError as e:  # a wider mesh needs its ranks
            if_mesh = e
        spans = tracer.events("search")
    finally:
        tracer.clear()
        disable_tracing()
    assert [s["args"].get("backend") for s in spans] == ["native"]
    assert model.search_result.log[0] == "native ffcore search"
    if if_mesh is None:
        x = np.random.RandomState(0).randn(32, 64).astype(np.float32)
        y = np.random.RandomState(1).randint(0, 10, (32, 1)).astype(np.int32)
        hist = model.fit([x], y, epochs=1)
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    else:
        assert "torch.distributed" in str(if_mesh)


def test_native_infeasible_raises():
    config, model = build_mlp_model(n_dev=4, batch=30)  # 30 % 4 != 0
    config.only_data_parallel = True
    with pytest.raises(ValueError, match="no feasible"):
        native.optimize_strategy(Graph(model.ops), config, TpuPodModel(4),
                                 30, 4)


def transformer_model(n_dev=8, batch=16, seq=32):
    config = _cfg(batch_size=batch, num_devices=n_dev, search_budget=8,
                  enable_sequence_parallel=True, refine_top_k=99)
    model = pt.FFModel(config)
    from flexflow_tpu_torch.models import (TransformerConfig,
                                           build_bert_encoder)

    cfg = TransformerConfig(hidden_size=32, embedding_size=32, num_heads=4,
                            num_layers=2, sequence_length=seq, vocab_size=50)
    tokens = model.create_tensor([batch, seq], pt.DataType.DT_INT32)
    build_bert_encoder(model, tokens, cfg)
    return config, model


def test_native_sp_search_agrees_with_python():
    config, model = transformer_model()
    _agrees_with_python(config, Graph(model.ops), 16, 8, ("dp", "tp", "sp"))


def test_native_sp_gated_by_dropout():
    """Attention-prob dropout has no SP kernel: both paths refuse sp > 1."""
    config, model = transformer_model()
    for op in model.ops:
        if op.op_type.value == "multihead_attention":
            op.params["dropout"] = 0.1
    res = native.optimize_strategy(Graph(model.ops), config, TpuPodModel(8),
                                   16, 8)
    assert "seq" not in res.mesh_axes


def test_native_dispatch_covers_sp():
    config, model = transformer_model()
    res = unity_optimize(Graph(model.ops), config, TpuPodModel(8), 16, 8)
    assert res.log[0] == "native ffcore search"


def moe_model(n_dev=8, batch=512):
    B, F, n, k, H = batch, 1024, 8, 2, 4096
    config = _cfg(batch_size=B, num_devices=n_dev, search_budget=8,
                  refine_top_k=99)
    model = pt.FFModel(config)
    inp = model.create_tensor([B, F])
    out = model.moe(inp, n, k, H, alpha=float(n), fused=True, name="moe")
    model.dense(out, 3)
    return config, model


def test_native_ep_search_agrees_with_python():
    config, model = moe_model()
    py = _agrees_with_python(config, Graph(model.ops), 512, 8,
                             ("dp", "tp", "ep"))
    assert py.mesh_axes.get("expert", 1) > 1, py.log


def test_native_dispatch_covers_experts():
    config, model = moe_model()
    res = unity_optimize(Graph(model.ops), config, TpuPodModel(8), 512, 8)
    assert res.log[0] == "native ffcore search", res.log
    assert res.mesh_axes.get("expert", 1) > 1, res.log


def conv_model(n_dev=8, batch=4):
    config = _cfg(batch_size=batch, num_devices=n_dev, search_budget=8,
                  enable_attribute_parallel=True, refine_top_k=99)
    model = pt.FFModel(config)
    inp = model.create_tensor([batch, 32, 256, 256])
    t = model.conv2d(inp, 64, 3, 3, 1, 1, 1, 1, name="c1")
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, name="c2")
    t = model.flat(t, name="flat")
    model.softmax(model.dense(t, 3, name="cls"))
    return config, model


def test_native_ap_search_agrees_with_python():
    config, model = conv_model()
    py = _agrees_with_python(config, Graph(model.ops), 4, 8,
                             ("dp", "tp", "ap"))
    assert py.mesh_axes.get("attr", 1) > 1, py.log


def test_native_dispatch_covers_attr():
    config, model = conv_model()
    res = unity_optimize(Graph(model.ops), config, TpuPodModel(8), 4, 8)
    assert res.log[0] == "native ffcore search", res.log
    assert res.mesh_axes.get("attr", 1) > 1, res.log


def megatron_model(n_dev=8, batch=8):
    config = _cfg(batch_size=batch, num_devices=n_dev, search_budget=8,
                  enable_parameter_parallel=True, refine_top_k=99)
    model = pt.FFModel(config)
    inp = model.create_tensor([batch, 4096])
    t = model.dense(inp, 8192, pt.ActiMode.AC_MODE_RELU, name="up")
    t = model.dense(t, 4096, name="down")
    model.softmax(model.dense(t, 4, name="cls"))
    return config, model


def test_native_row_tp_search_agrees_with_python():
    config, model = megatron_model()
    py = _agrees_with_python(config, Graph(model.ops), 8, 8,
                             ("dp", "tp", "tp_row"))
    assert any(s.tp_row for s in py.strategies.values()), py.log


# ---------------------------------------------------------------------
# against the JAX package's native core
# ---------------------------------------------------------------------
def _bf16_mlp(pkg, m):
    t = m.create_tensor([8, 16], pkg.DataType.DT_BFLOAT16)
    t = m.dense(t, 32, pkg.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 4))


SERIAL_GRAPHS = dict(GRAPHS, bf16_mlp=_bf16_mlp)


def _config(pkg, budget=8, **knobs):
    c = (pt.FFConfig(device="cpu", allow_mixed_precision=False)
         if pkg is pt else ff.FFConfig())
    c.allow_mixed_precision = False
    c.batch_size = 8
    c.search_budget = budget
    for k, v in knobs.items():
        setattr(c, k, v)
    return c


def _machine(mm, kind, n):
    if kind == "simple":
        return mm.SimpleMachineModel(n, mm.CHIP_SPECS["tpu-v5e"])
    if kind == "h100":
        # the JAX package has no H100 entry: the port's figures in its
        # ChipSpec
        return mm.TpuPodModel(n, mm.ChipSpec(**dataclasses.asdict(
            pmm.CHIP_SPECS["h100-sxm"])))
    return mm.TpuPodModel(n)


# op guids are a per-package process-wide count, and the protocol carries
# them: each pair of graphs is built from the same (high, unused) guid on
_GUID_BASES = itertools.count(1)


def _both(name, budget=8, **knobs):
    """(jax (graph, config, batch), port (graph, config, batch)), their
    ops numbered alike."""
    base = 10**9 + next(_GUID_BASES) * 10**5
    out = []
    for pkg, G, ops in ((ff, JGraph, jop), (pt, Graph, pop)):
        counter = ops._op_guid
        ops._op_guid = itertools.count(base)
        try:
            m = pkg.FFModel(_config(pkg, budget, **knobs))
            SERIAL_GRAPHS[name](pkg, m)
        finally:
            ops._op_guid = counter
        out.append((G(m.ops), m.config, m.input_ops[0].outputs[0].dims[0]))
    return out


KNOBS = {"plain": {},
         "axes": dict(enable_sequence_parallel=True,
                      enable_attribute_parallel=True,
                      enable_parameter_parallel=True, search_alpha=1.2,
                      seed=5),
         "memory": dict(memory_search=True, memory_budget_mb=0.05,
                        allow_mixed_precision=True)}


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("kind,n", [("simple", 4), ("pod", 8),
                                    ("h100", 8)])
@pytest.mark.parametrize("name", sorted(SERIAL_GRAPHS))
def test_serialize_graph_is_jax_s_byte_for_byte(name, kind, n, knobs):
    """The protocol text (machine, options, sps / eps / aps, node and
    edge lines) of the same graph, machine and knobs; a bf16 graph's
    elements count 2 bytes in both."""
    (jg, jc, jb), (pg, pc, pb) = _both(name, **KNOBS[knobs])
    want = jnative.serialize_graph(jg, _machine(jmm, kind, n), jc, jb, n,
                                   mcmc_iters=7)
    got = native.serialize_graph(pg, _machine(pmm, kind, n), pc, pb, n,
                                 mcmc_iters=7)
    assert got == want
    assert native.serialize_graph(pg) == jnative.serialize_graph(jg)


@pytest.mark.parametrize("name", sorted(SERIAL_GRAPHS))
def test_topo_order_and_bottlenecks_equal_jax_s(name):
    """The same guids in the same order as JAX's core gives; the
    bottlenecks are the port's Python `bottleneck_nodes()` (the
    topological order breaks ties its own way, in both packages)."""
    (jg, _, _), (pg, _, _) = _both(name)
    order = native.topo_order(pg)
    assert order == jnative.topo_order(jg)
    assert sorted(order) == sorted(pg.ops)
    assert native.bottlenecks(pg) == jnative.bottlenecks(jg) == \
        [op.guid for op in pg.bottleneck_nodes()]


def _plan(result, graph):
    return {graph.ops[g].name: (s.dp, s.tp, s.ep, s.ap, s.sp, s.tp_row)
            for g, s in result.strategies.items()}


@pytest.mark.parametrize("mcmc", [0, 200])
@pytest.mark.parametrize("budget", [0, 8])
@pytest.mark.parametrize("kind,n", [("simple", 4), ("pod", 8)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_optimize_strategy_equals_jax_s(name, kind, n, budget, mcmc):
    (jg, jc, jb), (pg, pc, pb) = _both(name, budget)
    want = jnative.optimize_strategy(jg, jc, _machine(jmm, kind, n), jb, n,
                                     mcmc_iters=mcmc)
    got = native.optimize_strategy(pg, pc, _machine(pmm, kind, n), pb, n,
                                   mcmc_iters=mcmc)
    assert got.mesh_axes == want.mesh_axes
    assert _plan(got, pg) == _plan(want, jg)
    assert got.cost_us == pytest.approx(want.cost_us, rel=REL, abs=0.0)
    assert got.memory_bytes == pytest.approx(want.memory_bytes, rel=REL,
                                             abs=0.0)
    assert got.log == want.log


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_native_prices_the_h100_host_as_the_python_simulator(name):
    """On the 8-card NVSwitch host (`TpuPodModel(8, h100-sxm)`: the link
    term is link_mult x ici_link_gbps in both) the native core's cost of
    its plan is the port's Python simulator's for the same plan."""
    _, (pg, pc, pb) = _both(name)
    machine = _machine(pmm, "h100", 8)
    res = native.optimize_strategy(pg, pc, machine, pb, 8)
    assert res.cost_us == pytest.approx(
        Simulator(machine, pc).simulate(pg, res.strategies), rel=REL)


# the (graph, machine, n, budget) cases where JAX's default search (its
# native core) and its Python search pick different plans (C21)
C21 = [("resnet", "pod", 8, 0), ("resnet", "pod", 8, 8),
       ("nmt", "simple", 4, 8), ("nmt", "pod", 8, 8)]


@pytest.mark.parametrize("name,kind,n,budget", C21)
def test_default_unity_optimize_gives_jax_s_default_plan(name, kind, n,
                                                         budget):
    """Through both packages' `unity_optimize` with the default flags:
    the port gives JAX's default (native) plan, which is not JAX's
    Python plan here."""
    (jg, jc, jb), (pg, pc, pb) = _both(name, budget)
    want = junity.unity_optimize(jg, jc, _machine(jmm, kind, n), jb, n)
    got = unity_optimize(pg, pc, _machine(pmm, kind, n), pb, n)
    assert got.log[0] == want.log[0] == "native ffcore search"
    assert got.mesh_axes == want.mesh_axes
    assert _plan(got, pg) == _plan(want, jg)
    assert got.cost_us == pytest.approx(want.cost_us, rel=REL, abs=0.0)
    jpc.reset_plan_cache()
    (jg2, jc2, jb2), _ = _both(name, budget, use_native_search=False)
    python = junity.unity_optimize(jg2, jc2, _machine(jmm, kind, n), jb2, n)
    assert (_plan(python, jg2), python.mesh_axes, python.cost_us) != \
        (_plan(want, jg), want.mesh_axes, want.cost_us)


# ---------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------
def test_library_is_built_under_the_port_s_build_dir():
    path = native.ensure_built()
    assert path is not None and native.available()
    build = os.path.join(ROOT, "flexflow_tpu_torch", "_build")
    assert os.path.dirname(path) == build
    assert os.path.basename(path).startswith("libffcore_")
    assert "src/ffcore" not in path
    assert path == str(native.library_path())


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The module as a new process finds it, building into tmp_path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "BUILD_INFO", {})
    return tmp_path


def test_a_missing_compiler_leaves_the_python_paths_with_one_warning(
        fresh_native, monkeypatch, caplog):
    monkeypatch.setattr(native, "CXX", "no-such-cxx-compiler")
    with caplog.at_level(logging.WARNING, logger="flexflow_tpu_torch.native"):
        assert not native.available()
        assert native.ensure_built() is None
        assert not native.available()
        assert native.version() is None
    warnings = [r for r in caplog.records
                if r.name == "flexflow_tpu_torch.native"]
    assert len(warnings) == 1
    assert "no-such-cxx-compiler" in warnings[0].getMessage()
    assert "no-such-cxx-compiler" in native.load_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.run("cmd topo\n")
    # the callers take their Python / numpy paths
    config, model = build_mlp_model()
    res = unity_optimize(Graph(model.ops), config, TpuPodModel(4), 32, 4)
    assert res.log[0] != "native ffcore search"
    loader = pt.SingleDataLoader(model, model.input_ops[0].outputs[0],
                                 np.zeros((64, 64), np.float32))
    assert loader.backend == "numpy"


CHILD = """
import json, sys
from pathlib import Path
from flexflow_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
path = native.ensure_built()
print(json.dumps([path, native.available(), native.version(),
                  native.BUILD_INFO.get("compiled")]))
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes build into one empty directory at once: one
    compiles under the lock, the other waits and loads its library."""
    import json

    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    got = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        got.append(json.loads(out.strip().splitlines()[-1]))
    assert [g[:3] for g in got] == [got[0][:3]] * 2
    assert got[0][1] and got[0][2] == "ffcore-0.1.0"
    assert sorted(g[3] for g in got) == [False, True]
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert libs == [os.path.basename(got[0][0])]
    # no object file and no temporary left behind
    assert sorted(os.listdir(tmp_path)) == sorted(libs + ["ffcore.lock"])


def test_the_port_imports_no_jax_with_the_native_core():
    code = (
        "import sys\n"
        "from flexflow_tpu_torch import native\n"
        "import flexflow_tpu_torch.runtime.dataloader\n"
        "assert native.available()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flexflow_tpu' or m.startswith('flexflow_tpu.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
