"""The command line of the port (`python -m flexflow_tpu_torch`, ROADMAP
A11 item 2) against the JAX package's, on the CPU, from the same argv:
`FFConfig.parse_args` over every JAX flag, `_synthetic` for every zoo
name, the default training path from JAX's weights, `--from-c-spec`,
`analyze`, `merge_timeline` / `timeline`, `validate_trace` and
`profile`. The JAX side is called in-process, as its own tests call it.
The port takes `--device cpu`; JAX's CPU devices are conftest's eight,
so a case that sizes the machine passes `--chips`."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.__main__ import _synthetic as jax_synthetic
from flexflow_tpu.__main__ import main as jax_main
from flexflow_tpu.analysis.cli import run_analyze as jax_analyze
from flexflow_tpu.obs.cli import run_profile as jax_profile
from flexflow_tpu.obs.cli import validate_trace as jax_validate
from flexflow_tpu.obs.timeline import merge_timeline as jax_merge
from flexflow_tpu.obs.timeline import run_timeline as jax_timeline
from flexflow_tpu_torch.__main__ import ZOO
from flexflow_tpu_torch.__main__ import _synthetic as pt_synthetic
from flexflow_tpu_torch.__main__ import main as pt_main
from flexflow_tpu_torch.analysis.cli import run_analyze as pt_analyze
from flexflow_tpu_torch.obs.cli import run_profile as pt_profile
from flexflow_tpu_torch.obs.cli import validate_trace as pt_validate
from flexflow_tpu_torch.obs.timeline import merge_timeline as pt_merge
from flexflow_tpu_torch.obs.timeline import run_timeline as pt_timeline
from tests.test_torch_c_model import HANDWRITTEN
from tests.test_torch_zoo import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


# -- FFConfig.parse_args ----------------------------------------------------
# every flag of JAX's parse_args with a value it accepts, and one it does
# not know
FLAGS = [
    ["-b", "16"], ["--batch-size", "16"], ["-e", "3"], ["--epochs", "3"],
    ["-i", "5"], ["--iterations", "5"], ["--steps-per-execution", "4"],
    ["--flash-block-q", "64"], ["--flash-block-k", "32"],
    ["--kernel-impl", "layernorm=pallas"],
    ["--collective-lowering", "explicit"], ["--grad-bucket-bytes", "1024"],
    ["--kernel-residual-threshold", "1.5"], ["--lr", "0.5"],
    ["--learning-rate", "0.5"], ["--wd", "0.1"], ["--weight-decay", "0.1"],
    ["--budget", "7"], ["--search-budget", "7"], ["--alpha", "1.5"],
    ["--search-alpha", "1.5"], ["--base-optimize-threshold", "5"],
    ["--refine-top-k", "2"], ["--plan-cache-dir", "/x"],
    ["--plan-cache-capacity", "3"], ["--no-plan-cache"],
    ["--no-search-warm-start"], ["--warm-fallback-tolerance", "1.2"],
    ["--replan-distance-weight", "0.5"], ["--strategy-search", "mcmc"],
    ["--mcmc-budget", "9"], ["--mcmc-propagate"], ["--only-data-parallel"],
    ["--enable-parameter-parallel"], ["--enable-attribute-parallel"],
    ["--enable-sequence-parallel"], ["--enable-pipeline-parallel"],
    ["--pipeline-microbatches", "2"], ["--search-overlap-backward-update"],
    ["--no-analysis-prune"], ["--verify-candidates"],
    ["--plan-analysis", "warn"], ["--memory-search"],
    ["--measure-op-costs"], ["--no-measure-op-costs"],
    ["--op-cost-cache", "c.json"], ["--memory-budget", "12.5"],
    ["--substitution-json", "r.json"], ["--export", "e.json"],
    ["--import", "i.json"],
    ["--export-strategy-computation-graph-file", "g.dot"],
    ["--export-strategy-task-graph-file", "t.dot"],
    ["--include-costs-dot-graph"], ["--profiling"], ["--fusion"],
    ["--seed", "3"], ["--nodes", "2"], ["--chips", "8"], ["-ll:gpu", "8"],
    ["--machine-model-version", "1"], ["--machine-model-file", "m.json"],
    ["--machine-spec", "m.json"], ["--fitted-profile", "p.json"],
    ["--simulator-workspace-size", "4096"], ["--print-freq", "7"],
    ["--not-a-flag", "-b", "4"],
]


def _fields():
    """The JAX FFConfig's fields that the flags set, all in the port."""
    skip = {"iteration_config", "computation_mode", "device_ids",
            "elastic_step_wrapper", "replan_live_plan"}
    return [f for f in ff.FFConfig.__dataclass_fields__ if f not in skip]


@pytest.mark.parametrize("argv", FLAGS, ids=lambda a: a[0])
def test_parse_args_every_jax_flag(argv):
    jc, pc = ff.FFConfig(), pt.FFConfig()
    jc.num_devices = pc.num_devices = 8
    assert pc.parse_args(argv) == jc.parse_args(argv)
    for f in _fields():
        assert getattr(pc, f) == getattr(jc, f), f
    assert pc.workers_per_node == jc.workers_per_node
    assert pc.total_devices == jc.total_devices


def test_from_command_line_and_missing_value():
    argv = ["-b", "4", "--nodes", "2", "--chips", "4", "--extra"]
    assert (pt.FFConfig.from_command_line(argv).batch_size
            == ff.FFConfig.from_command_line(argv).batch_size == 4)
    for cls in (pt.FFConfig, ff.FFConfig):
        with pytest.raises(ValueError, match="requires a value"):
            cls().parse_args(["--nodes"])


# -- _synthetic ---------------------------------------------------------------
SHRUNK = {"FF_BERT_HIDDEN": "32", "FF_BERT_HEADS": "4", "FF_BERT_LAYERS": "1",
          "FF_BERT_SEQ": "16", "FF_BERT_VOCAB": "64", "FF_MOE_HIDDEN": "32",
          "FF_MOE_HEADS": "4", "FF_MOE_LAYERS": "1", "FF_MOE_EXPERTS": "4",
          "FF_MOE_VOCAB": "64", "FF_MOE_SEQ": "8"}


def _ops(model):
    return [(op.name, op.op_type.value, [tuple(t.dims) for t in op.outputs])
            for op in model.ops]


@pytest.mark.parametrize("name", ZOO)
def test_synthetic_same_data_and_graph(name, monkeypatch):
    for k, v in SHRUNK.items():
        monkeypatch.setenv(k, v)
    jcfg, pcfg = ff.FFConfig(), pt.FFConfig(device="cpu")
    jcfg.parse_args(["-b", "2"])
    pcfg.parse_args(["-b", "2"])
    jm, jxs, jy = jax_synthetic(name, jcfg)
    pm, pxs, py = pt_synthetic(name, pcfg)
    assert len(jxs) == len(pxs)
    for a, b in zip(jxs, pxs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jy, py)
    assert _ops(pm) == _ops(jm)


def test_unknown_model_exits_like_jax():
    for synth, cfg in ((jax_synthetic, ff.FFConfig()),
                       (pt_synthetic, pt.FFConfig(device="cpu"))):
        with pytest.raises(SystemExit, match="unknown --model 'nope'"):
            synth("nope", cfg)


# -- the default path and --from-c-spec ------------------------------------
LAST_LINE = re.compile(
    r"^\[(?P<name>[^\]]+)\] (?P<epochs>\d+) epoch\(s\) in [0-9.]+s "
    r"\([0-9.]+ samples/s\), final metrics: (?P<metrics>.*)$")


def _last_line(out: str):
    line = out.strip().splitlines()[-1]
    m = LAST_LINE.match(line)
    assert m, line
    metrics = dict(kv.split("=") for kv in m["metrics"].split(", "))
    return m["name"], m["epochs"], {k: float(v) for k, v in metrics.items()}


def _capture_fit(monkeypatch, cls, record, before=None):
    """Wrap cls.fit: record its inputs and the weights it starts from;
    `before(model)` runs first (the port takes JAX's weights there)."""
    fit = cls.fit

    def wrapped(self, x=None, y=None, *a, **kw):
        if before is not None:
            before(self)
        record["xs"] = [np.asarray(v) for v in x]
        record["y"] = np.asarray(y)
        record["params"] = {o: {w: np.asarray(v) for w, v in ws.items()}
                            for o, ws in self.params.items()}
        record["hist"] = fit(self, x, y, *a, **kw)
        return record["hist"]

    monkeypatch.setattr(cls, "fit", wrapped)


def _f32(monkeypatch, cls):
    """FFConfig() in f32: the packages' bf16 products round apart by
    ~1e-5 of the loss; in f32 they agree to the tolerance."""
    init = cls.__init__

    def f32_init(self, *a, **kw):
        init(self, *a, **kw)
        self.allow_mixed_precision = False

    monkeypatch.setattr(cls, "__init__", f32_init)


def test_default_path_trains_like_jax(monkeypatch, capsys):
    argv = ["--model", "mnist_mlp", "-b", "16", "-e", "1", "--chips", "1"]
    jrec, prec = {}, {}
    with monkeypatch.context() as mp:
        _f32(mp, ff.FFConfig)
        _capture_fit(mp, ff.FFModel, jrec)
        jax_main(list(argv))
    jname, jepochs, jmetrics = _last_line(capsys.readouterr().out)
    with monkeypatch.context() as mp:
        _f32(mp, pt.FFConfig)
        _capture_fit(mp, pt.FFModel, prec,
                     before=lambda m: pt.params_from_jax(m, jrec["params"]))
        pt_main(argv + CPU)
    pname, pepochs, pmetrics = _last_line(capsys.readouterr().out)
    assert (pname, pepochs) == (jname, jepochs) == ("mnist_mlp", "1")
    for a, b in zip(prec["xs"] + [prec["y"]], jrec["xs"] + [jrec["y"]]):
        np.testing.assert_array_equal(a, b)
    assert set(pmetrics) == set(jmetrics)
    # the line prints 4 decimals; fit's own summary carries the values
    jlast, plast = jrec["hist"][-1], prec["hist"][-1]
    for k in set(jmetrics) - {"throughput"}:  # a wall clock rate
        assert plast[k] == pytest.approx(jlast[k], rel=1e-5, abs=1e-6), k


def test_from_c_spec_like_jax(tmp_path, monkeypatch, capsys):
    spec = tmp_path / "mlp.json"
    spec.write_text(json.dumps(HANDWRITTEN))
    argv = ["--from-c-spec", str(spec), "-e", "1", "--chips", "1"]
    jrec, prec = {}, {}
    with monkeypatch.context() as mp:
        _capture_fit(mp, ff.FFModel, jrec)
        jax_main(list(argv))
    jline = _last_line(capsys.readouterr().out)
    with monkeypatch.context() as mp:
        _capture_fit(mp, pt.FFModel, prec)
        pt_main(argv + CPU)
    pline = _last_line(capsys.readouterr().out)
    assert pline[:2] == jline[:2] == (str(spec), "1")
    assert set(pline[2]) == set(jline[2])
    for a, b in zip(prec["xs"] + [prec["y"]], jrec["xs"] + [jrec["y"]]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(SystemExit, match="missing value for --from-c-spec"):
        pt_main(["--from-c-spec"] + CPU)


def test_compile_exports_the_computation_graph_like_jax(tmp_path):
    texts = []
    for pkg, cfg, synth in ((ff, ff.FFConfig(), jax_synthetic),
                            (pt, pt.FFConfig(device="cpu"), pt_synthetic)):
        path = tmp_path / f"{pkg.__name__}.dot"
        cfg.parse_args(["-b", "4", "--chips", "1",
                        "--export-strategy-computation-graph-file",
                        str(path)])
        model, _, _ = synth("mnist_mlp", cfg)
        model.compile(
            optimizer=pkg.SGDOptimizer(model, lr=0.01),
            loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        texts.append(path.read_text())
    assert texts[1] == texts[0]
    assert texts[0].startswith("digraph")


def test_script_mode_like_jax(tmp_path, capsys):
    script = tmp_path / "user.py"
    script.write_text("import sys\nprint(sys.argv[1:], __name__)\n")
    argv = ["-b", "4", str(script), "--device", "cpu"]
    saved = list(sys.argv)
    try:
        jax_main(list(argv))
        jout = capsys.readouterr().out
        pt_main(list(argv))
        pout = capsys.readouterr().out
    finally:
        sys.argv = saved
    assert pout == jout == "['-b', '4', '--device', 'cpu'] __main__\n"


def test_cuda_without_a_card_exits():
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for argv in (["--model", "mnist_mlp"], ["profile"], ["analyze"],
                 ["timeline", "--trace", "t.json"],
                 ["serve-bench", "--requests", "1"]):
        with pytest.raises(SystemExit) as e:
            pt_main(argv)
        assert e.value.code != 0


# -- analyze ------------------------------------------------------------------
def _report(out: str) -> dict:
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


def _codes(doc):
    return sorted((d["code"], d["severity"]) for d in doc["diagnostics"])


def _mnist_strategy(tmp_path):
    from flexflow_tpu.core.graph import Graph
    from flexflow_tpu.search.machine_model import make_machine_model
    from flexflow_tpu.search.unity import export_strategy, unity_optimize

    cfg = ff.FFConfig()
    cfg.batch_size = 64
    cfg.search_budget = 4
    cfg.num_devices = 8
    model, _, _ = jax_synthetic("mnist_mlp", cfg)
    graph = Graph(model.ops)
    r = unity_optimize(graph, cfg, make_machine_model(cfg, 8),
                       cfg.batch_size, 8)
    path = str(tmp_path / "s.json")
    export_strategy(r, graph, path)
    return path


def _bad_strategy(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({
        "mesh_axes": {"data": 16},  # 16 > 4 devices
        "ops": {"linear_0": {"dp": 16, "tp": 1}},
    }))
    return str(path)


ANALYZE = {
    "clean": lambda tmp: ["--model", "mnist_mlp", "--chips", "4"],
    "json": lambda tmp: ["--model", "mnist_mlp", "--chips", "4", "--json"],
    "missing-value": lambda tmp: ["--model"],
    "missing-strategy-value": lambda tmp: ["--strategy"],
    "bad-strategy": lambda tmp: ["--model", "mnist_mlp", "--chips", "4",
                                 "--strategy", _bad_strategy(tmp), "--json"],
    "provenance-same": lambda tmp: ["--model", "mnist_mlp", "--chips", "8",
                                    "--strategy", _mnist_strategy(tmp),
                                    "--json"],
    "provenance-other-machine": lambda tmp: [
        "--model", "mnist_mlp", "--chips", "4",
        "--strategy", _mnist_strategy(tmp), "--json"],
    "multipod": lambda tmp: [
        "--model", "mnist_mlp", "--chips", "16", "--machine-spec",
        os.path.join(REPO, "examples", "machines", "multipod_2x8.json"),
        "--json"],
    **{f"artifact-{m}": (lambda tmp, m=m: [
        "--model", m, "--chips", "8", "--strategy",
        os.path.join(REPO, "examples", "strategies", f"{m}_8dev.json"),
        "--json"]) for m in ("bert", "cifar10_cnn", "mnist_mlp")},
}


@pytest.mark.parametrize("case", ANALYZE)
def test_analyze_like_jax(case, tmp_path, capsys):
    argv = ANALYZE[case](tmp_path)
    jrc = jax_analyze(list(argv))
    jout, jerr = capsys.readouterr()
    prc = pt_analyze(argv + CPU)
    pout, perr = capsys.readouterr()
    assert prc == jrc
    assert ("needs a value" in perr) == ("needs a value" in jerr)
    if "--json" in argv:
        jdoc, pdoc = _report(jout), _report(pout)
        assert set(pdoc) == set(jdoc)
        assert (pdoc["schema"], pdoc["ok"]) == (jdoc["schema"], jdoc["ok"])
        assert _codes(pdoc) == _codes(jdoc)
        assert pdoc["passes_run"] == jdoc["passes_run"]
    elif jrc == 0:
        assert "plan OK" in jout and "plan OK" in pout


def test_analyze_through_python_m():
    """The module entry itself: `python -m flexflow_tpu_torch analyze`."""
    r = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch", "analyze", "--model",
         "bert", "--chips", "8", "--strategy",
         os.path.join(REPO, "examples", "strategies", "bert_8dev.json"),
         "--json"] + CPU,
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "FF_BERT_LAYERS": "2"})
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["ok"] is True
    assert "plan OK" in r.stderr


# -- timeline and validate_trace ---------------------------------------------
EPOCH = 1_700_000_000.0


def _trace():
    return {"traceEvents": [
        {"name": "trace_metadata", "ph": "M", "pid": 7, "tid": 0,
         "args": {"epoch_wall_s": EPOCH}},
        {"name": "thread_name", "ph": "M", "pid": 7, "tid": 1,
         "args": {"name": "sched"}},
        {"name": "outer", "ph": "X", "ts": 0.0, "dur": 100.0, "pid": 7,
         "tid": 1, "args": {"trace_id": "a"}},
        {"name": "inner", "ph": "X", "ts": 10.0, "dur": 20.0, "pid": 7,
         "tid": 1, "args": {"trace_id": "a"}},
        {"name": "marker", "ph": "i", "s": "t", "ts": 50.0, "pid": 7,
         "tid": 1, "args": {"trace_id": "b"}}]}


EVENTS = [
    {"kind": "fleet.dispatch", "step": -1, "time_s": EPOCH + 0.001,
     "details": {"replica": "r0"}},
    {"kind": "fleet.dead", "step": 3, "time_s": EPOCH + 0.002,
     "details": {"replica": "r1"}}]
FLIGHT = {"entries": [
    {"stream": "events", "kind": "fleet.suspect", "wall_s": EPOCH + 0.0005,
     "details": {"replica": "r1"}},
    {"stream": "health", "kind": "fleet.respawn", "wall_s": EPOCH + 0.003,
     "step": 4},
    {"stream": "metrics", "source": "router", "wall_s": EPOCH + 0.004,
     "text": "a 1\nb 2\n"},
    {"stream": "metrics", "wall_s": EPOCH + 0.005, "text": ""}]}


@pytest.mark.parametrize("events, flight, epoch", [
    (EVENTS, FLIGHT, None), (None, FLIGHT, None), (EVENTS, None, None),
    (None, None, EPOCH - 1.0)], ids=["events+flight", "flight", "events",
                                     "epoch-wall"])
def test_merge_timeline_equals_jax(events, flight, epoch):
    assert (pt_merge(_trace(), events=events, flight=flight,
                     epoch_wall_s=epoch)
            == jax_merge(_trace(), events=events, flight=flight,
                         epoch_wall_s=epoch))


def test_merge_timeline_without_epoch_raises_like_jax():
    trace = {"traceEvents": _trace()["traceEvents"][1:]}
    for merge in (pt_merge, jax_merge):
        with pytest.raises(ValueError, match="no wall<->perf epoch"):
            merge(trace)


def _write(path, obj):
    path.write_text(json.dumps(obj))
    return str(path)


def test_run_timeline_like_jax(tmp_path, capsys):
    trace = _write(tmp_path / "trace.json", _trace())
    events = _write(tmp_path / "events.json", EVENTS)
    bundle = tmp_path / "flight" / "postmortem_0001"
    bundle.mkdir(parents=True)
    _write(bundle / "recorder.json", FLIGHT)
    _write(bundle / "trace.json", _trace())
    outs = {}
    for name, run, extra in (("jax", jax_timeline, []),
                             ("port", pt_timeline, CPU)):
        out = str(tmp_path / f"{name}.json")
        assert run(["--trace", trace, "--events", events, "--flight",
                    str(tmp_path / "flight"), "--out", out] + extra) == 0
        summary = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        assert summary.pop("out") == out
        outs[name] = (summary, json.load(open(out)))
        # the bundle's own trace stands in for a missing --trace
        assert run(["--flight", str(tmp_path / "flight"), "--out",
                    out] + extra) == 0
        capsys.readouterr()
    assert outs["port"] == outs["jax"]
    assert pt_validate(str(tmp_path / "port.json")) == \
        jax_validate(str(tmp_path / "jax.json"))


@pytest.mark.parametrize("argv, match", [
    ([], "need --trace and/or --flight"),
    (["--bogus", "1"], "unrecognized arguments"),
    (["--trace"], "missing value for --trace"),
    (["--flight", "{tmp}/empty"], "no recorder.json"),
    (["--flight", "{tmp}/bare"], "carries no trace.json")])
def test_run_timeline_missing_inputs_like_jax(argv, match, tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "bare").mkdir()
    _write(tmp_path / "bare" / "recorder.json", FLIGHT)
    argv = [a.format(tmp=tmp_path) for a in argv]
    for run, extra in ((jax_timeline, []), (pt_timeline, CPU)):
        with pytest.raises(SystemExit, match=match):
            run(argv + extra)


BAD_TRACES = {
    "not-a-list": {"traceEvents": {}},
    "missing-ts": {"traceEvents": [{"name": "a", "ph": "X", "dur": 1,
                                    "pid": 1, "tid": 1}]},
    "missing-dur": {"traceEvents": [{"name": "a", "ph": "X", "ts": 0,
                                     "pid": 1, "tid": 1}]},
    "overlap": {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]},
    "no-events": {"other": []},
}


@pytest.mark.parametrize("case", ["valid"] + list(BAD_TRACES))
def test_validate_trace_like_jax(case, tmp_path):
    path = _write(tmp_path / "t.json",
                  _trace() if case == "valid" else BAD_TRACES[case])
    try:
        want = jax_validate(path)
    except (ValueError, KeyError) as e:
        with pytest.raises(type(e)) as got:
            pt_validate(path)
        assert str(got.value) == str(e)
    else:
        assert pt_validate(path) == want == ["inner", "marker", "outer"]


def test_validate_trace_of_a_port_tracer_export(tmp_path):
    """A trace the port's tracer wrote, checked by both validators."""
    from flexflow_tpu_torch.obs.tracing import Tracer

    t = Tracer(enabled=True)
    with t.span("outer"):
        with t.span("inner"):
            pass
        t.instant("marker")
    path = t.export_chrome_trace(str(tmp_path / "t.json"))
    assert pt_validate(path) == jax_validate(path) == \
        ["inner", "marker", "outer"]


# -- profile ------------------------------------------------------------------
def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


@pytest.mark.parametrize("extra", [[], ["--kernel-report"]],
                         ids=["plain", "kernel-report"])
def test_profile_like_jax(extra, tmp_path, capsys):
    argv = ["--model", "mnist_mlp", "-b", "16", "-e", "1", "--chips", "1",
            "--calibration-max-ops", "3"] + extra
    runs = {}
    for name, run, dev in (("jax", jax_profile, []),
                           ("port", pt_profile, CPU)):
        out = str(tmp_path / name)
        rc = run(argv + ["--out", out] + dev)
        summary = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        runs[name] = (rc, out, summary)
    (jrc, jout, js), (prc, pout, ps) = runs["jax"], runs["port"]
    assert prc == jrc == 0
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    for f in ("bench.json", "calibration.json"):
        pdoc, jdoc = (json.load(open(os.path.join(d, f)))
                      for d in (pout, jout))
        assert _keys(pdoc) == _keys(jdoc), f
    assert _keys(ps) == _keys(js)
    assert (ps["ok"], ps["spans"], ps["steps_recorded"]) == \
        (js["ok"], js["spans"], js["steps_recorded"])
    bench = json.load(open(os.path.join(pout, "bench.json")))
    assert bench["backend"] == "cpu" and bench["n_devices"] == 1
