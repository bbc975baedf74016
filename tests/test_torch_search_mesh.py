"""The searched plan trains like the JAX package's on a mesh of gloo
ranks on the CPU (flexflow_tpu_torch.tools.tp_train `spawn_jobs`, as
tests/test_torch_tp.py spawns them): test_torch_tp.py's BERT (hidden 64,
4 heads, 2 layers, seq 16, batch 8, f32, Adam 1e-3, 3 steps, from JAX's
initial weights) under

 - compile(search_budget > 0) with no axes on 4 ranks: JAX picks
   {"data": 2} with three dp = 1 ops, a mesh smaller than the world and
   per-op data degrees; ranks 2 and 3 hold no position and refuse to fit;
 - an imported strategy file on {"data": 2, "model": 2}: the embedding
   and the first attention at dp 1, one FFN linear at tp 2;
 - compile() with no axes and no search on 2 ranks: {"data": 2}.

Both packages search on their Python paths (`use_native_search=False`;
tests/test_torch_search.py holds the native cores against each other).
Against JAX on 4 (2) of conftest's CPU devices: the same plan on every
rank, the losses within test_torch_tp.py's LOSS_REL and the final
weights within its W_RTOL / W_ATOL. Each spawn runs under its own time
limit.
"""
import json

import numpy as np
import pytest

import flexflow_tpu as ff
from tests.test_torch_tp import JOB as TP_JOB
from tests.test_torch_tp import LOSS_REL, W_ATOL, W_RTOL
from tests.test_torch_tp import _data, _host

SEARCH_BUDGET = 100  # JAX picks {"data": 2} and three dp = 1 ops here
# the imported plan: dp 2 x tp 2, the embedding and the first attention
# at dp 1, the second layer's first FFN linear at tp 2
IMPORTED = {"data": 2, "model": 2}
IMPORTED_OFF = {"input_0": (1, 1), "tok_emb": (1, 1),
                "layer0_attn": (1, 1), "layer1_ff1": (2, 2)}
JOIN_S = 120
# predict's batch on the mesh: 8 samples as 3 + 3 + 2 (a batch the data
# axis cannot cut, and a tail it can)
PREDICT_BATCH = 3


def _jax_fit(num_devices, **knobs):
    from flexflow_tpu.models import TransformerConfig, build_bert_encoder

    c = ff.FFConfig()
    c.num_devices = num_devices
    c.batch_size = 8
    c.allow_mixed_precision = False
    c.use_native_search = False
    for k, v in knobs.items():
        setattr(c, k, v)
    jm = ff.FFModel(c)
    tok = jm.create_tensor([8, 16], ff.DataType.DT_INT32)
    build_bert_encoder(jm, tok, TransformerConfig(**TP_JOB["widths"]),
                       use_flash=True)
    jm.compile(optimizer=ff.AdamOptimizer(jm, alpha=1e-3),
               loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ff.MetricsType.METRICS_ACCURACY])
    init = _host(jm.params)
    x, y = _data()
    hist = jm.fit(x, y, batch_size=8, epochs=TP_JOB["steps"])
    plan = {jm.graph.ops[g].name: [s.dp, s.tp]
            for g, s in (jm._op_strategies or {}).items()}
    return {"init": init, "losses": [h["loss"] for h in hist],
            "final": _host(jm.params), "axes": dict(jm.parallel_axes),
            "plan": plan, "eval": jm.eval(x, y, batch_size=8),
            "predict": jm.predict(x, batch_size=PREDICT_BATCH)}


@pytest.fixture(scope="module")
def strategy_file(tmp_path_factory):
    from flexflow_tpu.models import TransformerConfig, build_bert_encoder

    jm = ff.FFModel(ff.FFConfig())
    build_bert_encoder(jm, jm.create_tensor([8, 16], ff.DataType.DT_INT32),
                       TransformerConfig(**TP_JOB["widths"]), use_flash=True)
    ops = {}
    for op in jm.ops:
        dp, tp = IMPORTED_OFF.get(op.name, (2, 1))
        ops[op.name] = {"dp": dp, "tp": tp}
    path = tmp_path_factory.mktemp("plan") / "strategy.json"
    path.write_text(json.dumps({"mesh_axes": IMPORTED, "ops": ops}))
    return str(path)


@pytest.fixture(scope="module")
def jax_mesh_runs(strategy_file):
    return {"searched": _jax_fit(4, search_budget=SEARCH_BUDGET),
            "imported": _jax_fit(4, import_strategy_file=strategy_file),
            "default": _jax_fit(2)}


@pytest.fixture(scope="module")
def port_mesh_runs(jax_mesh_runs, strategy_file, tmp_path_factory):
    """4 gloo ranks: the searched plan and the imported one; then 2 ranks
    with no axes and no search (the default data axis). Results by rank."""
    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    x, y = _data()
    base = dict(TP_JOB, axes=None, x=x, y=y, return_params=True, eval=True,
                predict_batch=PREDICT_BATCH)
    jobs = [dict(base, params=jax_mesh_runs["searched"]["init"],
                 config={"search_budget": SEARCH_BUDGET,
                         "use_native_search": False}),
            dict(base, params=jax_mesh_runs["imported"]["init"],
                 config={"import_strategy_file": strategy_file})]
    four = spawn_jobs(4, "cpu", jobs, timeout_s=JOIN_S,
                      workdir=str(tmp_path_factory.mktemp("rdv4")))
    two = spawn_jobs(2, "cpu", [dict(
        base, params=jax_mesh_runs["default"]["init"])], timeout_s=JOIN_S,
        workdir=str(tmp_path_factory.mktemp("rdv2")))
    return {"searched": [r["jobs"][0] for r in four],
            "imported": [r["jobs"][1] for r in four],
            "default": [r["jobs"][0] for r in two]}


RUNS = ["searched", "imported", "default"]


@pytest.mark.parametrize("run", RUNS)
def test_mesh_plan_is_jax_s_on_every_rank(jax_mesh_runs, port_mesh_runs,
                                          run):
    want = jax_mesh_runs[run]
    ranks = port_mesh_runs[run]
    for r in ranks:
        assert r["plan"]["axes"] == want["axes"]
        if want["plan"]:
            assert r["plan"]["ops"] == want["plan"]
        assert r["plan"] == ranks[0]["plan"]
    if run == "searched":
        assert want["axes"] == {"data": 2}
        assert sorted(k for k, v in want["plan"].items() if v[0] == 1) == \
            ["input_0", "layer0_attn", "tok_emb"]
    if run == "default":
        assert want["axes"] == {"data": 2}


@pytest.mark.parametrize("run", RUNS)
def test_mesh_plan_trains_like_jax(jax_mesh_runs, port_mesh_runs, run):
    want = jax_mesh_runs[run]
    on_mesh = [r for r in port_mesh_runs[run] if "losses" in r]
    assert len(on_mesh) == 2 if run != "imported" else len(on_mesh) == 4
    for r in on_mesh:
        assert r["losses"] == on_mesh[0]["losses"]
        for p, j in zip(r["losses"], want["losses"]):
            assert p == pytest.approx(j, rel=LOSS_REL)
    assert on_mesh[0]["eval"]["loss"] == pytest.approx(
        want["eval"]["loss"], rel=LOSS_REL)
    np.testing.assert_allclose(on_mesh[0]["predict"], want["predict"],
                               rtol=W_RTOL, atol=W_ATOL)
    got = on_mesh[0]["params"]
    for op, ws in want["final"].items():
        for w, v in ws.items():
            np.testing.assert_allclose(got[op][w], v, rtol=W_RTOL,
                                       atol=W_ATOL, err_msg=f"{op}/{w}")


def test_ranks_past_the_mesh_refuse_to_train(port_mesh_runs):
    past = [r for r in port_mesh_runs["searched"] if r.get("outside_mesh")]
    assert len(past) == 2
    for r in past:
        assert "past the plan's mesh {'data': 2}" in r["fit_error"]
        assert "losses" not in r



def _compile_with_failing_search(rank, world, init, job):
    """A rank's body: compile a job whose search fails on rank 0; the
    error this rank raised."""
    from flexflow_tpu_torch.runtime import distributed
    from flexflow_tpu_torch.tools.tp_train import build_encoder

    distributed.initialize(init, world_size=world, rank=rank, device="cpu")
    try:
        build_encoder(job, "cpu")
        return None
    except Exception as exc:  # the test reads every rank's error
        return f"{type(exc).__name__}: {exc}"
    finally:
        distributed.shutdown()


def test_a_failed_search_raises_on_every_rank(tmp_path):
    """Rank 0's search raises (a rule file that does not parse) and
    tells the other rank, which raises too rather than wait for a
    plan."""
    from flexflow_tpu_torch.runtime.distributed import spawn

    rules = tmp_path / "broken_rules.json"
    rules.write_text('{"rule": [')
    job = dict(TP_JOB, axes=None, config={
        "search_budget": 5, "substitution_json_path": str(rules)})
    init = "file://" + str(tmp_path / "rdv")
    errors = spawn(_compile_with_failing_search, 2, (2, init, job),
                   timeout_s=JOIN_S)
    assert errors[0].startswith("JSONDecodeError")
    assert errors[1].startswith("RuntimeError: rank 0's strategy search "
                                "failed: JSONDecodeError")
