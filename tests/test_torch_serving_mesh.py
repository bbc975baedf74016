"""Serving on a mesh of gloo ranks on the CPU, held against the JAX package
on conftest's CPU devices (JAX's weights carried by op and weight name):

 - the JAX entry's leg 9 (`__graft_entry__.py:426-465`: a 4-row causal
   LM, 5-token prompts, 6 new tokens, f32): the port's GenerativeSession
   compiled in inference mode on {"data": 2}, {"model": 2} and
   {"data": 2, "model": 2} gives JAX's one-device greedy tokens exactly,
   at one and three tokens a dispatch, and for a partial batch with and
   without an eos_id that stops it early (decided on the gathered rows);
   sampled tokens equal the port's one-device ones (keys of the global
   rows); every rank returns the same array;
 - tests/test_serving.py's sharded scenario: InferenceModel with buckets
   (2, 8) over the same three meshes (bucket padding, a 5-row partial
   batch) against JAX's within rtol 1e-5, atol 1e-6, and 5 single-row
   requests through the leader-driven DynamicBatcher equal to the direct
   predict; a follower's submit raises;
 - the ContinuousBatcher refuses a partitioned model with JAX's
   ValueError, word for word.

Each world's jobs run in one spawn (tools/tp_train.py `spawn_jobs`, which
imports no jax) under one time limit: two ranks for the one-axis meshes,
four for data x model.
"""
import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu.serving import InferenceModel as JaxInferenceModel
from flexflow_tpu.serving.generate import GenerativeSession as JaxSession
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu_torch.serving.sched import (kv_cache_spec,
                                              local_kv_cache_spec)
from flexflow_tpu_torch.tools.tp_train import (MODELS, build_encoder,
                                               spawn_jobs)
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

JOIN_S = 240
TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = ({"data": 2}, {"model": 2}, {"data": 2, "model": 2})
IDS = ["data", "model", "data_model"]
LM = dict(model="lm9", batch=4, mixed=False, seed=48,
          comp_mode="inference")
MLP = dict(model="serve_mlp", batch=16, mixed=False, seed=9,
           comp_mode="inference")
# generate's keywords of each session run: greedy, greedy at K = 3,
# sampled; the partial batch (prompts 0 and 3): greedy, and with an eos
# both rows reach before the budget
RUNS = ({"new": 6}, {"new": 6, "k": 3},
        {"new": 6, "temperature": 0.8, "top_k": 8, "seed": 3})
PART_ROWS = [0, 3]
PART_RUNS = ({"new": 6}, {"new": 6, "eos_id": 5, "k": 2})


def _host(tree):
    return {op: {w: np.asarray(v, np.float32) for w, v in ws.items()}
            for op, ws in tree.items()}


def _jax_model(name, job, axes):
    cfg = ff.FFConfig()
    cfg.batch_size = job["batch"]
    cfg.allow_mixed_precision = False
    cfg.seed = job["seed"]
    cfg.num_devices = int(np.prod(list(axes.values()))) if axes else 1
    m = ff.FFModel(cfg)
    MODELS[name](ff, m, {"batch": job["batch"]})
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.0),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              parallel_axes=axes)
    return m


@pytest.fixture(scope="module")
def ref():
    """JAX's numbers: leg 9's sessions on one device, the serving model's
    predict on one device and on each mesh, and each mesh's refusal."""
    lm = _jax_model("lm9", LM, None)
    prompts = np.random.RandomState(8).randint(1, 50, size=(4, 5)).astype(
        np.int32)
    sess = JaxSession(lm, max_len=16)

    def gen(rows, r):
        return np.asarray(sess.generate(
            rows, max_new_tokens=r["new"], eos_id=r.get("eos_id"),
            tokens_per_dispatch=r.get("k", 1), seed=0))

    toks = {i: gen(prompts, r) for i, r in enumerate(RUNS)
            if not r.get("temperature")}
    part = [gen(prompts[PART_ROWS], r) for r in PART_RUNS]
    mlp = _jax_model("serve_mlp", MLP, None)
    x = np.random.RandomState(3).randn(5, 8).astype(np.float32)
    name = JaxInferenceModel(mlp).input_names[0]
    out = {"prompts": prompts, "tokens": toks, "partial": part,
           "lm_params": _host(lm.params), "mlp_params": _host(mlp.params),
           "x": x, "predict": np.asarray(JaxInferenceModel(
               mlp, batch_buckets=(2, 8)).predict({name: x})),
           "refusal": {}, "mesh_predict": {}}
    for axes, key in zip(MESHES, IDS):
        m = _jax_model("serve_mlp", MLP, axes)
        out["mesh_predict"][key] = np.asarray(JaxInferenceModel(
            m, batch_buckets=(2, 8)).predict({name: x}))
        with pytest.raises(ValueError) as err:
            JaxBatcher(_jax_model("lm9", LM, axes), max_len=16,
                       num_slots=2)
        out["refusal"][key] = str(err.value)
    return out


def _jobs(ref, axes):
    """One mesh's jobs: the sessions (a full and a partial batch), the
    sharded inference scenario, the ContinuousBatcher's refusal."""
    lm = dict(LM, axes=axes, params=ref["lm_params"],
              x=np.zeros((4, 8), np.int32), y=np.zeros((4, 8, 1), np.int32))
    return [
        dict(lm, serve={"kind": "session", "prompts": ref["prompts"],
                        "max_len": 16, "runs": list(RUNS)}),
        dict(lm, serve={"kind": "session",
                        "prompts": ref["prompts"][PART_ROWS], "max_len": 16,
                        "runs": list(PART_RUNS)}),
        dict(MLP, axes=axes, params=ref["mlp_params"],
             serve={"kind": "infer", "buckets": (2, 8), "x": ref["x"],
                    "batcher_rows": 5}),
        dict(lm, serve={"kind": "refusal", "max_len": 16})]


@pytest.fixture(scope="module")
def ranks(ref):
    """Each mesh's results by rank: {"data": 2} and {"model": 2} in one
    spawn of two ranks, {"data": 2, "model": 2} in one of four."""
    two = spawn_jobs(2, "cpu", _jobs(ref, MESHES[0]) + _jobs(ref, MESHES[1]),
                     timeout_s=JOIN_S)
    four = spawn_jobs(4, "cpu", _jobs(ref, MESHES[2]), timeout_s=JOIN_S)
    return {"data": [r["jobs"][:4] for r in two],
            "model": [r["jobs"][4:] for r in two],
            "data_model": [r["jobs"] for r in four]}


@pytest.mark.parametrize("key", IDS)
def test_leg9_greedy_tokens_equal_jax_one_device(ranks, ref, key):
    for jobs in ranks[key]:
        runs = jobs[0]["runs"]
        for i, want in ref["tokens"].items():
            np.testing.assert_array_equal(runs[i]["tokens"], want,
                                          err_msg=f"run {RUNS[i]}")
        for run, want in zip(jobs[1]["runs"], ref["partial"]):
            np.testing.assert_array_equal(run["tokens"], want)


def test_leg9_eos_stops_the_partial_batch_early(ref):
    """Both real rows of the partial batch reach eos 5 before the budget
    in JAX's one-device run, so the port's stop (on the gathered rows of
    every rank, padded rows finished from the start) is exercised."""
    assert ref["partial"][1].shape == (2, 5)
    assert (ref["partial"][1] == 5).any(axis=1).all()


@pytest.mark.parametrize("key", IDS)
def test_sampled_tokens_on_a_mesh_equal_the_ports_one_device(ranks, ref,
                                                             key):
    from flexflow_tpu_torch.serving import GenerativeSession

    one = build_encoder(dict(LM, axes={}, params=ref["lm_params"]), "cpu")
    r = RUNS[2]
    want = GenerativeSession(one, max_len=16).generate(
        ref["prompts"], max_new_tokens=r["new"], temperature=
        r["temperature"], top_k=r["top_k"], seed=r["seed"])
    for jobs in ranks[key]:
        np.testing.assert_array_equal(jobs[0]["runs"][2]["tokens"], want)


@pytest.mark.parametrize("key", IDS)
def test_session_runs_eagerly_on_its_rows_and_says_why(ranks, key):
    """Each rank walks its `data` rows (keys of the global rows), every
    dispatch an eager walk, with graph_capture's reason."""
    dp = 2 if "data" in key else 1
    rows = sorted((j[0]["stats"]["row0"], j[0]["stats"]["rows"])
                  for j in ranks[key])
    assert {r for _, r in rows} == {4 // dp}
    assert sorted({r0 for r0, _ in rows}) == [i * 4 // dp
                                              for i in range(dp)]
    for jobs in ranks[key]:
        st = jobs[0]["stats"]
        assert not st["graph_capture"] and st["reason"]
        assert st["graphs"]["captures"] == st["graphs"]["replays"] == 0
        assert st["graphs"]["eager_walks"] > 0


@pytest.mark.parametrize("key", IDS)
def test_inference_compile_on_a_mesh_builds_no_train_step(ranks, key):
    for jobs in ranks[key]:
        j = jobs[0]
        assert not j["train_step"] and not j["opt_state"]
        assert "training mode" in j["fit_error"]


@pytest.mark.parametrize("key", IDS)
def test_sharded_batched_inference_matches_jax(ranks, ref, key):
    """tests/test_serving.py:42-58 on the port's ranks: bucket padding and
    the 5-row partial batch against JAX (one device and the same mesh),
    and the leader's batcher against the direct predict."""
    for jobs in ranks[key]:
        got = jobs[2]["predict"]
        np.testing.assert_allclose(got, ref["predict"], **TOL)
        np.testing.assert_allclose(got, ref["mesh_predict"][key], **TOL)
        st = jobs[2]["stats"]
        assert st["graphs"]["captures"] == 0 and st["graphs"][
            "eager_walks"] >= 1
    leader = ranks[key][0][2]
    np.testing.assert_allclose(leader["batcher"], leader["predict"], **TOL)


@pytest.mark.parametrize("key", IDS)
def test_followers_walk_the_leaders_batches(ranks, key):
    """Every follower walked as many batches as the leader formed (each
    walk is collective) and refused a request of its own."""
    leader = ranks[key][0][2]
    walks = leader["stats"]["graphs"]["eager_walks"]
    for jobs in ranks[key][1:]:
        j = jobs[2]
        assert j["followed"] >= 1
        assert j["stats"]["graphs"]["eager_walks"] == walks
        assert "rank 0" in j["follower_submit"]


@pytest.mark.parametrize("key", IDS)
def test_continuous_batcher_refuses_partitioned_models_as_jax(ranks, ref,
                                                              key):
    for jobs in ranks[key]:
        assert jobs[3]["refusal"] == ref["refusal"][key]


def test_local_cache_geometry_takes_the_ranks_heads():
    """kv_cache_spec keeps the whole geometry (JAX's kv_bytes_per_token
    reads it); local_kv_cache_spec divides the heads of an attention op
    sharded over `model`, and is the whole one on one device."""
    from types import SimpleNamespace

    from flexflow_tpu_torch.core.tensor import (ParallelDim,
                                                ParallelTensorShape)
    from flexflow_tpu_torch.ffconst import DataType

    m = build_encoder(dict(LM, axes={}), "cpu")
    assert local_kv_cache_spec(m) == kv_cache_spec(m) \
        == [("g_attn", 4, 8, 8, kv_cache_spec(m)[0][4])]
    op = next(o for o in m.ops if o.name == "g_attn")
    op.shards = {"wk": ParallelTensorShape(
        [ParallelDim(32), ParallelDim(4, 2, "model"), ParallelDim(8)],
        DataType.DT_FLOAT)}
    assert local_kv_cache_spec(m)[0][1] == 2
    assert kv_cache_spec(m)[0][1] == 4
    from flexflow_tpu_torch.serving.sched import local_rows

    mesh = SimpleNamespace(size=lambda a: 2 if a == "data" else 1)
    assert local_rows(SimpleNamespace(mesh=mesh), 4) == 2
    assert local_rows(SimpleNamespace(mesh=mesh), 3) == 3
    assert local_rows(SimpleNamespace(mesh=None), 4) == 4
