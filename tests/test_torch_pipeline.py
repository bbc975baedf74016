"""Pipeline parallelism (the `stage` axis) on gloo ranks on the CPU,
held against the JAX package on conftest's CPU devices:

 - FFModel.compile(parallel_axes={"stage": 4}) and {"data": 2, "stage":
   2} of the JAX entry's pipeline leg (a BERT encoder, hidden 16, 2
   heads, 4 layers, seq 12, 4 microbatches, SGD) from the JAX pipeline
   model's weights, its stacked `__pipeline__` tree unstacked by
   `params_from_jax`: 3 steps of losses (relative 1e-4), the gathered
   weights (rtol 1e-4, atol 5e-5) and each rank's shard shapes against
   JAX's per-device shards (a stage's slice of the stacked tree);
 - `adopt_params_from`: a stage mesh adopting a one-device model's
   weights trains as that model does, and a pipeline source is refused;
 - models/pipeline_transformer.py: `make_train_step` on 4 stages
   against JAX's from JAX's stacked weights, and `sequential_forward`
   against JAX's.

All the ranks' jobs run in one spawn under one time limit.
"""
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu_torch.models import pipeline_transformer as ptx
from flexflow_tpu_torch.tools.tp_train import MODELS, spawn_jobs

LOSS_REL = 1e-4
W_RTOL, W_ATOL = 1e-4, 5e-5
JOIN_S = 150
STEPS = 3
WIDTHS = dict(hidden_size=16, embedding_size=16, num_heads=2, num_layers=4,
              sequence_length=12, vocab_size=64)
B = 8
MESHES = {"stage4": {"stage": 4}, "data2_stage2": {"data": 2, "stage": 2}}


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _data():
    rng = np.random.RandomState(5)
    x = rng.randint(0, 64, (B, 12)).astype(np.int32)
    y = rng.randint(0, 2, (B, 12, 1)).astype(np.int32)
    return x, y


def _jax_pp(axes):
    """The JAX pipeline model on `axes`: initial params (stacked tree
    included), per-device shard shapes, losses, and every weight by op
    name after training (stage slices resolved)."""
    import flexflow_tpu.models  # noqa: F401

    cfg = ff.FFConfig()
    cfg.num_devices = 4
    cfg.batch_size = B
    cfg.pipeline_microbatches = 4
    cfg.allow_mixed_precision = False
    cfg.seed = 45
    jm = ff.FFModel(cfg)
    MODELS["encoder"](ff, jm, {"batch": B, "use_flash": None}, **WIDTHS)
    jm.compile(optimizer=ff.SGDOptimizer(jm, lr=0.1),
               loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ff.MetricsType.METRICS_ACCURACY],
               parallel_axes=axes)
    assert jm.executor.pipeline_plan is not None
    init = _host(jm.params)
    shards = {}
    for op in jm.ops:
        for w in op.weights:
            name = w._weight_spec.name
            slot = jm.executor.pipeline_weight_slot(op.name)
            if slot is None:
                v = jm.params[op.name][name]
                shards.setdefault(op.name, {})[name] = tuple(
                    v.sharding.shard_shape(v.shape))
            else:
                v = jm.params["__pipeline__"][slot[0]][name]
                shards.setdefault(op.name, {})[name] = tuple(
                    v.sharding.shard_shape(v.shape))[1:]
    x, y = _data()
    hist = jm.fit(x, y, batch_size=B, epochs=STEPS)
    final = {op.name: {w._weight_spec.name: np.asarray(
        jm.get_parameter_by_id(op.name, w._weight_spec.name), np.float32)
        for w in op.weights} for op in jm.ops if op.weights}
    return {"init": init, "shards": shards, "final": final,
            "losses": [h["loss"] for h in hist]}


def _jax_pipeline_transformer():
    """JAX's pipeline transformer: stacked params (4 stages of one layer,
    hidden 16, 2 heads), 3 train steps on a stage mesh of 4 CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flexflow_tpu.models import pipeline_transformer as jpt

    key = jax.random.PRNGKey(0)
    params = jpt.init_pipeline_params(key, n_layers=4, hidden=16, heads=2,
                                      stages=4)
    rng = np.random.RandomState(9)
    emb = rng.randn(32, 16).astype(np.float32) * 0.1
    head = rng.randn(16, 32).astype(np.float32) * 0.1
    tokens = rng.randint(0, 32, (8, 12)).astype(np.int32)
    labels = rng.randint(0, 32, (8, 12)).astype(np.int32)
    start = {"params": _host(params), "emb": emb, "head": head,
             "tokens": tokens, "labels": labels, "microbatches": 4,
             "lr": 0.05, "steps": STEPS}
    mesh = Mesh(np.array(jax.devices()[:4]), ("stage",))
    step = jpt.make_train_step(mesh, microbatches=4, lr=0.05)
    p, e, h = params, jnp.asarray(emb), jnp.asarray(head)
    losses = []
    for _ in range(STEPS):
        p, e, h, loss = step(p, e, h, jnp.asarray(tokens),
                             jnp.asarray(labels))
        losses.append(float(loss))
    x = np.asarray(jnp.asarray(emb)[tokens])
    seq = np.asarray(jpt.sequential_forward(params, jnp.asarray(x)))
    return start, {"losses": losses, "params": _host(p),
                   "emb": np.asarray(e), "head": np.asarray(h),
                   "x": x, "sequential": seq}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x, y = _data()
    base = dict(model="encoder", widths=WIDTHS, batch=B, mixed=False,
                optimizer=("sgd", 0.1), x=x, y=y, steps=STEPS,
                config={"pipeline_microbatches": 4}, return_params=True)
    jax_runs, jobs = {}, []
    for name, axes in MESHES.items():
        jax_runs[name] = _jax_pp(axes)
        jobs.append(dict(base, axes=axes, jax_params=jax_runs[name]["init"]))
    jobs.append(dict(base, axes={"stage": 4}, adopt_sequential=True,
                     seed=7))
    jobs.append(dict(base, axes={}, seed=7))
    start, jax_ptx = _jax_pipeline_transformer()
    jobs.append({"pipeline_transformer": start})
    res = spawn_jobs(4, "cpu", jobs, timeout_s=JOIN_S,
                     workdir=str(tmp_path_factory.mktemp("rdv")))
    port = [[r["jobs"][i] for r in res] for i in range(len(jobs))]
    return jax_runs, port, jax_ptx


@pytest.mark.parametrize("i, mesh", list(enumerate(MESHES)))
def test_stage_losses_match_jax(runs, i, mesh):
    jax_runs, port, _ = runs
    want = jax_runs[mesh]["losses"]
    for rank in port[i]:
        assert rank["roles"]["pipeline"]["stages"] == MESHES[mesh]["stage"]
        assert len(rank["losses"]) == len(want)
        for g, w in zip(rank["losses"], want):
            assert g == pytest.approx(w, rel=LOSS_REL)


@pytest.mark.parametrize("i, mesh", list(enumerate(MESHES)))
def test_stage_weights_match_jax(runs, i, mesh):
    jax_runs, port, _ = runs
    want = jax_runs[mesh]["final"]
    for rank in port[i]:
        assert set(rank["params"]) == set(want)
        for op, ws in want.items():
            for w, v in ws.items():
                np.testing.assert_allclose(rank["params"][op][w], v,
                                           rtol=W_RTOL, atol=W_ATOL,
                                           err_msg=f"{mesh} {op}/{w}")


@pytest.mark.parametrize("i, mesh", list(enumerate(MESHES)))
def test_stage_shard_shapes_match_jax(runs, i, mesh):
    """Each rank holds its stage's layers (JAX's per-device slice of the
    stacked tree, leading dim dropped) and every op outside the region
    whole."""
    jax_runs, port, _ = runs
    want = jax_runs[mesh]["shards"]
    layers = {op.split("_")[0] for op in want if op.startswith("layer")}
    for rank in port[i]:
        got = rank["shard_shapes"]
        held = {op.split("_")[0] for op in got if op.startswith("layer")}
        assert len(held) == len(layers) // MESHES[mesh]["stage"]
        for op, ws in got.items():
            assert ws == want[op], op
        assert {op for op in want if not op.startswith("layer")} <= set(got)


def test_adopt_params_from_a_sequential_model(runs):
    """A stage mesh that adopted a one-device model's weights trains as
    that model does (the same seed's weights); a pipeline-parallel model
    is refused as a source."""
    _, port, _ = runs
    n = len(MESHES)
    pp, one = port[n], port[n + 1]
    for rank in pp:
        for g, w in zip(rank["losses"], one[0]["losses"]):
            assert g == pytest.approx(w, rel=LOSS_REL)
        for op, ws in one[0]["params"].items():
            for w, v in ws.items():
                np.testing.assert_allclose(rank["params"][op][w], v,
                                           rtol=W_RTOL, atol=W_ATOL)
        assert "sequential source" in rank["adopt_error"]


def test_pipeline_transformer_train_step_matches_jax(runs):
    """make_train_step over 4 stages (each rank its stage's slice) from
    JAX's stacked weights: losses and the updated weights against JAX's
    train step on a stage mesh."""
    _, port, jax_ptx = runs
    ranks = port[-1]
    for rank in ranks:
        for g, w in zip(rank["losses"], jax_ptx["losses"]):
            assert g == pytest.approx(w, rel=LOSS_REL)
        np.testing.assert_allclose(rank["emb"], jax_ptx["emb"],
                                   rtol=W_RTOL, atol=W_ATOL)
        np.testing.assert_allclose(rank["head"], jax_ptx["head"],
                                   rtol=W_RTOL, atol=W_ATOL)
        s = rank["stage"]
        for k, v in rank["params"].items():
            np.testing.assert_allclose(v[0], jax_ptx["params"][k][s],
                                       rtol=W_RTOL, atol=W_ATOL, err_msg=k)


def test_pipeline_transformer_sequential_forward_matches_jax(runs):
    _, _, jax_ptx = runs
    import jax

    from flexflow_tpu.models import pipeline_transformer as jpt

    params = jpt.init_pipeline_params(jax.random.PRNGKey(0), n_layers=4,
                                      hidden=16, heads=2, stages=4)
    got = ptx.sequential_forward(
        {k: torch.from_numpy(np.array(v)) for k, v in params.items()},
        torch.from_numpy(jax_ptx["x"]))
    np.testing.assert_allclose(got.numpy(), jax_ptx["sequential"],
                               rtol=1e-5, atol=1e-5)


def test_new_modules_import_no_jax():
    """The mesh axes' modules import neither jax nor the JAX package."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import flexflow_tpu_torch.kernels.ring_attention, "
        "flexflow_tpu_torch.kernels.ulysses_attention, "
        "flexflow_tpu_torch.kernels.pipeline, "
        "flexflow_tpu_torch.parallel.pipeline_plan, "
        "flexflow_tpu_torch.models.pipeline_transformer, "
        "flexflow_tpu_torch.runtime.collectives\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flexflow_tpu' or m.startswith('flexflow_tpu.')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
