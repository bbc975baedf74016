"""The explicit parallel ops of the port (parallel/parallel_ops.py, the
FFModel layer methods) against the JAX package's, on the CPU:

 - tests/test_fused_parallel.py's cases on {"data": 2}, two gloo ranks:
   a fused partition-then-combine clears the sharding, a one-partition
   fused chain shards as RepartitionOp does, a replicate descriptor
   clears every dim, an unknown descriptor raises, and the fused chain
   trains as the unfused chain (losses within 1e-5 relative);
 - the gradients through a Combine of a data-cut value, then ops on the
   whole batch, then a Repartition back (and through a Replicate), on
   {"data": 2} from JAX's weights, against `jax.grad` of JAX's loss on
   the whole batch (rtol 1e-5, atol 1e-6): what gathering with
   `gather_batch` instead of `gather_dim` gets `dp` times too small;
 - `rule_fuse_parallel_ops` collapses a chain as JAX's does (the same
   rewritten graph), and each layer method's one-device forward equals
   JAX's from the same weights;
 - a weight regularizer of weights sharded over `model` ({"model": 2},
   the sum of the shards' terms): 3 steps' losses and the final weights
   against JAX's from the same weights (relative 1e-5; weights rtol
   1e-5, atol 1e-6).

The ranks' jobs run in one spawn under one time limit.
"""
import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.core.graph import Graph as JGraph
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu_torch.core.graph import Graph as PGraph
from flexflow_tpu_torch.search import substitution as psub
from tests.test_torch_substitution import _sig

JOIN_S = 120
B, F = 8, 16


def _chain(kind):
    """The chain of each test_fused_parallel.py case, in either package."""
    return {
        "fused_pc": lambda m, x: m.fused_parallel(x, [
            {"type": "partition", "dim": 0, "degree": 2, "axis": "data"},
            {"type": "combine", "dim": 0}]),
        "fused_p": lambda m, x: m.fused_parallel(x, [
            {"type": "partition", "dim": 0, "degree": 2, "axis": "data"}]),
        "plain_p": lambda m, x: m.repartition(x, 0, 2, axis="data"),
        "fused_rep": lambda m, x: m.fused_parallel(x, [
            {"type": "partition", "dim": 0, "degree": 2, "axis": "data"},
            {"type": "replicate"}]),
        "unknown": lambda m, x: m.fused_parallel(x, [
            {"type": "shuffle", "dim": 0, "degree": 2}]),
        "unfused": lambda m, x: m.combine(
            m.repartition(x, 0, 2, axis="data"), 0),
    }[kind]


def _mlp_with(pkg, kind):
    if pkg is pt:
        config = pt.FFConfig(batch_size=B, device="cpu",
                             allow_mixed_precision=False)
    else:
        config = ff.FFConfig()
        config.batch_size = B
        config.num_devices = 1
    model = pkg.FFModel(config)
    x = model.create_tensor([B, F])
    model.softmax(model.dense(_chain(kind)(model, x), 4))
    return model


def _data():
    rs = np.random.RandomState(0)
    return (rs.randn(16, 16).astype(np.float32),
            rs.randint(0, 4, size=(16, 1)).astype(np.int32))


def _grad_graph(pkg, m, kind):
    """dense -> Combine (dim 0) -> a softmax over the batch dim -> dense
    -> Repartition (dim 0) -> dense -> softmax; with `kind` "replicate" a
    Replicate in place of the Combine. The softmax over the whole batch
    makes each rank's loss reach every rank's rows."""
    x = m.create_tensor([B, F])
    t = m.dense(x, 32, pkg.ActiMode.AC_MODE_RELU, name="d1")
    t = m.combine(t, 0) if kind == "combine" else m.replicate(t)
    t = m.softmax(t, axis=0)
    t = m.dense(t, 24, pkg.ActiMode.AC_MODE_RELU, name="d2")
    if kind == "combine":
        t = m.repartition(t, 0, 2)
    m.softmax(m.dense(t, 4, name="d3"))


def _l2(w):
    """The regularizer of the sharded weights' case (either package's
    arrays)."""
    return 0.05 * (w * w).sum()


def _reg_graph(pkg, m):
    x = m.create_tensor([B, F])
    t = m.dense(x, 32, pkg.ActiMode.AC_MODE_RELU, name="d1")
    m.softmax(m.dense(t, 4, name="d2"))
    for op in ("d1", "d2"):
        m.add_weight_regularizer(op, "kernel", _l2)


def _port_job(job):
    """One job on this rank (see the module docstring)."""
    import torch

    x, y = _data()
    if job["kind"] == "regularizer":
        m = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu",
                                   allow_mixed_precision=False))
        _reg_graph(pt, m)
        m.compile(optimizer=pt.SGDOptimizer(m, lr=0.1),
                  loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  parallel_axes={"model": 2})
        m.load_params(job["params"])
        hist = m.fit(x, y, batch_size=B, epochs=3)
        return {"losses": [h["loss"] for h in hist],
                "sharded": sorted(f"{op.name}/{w}" for op in m.ops
                                  for w in op.shards),
                "params": {o: {w: t.numpy() for w, t in ws.items()}
                           for o, ws in m.gather_params().items()}}
    if job["kind"] in ("combine", "replicate"):
        m = pt.FFModel(pt.FFConfig(batch_size=B, device="cpu",
                                   allow_mixed_precision=False))
        _grad_graph(pt, m, job["kind"])
        m.compile(optimizer=pt.SGDOptimizer(m, lr=0.1),
                  loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  parallel_axes={"data": 2})
        m.load_params(job["params"])
        gstep = m.executor.build_grad_metrics_step(m.loss.fn, None,
                                                   m.final_tensor)
        grads, mvals = gstep(*m._batch([x[:B]], y[:B], 0, B))
        whole = m.gather_params(grads)
        return {"loss": float(mvals["loss"]),
                "grads": {o: {w: t.numpy() for w, t in ws.items()}
                          for o, ws in whole.items()},
                "kinds": [op.op_type.value for op in m.ops]}
    m = _mlp_with(pt, job["kind"])
    try:
        m.compile(optimizer=pt.SGDOptimizer(m, lr=0.01),
                  loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  parallel_axes={"data": 2},
                  generator=torch.Generator().manual_seed(0))
    except ValueError as exc:
        return {"error": str(exc)}
    hist = m.fit(x, y, epochs=1)
    op = next(o for o in m.ops if hasattr(o, "reshard"))
    ps = op.outputs[0].parallel_shape
    return {"loss": hist[-1]["loss"],
            "dims": [(d.size, d.degree, d.axis) for d in ps.dims]}


def _rank(rank, world, init, jobs):
    from flexflow_tpu_torch.runtime import distributed

    distributed.initialize(init, world_size=world, rank=rank, device="cpu")
    torch_threads()
    try:
        return [_port_job(j) for j in jobs]
    finally:
        distributed.shutdown()


def torch_threads():
    import torch

    torch.set_num_threads(1)


def _jax_grads(kind):
    """JAX's weights and its gradients of the whole batch's loss."""
    import jax

    c = ff.FFConfig()
    c.batch_size = B
    c.num_devices = 1
    c.allow_mixed_precision = False
    m = ff.FFModel(c)
    _grad_graph(ff, m, kind)
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.1),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    x, y = _data()
    name = m.input_ops[0].name
    grads = m._grad_step(m.params, m.state, {name: x[:B]}, y[:B],
                         jax.random.PRNGKey(0))
    host = {o: {w: np.asarray(v) for w, v in ws.items()}
            for o, ws in m.params.items()}
    return host, {o: {w: np.asarray(v) for w, v in ws.items()}
                  for o, ws in grads.items()}


def _jax_regularized():
    """JAX's regularized model on one device: its weights, 3 steps'
    losses and its final weights."""
    c = ff.FFConfig()
    c.batch_size = B
    c.num_devices = 1
    c.allow_mixed_precision = False
    m = ff.FFModel(c)
    _reg_graph(ff, m)
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.1),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    init = {o: {w: np.asarray(v) for w, v in ws.items()}
            for o, ws in m.params.items()}
    x, y = _data()
    hist = m.fit(x, y, batch_size=B, epochs=3)
    return init, [h["loss"] for h in hist], {
        o: {w: np.asarray(v) for w, v in ws.items()}
        for o, ws in m.params.items()}


KINDS = ["fused_pc", "fused_p", "plain_p", "fused_rep", "unknown",
         "unfused"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from flexflow_tpu_torch.runtime.distributed import spawn

    jax_grads = {k: _jax_grads(k) for k in ("combine", "replicate")}
    jax_grads["regularizer"] = _jax_regularized()
    jobs = [{"kind": k} for k in KINDS]
    jobs += [{"kind": k, "params": jax_grads[k][0]}
             for k in ("combine", "replicate", "regularizer")]
    init = "file://" + str(tmp_path_factory.mktemp("rdv") / "rdv")
    ranks = spawn(_rank, 2, (2, init, jobs), timeout_s=JOIN_S)
    out = {}
    for i, job in enumerate(jobs):
        out[job["kind"]] = [r[i] for r in ranks]
    return out, jax_grads


def test_fused_partition_then_combine_shape(runs):
    for r in runs[0]["fused_pc"]:
        assert all(d[1] == 1 for d in r["dims"])


def test_fused_partition_shape_matches_standalone(runs):
    for f, p in zip(runs[0]["fused_p"], runs[0]["plain_p"]):
        assert f["dims"] == p["dims"] == [(B, 2, "data"), (F, 1, None)]


def test_replicate_descriptor_clears_sharding(runs):
    for r in runs[0]["fused_rep"]:
        assert all(d[1] == 1 and d[2] is None for d in r["dims"])


def test_unknown_descriptor_rejected(runs):
    for r in runs[0]["unknown"]:
        assert "unknown parallel descriptor" in r["error"]


def test_fused_chain_trains_like_unfused(runs):
    for f, u in zip(runs[0]["fused_pc"], runs[0]["unfused"]):
        assert f["loss"] == pytest.approx(u["loss"], rel=1e-5)
    # every rank reports the global batch's loss
    assert runs[0]["unfused"][0]["loss"] == runs[0]["unfused"][1]["loss"]


@pytest.mark.parametrize("kind", ["combine", "replicate"])
def test_gradients_through_a_whole_value_match_jax_grad(runs, kind):
    """Every rank's gradient (after the data mean) is jax.grad's of the
    whole batch's loss."""
    _, want = runs[1][kind]
    for r in runs[0][kind]:
        assert set(r["grads"]) == set(want)
        for op, ws in want.items():
            for w, g in ws.items():
                np.testing.assert_allclose(r["grads"][op][w], g, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{op}/{w}")
        assert {"combine", "replicate"} & set(r["kinds"])


def test_rule_collapses_parallel_chain_like_jax():
    def build(pkg):
        m = _mlp_with(pkg, "fused_pc")  # any graph: rebuilt below
        m = pkg.FFModel(m.config)
        x = m.create_tensor([B, F])
        t = m.replicate(m.combine(m.repartition(x, 0, 2), 0))
        m.softmax(m.dense(t, 4))
        return m, (PGraph if pkg is pt else JGraph)(m.ops)

    (_, jg), (_, pg) = build(ff), build(pt)
    assert _sig(pt, pg) == _sig(ff, jg)
    rule = {"fuse_parallel_ops": psub.rule_fuse_parallel_ops}
    applied = psub.apply_substitutions(pg, rule)
    assert applied == jsub.apply_substitutions(
        jg, {"fuse_parallel_ops": jsub.rule_fuse_parallel_ops})
    assert len(applied) == 2
    assert _sig(pt, pg) == _sig(ff, jg)
    fused = [op for op in pg.ops.values()
             if op.op_type == pt.OpType.FUSED_PARALLEL]
    assert [d["type"] for d in fused[0].params["descriptors"]] == \
        ["partition", "combine", "replicate"]


def _layers(pkg, m):
    x = m.create_tensor([3, B, F])
    t = m.reduction(x, 3)
    t = m.allreduce(m.replicate(t, 2))
    t = m.combine(m.repartition(t, 1, 2), 1)
    t = m.fused_parallel(t, [{"type": "partition", "dim": 0, "degree": 2},
                             {"type": "combine", "dim": 0}])
    m.softmax(m.dense(t, 4))


def test_layer_methods_forward_like_jax():
    """Each layer method's op type and output dims, and the one-device
    forward from JAX's weights."""
    import torch

    from flexflow_tpu.ffconst import CompMode

    rs = np.random.RandomState(3)
    x = rs.randn(3, B, F).astype(np.float32)
    jc = ff.FFConfig()
    jc.batch_size = 3
    jc.num_devices = 1
    jc.allow_mixed_precision = False
    jm = ff.FFModel(jc)
    _layers(ff, jm)
    jm.compile(optimizer=ff.SGDOptimizer(jm, lr=0.1),
               loss_type=ff.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    pm = pt.FFModel(pt.FFConfig(batch_size=3, device="cpu",
                                allow_mixed_precision=False))
    _layers(pt, pm)
    pm.compile(optimizer=pt.SGDOptimizer(pm, lr=0.1),
               loss_type=pt.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert [op.op_type.value for op in pm.ops] == \
        [op.op_type.value for op in jm.ops]
    assert [op.outputs[0].dims for op in pm.ops] == \
        [op.outputs[0].dims for op in jm.ops]
    pt.params_from_jax(pm, jm.params)
    name = jm.input_ops[0].name
    jv, _, _ = jm.executor.forward_values(
        jm.params, jm.state, {name: x}, None, CompMode.COMP_MODE_INFERENCE)
    pv = pm.executor.forward_values({name: torch.from_numpy(x)})
    np.testing.assert_allclose(pv[pm.final_tensor.guid].numpy(),
                               np.asarray(jv[jm.final_tensor.guid]),
                               rtol=1e-5, atol=1e-6)


def test_regularizer_of_model_sharded_weights_matches_jax(runs):
    _, want_losses, want_params = runs[1]["regularizer"]
    for r in runs[0]["regularizer"]:
        assert r["sharded"] == ["d1/bias", "d1/kernel", "d2/bias",
                                "d2/kernel"]
        for got, want in zip(r["losses"], want_losses):
            assert got == pytest.approx(want, rel=1e-5)
        for op, ws in want_params.items():
            for w, v in ws.items():
                np.testing.assert_allclose(r["params"][op][w], v, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{op}/{w}")
