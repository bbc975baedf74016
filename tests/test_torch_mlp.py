"""The MLP path on the CPU (ROADMAP A2): the digits MLP accuracy gate on
the port, and the port's MLP training against the JAX package's from
the same weights (`params_from_jax`): N Adam steps, several steps a
dispatch (`steps_per_execution`, with the trailing single steps),
gradient accumulation, and dataloader-driven fit, plain and K steps a
dispatch, in order and shuffled.

Tolerance: f32 (no mixed precision), the same math through another BLAS
and summation order; Adam passes gradient noise through at full
relative size in its first steps (observed well under 1e-5 on losses
and weights): losses rel 1e-5, weights rtol 1e-5 / atol 1e-6. The
port's own K-step and single-step runs are the same steps in the same
order on the CPU, so their weights agree exactly."""
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from tests.test_torch_zoo import one_torch_thread

LOSS = dict(rel=1e-5)
W_TOL = dict(rtol=1e-5, atol=1e-6)


def make_synthetic(n=2048, dim=64, classes=10, seed=0):
    """tests/test_mnist_mlp.py `make_synthetic`: a learnable linear task."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    w = rng.randn(dim, classes).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)[:, None]
    return x, y


def _config(pkg, bs, seed=0):
    if pkg is pt:
        return pt.FFConfig(batch_size=bs, allow_mixed_precision=False,
                           device="cpu")
    config = ff.FFConfig()
    config.batch_size = bs
    config.allow_mixed_precision = False
    config.seed = seed
    return config


def _mlp(pkg, bs, dims, optimizer, softmax=True, seed=0,
         metrics=("METRICS_ACCURACY",)):
    """dims[0] -> relu dims[1:-1] -> dims[-1] (-> softmax)."""
    m = pkg.FFModel(_config(pkg, bs, seed))
    t = m.create_tensor([bs, dims[0]])
    for d in dims[1:-1]:
        t = m.dense(t, d, pkg.ActiMode.AC_MODE_RELU)
    t = m.dense(t, dims[-1])
    if softmax:
        m.softmax(t)
    m.compile(optimizer=optimizer(pkg, m),
              loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[getattr(pkg.MetricsType, k) for k in metrics])
    return m


def _pair(bs, dims, optimizer, **kw):
    jm = _mlp(ff, bs, dims, optimizer, **kw)
    pm = _mlp(pt, bs, dims, optimizer, **kw)
    pt.params_from_jax(pm, jm.params)
    return jm, pm


def _same_params(pm, jm, tol=W_TOL):
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(v), err_msg=f"{op}/{w}",
                                       **tol)


def _adam(lr):
    return lambda pkg, m: pkg.AdamOptimizer(m, alpha=lr)


def _sgd(lr):
    return lambda pkg, m: pkg.SGDOptimizer(m, lr=lr)


one_thread = pytest.fixture(name="one_thread")(one_torch_thread)


def test_digits_mlp_accuracy_gate(one_thread):
    """tests/test_accuracy_gate.py's digits MLP (64 -> 128 -> 64 -> 10,
    RELU, Adam 2e-3, batch 64, 30 epochs) on the port, its own weights:
    eval accuracy on the held-out digits >= 0.90. Torch on one intra-op
    thread (`one_torch_thread`): its 720 small steps spend most of their
    time handing work between threads on many."""
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    x = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)[:, None]
    idx = np.random.RandomState(0).permutation(len(x))
    x, y = x[idx], y[idx]
    pm = _mlp(pt, 64, (64, 128, 64, 10), _adam(2e-3))
    pm.fit([x[:1536]], y[:1536], batch_size=64, epochs=30)
    ev = pm.eval([x[1536:1792]], y[1536:1792], batch_size=64)
    assert ev["samples"] == 256
    assert ev["accuracy"] >= 0.90, ev


def test_mlp_steps_match_jax():
    """tests/test_mnist_mlp.py's MLP (64 -> 128 RELU -> 10 -> softmax, Adam
    2e-3, accuracy and sparse cce) in f32: three epochs of 8 steps, the
    per-epoch history key for key, the weights, and eval."""
    x, y = make_synthetic(n=512)
    metrics = ("METRICS_ACCURACY", "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY")
    jm, pm = _pair(64, (64, 128, 10), _adam(2e-3), metrics=metrics)
    jh = jm.fit(x, y, epochs=3)
    ph = pm.fit(x, y, epochs=3)
    for j, p in zip(jh, ph):
        assert set(p) == set(j)
        assert p["samples"] == j["samples"] == 512
        assert p["accuracy"] == j["accuracy"]
        for k in ("loss", "sparse_cce"):
            assert p[k] == pytest.approx(j[k], **LOSS), k
    assert ph[-1]["loss"] < ph[0]["loss"]
    _same_params(pm, jm)
    je, pe = jm.eval(x[:200], y[:200]), pm.eval(x[:200], y[:200])
    assert pe["accuracy"] == je["accuracy"]
    assert pe["loss"] == pytest.approx(je["loss"], **LOSS)


@pytest.mark.parametrize("k", [1, 4])
def test_eval_after_fit_reads_the_trained_weights(k):
    """A bf16 (mixed-precision) model: eval, fit, eval, fit, eval. Eval's
    bf16 casts of the weights are cached by weight version (core/op.py
    `Op.w`); the update bumps the versions, so each eval after a fit
    equals, key for key, a fresh model's given the trained weights
    (K = 4: three dispatches of four steps a fit)."""
    x, y = make_synthetic(n=192)

    def build():
        m = pt.FFModel(pt.FFConfig(batch_size=16, device="cpu"))
        t = m.create_tensor([16, 64])
        m.softmax(m.dense(m.dense(t, 32, pt.ActiMode.AC_MODE_RELU), 10))
        m.compile(optimizer=pt.AdamOptimizer(m, alpha=2e-3),
                  metrics=[pt.MetricsType.METRICS_ACCURACY])
        return m

    m = build()
    before = m.eval(x, y)
    for _ in range(2):
        m.fit(x, y, epochs=1, steps_per_execution=k)
        after = m.eval(x, y)
        fresh = build()
        fresh.load_params(m.params)
        assert after == fresh.eval(x, y)
        assert after["loss"] != before["loss"]
        before = after


def _small_case(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(20, 6).astype(np.float32),
            rng.randint(0, 3, size=(20, 1)).astype(np.int32))


def test_steps_per_execution_matches_single_step_and_jax():
    """tests/test_mnist_mlp.py:157's case: n = 20, batch 4, K = 4, so each
    epoch runs one dispatch of 4 steps and one trailing single step; the
    port's K run equals its single-step run and the JAX K run."""
    x, y = _small_case(1)
    jm, plain = _pair(4, (6, 8, 3), _adam(0.01), seed=11)
    chunked = _mlp(pt, 4, (6, 8, 3), _adam(0.01))
    pt.params_from_jax(chunked, jm.params)
    jh = jm.fit(x=x, y=y, epochs=2, steps_per_execution=4)
    h1 = plain.fit(x=x, y=y, epochs=2)
    h2 = chunked.fit(x=x, y=y, epochs=2, steps_per_execution=4)
    for op, ws in plain.params.items():
        for w, v in ws.items():
            assert torch.equal(v, chunked.params[op][w]), (op, w)
    _same_params(chunked, jm)
    for j, a, b in zip(jh, h1, h2):
        # the same steps; the epoch sums a dispatch's f32 mean instead of
        # its four losses
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-6)
        assert a["accuracy"] == b["accuracy"]
        assert b["loss"] == pytest.approx(j["loss"], **LOSS)
        assert b["accuracy"] == j["accuracy"]
        assert b["samples"] == j["samples"] == 20
    assert int(chunked.opt_state["step"]) == int(plain.opt_state["step"]) \
        == jm._step_count == 10
    # one record a dispatch (steps=4), then the trailing step (steps=1),
    # as JAX's StepStats
    assert [(r["steps"], r["samples"])
            for r in chunked.step_stats.records()] == \
        [(r["steps"], r["samples"]) for r in jm.step_stats.records()] == \
        [(4, 16), (1, 4), (4, 16), (1, 4)]
    with pytest.raises(ValueError, match="mutually exclusive"):
        chunked.fit(x=x, y=y, epochs=1, accum_steps=2, steps_per_execution=2)
    with pytest.raises(ValueError, match="full dispatch"):
        chunked.fit(x=x, y=y, epochs=1, steps_per_execution=6)


def test_gradient_accumulation_matches_large_batch_and_jax():
    """tests/test_mnist_mlp.py:241's case: SGD, accum_steps=2 at batch 4
    against one batch-8 step, and against the JAX accumulation."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 6).astype(np.float32)
    y = rng.randint(0, 3, size=(8, 1)).astype(np.int32)
    jsmall = _mlp(ff, 4, (6, 8, 3), _sgd(0.1), seed=7, metrics=())
    big = _mlp(pt, 8, (6, 8, 3), _sgd(0.1), metrics=())
    small = _mlp(pt, 4, (6, 8, 3), _sgd(0.1), metrics=())
    pt.params_from_jax(big, jsmall.params)
    pt.params_from_jax(small, jsmall.params)
    jh = jsmall.fit(x=x, y=y, epochs=1, accum_steps=2)
    bh = big.fit(x=x, y=y, epochs=1)
    sh = small.fit(x=x, y=y, epochs=1, accum_steps=2)
    for op, ws in big.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(small.params[op][w].numpy(),
                                       v.numpy(), atol=1e-6, rtol=1e-5)
    _same_params(small, jsmall)
    assert sh[0]["loss"] == pytest.approx(bh[0]["loss"], **LOSS)
    assert sh[0]["loss"] == pytest.approx(jh[0]["loss"], **LOSS)
    assert sh[0]["samples"] == jh[0]["samples"] == 8
    # one optimizer step, one record of the two microbatches
    assert int(small.opt_state["step"]) == int(big.opt_state["step"]) == 1
    assert [(r["steps"], r["samples"])
            for r in small.step_stats.records()] == \
        [(r["steps"], r["samples"])
         for r in jsmall.step_stats.records()] == [(1, 8)]
    with pytest.raises(ValueError, match="full update"):
        small.fit(x=x, y=y, epochs=1, accum_steps=3)


@pytest.mark.parametrize("k,shuffle", [(1, False), (1, True), (3, False),
                                       (3, True)])
def test_dataloader_fit_matches_jax(k, shuffle):
    """Dataloader-driven fit (tests/test_mnist_mlp.py:77, :133): the
    attached loaders feed both packages the same batches (shuffled: a
    per-epoch permutation from RandomState(seed + epoch), the JAX numpy
    backend's order), one step or K = 3 steps a dispatch."""
    bs, n = 16, 96
    x, y = make_synthetic(n=n, dim=32)
    jm, pm = _pair(bs, (32, 10), _sgd(0.05))
    for pkg, m in ((ff, jm), (pt, pm)):
        kw = dict(prefetch=False) if pkg is ff else {}
        inp = m.input_ops[0].outputs[0]
        pkg.SingleDataLoader(m, inp, x, n, shuffle=shuffle, seed=3, **kw)
        pkg.SingleDataLoader(m, m.label_tensor, y, n, shuffle=shuffle,
                             seed=3, **kw)
    jh = jm.fit(epochs=2, steps_per_execution=k)
    ph = pm.fit(epochs=2, steps_per_execution=k)
    assert len(ph) == 2
    for j, p in zip(jh, ph):
        assert p["samples"] == j["samples"] == n
        assert p["accuracy"] == j["accuracy"]
        assert p["loss"] == pytest.approx(j["loss"], **LOSS)
    assert ph[-1]["loss"] < ph[0]["loss"]
    _same_params(pm, jm)
    loader = pm._dataloaders[0]
    assert loader.backend == "numpy" and loader.num_batches == n // bs
    with pytest.raises(ValueError, match="batch size"):
        pm.fit(batch_size=8)


def test_dataloader_fit_needs_loaders():
    pm = _mlp(pt, 4, (6, 3), _sgd(0.1))
    with pytest.raises(RuntimeError, match="attached dataloaders"):
        pm.fit()
    pt.SingleDataLoader(pm, pm.input_ops[0].outputs[0],
                        np.zeros((8, 6), np.float32))
    with pytest.raises(RuntimeError, match="label tensor"):
        pm.fit()


def test_regression_labels_stay_float_like_jax():
    """A mean-squared-error model trains on float targets (JAX
    `_label_dtype`: int class ids only for the sparse-categorical loss),
    its mse / rmse / mae metrics key for key with the JAX fit's."""
    rng = np.random.RandomState(6)
    x = rng.randn(16, 5).astype(np.float32)
    y = (x @ rng.randn(5, 3) * 0.3).astype(np.float32)
    metrics = ("METRICS_MEAN_SQUARED_ERROR",
               "METRICS_ROOT_MEAN_SQUARED_ERROR",
               "METRICS_MEAN_ABSOLUTE_ERROR")

    def build(pkg):
        m = pkg.FFModel(_config(pkg, 8))
        m.dense(m.create_tensor([8, 5]), 3)
        m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.1),
                  loss_type=pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
                  metrics=[getattr(pkg.MetricsType, k) for k in metrics])
        return m

    jm, pm = build(ff), build(pt)
    pt.params_from_jax(pm, jm.params)
    assert pm.label_tensor.dtype == pt.DataType.DT_FLOAT
    jh, ph = jm.fit(x, y, epochs=3), pm.fit(x, y, epochs=3)
    for j, p in zip(jh, ph):
        for k in ("loss", "mse", "rmse", "mae"):
            assert p[k] == pytest.approx(j[k], **LOSS), k
    _same_params(pm, jm)


def test_steps_per_execution_on_a_cuda_mesh_raises():
    """K steps a dispatch on a mesh of CUDA ranks would capture gloo's
    host-staged collectives: it no longer raises, it runs the K steps
    eagerly in one dispatch, and says so (`MultiStep.stats()`; the rule
    is runtime/distributed.py `graph_capture`); on one card it captures,
    on the CPU it runs eagerly."""
    from types import SimpleNamespace

    from flexflow_tpu_torch.runtime import distributed
    from flexflow_tpu_torch.runtime.executor import Executor

    pm = _mlp(pt, 4, (6, 3), _sgd(0.1))
    cuda = torch.device("cuda")
    ex = Executor(pm.graph, pm.config, SimpleNamespace(
        device=cuda, size=lambda axis: 1))
    ms = ex.build_multi_step(pm.optimizer, pm.loss.fn, pm.metrics,
                             pm.final_tensor, 4)
    st = ms.stats()
    assert st["captured"] is False and st["steps"] == 4
    assert "NCCL" in st["reason"]
    assert distributed.graph_capture(cuda, None) == (True, None)
    assert distributed.graph_capture(torch.device("cpu"), None)[0] is False
    assert pm._multi_step(4).stats()["captured"] is False