"""The keras_exp frontend of the port (flexflow_tpu_torch/keras_exp/): the
scenarios of tests/test_keras_exp.py against the JAX package's, on the
CPU in f32. Without tensorflow and tf2onnx on either machine, the tests
feed the ONNX a tf.keras export would produce, written with the port's
wire codec (onnx/wire.py); the same proto goes to both packages."""
import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as ff
from flexflow_tpu.keras_exp import Model as JaxModel
from flexflow_tpu_torch.keras_exp import Model
from flexflow_tpu_torch.onnx import wire
from tests.test_torch_zoo import one_torch_thread, unoptimised_xla

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _keras_style_onnx():
    """The graph tf2onnx emits for a Dense->ReLU->Dense keras model
    (Gemm with transB, keras-style initializer names)."""
    rng = np.random.RandomState(0)
    w1 = rng.randn(16, 20).astype(np.float32)  # (out, in), transB=1
    b1 = rng.randn(16).astype(np.float32)
    w2 = rng.randn(4, 16).astype(np.float32)
    b2 = rng.randn(4).astype(np.float32)
    nodes = [
        wire.make_node("Gemm", ["x", "dense/kernel", "dense/bias"], ["h"],
                       name="dense", transB=1),
        wire.make_node("Relu", ["h"], ["hr"], name="re_lu"),
        wire.make_node("Gemm", ["hr", "dense_1/kernel", "dense_1/bias"],
                       ["y"], name="dense_1", transB=1),
        wire.make_node("Softmax", ["y"], ["prob"], name="softmax"),
    ]
    proto = wire.make_model(
        nodes, {"x": (8, 20)}, {"prob": (8, 4)},
        {"dense/kernel": w1, "dense/bias": b1,
         "dense_1/kernel": w2, "dense_1/bias": b2},
        name="keras_mlp")
    return proto, (w1, b1, w2, b2)


def _both(optimizer):
    """The keras_exp model of each package from one proto, f32, compiled
    with optimizer(pkg, ffmodel)."""
    proto, weights = _keras_style_onnx()
    out = []
    for pkg, M in ((jff, JaxModel), (ff, Model)):
        if pkg is ff:
            m = M(proto, batch_size=8, config=ff.FFConfig(device="cpu"))
        else:
            m = M(proto, batch_size=8)
        m.config.allow_mixed_precision = False
        with unoptimised_xla():
            ffmodel = m.build([[8, 20]])
            m.compile(optimizer=optimizer(pkg, ffmodel),
                      loss_type=pkg.LossType.
                      LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                      metrics=[pkg.MetricsType.METRICS_ACCURACY])
        out.append(m)
    jm, pm = out
    assert [(op.name, op.op_type.value) for op in pm.ffmodel.ops] == \
        [(op.name, op.op_type.value) for op in jm.ffmodel.ops]
    return jm, pm, weights


def test_keras_exp_model_builds_and_trains_like_jax():
    jm, pm, _ = _both(lambda pkg, m: pkg.AdamOptimizer(m, alpha=1e-3))
    rng = np.random.RandomState(1)
    x = rng.randn(32, 20).astype(np.float32)
    y = rng.randint(0, 4, size=(32, 1)).astype(np.int32)
    hj = jm.fit([x], y, batch_size=8, epochs=3)
    hp = pm.fit([x], y, batch_size=8, epochs=3)
    assert np.isfinite(hp[0]["loss"])
    np.testing.assert_allclose([h["loss"] for h in hp],
                               [h["loss"] for h in hj], rtol=1e-4)
    np.testing.assert_allclose(pm.ffmodel.predict(x), jm.ffmodel.predict(x),
                               rtol=0, atol=1e-5)


def test_keras_exp_weights_transfer_like_jax():
    """The imported keras weights give numpy's forward, and JAX's."""
    jm, pm, (w1, b1, w2, b2) = _both(
        lambda pkg, m: pkg.SGDOptimizer(m, lr=0.0))
    x = np.random.RandomState(1).randn(8, 20).astype(np.float32)
    ours = pm.ffmodel.predict(x)
    h = np.maximum(x @ w1.T + b1, 0)
    logits = h @ w2.T + b2
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    ref = e / e.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours, jm.ffmodel.predict(x), rtol=0,
                               atol=1e-5)


def test_keras_exp_live_tf_needs_tf2onnx():
    from flexflow_tpu_torch.keras_exp.models import _to_onnx

    class FakeKeras:
        pass

    FakeKeras.__module__ = "keras.engine.training"
    with pytest.raises(ImportError, match="tf2onnx|tensorflow"):
        _to_onnx(FakeKeras())
    proto, _ = _keras_style_onnx()
    assert _to_onnx(proto) is proto
    assert _to_onnx("model.onnx") == "model.onnx"
