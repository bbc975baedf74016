"""The MLP path's ops on the CPU: every elementwise op, activation,
shape op, reduction, TopK, BatchMatmul and core op the port gained for
ROADMAP A2, and the conv, pool, flat, batch-norm, LSTM, embedding-bag,
dropout and attention cases of A3 / A6, one parametrised case each, the
port's forward against the JAX package's on the same numpy inputs
(weights carried by `params_from_jax`), in f32; and the six metric types
key for key.

Tolerance: f32, rtol 1e-5 / atol 1e-6 — the same math, with
transcendentals (exp, tanh, erf-free gelu, rsqrt, pow) from another
library, a few ulp apart; integer outputs (casts, TopK indices) and
data movement exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.ffconst import CompMode
from flexflow_tpu.runtime.metrics import Metrics as JaxMetrics
from flexflow_tpu_torch.runtime.metrics import Metrics as PortMetrics

RTOL, ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


def _int_dtype(pkg, arr):
    return pkg.DataType.DT_INT32 if arr.dtype.kind in "iu" \
        else pkg.DataType.DT_FLOAT


def _jax_forward(build, inputs):
    config = ff.FFConfig()
    config.batch_size = inputs[0].shape[0]
    config.allow_mixed_precision = False
    m = ff.FFModel(config)
    tins = [m.create_tensor(a.shape, _int_dtype(ff, a)) for a in inputs]
    m.final_tensor = build(ff, m, tins)
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.0),
              loss_type=ff.LossType.LOSS_IDENTITY)
    feeds = {op.name: a for op, a in zip(m.input_ops, inputs)}
    values, _, _ = m.executor.forward_values(
        m.params, m.state, feeds, None, CompMode.COMP_MODE_INFERENCE)
    return np.asarray(values[m.final_tensor.guid]), m


def _port_forward(build, inputs, jm):
    m = pt.FFModel(pt.FFConfig(batch_size=inputs[0].shape[0],
                               allow_mixed_precision=False, device="cpu"))
    tins = [m.create_tensor(a.shape, _int_dtype(pt, a)) for a in inputs]
    m.final_tensor = build(pt, m, tins)
    m.compile(loss_type=pt.LossType.LOSS_IDENTITY,
              comp_mode=pt.CompMode.COMP_MODE_INFERENCE)
    if jm.params:
        pt.params_from_jax(m, jm.params)
    feeds = {op.name: torch.from_numpy(a) for op, a in zip(m.input_ops,
                                                            inputs)}
    with torch.no_grad():
        out = m.executor.forward_values(feeds)[m.final_tensor.guid]
    return out.numpy()


X = _rand(4, 3, 8)
XP = _rand(4, 3, 8, positive=True)
IDX = np.random.RandomState(5).randint(0, 3, size=(4, 2, 8)).astype(np.int32)
IMG = _rand(2, 3, 7, 8, seed=10)
BAGS = np.random.RandomState(13).randint(0, 20, size=(4, 3, 5)).astype(
    np.int32)

CASES = {
    # unary ops and the scalar ops
    "relu": ([X], lambda p, m, t: m.relu(t[0])),
    "sigmoid": ([X], lambda p, m, t: m.sigmoid(t[0])),
    "tanh": ([X], lambda p, m, t: m.tanh(t[0])),
    "gelu": ([X], lambda p, m, t: m.gelu(t[0])),
    "elu": ([X], lambda p, m, t: m.elu(t[0])),
    "rsqrt": ([XP], lambda p, m, t: m.rsqrt(t[0])),
    "exp": ([X], lambda p, m, t: m.exp(t[0])),
    "sin": ([X], lambda p, m, t: m.sin(t[0])),
    "cos": ([X], lambda p, m, t: m.cos(t[0])),
    "identity": ([X], lambda p, m, t: m.identity(t[0])),
    "pow3": ([X], lambda p, m, t: m.pow(t[0], 3)),
    "pow_half": ([XP], lambda p, m, t: m.pow(t[0], 0.5)),
    "scalar_multiply": ([X], lambda p, m, t: m.scalar_multiply(t[0], 2.5)),
    "scalar_add": ([X], lambda p, m, t: m.scalar_add(t[0], 2.5)),
    "scalar_sub": ([X], lambda p, m, t: m.scalar_sub(t[0], 2.5)),
    "scalar_true_divide": ([X],
                           lambda p, m, t: m.scalar_true_divide(t[0], 2.5)),
    # binary ops, broadcasting (4, 1, 8) against (3, 8)
    **{name: ([_rand(4, 1, 8, seed=1), _rand(3, 8, seed=2, positive=True)],
              (lambda f: lambda p, m, t: getattr(m, f)(t[0], t[1]))(name))
       for name in ("add", "subtract", "multiply", "divide", "max", "min")},
    "cast_to_int": ([X * 10], lambda p, m, t: m.cast(
        t[0], p.DataType.DT_INT32)),
    "cast_to_float": ([IDX], lambda p, m, t: m.cast(
        t[0], p.DataType.DT_FLOAT)),
    # dense with each activation
    **{f"dense_{a}": ([_rand(4, 8)], (lambda act: lambda p, m, t: m.dense(
        t[0], 16, getattr(p.ActiMode, act)))(f"AC_MODE_{a.upper()}"))
       for a in ("relu", "sigmoid", "tanh", "gelu")},
    # shape ops, reductions, TopK, BatchMatmul
    "reshape": ([X], lambda p, m, t: m.reshape(t[0], [4, -1])),
    "transpose": ([X], lambda p, m, t: m.transpose(t[0], [0, 2, 1])),
    "reverse": ([X], lambda p, m, t: m.reverse(t[0], 1)),
    "concat": ([X, _rand(4, 2, 8, seed=3)],
               lambda p, m, t: m.concat(t, axis=1)),
    "split": ([X], lambda p, m, t: m.split(t[0], [1, 2], 1)[1]),
    "split_even": ([_rand(4, 6, 8)], lambda p, m, t: m.split(t[0], 3, 1)[2]),
    "gather": ([X, IDX], lambda p, m, t: m.gather(t[0], t[1], dim=1)),
    "reduce_sum": ([X], lambda p, m, t: m.reduce_sum(t[0], [1, 2])),
    "reduce_sum_keepdims": ([X], lambda p, m, t: m.reduce_sum(
        t[0], [1], keepdims=True)),
    "mean": ([X], lambda p, m, t: m.mean(t[0], [2])),
    "mean_keepdims": ([X], lambda p, m, t: m.mean(t[0], [0, 2],
                                                  keepdims=True)),
    "top_k_values": ([X], lambda p, m, t: m.top_k(t[0], 3)[0]),
    "top_k_indices": ([X], lambda p, m, t: m.top_k(t[0], 3)[1]),
    "batch_matmul": ([X, _rand(4, 8, 5, seed=4)],
                     lambda p, m, t: m.batch_matmul(t[0], t[1])),
    # core ops
    "constant": ([X], lambda p, m, t: m.add(t[0], m.create_constant(
        _rand(3, 8, seed=6)))),
    "constant_trainable": ([X], lambda p, m, t: m.multiply(
        t[0], m.create_constant(_rand(3, 8, seed=7), trainable=True))),
    "noop": ([X], lambda p, m, t: m._add_op(p.OpType.NOOP, [t[0]]).outputs[0]),
    # the op set of ROADMAP A6: conv, pool, flat, batch norm (inference:
    # the initial running statistics), LSTM, the embedding bags, dropout
    # outside training, attention with kdim != vdim
    "conv_bias": ([IMG], lambda p, m, t: m.conv2d(
        t[0], 5, 3, 3, 1, 1, 0, 0)),
    "conv_no_bias_relu": ([IMG], lambda p, m, t: m.conv2d(
        t[0], 5, 3, 3, 1, 1, 1, 1, p.ActiMode.AC_MODE_RELU,
        use_bias=False)),
    "conv_grouped": ([_rand(2, 4, 9, 9, seed=11)], lambda p, m, t: m.conv2d(
        t[0], 6, 3, 3, 1, 1, 1, 1, groups=2)),
    "conv_strided_padded": ([IMG], lambda p, m, t: m.conv2d(
        t[0], 4, 5, 3, 2, 3, 2, 1, p.ActiMode.AC_MODE_TANH)),
    "max_pool": ([IMG], lambda p, m, t: m.pool2d(t[0], 2, 2, 2, 2, 0, 0)),
    "max_pool_padded": ([IMG], lambda p, m, t: m.pool2d(
        t[0], 3, 3, 2, 2, 1, 1, p.PoolType.POOL_MAX)),
    "avg_pool": ([IMG], lambda p, m, t: m.pool2d(
        t[0], 2, 3, 1, 2, 0, 0, p.PoolType.POOL_AVG)),
    "avg_pool_padded_relu": ([IMG], lambda p, m, t: m.pool2d(
        t[0], 3, 3, 1, 1, 1, 1, p.PoolType.POOL_AVG,
        p.ActiMode.AC_MODE_RELU)),
    "flat": ([IMG], lambda p, m, t: m.flat(t[0])),
    "batch_norm_inference": ([IMG], lambda p, m, t: m.batch_norm(t[0])),
    "batch_norm_inference_no_relu": ([IMG], lambda p, m, t: m.batch_norm(
        t[0], relu=False)),
    "lstm_sequences": ([X], lambda p, m, t: m.lstm(t[0], 6)),
    "lstm_last": ([X], lambda p, m, t: m.lstm(t[0], 6,
                                              return_sequences=False)),
    "embedding_bag_sum": ([BAGS], lambda p, m, t: m.embedding(
        t[0], 20, 8, p.AggrMode.AGGR_MODE_SUM)),
    "embedding_bag_avg": ([BAGS], lambda p, m, t: m.embedding(
        t[0], 20, 8, p.AggrMode.AGGR_MODE_AVG)),
    "dropout_inference": ([X], lambda p, m, t: m.dropout(t[0], 0.5)),
    "attention_kdim_ne_vdim": ([X, _rand(4, 5, 8, seed=12)],
                               lambda p, m, t: m.multihead_attention(
                                   t[0], t[1], t[1], 8, 2, kdim=3, vdim=5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    inputs, build = CASES[case]
    want, jm = _jax_forward(build, inputs)
    got = _port_forward(build, inputs, jm)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


ALL_METRICS = ["METRICS_ACCURACY", "METRICS_CATEGORICAL_CROSSENTROPY",
               "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY",
               "METRICS_MEAN_SQUARED_ERROR",
               "METRICS_ROOT_MEAN_SQUARED_ERROR",
               "METRICS_MEAN_ABSOLUTE_ERROR"]


@pytest.mark.parametrize("labels", ["sparse", "one_hot"])
def test_metrics_match_jax(labels):
    """The six metrics on softmax outputs: sparse (B, 1) int labels (the
    sparse cce, accuracy), one-hot float labels (cce, the regression
    metrics, accuracy by argmax of the label)."""
    rng = np.random.RandomState(9)
    logits = rng.randn(16, 5).astype(np.float32)
    pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rng.randint(0, 5, size=(16, 1)).astype(np.int32)
    label = ids if labels == "sparse" else np.eye(5, dtype=np.float32)[
        ids[:, 0]]
    names = ALL_METRICS if labels == "one_hot" else [
        "METRICS_ACCURACY", "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY"]
    jmet = JaxMetrics(ff.LossType.LOSS_CATEGORICAL_CROSSENTROPY,
                      [getattr(ff.MetricsType, n) for n in names])
    pmet = PortMetrics(pt.LossType.LOSS_CATEGORICAL_CROSSENTROPY,
                       [getattr(pt.MetricsType, n) for n in names])
    want = jmet.compute(jnp.asarray(pred), jnp.asarray(label))
    got = pmet.compute(torch.from_numpy(pred), torch.from_numpy(label))
    assert list(got) == list(want) == pmet.keys()
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].dim() == 0, k
        assert float(got[k]) == pytest.approx(float(v), rel=1e-6,
                                              abs=1e-7), k


def test_bf16_input_is_staged_as_f32_and_cast_on_the_device():
    """numpy has no bfloat16 without jax's ml_dtypes: a DT_BFLOAT16 input
    is staged as f32 on the host and cast where it lands, to the values
    JAX's bf16 input holds."""
    assert pt.DataType.DT_BFLOAT16.host_np_dtype == np.float32
    with pytest.raises(TypeError, match="no numpy dtype"):
        pt.DataType.DT_BFLOAT16.np_dtype
    m = pt.FFModel(pt.FFConfig(batch_size=4, device="cpu"))
    t = m.create_tensor([4, 8], pt.DataType.DT_BFLOAT16)
    m.final_tensor = m.cast(t, pt.DataType.DT_FLOAT)
    m.compile(loss_type=pt.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    x = _rand(4, 8)
    inputs, label = m._batch([x], np.zeros((4, 8), np.float32), 0, 4)
    got = inputs[m.input_ops[0].name]
    assert got.dtype == torch.bfloat16 and label.dtype == torch.float32
    want = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
