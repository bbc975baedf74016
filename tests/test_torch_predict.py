"""Batched inference, the manual loop and the rest of the FFModel API on
the CPU (ROADMAP A1), each against the JAX package from the same seeded
numpy inputs, the port given the JAX model's weights (`params_from_jax`):
`predict` (the tail batch included) on an MLP, the flagship BERT encoder
cut to 2 layers, and ResNet (stages (1, 1), 64 px) and a batch-norm net
after two fit steps, and after an inference-mode compile; the LSTM against a numpy replay; the
manual loop (`set_iteration_batch` / `forward` / `zero_gradients` /
`backward` / `update`) against JAX's and against the port's own `fit`;
iteration seq_length truncation (tests/test_seq_length.py's three
scenarios); the manual backward of a dropout model; weight regularizers
in `fit`; the Tensor value API, `summary` and the layer queries; the new
signatures and config flags.

Tolerances (f32: the same math in another BLAS and summation order):
predict and losses 1e-5 relative (1e-6 absolute), ResNet's predict 1e-4
(a conv stack over running statistics two steps old), weights rtol 1e-4
/ atol 1e-6; the port against itself (manual loop against fit, a walk
against its replay) to the bit."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu import models as jzoo
from flexflow_tpu_torch import models as pzoo
from flexflow_tpu_torch.core.tensor import ParallelDim, ParallelTensorShape
from tests.test_torch_zoo import one_torch_thread, unoptimised_xla

TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_TOL = dict(rtol=1e-4, atol=1e-4)
W_TOL = dict(rtol=1e-4, atol=1e-6)

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _config(pkg, batch):
    if pkg is pt:
        return pt.FFConfig(batch_size=batch, allow_mixed_precision=False,
                           device="cpu")
    config = ff.FFConfig()
    config.num_devices = 1
    config.batch_size = batch
    config.allow_mixed_precision = False
    return config


def _compile(pkg, build, batch, opt=None, loss="sparse", metrics=(),
             mode=None):
    m = pkg.FFModel(_config(pkg, batch))
    build(pkg, m)
    kw = {} if mode is None else {"comp_mode": getattr(pkg.CompMode, mode)}
    loss_type = {"sparse": pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                 "identity": pkg.LossType.LOSS_IDENTITY,
                 "mse": pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE}[loss]
    with unoptimised_xla() if pkg is ff else contextlib.nullcontext():
        m.compile(optimizer=(opt or (lambda p, mm: p.SGDOptimizer(
                      mm, lr=0.01)))(pkg, m),
                  loss_type=loss_type,
                  metrics=[getattr(pkg.MetricsType, n) for n in metrics],
                  **kw)
    return m


def _pair(build, batch, **kw):
    jm = _compile(ff, build, batch, **kw)
    pm = _compile(pt, build, batch, **kw)
    pt.params_from_jax(pm, jm.params)
    return jm, pm


def _mlp(pkg, m, batch=8):
    t = m.create_tensor([batch, 16])
    t = m.dense(t, 32, pkg.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 4))


def _bert(pkg, m, batch=4):
    tok = m.create_tensor([batch, 16], pkg.DataType.DT_INT32)
    cfg = (jzoo if pkg is ff else pzoo).TransformerConfig(
        hidden_size=64, embedding_size=64, num_heads=4, num_layers=2,
        sequence_length=16, vocab_size=97)
    (jzoo if pkg is ff else pzoo).build_bert_encoder(m, tok, cfg)


def _resnet(pkg, m, batch=4):
    t = m.create_tensor([batch, 3, 64, 64])
    (jzoo if pkg is ff else pzoo).build_resnet(m, t, stages=(1, 1))


def _assert_params_close(jm, pm, **tol):
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(v), err_msg=f"{op}/{w}",
                                       **(tol or W_TOL))


# -- predict -----------------------------------------------------------------
def test_predict_mlp_matches_jax_with_tail_batch():
    jm, pm = _pair(_mlp, 8)
    x = np.random.RandomState(0).randn(21, 16).astype(np.float32)
    got = pm.predict(x)
    assert got.dtype == np.float32 and got.shape == (21, 4)
    np.testing.assert_allclose(got, jm.predict(x), **TOL)
    # a batch size of its own, and the same bits again
    np.testing.assert_array_equal(pm.predict([x], batch_size=5),
                                  pm.predict(x, batch_size=5))
    np.testing.assert_allclose(pm.predict(x, batch_size=5), got, **TOL)


def test_predict_bert_two_layers_matches_jax():
    jm, pm = _pair(_bert, 4, opt=lambda p, m: p.AdamOptimizer(m, alpha=1e-3),
                   metrics=("METRICS_ACCURACY",))
    x = np.random.RandomState(1).randint(0, 97, size=(11, 16)).astype(
        np.int32)
    got = pm.predict(x)
    assert got.shape == (11, 16, 2)
    np.testing.assert_allclose(got, jm.predict(x), **TOL)


def _bn_cnn(pkg, m, batch=4):
    t = m.conv2d(m.create_tensor([batch, 3, 16, 16]), 8, 3, 3, 1, 1, 1, 1)
    t = m.pool2d(m.batch_norm(t), 2, 2, 2, 2, 0, 0)
    m.softmax(m.dense(m.flat(t), 10))


@pytest.mark.parametrize("build,size", [(_resnet, 64), (_bn_cnn, 16)],
                         ids=["resnet", "batch_norm"])
def test_predict_after_two_steps_reads_op_state_like_jax(build, size):
    """ResNet (stages (1, 1), 64 px; no batch norm, as every zoo builder)
    and a conv / batch-norm net, each after two fit steps: predict with a
    tail batch against JAX's, the batch norm's running statistics read
    and left as they were."""
    jm, pm = _pair(build, 4)
    rng = np.random.RandomState(2)
    for _ in range(2):
        x = rng.randn(4, 3, size, size).astype(np.float32)
        y = rng.randint(0, 10, size=(4, 1)).astype(np.int32)
        jm.fit([x], y, batch_size=4, epochs=1)
        pm.fit([x], y, batch_size=4, epochs=1)
    before = {op: {v: t.clone() for v, t in vs.items()}
              for op, vs in pm.state.items()}
    assert len(before) == (build is _bn_cnn)
    x = rng.randn(6, 3, size, size).astype(np.float32)
    got = pm.predict(x)
    # JAX's flat reshapes to the declared batch, so its predict takes no
    # tail batch here: pad the tail (inference rows are independent)
    pad = np.concatenate([x, np.zeros((2, 3, size, size), np.float32)])
    np.testing.assert_allclose(got, jm.predict(pad)[:6], **RESNET_TOL)
    # predict reads the running statistics and writes none
    for op, vs in pm.state.items():
        for v, t in vs.items():
            assert torch.equal(t, before[op][v]), (op, v)
            np.testing.assert_allclose(t.numpy(), np.asarray(
                jm.state[op][v]), **RESNET_TOL)


def test_predict_after_inference_compile():
    jm, pm = _pair(_mlp, 8, mode="COMP_MODE_INFERENCE")
    assert pm.opt_state is None and pm.optimizer is None
    x = np.random.RandomState(3).randn(19, 16).astype(np.float32)
    np.testing.assert_allclose(pm.predict(x), jm.predict(x), **TOL)
    # eval runs in either mode, as JAX's; the training entries do not
    y = np.random.RandomState(3).randint(0, 4, size=(19, 1)).astype(np.int32)
    assert pm.eval(x, y)["samples"] == 19
    with pytest.raises(RuntimeError, match="training mode"):
        pm.fit(x[:8], y[:8])
    with pytest.raises(RuntimeError, match="training mode"):
        pm.backward()


def test_predict_before_compile_raises():
    m = pt.FFModel(_config(pt, 8))
    _mlp(pt, m)
    with pytest.raises(RuntimeError, match="compile"):
        m.predict(np.zeros((8, 16), np.float32))


def test_lstm_numerics_vs_reference():
    """tests/test_models.py's LSTM check on the port: predict against a
    numpy replay of the gates."""
    batch, seq, dim, hidden = 2, 5, 3, 4

    def build(pkg, m):
        m.lstm(m.create_tensor([batch, seq, dim]), hidden)

    model = _compile(pt, build, batch,
                     opt=lambda p, m: p.SGDOptimizer(m, lr=0.0), loss="mse")
    x = np.random.RandomState(1).randn(batch, seq, dim).astype(np.float32)
    pred = model.predict([x])
    lstm = next(op for op in model.ops if op.op_type == pt.OpType.LSTM)
    w = model.params[lstm.name]
    wx, wh, b = (w["kernel"].numpy(), w["recurrent_kernel"].numpy(),
                 w["bias"].numpy())

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    h = np.zeros((batch, hidden), np.float32)
    c = np.zeros((batch, hidden), np.float32)
    outs = []
    for t in range(seq):
        gates = x[:, t] @ wx + h @ wh + b
        i, f, g, o = np.split(gates, 4, axis=-1)
        c = sigmoid(f) * c + sigmoid(i) * np.tanh(g)
        h = sigmoid(o) * np.tanh(c)
        outs.append(h)
    np.testing.assert_allclose(pred, np.stack(outs, axis=1), rtol=2e-4,
                               atol=2e-4)


# -- the manual loop -----------------------------------------------------------
def _synthetic(n=256, dim=32, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    w = rng.randn(dim, classes).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)[:, None]


def _manual_mlp(pkg, m, batch=32):
    t = m.dense(m.create_tensor([batch, 32]), 64, pkg.ActiMode.AC_MODE_RELU)
    m.dense(t, 10)


def test_manual_loop_matches_jax():
    """tests/test_mnist_mlp.py's manual loop (SGD 0.05, 8 iterations on
    one batch) in both packages: the loss of each forward's output and
    the final weights."""
    x, y = _synthetic()
    sgd = (lambda p, m: p.SGDOptimizer(m, lr=0.05))
    jm, pm = _pair(_manual_mlp, 32, opt=sgd, metrics=("METRICS_ACCURACY",))
    jl, pl = [], []
    for _ in range(8):
        for m, losses in ((jm, jl), (pm, pl)):
            m.set_iteration_batch([x[:32]], y[:32])
            pred = m.forward()
            m.zero_gradients()
            m.backward()
            m.update()
            losses.append(float(m.loss.fn(
                pred, jnp.asarray(y[:32]) if m is jm
                else torch.from_numpy(y[:32]))))
    np.testing.assert_allclose(pl, jl, **TOL)
    assert pl[-1] < pl[0]
    _assert_params_close(jm, pm)


def test_manual_loop_equals_fit_to_the_bit():
    """Two manual iterations on one batch and two fit steps on it, from the
    same weights: the same losses and weights (ROADMAP A1's gate)."""
    x, y = _synthetic(n=32)
    adam = (lambda p, m: p.AdamOptimizer(m, alpha=1e-2))
    a = _compile(pt, _manual_mlp, 32, opt=adam)
    b = _compile(pt, _manual_mlp, 32, opt=adam)
    a.set_iteration_batch([x], y)
    manual = []
    for _ in range(2):
        pred = a.forward()
        assert not pred.requires_grad and pred.grad_fn is None
        manual.append(float(a.loss.fn(pred, torch.from_numpy(y))))
        a.zero_gradients()
        a.backward()
        a.update()
    b.fit(np.concatenate([x, x]), np.concatenate([y, y]), batch_size=32,
          epochs=1)
    assert manual == [r["loss"] for r in b.step_records]
    for op, ws in b.params.items():
        for w, t in ws.items():
            assert torch.equal(a.params[op][w], t), (op, w)
    assert int(a.opt_state["step"]) == int(b.opt_state["step"]) == 2


def test_manual_loop_order_and_modes():
    x, y = _synthetic(n=32)
    m = _compile(pt, _manual_mlp, 32)
    m.set_iteration_batch([x], y)
    with pytest.raises(RuntimeError, match="backward"):
        m.update()
    m.forward()
    m.backward()
    m.zero_gradients()
    with pytest.raises(RuntimeError, match="backward"):
        m.update()
    inf = _compile(pt, _manual_mlp, 32, mode="COMP_MODE_INFERENCE")
    inf.set_iteration_batch([x], y)
    np.testing.assert_array_equal(inf.forward().numpy(), inf.predict(x))
    with pytest.raises(RuntimeError, match="training mode"):
        inf.update()


def _attn(pkg, m, batch=2, seq=8, embed=16, heads=4, dense=False):
    inp = m.create_tensor([batch, seq, embed])
    out = m.multihead_attention(inp, inp, inp, embed, heads, name="attn")
    if dense:
        m.dense(out, 3, name="cls")
    else:
        m.final_tensor = out


def test_attention_forward_truncates_to_seq_length():
    """tests/test_seq_length.py's first scenario on the port, and the same
    truncated forward in JAX."""
    B, S, E, L = 2, 8, 16, 5
    x = np.random.RandomState(3).randn(B, S, E).astype(np.float32)
    zero = (lambda p, m: p.SGDOptimizer(m, lr=0.0))
    jm, pm = _pair(_attn, B, opt=zero, loss="identity")
    for m in (jm, pm):
        m.set_iteration_batch([x], np.zeros((B, S, E), np.float32))
    full = pm.forward().numpy()
    trunc = pm.forward(seq_length=L).numpy()
    np.testing.assert_allclose(trunc, np.asarray(jm.forward(seq_length=L)),
                               **TOL)
    # the oracle: the full forward of a model built at length L
    short = _compile(pt, lambda p, m: _attn(p, m, seq=L), B, opt=zero,
                     loss="identity")
    pt.params_from_jax(short, jm.params)
    short.set_iteration_batch([x[:, :L]], np.zeros((B, L, E), np.float32))
    np.testing.assert_allclose(trunc[:, :L], short.forward().numpy(), **TOL)
    assert np.all(trunc[:, L:] == 0.0)
    assert not np.allclose(trunc[:, :L], full[:, :L])


def test_batch_matmul_seq_length_dims_truncate():
    B, S, D, L = 2, 6, 4, 3
    rng = np.random.RandomState(4)
    a = rng.randn(B, S, D).astype(np.float32)
    b = rng.randn(B, D, S).astype(np.float32)

    def build(pkg, m):
        ta = m.create_tensor([B, S, D])
        tb = m.create_tensor([B, D, S])
        m.final_tensor = m.batch_matmul(ta, tb, a_seq_length_dim=1,
                                        b_seq_length_dim=2)

    m = _compile(pt, build, B, opt=lambda p, mm: p.SGDOptimizer(mm, lr=0.0),
                 loss="identity")
    m.set_iteration_batch([a, b], np.zeros((B, S, S), np.float32))
    got = m.forward(seq_length=L).numpy()
    np.testing.assert_allclose(got[:, :L, :L], a[:, :L] @ b[:, :, :L],
                               **TOL)
    assert np.all(got[:, L:, :] == 0.0) and np.all(got[:, :, L:] == 0.0)
    # no truncation without seq_length, or at a length past the dims
    np.testing.assert_allclose(m.forward().numpy(), a @ b, **TOL)
    np.testing.assert_allclose(m.forward(seq_length=S + 2).numpy(), a @ b,
                               **TOL)


def test_backward_seq_length_matches_jax_and_zeroes_truncated_grads():
    """tests/test_seq_length.py's third scenario on the port, its
    truncated gradients against JAX's."""
    B, S, E, L = 2, 8, 16, 4
    x = np.random.RandomState(0).randn(B, S, E).astype(np.float32)
    y = np.zeros((B, S, 1), dtype=np.int32)
    jm, pm = _pair(lambda p, m: _attn(p, m, dense=True), B)
    for m in (jm, pm):
        m.set_iteration_batch([x], y)
        m.forward()
        m.backward()
    full = {w: t.clone() for w, t in pm._manual["grads"]["attn"].items()}
    for m in (jm, pm):
        m.forward(seq_length=L)
        m.backward(seq_length=L)
    got, want = pm._manual["grads"], jm._manual["grads"]
    for op, ws in want.items():
        for w, g in ws.items():
            assert torch.isfinite(got[op][w]).all()
            np.testing.assert_allclose(got[op][w].numpy(), np.asarray(g),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{op}/{w}")
    assert not np.allclose(full["wq"].numpy(), got["attn"]["wq"].numpy())
    pm.update()


def _dropout_net(pkg, m, batch=8):
    t = m.dense(m.create_tensor([batch, 16]), 32, pkg.ActiMode.AC_MODE_RELU)
    t = m.dropout(t, 0.5)
    m.softmax(m.dense(t, 4))


def test_manual_backward_replays_the_forwards_dropout_masks():
    """The manual backward's gradients equal autograd's of the loss of its
    own forward's output: the backward walks from the generator state the
    forward saved, so it draws the forward's masks."""
    rng = np.random.RandomState(5)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 4, size=(8, 1)).astype(np.int32)
    m = _compile(pt, _dropout_net, 8)
    m.set_iteration_batch([x], y)
    gen = m.executor.generator
    state = gen.get_state()
    pred = m.forward()
    after = gen.get_state()
    m.backward()
    assert torch.equal(gen.get_state(), after)
    # autograd of the forward's own loss, from the same generator state
    gen.set_state(state)
    params = m.executor.parameters()
    inputs, label = m._manual["inputs"], m._manual["label"]
    out = m.executor.forward_values(
        inputs, mode=pt.CompMode.COMP_MODE_TRAINING, write_state=False)[
            m.final_tensor.guid]
    assert torch.equal(out.detach(), pred)
    flat = [(op, w, p) for op, ws in params.items() for w, p in ws.items()]
    grads = torch.autograd.grad(m.loss.fn(out, label),
                                [p for _, _, p in flat])
    for (op, w, _), g in zip(flat, grads):
        assert torch.equal(m._manual["grads"][op][w], g), (op, w)
    # a backward with no forward before it draws new masks
    m.backward()
    assert any(not torch.equal(m._manual["grads"][op][w], g)
               for (op, w, _), g in zip(flat, grads))


# -- regularizers ------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2])
def test_weight_regularizer_in_fit_matches_jax(k):
    x, y = _synthetic(n=64)
    sgd = (lambda p, m: p.SGDOptimizer(m, lr=0.05))
    jm = _compile(ff, _manual_mlp, 32, opt=sgd, metrics=("METRICS_ACCURACY",))
    pm = _compile(pt, _manual_mlp, 32, opt=sgd,
                  metrics=("METRICS_ACCURACY",))
    for m, sq in ((jm, jnp.sum), (pm, torch.sum)):
        m.add_weight_regularizer("linear_0", "kernel",
                                 lambda w, sq=sq: 0.05 * sq(w * w))
        m.add_weight_regularizer("no_such_op", "kernel", lambda w: w)
    # regularizers are read at compile
    jm.compile(optimizer=sgd(ff, jm),
               loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ff.MetricsType.METRICS_ACCURACY])
    pm.compile(optimizer=sgd(pt, pm),
               loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[pt.MetricsType.METRICS_ACCURACY])
    pt.params_from_jax(pm, jm.params)
    jh = jm.fit(x, y, batch_size=32, epochs=2, steps_per_execution=k)
    ph = pm.fit(x, y, batch_size=32, epochs=2, steps_per_execution=k)
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-5)
    _assert_params_close(jm, pm)
    # eval's loss has no regularizer term
    ev = pm.eval(x, y, batch_size=32)
    assert ev["loss"] == pytest.approx(jm.eval(x, y, batch_size=32)["loss"],
                                       rel=1e-5)


def test_weight_regularizer_in_accumulation():
    x, y = _synthetic(n=64)
    sgd = (lambda p, m: p.SGDOptimizer(m, lr=0.05))
    a = _compile(pt, _manual_mlp, 32, opt=sgd)
    b = _compile(pt, _manual_mlp, 32, opt=sgd)
    a.add_weight_regularizer("linear_1", "kernel",
                             lambda w: 0.1 * torch.sum(w * w))
    a.compile(optimizer=sgd(pt, a),
              loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              generator=torch.Generator().manual_seed(0))
    la = a.fit(x, y, batch_size=32, epochs=1, accum_steps=2)[0]["loss"]
    lb = b.fit(x, y, batch_size=32, epochs=1, accum_steps=2)[0]["loss"]
    reg = 0.1 * float(torch.sum(b.params["linear_1"]["kernel"] ** 2))
    assert la > lb and reg > 0


# -- the Tensor value API, summary and queries --------------------------------
def test_tensor_value_api():
    m = _compile(pt, _mlp, 8)
    op = m.get_layer_by_name("linear_0")
    w = op.weights[0]
    assert w.owner_op is op and w._weight_spec.name == "kernel"
    assert w.num_elements() == 16 * 32
    assert not any(isinstance(v, list) for v in op._parameters.values())
    assert [n for n, _ in op.named_parameters()] == ["kernel", "bias"]
    np.testing.assert_array_equal(w.get_tensor(m),
                                  m.params["linear_0"]["kernel"].numpy())
    before = m.executor.parameters()["linear_0"]["kernel"]
    version = before._version
    value = np.arange(16 * 32, dtype=np.float32).reshape(16, 32)
    assert w.set_tensor(m, value)
    assert m.executor.parameters()["linear_0"]["kernel"] is before
    assert before._version > version
    np.testing.assert_array_equal(m.get_parameter_by_id("linear_0",
                                                        "kernel"), value)
    with pytest.raises(ValueError, match="shape mismatch"):
        w.set_tensor(m, np.zeros((3, 3)))
    with pytest.raises(KeyError):
        m.get_parameter_by_id("nope", "kernel")
    # a non-weight tensor holds a host value only
    t = m.input_ops[0].outputs[0]
    with pytest.raises(RuntimeError, match="no materialized value"):
        t.get_tensor(m)
    t.attach_numpy_array(np.ones((8, 16)))
    assert t.get_tensor(m).dtype == np.float32
    # a handle of another model's op is stale here
    other = _compile(pt, _mlp, 8)
    with pytest.raises(KeyError, match="stale"):
        other.get_layer_by_name("linear_0").weights[0].get_tensor(m)
    pts = ParallelTensorShape([ParallelDim(8), ParallelDim(6, 2, "model")],
                              pt.DataType.DT_FLOAT)
    assert pts.shape == (8, 6) and pts.num_elements() == 48


@pytest.mark.parametrize("build", [_mlp, _bert, _resnet],
                         ids=["mlp", "bert", "resnet"])
def test_summary_text_equals_jax(build):
    jm, pm = _pair(build, 4)
    lines = []
    assert pm.summary(print_fn=lines.append) == jm.summary(print_fn=None)
    assert lines == [jm.summary(print_fn=None)]


def test_layer_queries_and_perf_metrics(capsys):
    jm, pm = _pair(_mlp, 8, metrics=("METRICS_ACCURACY",))
    assert [op.name for op in pm.get_layers()] == \
        [op.name for op in jm.get_layers()]
    assert pm.get_layer_by_id(1).name == jm.get_layer_by_id(1).name
    with pytest.raises(KeyError):
        pm.get_layer_by_name("missing")
    pm.print_layers()
    port_out = capsys.readouterr().out
    jm.print_layers()
    assert port_out == capsys.readouterr().out
    rng = np.random.RandomState(0)
    x = rng.randn(24, 16).astype(np.float32)
    y = rng.randint(0, 4, size=(24, 1)).astype(np.int32)
    jm.fit(x, y, batch_size=8, epochs=1, verbose=True)
    jax_out = capsys.readouterr().out
    pm.fit(x, y, batch_size=8, epochs=1, verbose=True)
    out = capsys.readouterr().out
    assert out.startswith("epoch 0: loss=") and out.endswith("samples/s\n")
    # the same line up to the throughput
    assert out.rsplit(" ", 2)[0] == jax_out.rsplit(" ", 2)[0]
    pj, pp = jm.get_perf_metrics(), pm.get_perf_metrics()
    assert (pp.train_all, pp.train_correct) == (pj.train_all,
                                                pj.train_correct)
    assert pp.loss_sum == pytest.approx(pj.loss_sum, rel=1e-5)
    pm.reset_metrics()
    assert pm.get_perf_metrics().train_all == 0


def _signature_net(pkg, m, extra=False):
    t = m.create_tensor([4, 8, 16], create_grad=False)
    ids = m.create_tensor([4, 8], pkg.DataType.DT_INT32)
    kw = dict(add_bias_kv=True, add_zero_attn=True,
              sequence_parallel_mode="ulysses") if extra else {}
    e = m.embedding(ids, 10, 16, shared_op=None)
    d = m.dense(t, 16, shared_op=None)
    m.multihead_attention(d, e, e, 16, 4, **kw)


def test_new_signatures_and_config_flags():
    with_flags = _compile(pt, lambda p, m: _signature_net(p, m, True), 4,
                          loss="identity")
    plain = _compile(pt, _signature_net, 4, loss="identity")
    assert with_flags.input_ops[0].outputs[0].create_gradients is False
    op = with_flags.get_layer_by_name("multihead_attention_0")
    assert op.params["add_bias_kv"] and op.params["add_zero_attn"]
    assert op.params["sequence_parallel_mode"] == "ulysses"
    # add_bias_kv / add_zero_attn change nothing, as in JAX's lowering
    plain.load_params(with_flags.params)
    rng = np.random.RandomState(0)
    xs = [rng.randn(4, 8, 16).astype(np.float32),
          rng.randint(0, 10, size=(4, 8)).astype(np.int32)]
    np.testing.assert_array_equal(with_flags.predict(xs), plain.predict(xs))
    jm = _compile(ff, lambda p, m: _signature_net(p, m, True), 4,
                  loss="identity")
    pt.params_from_jax(with_flags, jm.params)
    np.testing.assert_allclose(with_flags.predict(xs), jm.predict(xs), **TOL)

    cfg, jcfg = pt.FFConfig(), ff.FFConfig()
    for c in (cfg, jcfg):
        c.parse_args(["-i", "3", "--steps-per-execution", "4", "--wd",
                      "0.5", "--print-freq", "7", "--profiling"])
    for field in ("iterations", "steps_per_execution", "weight_decay",
                  "print_freq", "profiling"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
        assert getattr(pt.FFConfig(), field) == getattr(ff.FFConfig(), field)
    cfg.parse_args(["--iterations", "5", "--weight-decay", "0.25"])
    assert (cfg.iterations, cfg.weight_decay) == (5, 0.25)
    cfg.parse_args(["--collective-lowering", "explicit"])
    jcfg.parse_args(["--collective-lowering", "explicit"])
    assert cfg.collective_lowering == jcfg.collective_lowering == "explicit"
    with pytest.raises(ValueError, match="not ported"):
        cfg.parse_args(["--nodes", "2"])
