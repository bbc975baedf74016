"""The op set of ROADMAP A3 / A6 on the CPU, beyond the per-op forwards
of tests/test_torch_ops_ext.py: first-step gradients of conv, batch norm
and LSTM models against the JAX package's; batch norm's running
statistics after training steps against JAX's `model.state`, and eval
reading them; dropout and attention dropout (masks cannot match across
two random number generators, so: the identity at rate 0 and outside
training, the keep fraction and the survivors' scale, the attention core
against JAX's formula on the same numpy mask, the paths taken, seeded
determinism and new masks every step); the op FLOPs against JAX's; the
digits CNN accuracy gate on the port.

Tolerance: f32. Gradients rtol 1e-5 with an absolute floor of 1e-5 x
the op's largest gradient (another summation order); batch-norm
statistics 1e-6; the attention core rtol 1e-5 / atol 1e-6; dropout
survivors exact (x / keep is one rounding in both)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.ffconst import CompMode as JaxCompMode
from flexflow_tpu_torch.ffconst import CompMode
from flexflow_tpu_torch.ops.attention import MultiHeadAttentionOp
from tests.test_torch_zoo import one_torch_thread, unoptimised_xla

GRAD_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-6, atol=1e-6)

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _config(pkg, batch, seed=0, **kw):
    if pkg is pt:
        return pt.FFConfig(batch_size=batch, allow_mixed_precision=False,
                           device="cpu", seed=seed, **kw)
    config = ff.FFConfig()
    config.num_devices = 1
    config.batch_size = batch
    config.allow_mixed_precision = False
    config.seed = seed
    return config


def _conv_net(pkg, m, t):
    t = m.conv2d(t, 6, 3, 3, 1, 1, 1, 1, pkg.ActiMode.AC_MODE_RELU)
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
    return m.flat(t)


def _grouped_net(pkg, m, t):
    t = m.conv2d(t, 6, 3, 3, 2, 2, 1, 1, groups=3)
    t = m.pool2d(t, 3, 3, 1, 1, 1, 1, pkg.PoolType.POOL_AVG)
    return m.flat(t)


def _bn_net(pkg, m, t):
    t = m.conv2d(t, 4, 3, 3, 1, 1, 1, 1)
    t = m.batch_norm(t)
    t = m.conv2d(t, 4, 3, 3, 2, 2, 1, 1)
    t = m.batch_norm(t, relu=False)
    return m.flat(t)


def _lstm_net(pkg, m, t):
    t = m.lstm(t, 7)
    return m.lstm(t, 5, return_sequences=False)


NETS = {"conv": (_conv_net, (4, 3, 8, 8)),
        "conv_grouped": (_grouped_net, (4, 3, 8, 8)),
        "batch_norm": (_bn_net, (4, 3, 8, 8)),
        "lstm": (_lstm_net, (4, 5, 6))}


def _build(pkg, net, batch_shape, seed=0, optimizer=None, **kw):
    fn, _ = NETS[net] if isinstance(net, str) else (net, None)
    m = pkg.FFModel(_config(pkg, batch_shape[0], seed, **kw))
    t = fn(pkg, m, m.create_tensor(list(batch_shape)))
    m.softmax(m.dense(t, 5))
    with unoptimised_xla() if pkg is ff else contextlib.nullcontext():
        m.compile(optimizer=(optimizer or (lambda p, mm: p.SGDOptimizer(
            mm, lr=0.05)))(pkg, m),
            loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
            metrics=[pkg.MetricsType.METRICS_ACCURACY])
    return m


def _pair(net, shape, **kw):
    jm = _build(ff, net, shape, **kw)
    pm = _build(pt, net, shape, **kw)
    pt.params_from_jax(pm, jm.params)
    return jm, pm


def _data(shape, seed=0, n=None):
    rng = np.random.RandomState(seed)
    n = n or shape[0]
    return (rng.randn(n, *shape[1:]).astype(np.float32),
            rng.randint(0, 5, size=(n, 1)).astype(np.int32))


@pytest.mark.parametrize("net", sorted(NETS))
def test_first_step_gradients_match_jax(net):
    shape = NETS[net][1]
    jm, pm = _pair(net, shape)
    x, y = _data(shape)
    name = jm.input_ops[0].name
    jgrads = jm.executor.build_grad_step(jm.loss.fn, jm.final_tensor)(
        jm.params, jm.state, {name: jnp.asarray(x)}, jnp.asarray(y),
        jax.random.PRNGKey(0))
    pgrads, _ = pm.executor.build_grad_metrics_step(
        pm.loss.fn, pm.metrics, pm.final_tensor)(
        {pm.input_ops[0].name: torch.from_numpy(x)}, torch.from_numpy(y))
    assert set(pgrads) == set(jgrads)
    for op, ws in jgrads.items():
        scale = max(float(np.abs(np.asarray(g)).max()) for g in ws.values())
        for w, g in ws.items():
            np.testing.assert_allclose(
                pgrads[op][w].numpy(), np.asarray(g), rtol=GRAD_RTOL,
                atol=GRAD_RTOL * scale, err_msg=f"{op}/{w}")


def _bn_steps(k=1, steps=3):
    shape = NETS["batch_norm"][1]
    jm, pm = _pair("batch_norm", shape)
    x, y = _data(shape, seed=1, n=shape[0] * steps)
    jh = jm.fit(x, y, epochs=1)
    ph = pm.fit(x, y, epochs=1, steps_per_execution=k)
    return jm, pm, jh, ph


@pytest.mark.parametrize("k", [1, 3])
def test_batch_norm_running_stats_match_jax_after_three_steps(k):
    """3 SGD steps (one dispatch of 3 at k = 3): the epoch loss, the
    weights and `model.state`, key for key, against JAX's."""
    jm, pm, jh, ph = _bn_steps(k)
    assert ph[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    assert set(pm.state) == set(jm.state) == {"batchnorm_0", "batchnorm_1"}
    for op, vs in jm.state.items():
        assert set(pm.state[op]) == set(vs) == {"running_mean",
                                                "running_var"}
        for v, val in vs.items():
            assert not np.allclose(np.asarray(val), 0.0 if "mean" in v
                                   else 1.0)
            np.testing.assert_allclose(pm.state[op][v].numpy(),
                                       np.asarray(val), err_msg=f"{op}/{v}",
                                       **STATE_TOL)
    for op, ws in jm.params.items():
        for w, val in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(val), rtol=1e-4, atol=1e-6)


def test_eval_reads_the_running_stats_like_jax():
    """After training, eval normalises by the running statistics: the
    port's eval against JAX's, and against a fresh port model given the
    trained weights and JAX's state (`load_state`)."""
    jm, pm, _, _ = _bn_steps()
    x, y = _data(NETS["batch_norm"][1], seed=7, n=8)
    want = jm.eval(x, y, batch_size=4)
    got = pm.eval(x, y, batch_size=4)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["accuracy"] == want["accuracy"]
    fresh = _build(pt, "batch_norm", NETS["batch_norm"][1])
    pt.params_from_jax(fresh, jm.params)
    before = fresh.eval(x, y, batch_size=4)["loss"]
    fresh.load_state(jm.state)
    after = fresh.eval(x, y, batch_size=4)["loss"]
    assert after == pytest.approx(want["loss"], rel=1e-5)
    assert before != pytest.approx(after, rel=1e-4)


def test_load_state_checks_names_and_shapes():
    pm = _build(pt, "batch_norm", NETS["batch_norm"][1])
    state = {op: {v: t.numpy().copy() for v, t in vs.items()}
             for op, vs in pm.state.items()}
    del state["batchnorm_1"]["running_var"]
    with pytest.raises(KeyError, match="state tree"):
        pm.load_state(state)
    state = {op: {v: np.zeros(3, np.float32) for v in vs}
             for op, vs in pm.state.items()}
    with pytest.raises(ValueError, match="shape"):
        pm.load_state(state)


def _walk(m, x, training=True):
    mode = CompMode.COMP_MODE_TRAINING if training \
        else CompMode.COMP_MODE_INFERENCE
    with torch.no_grad():
        return m.executor.forward_values(
            {m.input_ops[0].name: torch.from_numpy(x)}, mode=mode)[
            m.final_tensor.guid]


def _dropout_model(rate, n=1024, batch=64, seed=0):
    m = pt.FFModel(_config(pt, batch, seed))
    m.final_tensor = m.dropout(m.create_tensor([batch, n]), rate)
    m.compile(loss_type=pt.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    return m


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.5, False),
                                           (0.0, False)])
def test_dropout_is_the_identity_at_rate_zero_and_outside_training(
        rate, training):
    x = np.random.RandomState(2).randn(64, 1024).astype(np.float32)
    got = _walk(_dropout_model(rate), x, training)
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_keeps_a_binomial_fraction_scaled_by_one_over_keep(rate):
    """Survivors equal x / (1 - rate) to the bit (JAX's where(mask, x /
    keep, 0)); the kept fraction of 65,536 within 6 sigma of 1 - rate."""
    x = np.random.RandomState(3).randn(64, 1024).astype(np.float32) + 5.0
    got = _walk(_dropout_model(rate), x).numpy()
    kept = got != 0
    keep = 1.0 - rate
    want = np.asarray(jnp.where(jnp.asarray(kept), jnp.asarray(x) / keep,
                                0.0))
    np.testing.assert_array_equal(got, want)
    n = x.size
    assert abs(kept.sum() - n * keep) <= 6 * np.sqrt(n * keep * rate)


def test_dropout_is_seeded_and_draws_new_masks_every_walk():
    x = np.ones((64, 1024), np.float32)
    a, b, c = (_dropout_model(0.5, seed=s) for s in (0, 0, 1))
    a1, a2 = _walk(a, x), _walk(a, x)
    b1, b2 = _walk(b, x), _walk(b, x)
    c1 = _walk(c, x)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, a2)
    assert not torch.equal(a1, c1)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_dropout_core_matches_the_jax_formula(causal):
    """The port's einsum core with a given keep mask against JAX's
    `attn_core` (flexflow_tpu/ops/attention.py) on the same numpy mask."""
    rng = np.random.RandomState(4)
    b, lq, lk, h, d, rate = 2, 6, 7, 3, 4, 0.25
    q, k, v = (rng.randn(b, n, h, d).astype(np.float32)
               for n in (lq, lk, lk))
    keep = rng.rand(b, h, lq, lk) < 1.0 - rate
    scale = 1.0 / np.sqrt(d)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                        preferred_element_type=jnp.float32) * scale
    if causal:
        mask = jnp.tril(jnp.ones((lq, lk), dtype=bool), lk - lq)
        logits = jnp.where(mask, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    probs = jnp.where(keep, probs / (1.0 - rate), 0.0)
    want = jnp.einsum("bhqk,bkhd->bqhd", probs.astype(jnp.float32), v)
    got = MultiHeadAttentionOp._einsum_core(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale,
        causal, torch.float32, rate, keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _attention_model(dropout, impl="auto", seed=0):
    m = pt.FFModel(_config(pt, 2, seed, kernel_impl=impl))
    t = m.create_tensor([2, 8, 16])
    m.final_tensor = m.multihead_attention(t, t, t, 16, 4, dropout=dropout)
    m.compile(loss_type=pt.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
              generator=torch.Generator().manual_seed(3))
    return m


def test_attention_dropout_takes_the_einsum_core_in_training_only(
        monkeypatch):
    """Under the kernel tier (flash forced; its plain version on the
    CPU): a training walk with dropout calls no flash kernel, inference
    and a dropout-free training walk call the flash forward; inference
    with dropout set gives the dropout-free model's output to the bit."""
    from flexflow_tpu_torch.kernels.registry import KERNELS
    from flexflow_tpu_torch.ops import attention

    calls = []

    def flash(*a, **kw):
        calls.append(1)
        return flash_attention(*a, **kw)

    flash_attention = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention", flash)
    x = np.random.RandomState(5).randn(2, 8, 16).astype(np.float32)
    try:
        drop, plain = (_attention_model(r, "pallas") for r in (0.1, 0.0))
        runs = {}
        for name, m, training in (("drop_train", drop, True),
                                  ("drop_infer", drop, False),
                                  ("plain_train", plain, True)):
            calls.clear()
            runs[name] = _walk(m, x, training)
            runs[name + "_flash"] = len(calls)
        assert runs["drop_train_flash"] == 0
        assert runs["drop_infer_flash"] == 1
        assert runs["plain_train_flash"] == 1
        assert torch.equal(runs["drop_infer"], _walk(plain, x, False))
        assert not torch.equal(runs["drop_train"], runs["plain_train"])
    finally:
        KERNELS.configure(pt.FFConfig(device="cpu"))


def test_attention_dropout_training_is_seeded():
    """Two models of one seed train to the same bits with attention
    dropout; another seed gives other losses; every loss finite."""
    rng = np.random.RandomState(6)
    x = rng.randn(6, 8, 16).astype(np.float32)
    y = rng.randn(6, 8, 16).astype(np.float32)
    losses = []
    for seed in (0, 0, 1):
        m = _attention_model(0.3, seed=seed)
        m.fit(x, y, batch_size=2, epochs=1)
        losses.append([r["loss"] for r in m.step_stats.records()])
    assert losses[0] == losses[1] and losses[0] != losses[2]
    assert np.all(np.isfinite(losses))


def test_dropout_k_steps_a_dispatch_equal_single_steps():
    """fit(steps_per_execution=3) draws the masks 3 single steps draw
    from the same seed: losses, weights and batch-norm state equal."""
    shape = (4, 3, 8, 8)

    def net(pkg, m, t):
        t = m.batch_norm(m.conv2d(t, 4, 3, 3, 1, 1, 1, 1))
        return m.dropout(m.flat(t), 0.3)

    x, y = _data(shape, seed=8, n=12)
    runs = []
    for k in (1, 3):
        m = _build(pt, net, shape, seed=5)
        m.fit(x, y, epochs=1, steps_per_execution=k)
        losses = [r["loss"] for r in m.step_stats.records()]
        runs.append((losses, m.params, m.state))
    (l1, p1, s1), (l3, p3, s3) = runs
    # the dispatch's record holds its 3 steps' f32 mean loss (JAX's
    # StepStats): the single steps' give it to the bit
    assert len(l1) == 3 and l3 == [float(np.asarray(l1, np.float32).mean())]
    for op, ws in p1.items():
        for w, t in ws.items():
            assert torch.equal(t, p3[op][w]), (op, w)
    for op, vs in s1.items():
        for v, t in vs.items():
            assert torch.equal(t, s3[op][v]), (op, v)


FLOP_CASES = {
    "conv": lambda p, m, t: m.conv2d(t, 6, 3, 3, 2, 1, 1, 0, groups=3),
    "lstm": lambda p, m, t: m.lstm(m.reshape(t, [4, 24, 8]), 5),
    "dense": lambda p, m, t: m.dense(m.flat(t), 7),
    "attention": lambda p, m, t: m.multihead_attention(
        *(m.reshape(t, [4, 24, 8]),) * 3, 8, 2, kdim=3, vdim=5),
}


@pytest.mark.parametrize("case", sorted(FLOP_CASES))
def test_op_flops_match_jax(case):
    out = []
    for pkg in (ff, pt):
        m = pkg.FFModel(_config(pkg, 4))
        FLOP_CASES[case](pkg, m, m.create_tensor([4, 3, 8, 8]))
        out.append([op.flops() for op in m.ops])
    assert out[0] == out[1] and max(out[1]) > 0


def test_digits_cnn_accuracy_gate():
    """tests/test_accuracy_gate.py's digits CNN (conv16 - conv32 - pool -
    flat - dense10, RELU, Adam 2e-3, batch 64, 30 epochs) on the port,
    its own weights: eval accuracy on the held-out digits >= 0.90."""
    datasets = pytest.importorskip("sklearn.datasets")
    d = datasets.load_digits()
    x = (d.data / 16.0).astype(np.float32).reshape(-1, 1, 8, 8)
    y = d.target.astype(np.int32)[:, None]
    idx = np.random.RandomState(0).permutation(len(x))
    x, y = x[idx], y[idx]

    def net(pkg, m, t):
        t = m.conv2d(t, 16, 3, 3, 1, 1, 1, 1, pkg.ActiMode.AC_MODE_RELU)
        t = m.conv2d(t, 32, 3, 3, 1, 1, 1, 1, pkg.ActiMode.AC_MODE_RELU)
        return m.flat(m.pool2d(t, 2, 2, 2, 2, 0, 0))

    m = pt.FFModel(_config(pt, 64))
    t = net(pt, m, m.create_tensor([64, 1, 8, 8]))
    m.softmax(m.dense(t, 10))
    m.compile(optimizer=pt.AdamOptimizer(m, alpha=2e-3),
              loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[pt.MetricsType.METRICS_ACCURACY])
    m.fit([x[:1536]], y[:1536], batch_size=64, epochs=30)
    ev = m.eval([x[1536:1792]], y[1536:1792], batch_size=64)
    assert ev["samples"] == 256
    assert ev["accuracy"] >= 0.90, ev


def test_jax_model_state_is_the_initial_running_stats():
    """Both packages start the running statistics at 0 and 1."""
    jm = _build(ff, "batch_norm", NETS["batch_norm"][1])
    pm = _build(pt, "batch_norm", NETS["batch_norm"][1])
    for op, vs in jm.state.items():
        for v, val in vs.items():
            np.testing.assert_array_equal(pm.state[op][v].numpy(),
                                          np.asarray(val))
    assert JaxCompMode.COMP_MODE_TRAINING.value == \
        CompMode.COMP_MODE_TRAINING.value


def test_batch_stats_and_dropout_on_a_data_mesh_raise():
    """Batch statistics and dropout masks over a `data` axis are the global
    batch's now (tests/test_torch_axes.py holds batch norm on a data x
    attr mesh against JAX): a training walk whose inputs the axis did not
    cut (`in_cuts` empty) gives the one-device values from the same
    generator, batch norm, dropout and attention dropout alike;
    inference reads the running statistics."""
    from types import SimpleNamespace

    from flexflow_tpu_torch.core.op import LoweringContext

    m = pt.FFModel(_config(pt, 4))
    t = m.create_tensor([4, 3, 8, 8])
    bn = m.batch_norm(t)
    drop = m.dropout(m.flat(bn), 0.5)
    s = m.reshape(drop, [4, 12, 16])
    m.final_tensor = m.multihead_attention(s, s, s, 16, 2, dropout=0.1)
    m.compile(loss_type=pt.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    mesh = SimpleNamespace(size=lambda axis: 2 if axis == "data" else 1)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 3, 8, 8).astype(np.float32))
    for op, arg in ((m.ops[1], x),
                    (m.ops[3], torch.from_numpy(
                        rng.randn(4, 192).astype(np.float32))),
                    (m.ops[5], torch.from_numpy(
                        rng.randn(4, 12, 16).astype(np.float32)))):
        args = [arg] * (3 if op is m.ops[5] else 1)
        outs = []
        for mm in (mesh, None):
            ctx = LoweringContext(m.config, CompMode.COMP_MODE_TRAINING)
            ctx.mesh = mm
            ctx.write_state = False
            ctx.generator = torch.Generator().manual_seed(3)
            with torch.no_grad():
                outs.append(op.lower(ctx, args)[0])
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    ctx = LoweringContext(m.config, CompMode.COMP_MODE_INFERENCE)
    ctx.mesh = mesh
    assert m.ops[1].lower(ctx, [x])[0].shape == x.shape
