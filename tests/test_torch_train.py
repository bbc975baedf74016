"""The training slice on the CPU: the port's BERT encoder against the JAX
package's, same weights (`params_from_jax`), same optimizer state
(`opt_state_from_jax`), same tokens and labels — first-step gradients by
op and weight name, then the per-step losses of three Adam and three
momentum-SGD steps; a mixed-precision bf16 run; and one run with the
kernel tier forced in both packages: the JAX side through the
interpret-mode Pallas kernels (flash attention, LayerNorm, softmax), the
port through the plain versions of its kernels. Otherwise both run their
reference lowerings, each registry's choice on the CPU."""
import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.kernels.registry import KERNELS
from flexflow_tpu_torch.kernels.registry import KERNELS as PORT_KERNELS
from flexflow_tpu.models import TransformerConfig as JaxTransformerConfig
from flexflow_tpu.models import build_bert_encoder as jax_build_bert
from flexflow_tpu_torch.models import TransformerConfig, build_bert_encoder

B, L, HIDDEN, HEADS, LAYERS, VOCAB = 4, 16, 64, 4, 2, 97
WIDTHS = dict(hidden_size=HIDDEN, embedding_size=HIDDEN, num_heads=HEADS,
              num_layers=LAYERS, sequence_length=L, vocab_size=VOCAB)
# f32: the same math through another BLAS and summation order; Adam's
# first steps divide by sqrt(v) ~ |g|, which passes gradient noise through
# at full relative size (observed <= 2e-6 on the losses)
F32_LOSS = dict(rel=1e-4)
# gradients: absolute error against the op's largest gradient — bk's is
# zero in exact arithmetic (softmax is invariant to a shift of every score
# of a query), so both packages give ~1e-11 noise there
F32_GRAD_RTOL = 1e-4
# mixed precision: bf16 activations at every op boundary, rounded at other
# points (flash vs einsum core, hand-derived vs autodiff norm backward)
BF16_LOSS = dict(rel=2e-2)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, VOCAB, size=(B, L)).astype(np.int32)
    y = rng.randint(0, 2, size=(B, L, 1)).astype(np.int32)
    return x, y


def _models(jax_opt, port_opt, mixed=False, use_flash=None, widths=WIDTHS,
            batch=B):
    seq = widths["sequence_length"]
    config = ff.FFConfig()
    config.num_devices = 1
    config.batch_size = batch
    config.allow_mixed_precision = mixed
    jm = ff.FFModel(config)
    tok = jm.create_tensor([batch, seq], ff.DataType.DT_INT32)
    jax_build_bert(jm, tok, JaxTransformerConfig(**widths),
                   use_flash=use_flash)
    jm.compile(optimizer=jax_opt(jm),
               loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ff.MetricsType.METRICS_ACCURACY])

    pm = pt.FFModel(pt.FFConfig(batch_size=batch,
                                allow_mixed_precision=mixed, device="cpu"))
    tok = pm.create_tensor([batch, seq], pt.DataType.DT_INT32)
    build_bert_encoder(pm, tok, TransformerConfig(**widths),
                       use_flash=use_flash)
    pm.compile(optimizer=port_opt(pm),
               loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[pt.MetricsType.METRICS_ACCURACY])
    pt.params_from_jax(pm, jm.params)
    pt.opt_state_from_jax(pm, jm.opt_state)
    return jm, pm


def _first_grads(jm, pm, x, y):
    name = jm.input_ops[0].name
    jgrads = jm.executor.build_grad_step(jm.loss.fn, jm.final_tensor)(
        jm.params, jm.state, {name: jax.numpy.asarray(x)},
        jax.numpy.asarray(y), jax.random.PRNGKey(0))
    gstep = pm.executor.build_grad_metrics_step(pm.loss.fn, pm.metrics,
                                                pm.final_tensor)
    pgrads, _ = gstep({pm.input_ops[0].name: torch.from_numpy(x)},
                      torch.from_numpy(y))
    return jgrads, pgrads


def _check_grads(jgrads, pgrads, rtol):
    assert set(pgrads) == set(jgrads)
    for op, ws in jgrads.items():
        assert set(pgrads[op]) == set(ws), op
        scale = max(float(np.abs(np.asarray(g)).max()) for g in ws.values())
        for w, g in ws.items():
            got = pgrads[op][w]
            assert got.dtype == torch.float32, (op, w)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(g, np.float32), rtol=rtol,
                atol=rtol * scale, err_msg=f"{op}/{w}")


OPTIMIZERS = {
    "adam": (lambda m: ff.AdamOptimizer(m, alpha=1e-3),
             lambda m: pt.AdamOptimizer(m, alpha=1e-3)),
    "sgd_momentum": (lambda m: ff.SGDOptimizer(m, lr=0.05, momentum=0.9),
                     lambda m: pt.SGDOptimizer(m, lr=0.05, momentum=0.9)),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_f32_steps_match_jax(opt):
    jm, pm = _models(*OPTIMIZERS[opt])
    x, y = _data()
    jgrads, pgrads = _first_grads(jm, pm, x, y)
    _check_grads(jgrads, pgrads, F32_GRAD_RTOL)
    jh = jm.fit(x, y, batch_size=B, epochs=3)
    ph = pm.fit(x, y, batch_size=B, epochs=3)
    # one epoch of one step each: the history per epoch, the step
    # records (StepStats) beside it, one step each, as JAX's
    assert [r["epoch"] for r in ph] == [0, 1, 2]
    assert [r["steps"] for r in pm.step_stats.records()] == \
        [r["steps"] for r in jm.step_stats.records()] == [1, 1, 1]
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], **F32_LOSS)
        # both count round(accuracy * batch) correct samples
        # (PerfMetrics.update)
        assert p["accuracy"] == j["accuracy"]
    assert pm.opt_state["step"] == 3
    # bk's gradient is noise (see F32_GRAD_RTOL) that Adam normalises into
    # steps of its own: bk ends within ~1e-5 of 0 in both, with any sign
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=5e-5,
                                       err_msg=f"{op}/{w}")


def _mlp(pkg, config):
    m = pkg.FFModel(config)
    t = m.create_tensor([4, 20], pkg.DataType.DT_FLOAT)
    t = m.dense(t, 16, pkg.ActiMode.AC_MODE_GELU, name="fc1")
    m.softmax(m.dense(t, 4, name="fc2"))
    m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.05),
              loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[pkg.MetricsType.METRICS_ACCURACY])
    return m


def test_fit_history_matches_jax_per_epoch():
    """fit returns the JAX package's history over several steps per
    epoch: one PerfMetrics summary per epoch with its epoch and
    throughput, key for key; the steps' records go to step_stats, as
    JAX's."""
    config = ff.FFConfig()
    config.num_devices = 1
    config.batch_size = 4
    config.allow_mixed_precision = False
    jm = _mlp(ff, config)
    pm = _mlp(pt, pt.FFConfig(batch_size=4, allow_mixed_precision=False,
                              device="cpu"))
    pt.params_from_jax(pm, jm.params)
    rng = np.random.RandomState(11)
    x = rng.randn(16, 20).astype(np.float32)
    y = rng.randint(0, 4, size=(16, 1)).astype(np.int32)
    jh = jm.fit(x, y, batch_size=4, epochs=2)
    ph = pm.fit(x, y, batch_size=4, epochs=2)
    assert len(ph) == len(jh) == 2
    for j, p in zip(jh, ph):
        assert set(p) == set(j)
        assert p["epoch"] == j["epoch"]
        assert p["samples"] == j["samples"] == 16
        assert p["accuracy"] == j["accuracy"]
        assert p["throughput"] > 0
        for k in ("loss", "cce", "sparse_cce", "mse", "rmse", "mae"):
            assert p[k] == pytest.approx(j[k], **F32_LOSS), k
    recs, jrecs = pm.step_stats.records(), jm.step_stats.records()
    assert [(r["steps"], r["samples"]) for r in recs] == \
        [(r["steps"], r["samples"]) for r in jrecs] == [(1, 4)] * 8
    for r, j in zip(recs, jrecs):
        assert r["loss"] == pytest.approx(j["loss"], **F32_LOSS)
    for e in range(2):  # equal batches: the epoch's loss is their mean
        steps = [r["loss"] for r in recs[4 * e:4 * e + 4]]
        assert ph[e]["loss"] == pytest.approx(np.mean(steps), rel=1e-6)
    pm.fit(x, y, batch_size=4, epochs=1)
    assert len(pm.step_stats) == 4  # made anew by every call


def test_bf16_mixed_precision_adam_matches_jax():
    """bf16 activations and bf16 Adam moments, bench.py's configuration."""
    import jax.numpy as jnp

    jm, pm = _models(
        lambda m: ff.AdamOptimizer(m, alpha=1e-3, moments_dtype=jnp.bfloat16),
        lambda m: pt.AdamOptimizer(m, alpha=1e-3,
                                   moments_dtype=torch.bfloat16), mixed=True)
    assert pm.opt_state["m"]["cls"]["kernel"].dtype == torch.bfloat16
    x, y = _data(1)
    jh = jm.fit(x, y, batch_size=B, epochs=3)
    ph = pm.fit(x, y, batch_size=B, epochs=3)
    for j, p in zip(jh, ph):
        assert np.isfinite(p["loss"])
        assert p["loss"] == pytest.approx(j["loss"], **BF16_LOSS)


def test_first_adam_step_saturates_classifier_like_jax():
    """bench.py's optimizer (Adam alpha 1e-4, bf16 moments) on a 12-layer
    encoder: the first step moves nearly every weight by ~alpha (m / sqrt(v)
    = sign(g)), and the token states of a deep random post-LN encoder
    point nearly one way, so the classifier's logit gap of every token
    moves together and overshoots. From step 2 the loss sits at that of a
    model sure of one class, log(1 + e^-1) + the share of the other label
    (the loss is log_softmax of the softmax output). The JAX package does
    the same, step for step."""
    import jax.numpy as jnp

    widths = dict(WIDTHS, hidden_size=128, embedding_size=128,
                  num_layers=12, vocab_size=1000)
    jm, pm = _models(
        lambda m: ff.AdamOptimizer(m, alpha=1e-4, moments_dtype=jnp.bfloat16),
        lambda m: pt.AdamOptimizer(m, alpha=1e-4,
                                   moments_dtype=torch.bfloat16),
        widths=widths, batch=2)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 1000, size=(2, L)).astype(np.int32)
    y = rng.randint(0, 2, size=(2, L, 1)).astype(np.int32)
    jh = jm.fit(x, y, batch_size=2, epochs=3)
    ph = pm.fit(x, y, batch_size=2, epochs=3)
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], **F32_LOSS)
    share0 = float((y == 0).mean())
    sure = [np.log1p(np.exp(-1.0)) + s for s in (1 - share0, share0)]
    for rec in ph[1:]:
        assert min(abs(rec["loss"] - v) for v in sure) < 1e-3, (ph, sure)


def test_f32_step_matches_jax_through_pallas_kernels():
    """The kernel tier forced in both packages: the JAX side through its
    interpret-mode Pallas kernels, the port through the plain versions of
    its kernels — packed flash attention (use_flash=True), fused LayerNorm
    and fused softmax, forward and backward."""
    with KERNELS.override("layernorm", "pallas"), \
            KERNELS.override("softmax", "pallas"), \
            PORT_KERNELS.override("layernorm", "pallas"), \
            PORT_KERNELS.override("softmax", "pallas"):
        jm, pm = _models(*OPTIMIZERS["adam"], use_flash=True)
        x, y = _data(2)
        jgrads, pgrads = _first_grads(jm, pm, x, y)
        jh = jm.fit(x, y, batch_size=B, epochs=2)
        _check_grads(jgrads, pgrads, F32_GRAD_RTOL)
        ph = pm.fit(x, y, batch_size=B, epochs=2)
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], **F32_LOSS)


def test_eval_and_unported_options_raise():
    """eval returns the JAX eval's PerfMetrics summary, key for key, over 6
    samples in batches of 4 (a tail batch of 2: ROADMAP C4's case);
    accumulation together with several steps a dispatch raises as in
    JAX, and so does attention dropout forced onto the flash kernel;
    what is still unported raises."""
    jm, pm = _models(*OPTIMIZERS["sgd_momentum"])
    rng = np.random.RandomState(3)
    x = rng.randint(0, VOCAB, size=(6, L)).astype(np.int32)
    y = rng.randint(0, 2, size=(6, L, 1)).astype(np.int32)
    want = jm.eval(x, y, batch_size=B)
    got = pm.eval(x, y, batch_size=B)
    assert set(got) == set(want) and len(want) == 8
    assert got["samples"] == want["samples"] == 6
    assert got["accuracy"] == want["accuracy"]
    for k in ("loss", "cce", "sparse_cce", "mse", "rmse", "mae"):
        assert got[k] == pytest.approx(want[k], **F32_LOSS), k
    with pytest.raises(ValueError, match="mutually exclusive"):
        pm.fit(x, y, batch_size=B, accum_steps=2, steps_per_execution=2)
    with pytest.raises(KeyError, match="optimizer state keys"):
        pm.load_opt_state({"step": 0, "lr": 0.1})
    m = pt.FFModel(pt.FFConfig(device="cpu"))
    t = m.create_tensor([2, 4, 8])
    with pytest.raises(ValueError, match="dropout"):
        m.multihead_attention(t, t, t, 8, 2, dropout=0.1, use_flash=True)
    with pytest.raises(ValueError, match="sequence_parallel attention"):
        m.multihead_attention(t, t, t, 8, 2, dropout=0.1,
                              sequence_parallel=True)
    m.dense(t, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        m.compile(parallel_axes={"model": 2})
