"""The kernel tier's selection path on the CPU: the port against the JAX
package, same seed and weights (`params_from_jax`), each package once
under its reference lowerings and once with its kernel tier forced (the
port's plain kernel versions, the JAX package's interpret-mode Pallas
kernels).

 - the JAX kernel-tier graph of tests/test_pallas_kernels.py
   (layer_norm -> rms_norm -> dense -> softmax, sparse CE and accuracy,
   SGD lr 0.05, data from RandomState(8)), fit for 2 epochs;
 - norms and softmax over other axes than the trailing one (reference
   lowerings only, as in the JAX package), forward and backward;
 - the four other losses through `reduce_scalar`, both impls;
 - the flagship encoder at 2 layers, hidden 64, with use_flash=False
   (the einsum core) in both packages;
 - KV-cache decoding with the decode families forced to the kernels.

Tolerances: f32, the same math through another BLAS and summation order:
losses rel 1e-4 / abs 1e-5 (as test_training_parity_reference_vs_forced_
pallas), weights and gradients rel 1e-4 of their op's largest entry.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.ffconst import CompMode
from flexflow_tpu.kernels.registry import KERNELS as JAX_KERNELS
from flexflow_tpu.runtime import losses as jax_losses
from flexflow_tpu_torch.kernels import launch_counts
from flexflow_tpu_torch.kernels.registry import KERNELS
from flexflow_tpu_torch.runtime import losses as pt_losses

TIER = ("layernorm", "rmsnorm", "softmax", "reduction")
LOSS_TOL = dict(rel=1e-4, abs=1e-5)
SPARSE = "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"


@pytest.fixture(autouse=True)
def _default_knob():
    """compile() configures the process default; give it back."""
    yield
    KERNELS.configure(pt.FFConfig(device="cpu"))


@contextlib.contextmanager
def forced(registry, families):
    with contextlib.ExitStack() as st:
        for fam in families:
            st.enter_context(registry.override(fam, "pallas"))
        yield


def _tier_graph(m, pkg):
    inp = m.create_tensor([4, 6, 32])
    t = m.layer_norm(inp, [-1], name="ln")
    t = m.rms_norm(t, [-1], name="rms")
    t = m.dense(t, 10, name="cls")
    m.softmax(t)
    m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.05),
              loss_type=getattr(pkg.LossType, SPARSE),
              metrics=[pkg.MetricsType.METRICS_ACCURACY])
    return m


def _tier_models(mixed):
    cfg = ff.FFConfig()
    cfg.batch_size = 4
    cfg.seed = 0
    cfg.allow_mixed_precision = mixed
    jm = _tier_graph(ff.FFModel(cfg), ff)
    pm = _tier_graph(pt.FFModel(pt.FFConfig(
        batch_size=4, allow_mixed_precision=mixed, device="cpu")), pt)
    pt.params_from_jax(pm, jm.params)
    return jm, pm


def _tier_data():
    rng = np.random.RandomState(8)
    x = rng.randn(8, 6, 32).astype(np.float32)
    y = rng.randint(0, 10, size=(8, 6, 1)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_tier_graph_matches_jax(impl):
    """f32, 2 epochs of 2 steps: under the reference lowerings (auto on
    the CPU in both packages), then with layernorm, rmsnorm, softmax and
    reduction forced to the kernel tier in both."""
    x, y = _tier_data()
    jm, pm = _tier_models(mixed=False)
    families = TIER if impl == "pallas" else ()
    before = launch_counts()
    with forced(JAX_KERNELS, families):
        jh = jm.fit([x], y, batch_size=4, epochs=2)
    with forced(KERNELS, families):
        ph = pm.fit(x, y, batch_size=4, epochs=2)
    assert launch_counts() == before  # the CPU runs no kernel
    assert len(ph) == len(jh) == 2
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], **LOSS_TOL)
        assert p["accuracy"] == j["accuracy"]
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{op}/{w}")


def test_tier_graph_reference_vs_forced_kernels():
    """The JAX test's own claim, on the port: bf16 mixed precision, the
    same data and seed through the reference lowerings and through the
    kernel tier land on the same losses and accuracies step by step."""
    x, y = _tier_data()
    _, ref = _tier_models(mixed=True)
    _, fused = _tier_models(mixed=True)

    def steps(m):
        # 2 epochs of the 2 batches, one fit call a batch: each call's
        # history is one step's loss and accuracy, and its StepStats
        # record that step's loss
        out = []
        for _ in range(2):
            for lo in (0, 4):
                h = m.fit(x[lo:lo + 4], y[lo:lo + 4], batch_size=4,
                          epochs=1)
                assert [r["loss"] for r in m.step_stats.records()] == \
                    [h[0]["loss"]]
                out += h
        return out

    h_ref = steps(ref)
    with forced(KERNELS, TIER):
        h_fused = steps(fused)
    assert len(h_ref) == len(h_fused) == 4
    for r, f in zip(h_ref, h_fused):
        assert f["loss"] == pytest.approx(r["loss"], **LOSS_TOL)
        assert f["accuracy"] == r["accuracy"]


def _axes_graph(m, pkg):
    """Norms and softmax over other axes than the trailing one: only the
    reference lowerings take them, in both packages."""
    inp = m.create_tensor([4, 6, 8])
    t = m.layer_norm(inp, [1], name="ln_axis1")
    t = m.rms_norm(t, [1, 2], name="rms_axes12")
    t = m.softmax(t, axis=1, name="sm_axis1")
    t = m.layer_norm(t, [-1], elementwise_affine=False, name="ln_plain")
    t = m.rms_norm(t, [-1], elementwise_affine=False, name="rms_plain")
    m.softmax(m.dense(t, 5, name="cls"))
    m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.5),
              loss_type=getattr(pkg.LossType, SPARSE),
              metrics=[pkg.MetricsType.METRICS_ACCURACY])
    return m


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_norms_over_any_axes_match_jax(impl):
    cfg = ff.FFConfig()
    cfg.batch_size = 4
    cfg.allow_mixed_precision = False
    jm = _axes_graph(ff.FFModel(cfg), ff)
    pm = _axes_graph(pt.FFModel(pt.FFConfig(
        batch_size=4, allow_mixed_precision=False, device="cpu")), pt)
    assert {op: {w: tuple(v.shape) for w, v in ws.items()}
            for op, ws in pm.params.items()} == \
        {op: {w: tuple(v.shape) for w, v in ws.items()}
         for op, ws in jm.params.items()}
    pt.params_from_jax(pm, jm.params)
    rng = np.random.RandomState(9)
    x = (rng.randn(8, 6, 8) * 2 + 1).astype(np.float32)
    y = rng.randint(0, 5, size=(8, 6, 1)).astype(np.int32)
    families = TIER if impl == "pallas" else ()
    with forced(JAX_KERNELS, families):
        jh = jm.fit([x], y, batch_size=4, epochs=2)
    with forced(KERNELS, families):
        ph = pm.fit(x, y, batch_size=4, epochs=2)
    assert len(ph) == len(jh) == 2
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], **LOSS_TOL)
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(pm.params[op][w].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{op}/{w}")


LOSSES = {
    "categorical_crossentropy": (jax_losses.categorical_crossentropy,
                                 pt_losses.categorical_crossentropy),
    "mse_avg": (lambda p, t: jax_losses.mean_squared_error(p, t, "avg"),
                lambda p, t: pt_losses.mean_squared_error(p, t, "avg")),
    "mse_sum": (lambda p, t: jax_losses.mean_squared_error(p, t, "sum"),
                lambda p, t: pt_losses.mean_squared_error(p, t, "sum")),
    "identity": (jax_losses.identity_loss, pt_losses.identity_loss),
}


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name, impl):
    """Value and gradient of each loss, both reduction impls."""
    rng = np.random.RandomState(13)
    pred = rng.rand(5, 3, 7).astype(np.float32) + 0.05
    target = rng.rand(5, 3, 7).astype(np.float32)
    if name == "categorical_crossentropy":
        target = target / target.sum(-1, keepdims=True)
    jfn, pfn = LOSSES[name]
    with forced(JAX_KERNELS, ("reduction",) if impl == "pallas" else ()):
        jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                              jnp.asarray(target))
    tp = torch.from_numpy(pred).requires_grad_()
    with forced(KERNELS, ("reduction",) if impl == "pallas" else ()):
        pval = pfn(tp, torch.from_numpy(target))
    (pgrad,) = torch.autograd.grad(pval, tp)
    assert pval.dtype == torch.float32 and pval.shape == ()
    assert float(pval.detach()) == pytest.approx(float(jval), rel=1e-5)
    np.testing.assert_allclose(pgrad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-7)
    assert pt_losses.loss_fn_for(getattr(
        pt.LossType, {"categorical_crossentropy":
                      "LOSS_CATEGORICAL_CROSSENTROPY",
                      "mse_avg": "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE",
                      "mse_sum": "LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE",
                      "identity": "LOSS_IDENTITY"}[name])) is not None


def test_flagship_einsum_core_matches_jax():
    """use_flash=False in both packages: the port's einsum reference core
    against the JAX package's, first-step gradients and two Adam steps."""
    from tests.test_torch_train import (B, F32_GRAD_RTOL, F32_LOSS,
                                        OPTIMIZERS, _check_grads, _data,
                                        _first_grads, _models)

    jm, pm = _models(*OPTIMIZERS["adam"], use_flash=False)
    x, y = _data(5)
    before = launch_counts()
    jgrads, pgrads = _first_grads(jm, pm, x, y)
    _check_grads(jgrads, pgrads, F32_GRAD_RTOL)
    jh = jm.fit(x, y, batch_size=B, epochs=2)
    ph = pm.fit(x, y, batch_size=B, epochs=2)
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], **F32_LOSS)
    assert launch_counts() == before


def test_decode_through_forced_kernels_matches_jax():
    """Chunked prefill and a ragged decode step with the decode families
    forced to the kernel tier (the plain kernel versions on the CPU),
    against the JAX package's default einsum decode chain."""
    from tests.test_generate import _build_lm
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    jm = _build_lm(2, 8)
    pm = build_tiny_lm(2, 8, vocab=50, device="cpu")
    pt.params_from_jax(pm, jm.params)
    attn = [op.name for op in pm.ops
            if op.op_type.value == "multihead_attention"]
    jcache = {n: {v: jnp.zeros((2, 24, 4, 8)) for v in ("k_cache",
                                                         "v_cache")}
              for n in attn}
    pcache = {n: {v: torch.zeros((2, 24, 4, 8)) for v in ("k_cache",
                                                           "v_cache")}
              for n in attn}
    rng = np.random.RandomState(14)
    steps = [(rng.randint(1, 50, size=(2, 4)).astype(np.int32), 0),
             (rng.randint(1, 50, size=(2, 1)).astype(np.int32),
              np.array([4, 2], np.int32))]
    jin, pin = jm.input_ops[0].name, pm.input_ops[0].name
    with forced(KERNELS, ("attention_decode", "attention_decode_mq")):
        for toks, pos in steps:
            vals, new_state, _ = jm.executor.forward_values(
                jm.params, {**jm.state, **jcache}, {jin: jnp.asarray(toks)},
                None, CompMode.COMP_MODE_INFERENCE,
                decode_pos=jnp.asarray(pos, jnp.int32))
            jcache = {n: {v: new_state[n][v] for v in ("k_cache", "v_cache")}
                      for n in attn}
            tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) \
                else pos
            pvals = pm.executor.forward_values(
                {pin: torch.from_numpy(toks)}, state=pcache,
                decode_pos=tpos)
            np.testing.assert_allclose(
                pvals[pm.final_tensor.guid].numpy(),
                np.asarray(vals[jm.final_tensor.guid]), rtol=1e-5,
                atol=1e-6)
