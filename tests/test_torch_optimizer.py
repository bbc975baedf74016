"""The optimizer update on the CPU: the plain version of the fused
multi-tensor kernel (kernels/optimizer.py, the per-tensor loop) against
the JAX package's `update` over several steps, for SGD (plain, momentum,
nesterov, weight decay) and Adam (f32 and bf16 moments, weight decay);
`set_lr` between steps; and a JAX optimizer state carried into the
port's device-scalar step and lr. The kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: the same f32 operations in the same order; alpha_t's powers
come from another library's powf and XLA may fuse the update, so
weights agree to a few ulp (rtol 2e-6, atol 1e-7); a bf16 moment may
round one bf16 ulp apart where its f32 value sits within an ulp of a
rounding midpoint (rtol 8e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu_torch.kernels import optimizer as kopt

SHAPES = {"fc": {"kernel": (16, 8), "bias": (8,)}, "emb": {"weight": (33,)},
          "one": {"w": (1,)}}
STEPS = 4
W_TOL = dict(rtol=2e-6, atol=1e-7)
BF16_TOL = dict(rtol=8e-3, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {op: {w: (scale * rng.randn(*s)).astype(np.float32)
                 for w, s in ws.items()} for op, ws in SHAPES.items()}


def _port(tree):
    return {op: {w: torch.from_numpy(v.copy()) for w, v in ws.items()}
            for op, ws in tree.items()}


def _close(port_tree, jax_tree, tol):
    for op, ws in jax_tree.items():
        for w, v in ws.items():
            np.testing.assert_allclose(
                port_tree[op][w].float().numpy(),
                np.asarray(jnp.asarray(v, jnp.float32)), err_msg=f"{op}/{w}",
                **tol)


OPTS = {
    "sgd": (lambda p: p.SGDOptimizer(lr=0.05), {}),
    "sgd_wd": (lambda p: p.SGDOptimizer(lr=0.05, weight_decay=0.01), {}),
    "sgd_momentum": (lambda p: p.SGDOptimizer(lr=0.05, momentum=0.9), {}),
    "sgd_nesterov": (lambda p: p.SGDOptimizer(
        lr=0.05, momentum=0.9, nesterov=True, weight_decay=0.01), {}),
    "adam": (lambda p: p.AdamOptimizer(alpha=1e-2), {}),
    "adam_wd": (lambda p: p.AdamOptimizer(alpha=1e-2, weight_decay=0.05),
                {}),
    "adam_bf16": (lambda p: p.AdamOptimizer(
        alpha=1e-2, moments_dtype=(torch.bfloat16 if p is pt
                                   else jnp.bfloat16)), {}),
}


@pytest.mark.parametrize("set_lr", [False, True], ids=["", "set_lr"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_update_matches_jax(name, set_lr):
    make, _ = OPTS[name]
    jopt, popt = make(ff), make(pt)
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_state(jp)
    pp = _port(params)
    ps = popt.init_state(pp)
    assert ps["step"].dtype == torch.int32 and ps["step"].dim() == 0
    assert ps["lr"].dtype == torch.float32 and ps["lr"].dim() == 0
    for step in range(STEPS):
        if set_lr and step == 2:
            js = jopt.set_lr(js, 0.003)
            popt.set_lr(ps, 0.003)
        grads = _tree(10 + step, scale=0.3)
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, grads), js)
        popt.update(pp, _port(grads), ps)
    _close(pp, jp, W_TOL)
    assert int(ps["step"]) == int(js["step"]) == STEPS
    assert float(ps["lr"]) == float(js["lr"])
    for key in ("m", "v"):
        if key in js:
            bf16 = ps[key]["fc"]["kernel"].dtype == torch.bfloat16
            _close(ps[key], js[key], BF16_TOL if bf16 else W_TOL)


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain loop and count no
    launch; an empty list and zero-size tensors are no work."""
    w = [torch.ones(3), torch.ones(0)]
    g = [torch.full((3,), 0.5), torch.ones(0)]
    m = [torch.zeros(3), torch.zeros(0)]
    v = [torch.zeros(3), torch.zeros(0)]
    step = torch.zeros((), dtype=torch.int32)
    lr = torch.tensor(0.1)
    before = dict(kopt.LAUNCHES)
    kopt.adam(w, g, m, v, step, lr, beta1=0.9, beta2=0.999, eps=1e-8)
    kopt.sgd(w, g, None, lr)
    kopt.adam([], [], [], [], step, lr, beta1=0.9, beta2=0.999, eps=1e-8)
    assert kopt.LAUNCHES == before
    # Adam's first step moves each weight by lr * sign(g) (alpha_1 * m /
    # sqrt(v) at t = 1, up to eps), then SGD by lr * g
    np.testing.assert_allclose(w[0].numpy(), 1 - 0.1 - 0.05, rtol=1e-6)
    with pytest.raises(ValueError, match="several devices"):
        kopt.sgd([torch.ones(1), torch.ones(1, device="meta")],
                 [torch.ones(1)] * 2, None, lr)


def _mlp(pkg, optimizer, bs=8):
    if pkg is ff:
        config = ff.FFConfig()
        config.batch_size = bs
        config.allow_mixed_precision = False
    else:
        config = pt.FFConfig(batch_size=bs, allow_mixed_precision=False,
                             device="cpu")
    m = pkg.FFModel(config)
    t = m.create_tensor([bs, 12])
    t = m.dense(t, 16, pkg.ActiMode.AC_MODE_TANH)
    m.softmax(m.dense(t, 4))
    m.compile(optimizer=optimizer(pkg, m),
              loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[pkg.MetricsType.METRICS_ACCURACY])
    return m


def test_opt_state_from_jax_and_set_learning_rate():
    """A JAX model's state after two Adam steps (bf16 moments) carried
    into the port: step and lr land in the port's int32 / f32 device
    scalars, the moments by name; from there, with the learning rate
    changed by `set_learning_rate` in both, the next steps agree."""
    def adam(pkg, m):
        return pkg.AdamOptimizer(m, alpha=5e-3, moments_dtype=(
            jnp.bfloat16 if pkg is ff else torch.bfloat16))

    jm, pm = _mlp(ff, adam), _mlp(pt, adam)
    rng = np.random.RandomState(4)
    x = rng.randn(16, 12).astype(np.float32)
    y = rng.randint(0, 4, size=(16, 1)).astype(np.int32)
    jm.fit(x, y, epochs=1)
    pt.params_from_jax(pm, jm.params)
    pt.opt_state_from_jax(pm, jm.opt_state)
    st = pm.opt_state
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 2
    assert st["lr"].dtype == torch.float32 and float(st["lr"]) == \
        pytest.approx(5e-3)
    assert st["m"]["linear_0"]["kernel"].dtype == torch.bfloat16
    _close(st["m"], jm.opt_state["m"], W_TOL)  # bf16 values, carried
    jm.set_learning_rate(1e-3)
    pm.set_learning_rate(1e-3)
    assert float(pm.opt_state["lr"]) == pytest.approx(1e-3)
    jh = jm.fit(x, y, epochs=2)
    ph = pm.fit(x, y, epochs=2)
    for j, p in zip(jh, ph):
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-5)
    assert int(pm.opt_state["step"]) == int(jm.opt_state["step"]) == 6
    _close(pm.params, jm.params, dict(rtol=1e-5, atol=1e-6))


def test_optimizer_family_follows_the_bare_knobs():
    """The update is a kernel family of the port's registry with no JAX
    counterpart: auto takes the kernel on a Hopper card and the loop on
    the CPU; the bare `reference` / `pallas` knobs and an override reach
    it; a `family=impl` spec names only the JAX families, so it leaves
    the update on auto; parse_spec stays the JAX package's."""
    from flexflow_tpu.kernels.registry import KernelRegistry as JaxRegistry
    from flexflow_tpu_torch.kernels.registry import (PORT_FAMILIES,
                                                     KernelRegistry)

    assert PORT_FAMILIES == ("optimizer",)
    reg = KernelRegistry()
    assert reg.select("optimizer", device="cpu", record=False).reason \
        == "backend"
    reg._has_kernels = lambda device: True
    assert reg.select("optimizer", device="cuda", record=False)
    for spec, impl, reason in (("reference", "reference", "config"),
                               ("pallas", "pallas", "config"),
                               ("softmax=reference", "pallas", "default")):
        c = reg.select("optimizer", config=pt.FFConfig(kernel_impl=spec),
                       device="cuda", record=False)
        assert (c.impl, c.reason) == (impl, reason), spec
        assert KernelRegistry.parse_spec(spec) == \
            JaxRegistry.parse_spec(spec)
    with reg.override("optimizer", "reference"):
        c = reg.select("optimizer", device="cuda", record=False)
        assert (c.impl, c.reason) == ("reference", "override")


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_update_on_cpu_runs_the_loop_under_every_impl(impl):
    """On the CPU either impl of the update ends in the plain loop (the
    kernel tier's wrapper takes it for CPU tensors): no launch, the
    weights of the auto run."""
    from flexflow_tpu_torch.kernels.registry import KERNELS

    def adam(pkg, m):
        return pkg.AdamOptimizer(m, alpha=5e-3)

    rng = np.random.RandomState(6)
    x = rng.randn(16, 12).astype(np.float32)
    y = rng.randint(0, 4, size=(16, 1)).astype(np.int32)
    base = _mlp(pt, adam)
    start = {op: {w: t.clone() for w, t in ws.items()}
             for op, ws in base.params.items()}
    base.fit(x, y, epochs=2)
    m = _mlp(pt, adam)
    m.load_params(start)
    before = dict(kopt.LAUNCHES)
    with KERNELS.override("optimizer", impl):
        m.fit(x, y, epochs=2)
    assert kopt.LAUNCHES == before
    for op, ws in base.params.items():
        for w, t in ws.items():
            assert torch.equal(t, m.params[op][w]), (op, w)
