"""The MoE ops, builders and recompile hook of the port on the CPU (ROADMAP
A6), against the JAX package on the same weights (carried across by op
and weight name) and the same numpy inputs: the fused ExpertsOp at rank 2
and 3, with a capacity that drops assignments (outputs and router state),
the capacity clamp, fused against unfused, gradients of the input, the
gate and the experts against `jax.grad` with and without the
load-balance loss; GroupBy, Aggregate, AggregateSpec and Cache; the
builders' per-step losses (aux loss included); the cache recompile end
to end; the router metrics' exposition; the MoE ops raising on a mesh;
TopKOp's tie order.

Tolerance: f32. Outputs and losses rtol 1e-5 (atol 1e-6 for values near
0): the gathers are exact, the expert FFN sums its products in another
order; gradients rtol 1e-5 with an absolute floor of 1e-5 x the weight's
largest gradient; router state exact (counts and shares of small
integers)."""
import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu import models as jzoo
from flexflow_tpu.ffconst import CompMode as JaxCompMode
from flexflow_tpu_torch import models as pzoo
from flexflow_tpu_torch.ffconst import CompMode
from tests.test_torch_zoo import one_torch_thread, unoptimised_xla

RTOL = 1e-5
ATOL = 1e-6
GRAD_RTOL = 1e-5

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _config(pkg, batch, seed=0):
    if pkg is pt:
        return pt.FFConfig(batch_size=batch, allow_mixed_precision=False,
                           device="cpu", seed=seed)
    config = ff.FFConfig()
    config.num_devices = 1
    config.batch_size = batch
    config.allow_mixed_precision = False
    config.seed = seed
    return config


def _compile(pkg, m, loss="LOSS_IDENTITY", lr=0.0):
    with unoptimised_xla() if pkg is ff else contextlib.nullcontext():
        m.compile(optimizer=pkg.SGDOptimizer(m, lr=lr),
                  loss_type=getattr(pkg.LossType, loss))
    return m


def _moe_model(pkg, dims, n=4, k=2, h=5, alpha=None, fused=True,
               lambda_bal=0.0):
    m = pkg.FFModel(_config(pkg, dims[0]))
    x = m.create_tensor(list(dims))
    m.final_tensor = m.moe(x, n, k, h, alpha=float(n) if alpha is None
                           else alpha, lambda_bal=lambda_bal, fused=fused,
                           name="moe")
    return _compile(pkg, m)


def _pair(dims, **kw):
    jm = _moe_model(ff, dims, **kw)
    pm = _moe_model(pt, dims, **kw)
    pt.params_from_jax(pm, jm.params)
    return jm, pm


def _jax_walk(jm, x, state=True):
    """JAX `forward_values` handed `model.state` (the updates kept, as an
    explicit walk keeps them): the output and the new state."""
    vals, new_state, _ = jm.executor.forward_values(
        jm.params, jm.state if state else {},
        {jm.input_ops[0].name: x}, None, JaxCompMode.COMP_MODE_INFERENCE)
    jm.state = new_state
    return np.asarray(vals[jm.final_tensor.guid])


def _port_walk(pm, x):
    with torch.no_grad():
        return pm.executor.forward_values(
            {pm.input_ops[0].name: torch.from_numpy(x)},
            state=pm.state)[pm.final_tensor.guid].numpy()


def _close(got, want, **kw):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, **kw)


@pytest.mark.parametrize("dims", [(8, 6), (4, 3, 6)],
                         ids=["rank2", "rank3"])
def test_experts_forward_matches_jax(dims):
    jm, pm = _pair(dims)
    x = np.random.RandomState(11).randn(*dims).astype(np.float32)
    want = _jax_walk(jm, x)
    got = _port_walk(pm, x)
    assert got.shape == dims[:-1] + (5,)
    _close(got, want)
    for v in ("dropped", "load"):
        np.testing.assert_array_equal(pm.state["moe_experts"][v].numpy(),
                                      np.asarray(jm.state["moe_experts"][v]))


def test_rank3_experts_match_flattened_rank2():
    """(batch, seq, F) dispatches per token over the flattened leading
    dims (JAX tests/test_experts.py:156)."""
    _, m3 = _pair((4, 3, 6))
    _, m2 = _pair((12, 6))
    m2.load_params(m3.params)
    x = np.random.RandomState(11).randn(4, 3, 6).astype(np.float32)
    _close(_port_walk(m3, x), _port_walk(m2, x.reshape(12, 6)).reshape(
        4, 3, 5))


def test_router_state_tracks_drops_and_load_like_jax():
    """alpha = 0.25: capacity max(2, ceil(0.25 * 2 * 32 / 4)) = 4 slots an
    expert for 64 assignments, so drops are certain (JAX
    tests/test_experts.py:186): two walks handed model.state, each
    output, `dropped` (twice the first walk's) and `load` against JAX's;
    eval leaves the state as it was."""
    jm, pm = _pair((32, 6), alpha=0.25)
    x = np.random.RandomState(3).randn(32, 6).astype(np.float32)
    for walk in range(2):
        _close(_port_walk(pm, x), _jax_walk(jm, x), err_msg=str(walk))
        for v in ("dropped", "load"):
            np.testing.assert_array_equal(
                pm.state["moe_experts"][v].numpy(),
                np.asarray(jm.state["moe_experts"][v]), err_msg=v)
    d = float(pm.state["moe_experts"]["dropped"])
    assert d > 0 and d % 2 == 0
    assert float(pm.state["moe_experts"]["load"].sum()) == \
        pytest.approx(1.0, abs=1e-6)
    pm.eval(x, np.zeros((32, 5), np.float32))
    assert float(pm.state["moe_experts"]["dropped"]) == d


@pytest.mark.parametrize("args", [(4, 2, 64, 1.0), (64, 2, 4, 1.0),
                                  (64, 2, 4, 2.0), (1024, 2, 256, 2.0),
                                  (8, 2, 4, 4.0), (3, 1, 8, 0.5)])
def test_moe_capacity_clamps_like_jax(args):
    from flexflow_tpu.ops import moe as jmoe
    from flexflow_tpu_torch.ops import moe as pmoe

    assert pmoe.moe_capacity(*args) == jmoe.moe_capacity(*args)
    assert pmoe.moe_capacity_degenerate(*args) == \
        jmoe.moe_capacity_degenerate(*args)
    assert pmoe.moe_tokens((4, 3, 6)) == jmoe.moe_tokens((4, 3, 6)) == 12
    assert pmoe.moe_capacity(4, 2, 64, 1.0) == 2
    assert pmoe.moe_capacity_degenerate(4, 2, 64, 1.0)


@pytest.mark.parametrize("alpha", [4.0, 0.5])
def test_fused_experts_match_unfused(alpha):
    """The fused op against group_by -> a dense per expert -> aggregate,
    the per-expert dense weights packed into the (n, F, H) stacks (JAX
    tests/test_experts.py:49), and the unfused path against JAX's."""
    n = 4
    jmu, unfused = _pair((8, 6), fused=False, alpha=alpha)
    _, fused = _pair((8, 6), fused=True, alpha=alpha)
    params = {op: dict(ws) for op, ws in fused.params.items()}
    params["moe_gate"] = dict(unfused.params["moe_gate"])
    params["moe_experts"] = {
        w: torch.stack([unfused.params[f"moe_exp{i}"][w] for i in range(n)])
        for w in ("kernel", "bias")}
    fused.load_params(params)
    x = np.random.RandomState(7).randn(8, 6).astype(np.float32)
    ref = _port_walk(unfused, x)
    _close(_port_walk(fused, x), ref)
    _close(ref, _jax_walk(jmu, x))


@pytest.mark.parametrize("lambda_bal", [0.0, 0.1])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_gradients_match_jax_grad(fused, lambda_bal):
    """d/d(x, weights) of sum(out * R) + the aux losses, a capacity that
    drops assignments (alpha 0.5), against jax.grad of the same through
    the JAX executor."""
    dims, h = (8, 6), 5
    jm, pm = _pair(dims, fused=fused, alpha=0.5, lambda_bal=lambda_bal)
    rng = np.random.RandomState(5)
    x = rng.randn(*dims).astype(np.float32)
    r = rng.randn(dims[0], h).astype(np.float32)
    name = jm.input_ops[0].name

    def jloss(params, xv):
        vals, _, aux = jm.executor.forward_values(
            params, jm.state, {name: xv}, None,
            JaxCompMode.COMP_MODE_TRAINING)
        return jnp.sum(vals[jm.final_tensor.guid] * r) + aux

    jloss_v, (jgw, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jm.params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    aux = []
    vals = pm.executor.forward_values({name: xt},
                                      mode=CompMode.COMP_MODE_TRAINING,
                                      aux_losses=aux)
    loss = (vals[pm.final_tensor.guid] * torch.from_numpy(r)).sum()
    assert len(aux) == (1 if lambda_bal else 0)
    if aux:
        loss = loss + sum(aux[1:], aux[0])
    flat = [(op, w, p) for op, ws in pm.executor.parameters().items()
            for w, p in ws.items()]
    got = torch.autograd.grad(loss, [xt] + [p for _, _, p in flat],
                              allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(jloss_v), rel=RTOL)
    gx = np.asarray(jgx)
    np.testing.assert_allclose(got[0].numpy(), gx, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(gx).max())
    for (op, w, _), g in zip(flat, got[1:]):
        want = np.asarray(jgw[op][w])
        g = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, want, rtol=GRAD_RTOL,
            atol=GRAD_RTOL * max(np.abs(want).max(), 1e-30),
            err_msg=f"{op}/{w}")
    assert np.abs(np.asarray(jgw["moe_gate"]["kernel"])).max() > 0


def _ops_model(pkg, lambda_bal, spec=False):
    """group_by -> aggregate (or aggregate_spec) over given gate weights,
    ids and gate distribution, alpha 0.5 (drops)."""
    B, F, n, k = 8, 6, 4, 2
    m = pkg.FFModel(_config(pkg, B))
    x = m.create_tensor([B, F])
    g = m.create_tensor([B, k])
    ids = m.create_tensor([B, k], pkg.DataType.DT_INT32)
    full = m.create_tensor([B, n])
    grouped = m.group_by(x, ids, n, alpha=0.5, name="gb")
    if spec:
        m.final_tensor = m.aggregate_spec([g, ids, ids, full] + grouped, n,
                                          lambda_bal, name="agg")
    else:
        m.final_tensor = m.aggregate(g, ids, ids, full, grouped, n,
                                     lambda_bal, name="agg")
    return _compile(pkg, m), grouped


def _ops_inputs():
    rng = np.random.RandomState(2)
    B, F, n, k = 8, 6, 4, 2
    ids = np.stack([rng.permutation(n)[:k] for _ in range(B)]).astype(
        np.int32)
    ids[:6] = [0, 1]  # experts 0 and 1 overflow their 2 slots
    full = rng.rand(B, n).astype(np.float32)
    return [rng.randn(B, F).astype(np.float32),
            rng.rand(B, k).astype(np.float32), ids,
            full / full.sum(1, keepdims=True)]


@pytest.mark.parametrize("spec", [False, True],
                         ids=["aggregate", "aggregate_spec"])
def test_group_by_and_aggregate_match_jax(spec):
    """Each of group_by's n (cap, F) buffers and the aggregate's output
    (training walks, so the aux loss is computed) against JAX's, and
    the load-balance loss itself."""
    jm, jg = _ops_model(ff, 0.04, spec)
    pm, pg = _ops_model(pt, 0.04, spec)
    ins = _ops_inputs()
    jfeed = {op.name: v for op, v in zip(jm.input_ops, ins)}
    jvals, _, jaux = jm.executor.forward_values(
        jm.params, jm.state, jfeed, None, JaxCompMode.COMP_MODE_TRAINING)
    aux = []
    pvals = pm.executor.forward_values(
        {op.name: torch.from_numpy(v) for op, v in zip(pm.input_ops, ins)},
        mode=CompMode.COMP_MODE_TRAINING, aux_losses=aux)
    assert pg[0].dims == jg[0].dims == (2, 6)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(pvals[a.guid].detach().numpy(),
                                      np.asarray(jvals[b.guid]))
    _close(pvals[pm.final_tensor.guid].detach().numpy(),
           np.asarray(jvals[jm.final_tensor.guid]))
    assert len(aux) == 1
    assert float(aux[0]) == pytest.approx(float(jaux), rel=RTOL)


def test_load_balance_loss_matches_jax():
    from flexflow_tpu.ops import moe as jmoe
    from flexflow_tpu_torch.ops import moe as pmoe

    _, _, ids, full = _ops_inputs()
    want = jmoe._load_balance_loss(jnp.asarray(full), jnp.asarray(ids), 4,
                                   0.3)
    plan = pmoe.DispatchPlan(torch.from_numpy(ids), 4, 4)
    got = pmoe.load_balance_loss(torch.from_numpy(full), plan, 0.3)
    assert float(got) == pytest.approx(float(want), rel=RTOL)


def _cache_model(pkg):
    m = pkg.FFModel(_config(pkg, 4))
    x = m.create_tensor([4, 5])
    m.final_tensor = m.cache(x, name="c")
    return _compile(pkg, m)


def test_cache_op_matches_jax():
    """Walks handed model.state: the output (the input, then the cached
    tensor once use_cached is set), `cached` and `score` after each,
    against JAX's."""
    jm, pm = _cache_model(ff), _cache_model(pt)
    rng = np.random.RandomState(4)
    for walk in range(4):
        if walk == 2:
            for m in (jm, pm):
                m.ops[-1].params["use_cached"] = True
        x = rng.randn(4, 5).astype(np.float32)
        want = _jax_walk(jm, x)
        _close(_port_walk(pm, x), want, err_msg=str(walk))
        for v in ("cached", "score"):
            _close(pm.state["c"][v].numpy(), np.asarray(jm.state["c"][v]),
                   err_msg=f"{walk} {v}")
    assert pm.get_cache_score(pm.final_tensor) == pytest.approx(
        float(jm.get_cache_score(jm.final_tensor)), rel=RTOL)


def _zoo_transformer(pkg, lambda_bal, lm=False):
    cfg = (jzoo if pkg is ff else pzoo).MoeTransformerConfig(
        hidden_size=16, num_heads=2, num_layers=2, num_experts=4, top_k=2,
        lambda_bal=lambda_bal, moe_every=2, vocab_size=50,
        capacity_factor=0.5)
    m = pkg.FFModel(_config(pkg, 4, seed=7))
    tokens = m.create_tensor([4, 8], pkg.DataType.DT_INT32)
    build = (jzoo if pkg is ff else pzoo).build_moe_lm if lm else \
        (jzoo if pkg is ff else pzoo).build_moe_transformer
    build(m, tokens, cfg)
    return _compile(pkg, m, "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", lr=0.05)


@pytest.mark.parametrize("lm,lambda_bal", [(False, 0.0), (False, 0.01),
                                           (True, 0.01)],
                         ids=["transformer", "transformer_bal", "lm_bal"])
def test_builder_losses_match_jax(lm, lambda_bal):
    """build_moe_transformer / build_moe_lm (a dense layer, then an MoE
    layer; capacity 0.5 drops): the graphs' op names and shapes, three
    SGD steps' losses (each with the load-balance losses) and the router
    state after them against JAX's (JAX tests/test_models.py:274, 297,
    312); lambda_bal raises the first loss above the unbalanced one."""
    jm = _zoo_transformer(ff, lambda_bal, lm)
    pm = _zoo_transformer(pt, lambda_bal, lm)
    assert [(op.name, op.op_type.value, [t.dims for t in op.outputs])
            for op in pm.ops] == \
        [(op.name, op.op_type.value, [t.dims for t in op.outputs])
         for op in jm.ops]
    assert [op.name for op in pzoo.moe_expert_ops(pm)] == ["l1_moe_experts"]
    pt.params_from_jax(pm, jm.params)
    rng = np.random.RandomState(5)
    vocab = 50 if lm else 2
    for step in range(3):
        x = rng.randint(0, 50, size=(4, 8)).astype(np.int32)
        y = rng.randint(0, vocab, size=(4, 8, 1)).astype(np.int32)
        jl = jm.fit(x, y, batch_size=4, epochs=1)[0]["loss"]
        pl = pm.fit(x, y, batch_size=4, epochs=1)[0]["loss"]
        assert pl == pytest.approx(jl, rel=RTOL), step
    for v in ("dropped", "load"):
        np.testing.assert_array_equal(
            pm.state["l1_moe_experts"][v].numpy(),
            np.asarray(jm.state["l1_moe_experts"][v]), err_msg=v)
    assert float(pm.state["l1_moe_experts"]["dropped"]) > 0


def test_moe_encoder_trains_like_jax():
    """build_moe_encoder (the unfused path) with a mean pool and a 10-way
    head (JAX tests/test_models.py:185): two SGD steps' losses against
    JAX's, finite."""
    def build(pkg):
        cfg = (jzoo if pkg is ff else pzoo).MoeConfig(
            hidden_size=16, num_attention_heads=4, num_encoder_layers=1,
            num_exp=4, num_select=2)
        m = pkg.FFModel(_config(pkg, 4))
        inp = m.create_tensor([4, 8, 16])
        out = (jzoo if pkg is ff else pzoo).build_moe_encoder(m, inp, cfg)
        assert out.dims == (4, 8, 16)
        m.softmax(m.dense(m.mean(out, [1]), 10))
        return _compile(pkg, m, "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY",
                        lr=0.05)

    jm, pm = build(ff), build(pt)
    pt.params_from_jax(pm, jm.params)
    rng = np.random.RandomState(0)
    for step in range(2):
        x = rng.randn(4, 8, 16).astype(np.float32)
        y = rng.randint(0, 10, size=(4, 1)).astype(np.int32)
        jl = jm.fit(x, y, batch_size=4, epochs=1)[0]["loss"]
        pl = pm.fit(x, y, batch_size=4, epochs=1)[0]["loss"]
        assert np.isfinite(pl) and pl == pytest.approx(jl, rel=RTOL), step


def test_moe_steps_a_dispatch_equal_single_steps():
    """fit(steps_per_execution=3) (three eager steps on the CPU) gives the
    single steps' losses, weights and router state."""
    a = _zoo_transformer(pt, 0.01)
    b = _zoo_transformer(pt, 0.01)
    b.load_params(a.params)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 50, size=(12, 8)).astype(np.int32)
    y = rng.randint(0, 2, size=(12, 8, 1)).astype(np.int32)
    a.fit(x, y, batch_size=4, epochs=1)
    b.fit(x, y, batch_size=4, epochs=1, steps_per_execution=3)
    # the dispatch's record holds its steps' f32 mean loss (JAX's
    # StepStats); the single steps' losses give the same mean to the bit
    singles = [r["loss"] for r in a.step_stats.records()]
    assert len(singles) == 3 and len(b.step_stats) == 1
    assert b.step_stats.records()[0]["loss"] == \
        float(np.asarray(singles, np.float32).mean())
    for op, vs in a.state.items():
        for v, t in vs.items():
            assert torch.equal(t, b.state[op][v]), (op, v)
    for op, ws in a.params.items():
        for w, t in ws.items():
            assert torch.equal(t, b.params[op][w]), (op, w)


def _recompile_pair(pkg):
    from flexflow_tpu.runtime import recompile as jrec
    from flexflow_tpu_torch.runtime import recompile as prec

    rec = jrec if pkg is ff else prec
    m = pkg.FFModel(_config(pkg, 8))
    inp = m.create_tensor([8, 16])
    cached = m.cache(inp, name="assign_cache")
    m.softmax(m.dense(cached, 4, name="head"))
    _compile(pkg, m, "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY", lr=0.0)
    fired = []

    def alter(model):
        fired.append(model._step_count)
        rec.moe_cache_alter(model)

    state = rec.RecompileState(
        rec.moe_cache_trigger(threshold=1e-6, warmup_steps=2), alter)
    m.recompile_on_condition(state)
    return m, state, fired


@pytest.mark.parametrize("k", [1, 2])
def test_moe_cache_switch_end_to_end_like_jax(k):
    """The cache serves its input until the scores settle, then the alter
    switches it to the cached tensor (JAX tests/test_recompile.py:81):
    the trigger fires once, at the same step count as JAX's, and the
    losses of the epochs before and after agree; with k = 2 the K-step
    dispatches after the alter use a new MultiStep."""
    x = np.tile(np.random.RandomState(0).randn(1, 16).astype(np.float32),
                (64, 1))
    y = np.zeros((64, 1), dtype=np.int32)
    (jm, js, jf), (pm, ps, pf) = _recompile_pair(ff), _recompile_pair(pt)
    pt.params_from_jax(pm, jm.params)
    jl = jm.fit(x, y, epochs=1)[0]["loss"]
    pl = pm.fit(x, y, epochs=1, steps_per_execution=k)[0]["loss"]
    assert pl == pytest.approx(jl, rel=RTOL)
    cache = [op for op in pm.ops if op.op_type.value == "cache"][0]
    assert cache.params.get("use_cached") is True
    assert js.fired == ps.fired == 1
    assert pf == jf == [2]
    jl = jm.fit(x, y, epochs=1)[0]["loss"]
    pl = pm.fit(x, y, epochs=1, steps_per_execution=k)[0]["loss"]
    assert np.isfinite(pl) and pl == pytest.approx(jl, rel=RTOL)


def test_invalidate_compiled_steps_drops_the_captured_dispatches():
    pm, _, _ = _recompile_pair(pt)
    before = pm._multi_step(2)
    step = pm._train_step
    pm.invalidate_compiled_steps()
    assert pm._multi_step(2) is not before and pm._train_step is not step


def test_publish_moe_metrics_matches_jax_exposition():
    """publish_moe_metrics after the dropping walks: the raw numbers and
    the registry's exposition text equal JAX's (counter deltas: a second
    publish adds only the new drops)."""
    from flexflow_tpu.obs import moe as jobs
    from flexflow_tpu.obs.registry import MetricsRegistry as JReg
    from flexflow_tpu_torch.obs import moe as pobs
    from flexflow_tpu_torch.obs.registry import MetricsRegistry as PReg

    jm, pm = _pair((32, 6), alpha=0.25)
    x = np.random.RandomState(3).randn(32, 6).astype(np.float32)
    jreg, preg = JReg(), PReg()
    for _ in range(2):
        _jax_walk(jm, x)
        _port_walk(pm, x)
        want = jobs.publish_moe_metrics(jm, registry=jreg)
        got = pobs.publish_moe_metrics(pm, registry=preg)
        assert got == want
        assert preg.render() == jreg.render()
    assert "ff_moe_router_dropped_tokens_total" in preg.render()
    pobs.reset_moe_publisher()
    jobs.reset_moe_publisher()


def test_fit_publishes_the_router_families_once_an_epoch():
    from flexflow_tpu_torch.obs.registry import REGISTRY

    pm = _zoo_transformer(pt, 0.01)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 50, size=(8, 8)).astype(np.int32)
    y = rng.randint(0, 2, size=(8, 8, 1)).astype(np.int32)
    pm.fit(x, y, batch_size=4, epochs=1)
    fam = REGISTRY.get("ff_moe_expert_load_imbalance")
    assert fam is not None and fam.value(op="l1_moe_experts") >= 1.0


def test_moe_ops_on_a_mesh_raise_naming_a8():
    """The MoE ops run on a mesh now (capacity from the global batch,
    tests/test_torch_axes.py holds the expert axis against JAX): a walk
    whose inputs the `data` axis did not cut (`in_cuts` empty: a batch it
    does not divide) gives the one-device values, for ExpertsOp, GroupByOp
    and AggregateOp."""
    from flexflow_tpu_torch.core.op import LoweringContext

    _, fused = _pair((8, 6))
    _, unfused = _pair((8, 6), fused=False)
    mesh = SimpleNamespace(size=lambda axis: 2 if axis == "data" else 1)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    g = torch.full((8, 2), 0.5)
    ids = torch.from_numpy(rng.randint(0, 4, (8, 2)).astype(np.int32))
    experts = [op for op in fused.ops if op.op_type.value == "experts"][0]
    gb = [op for op in unfused.ops if op.op_type.value == "group_by"][0]
    agg = [op for op in unfused.ops if op.op_type.value == "aggregate"][0]
    for op, args in ((experts, [x, g, ids]), (gb, [x, ids]),
                     (agg, [g, ids, ids, torch.zeros(8, 4)]
                      + [torch.ones(16, 5)] * 4)):
        outs = []
        for m in (mesh, None):
            ctx = LoweringContext(fused.config, CompMode.COMP_MODE_INFERENCE)
            ctx.mesh = m
            with torch.no_grad():
                outs.append(op.lower(ctx, args))
        for a, b in zip(*outs):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lambda_bal_without_full_gate_raises():
    m = pt.FFModel(_config(pt, 8))
    x = m.create_tensor([8, 6])
    g = m.create_tensor([8, 2])
    ids = m.create_tensor([8, 2], pt.DataType.DT_INT32)
    m.final_tensor = m.experts(x, g, ids, 4, 5, lambda_bal=0.1)
    # compile's plan analysis rejects the plan first (FFTA082, as JAX's
    # compile does); with the gate off, the lowering raises
    from flexflow_tpu_torch.analysis import PlanAnalysisError

    with pytest.raises(PlanAnalysisError, match="FFTA082"):
        _compile(pt, m)
    m.config.plan_analysis = "off"
    _compile(pt, m)
    feeds = {m.input_ops[0].name: torch.zeros(8, 6),
             m.input_ops[1].name: torch.zeros(8, 2),
             m.input_ops[2].name: torch.zeros(8, 2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="full_gate"):
        m.executor.forward_values(feeds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_takes_the_lower_index_among_ties_like_jax(dtype):
    """Planted ties, and a bf16 gate distribution near 1/256 (where ties
    are common): TopKOp's values and indices against jax.lax.top_k's."""
    rng = np.random.RandomState(9)
    x = np.array([[0.1, 0.5, 0.5, 0.2, 0.5], [0.3, 0.3, 0.3, 0.3, 0.3],
                  [0.0, 1.0, 0.0, 1.0, 0.0]], np.float32)
    near = (1 / 256 + rng.randint(-2, 3, size=(64, 256)) * 2**-16).astype(
        np.float32)
    for arr, k in ((x, 3), (near, 2)):
        m = pt.FFModel(_config(pt, arr.shape[0]))
        t = m.create_tensor(list(arr.shape))
        vals, idx = m.top_k(t, k)
        _compile(pt, m)
        with torch.no_grad():
            out = m.executor.forward_values(
                {m.input_ops[0].name: torch.from_numpy(arr).to(dtype)})
        jv, ji = jax.lax.top_k(jnp.asarray(arr, dtype=jnp.bfloat16
                                           if dtype == torch.bfloat16
                                           else jnp.float32), k)
        np.testing.assert_array_equal(out[idx.guid].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(out[vals.guid].float().numpy(),
                                      np.asarray(jv, np.float32))


@pytest.mark.parametrize("hidden,heads,mixed,want", [
    (64, 16, True, False), (64, 16, False, True), (64, 8, True, True),
    (1024, 16, True, True), (48, 4, True, False)])
def test_auto_attention_takes_flash_only_where_it_fits(
        monkeypatch, hidden, heads, mixed, want):
    """On a Hopper card auto picks the flash kernel only for head dims it
    takes in the compute dtype: MoeConfig()'s 64 over 16 heads (head dim
    4) in bf16 stays on the einsum core, where flash_route would raise;
    f32 (the CUDA-core route) takes any head dim."""
    from flexflow_tpu_torch.core.op import LoweringContext
    from flexflow_tpu_torch.kernels.flash_attention import flash_fits
    from flexflow_tpu_torch.kernels.registry import KERNELS

    monkeypatch.setattr(KERNELS, "_has_kernels", lambda device: True)
    m = pt.FFModel(pt.FFConfig(batch_size=2, allow_mixed_precision=mixed,
                               device="cpu"))
    t = m.create_tensor([2, 16, hidden])
    m.multihead_attention(t, t, t, hidden, heads)
    ctx = LoweringContext(m.config, CompMode.COMP_MODE_TRAINING)
    assert bool(m.ops[-1]._use_flash(ctx, "cuda")) == want
    dtype = torch.bfloat16 if mixed else torch.float32
    assert flash_fits(dtype, hidden // heads) == want
