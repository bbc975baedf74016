"""The mesh axes beside data x model on gloo ranks on the CPU, each held
against the JAX package on conftest's CPU devices from JAX's weights
(carried by `params_from_jax`): 3 steps of losses (relative 1e-4), the
gathered weights (rtol 1e-4, atol 5e-5, as tests/test_torch_tp.py) and
each rank's shard shapes against JAX's per-device shards.

 - `seq`: a 2-layer attention encoder (hidden 64, 4 heads, seq 16) on
   {"seq": 4}, ring and Ulysses (JAX's ring and Ulysses under
   shard_map), and `ring_attention` / `ulysses_attention` alone against
   JAX's on the same inputs, forward and gradients, causal and not;
 - `expert`: the JAX entry's MoE leg (8 experts, top-2) on
   {"data": 2, "expert": 2};
 - `attr`: an 8x8 conv stack with batch norm on {"data": 2, "attr": 2};
 - the Megatron row pair by strategy import on {"data": 2, "model": 2},
   fit(steps_per_execution=2);
 - the Unity search under the config where JAX's search cuts `seq`
   (tests/test_sequence_parallel_search.py's transformer): the same plan,
   run on 4 ranks.

All the ranks' jobs run in one spawn (flexflow_tpu_torch.tools.tp_train
`spawn_jobs`, which imports no jax) under one time limit.
"""
import json

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu_torch.tools.tp_train import MODELS, spawn_jobs

LOSS_REL = 1e-4
W_RTOL, W_ATOL = 1e-4, 5e-5
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
JOIN_S = 150
SP = dict(seq=16, hidden=64, heads=4, layers=2, ffn=True)
STEPS = 3


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32) if np.ndim(tree) else np.asarray(tree)


def _jax_model(name, widths, batch, axes, opt, seed, **config):
    """The tp_train graph `name` in the JAX package, compiled on `axes`
    (None: the plan from its config)."""
    cfg = ff.FFConfig()
    cfg.batch_size = batch
    cfg.allow_mixed_precision = False
    cfg.seed = seed
    cfg.num_devices = 4 if axes is None or axes else 1
    for k, v in config.items():
        setattr(cfg, k, v)
    jm = ff.FFModel(cfg)
    import flexflow_tpu.models  # noqa: F401

    MODELS[name](ff, jm, {"batch": batch, "use_flash": None}, **widths)
    jopt = (ff.SGDOptimizer(jm, lr=opt[1]) if opt[0] == "sgd"
            else ff.AdamOptimizer(jm, alpha=opt[1]))
    jm.compile(optimizer=jopt,
               loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ff.MetricsType.METRICS_ACCURACY],
               parallel_axes=axes)
    return jm


def _jax_run(name, widths, batch, axes, opt, x, y, seed=0, k=1,
             epochs=STEPS, **config):
    jm = _jax_model(name, widths, batch, axes, opt, seed, **config)
    shards = {op: {w: tuple(v.sharding.shard_shape(v.shape))
                   for w, v in ws.items()} for op, ws in jm.params.items()}
    init = _host(jm.params)
    hist = jm.fit(x, y, batch_size=batch, epochs=epochs,
                  steps_per_execution=k)
    return {"init": init, "shards": shards, "final": _host(jm.params),
            "losses": [h["loss"] for h in hist], "model": jm}


def _data(seed, x_shape, classes, y_shape, ints=None):
    rng = np.random.RandomState(seed)
    x = (rng.randint(0, ints, x_shape).astype(np.int32) if ints
         else rng.randn(*x_shape).astype(np.float32))
    return x, rng.randint(0, classes, y_shape).astype(np.int32)


def _attention_inputs(seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(2, 16, 4, 8).astype(np.float32)
            for n in ("q", "k", "v", "dout")}


# each case: name -> (tp_train job for the port, the JAX run's arguments)
def _cases(tmp_path):
    strat = {"mesh_axes": {"data": 2, "model": 2}, "cost_us": 0.0,
             "memory_bytes": 0.0,
             "ops": {"rp_fc1": {"dp": 2, "tp": 2, "ep": 1, "ap": 1,
                                "tp_row": False},
                     "rp_fc2": {"dp": 2, "tp": 2, "ep": 1, "ap": 1,
                                "tp_row": True}}}
    spath = str(tmp_path / "rowpair.json")
    with open(spath, "w") as f:
        json.dump(strat, f)
    sp_x, sp_y = _data(1, (4, 16, 64), 2, (4, 16, 1))
    moe_x, moe_y = _data(3, (8, 16), 3, (8, 1))
    row_x, row_y = _data(6, (16, 32), 4, (16, 1))
    conv_x, conv_y = _data(7, (8, 3, 8, 8), 4, (8, 1))
    srch_x, srch_y = _data(2, (2, 128), 4, (2, 128, 1), ints=100)
    search_cfg = dict(search_budget=8, enable_sequence_parallel=True,
                      use_native_search=False, num_devices=4)
    return {
        "seq_ring": ("sp_attn", dict(SP, mode="ring"), 4, {"seq": 4},
                     ("sgd", 0.1), sp_x, sp_y, {}, 1),
        "seq_ulysses": ("sp_attn", dict(SP, mode="ulysses"), 4,
                        {"seq": 4}, ("sgd", 0.1), sp_x, sp_y, {}, 1),
        "expert": ("moe", {}, 8, {"data": 2, "expert": 2},
                   ("adam", 1e-3), moe_x, moe_y, {}, 1),
        "attr_bn": ("conv", dict(batch_norm=True, convs=2), 8,
                    {"data": 2, "attr": 2}, ("sgd", 0.1), conv_x, conv_y,
                    {"enable_attribute_parallel": True}, 1),
        "row_pair_k2": ("row_mlp", {}, 8, None, ("sgd", 0.1), row_x,
                        row_y, {"import_strategy_file": spath,
                                "num_devices": 4}, 2),
        "seq_search": ("sp_search", {}, 2, None, ("sgd", 0.01), srch_x,
                       srch_y, search_cfg, 1),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's run of every case, and the port's on 4 gloo ranks from JAX's
    initial weights (one spawn: the cases, then the attention kernels)."""
    tmp = tmp_path_factory.mktemp("axes")
    cases = _cases(tmp)
    jax_runs, jobs = {}, []
    for name, (model, widths, batch, axes, opt, x, y, config,
               k) in cases.items():
        jr = _jax_run(model, widths, batch, axes, opt, x, y, k=k, **config)
        jax_runs[name] = jr
        opt_spec = (opt[0], opt[1]) + ((None,) if opt[0] == "adam" else ())
        jobs.append(dict(model=model, widths=widths, batch=batch, axes=axes,
                         mixed=False, optimizer=opt_spec, config=config,
                         params=jr["init"], x=x, y=y, steps=STEPS,
                         steps_per_execution=k, return_params=True))
    kernels = [(fn, causal) for fn in ("ring", "ulysses")
               for causal in (False, True)]
    for i, (fn, causal) in enumerate(kernels):
        jobs.append({"attention": dict(_attention_inputs(10 + i), fn=fn,
                                       causal=causal)})
    res = spawn_jobs(4, "cpu", jobs, timeout_s=JOIN_S,
                     workdir=str(tmp_path_factory.mktemp("rdv")))
    port = {name: [r["jobs"][i] for r in res]
            for i, name in enumerate(cases)}
    attn = {key: [r["jobs"][len(cases) + i] for r in res]
            for i, key in enumerate(kernels)}
    return jax_runs, port, attn


CASES = ["seq_ring", "seq_ulysses", "expert", "attr_bn", "row_pair_k2",
         "seq_search"]


@pytest.mark.parametrize("case", CASES)
def test_losses_match_jax(runs, case):
    """Each step's loss (a K = 2 dispatch's mean for the row pair, as
    JAX's epoch reports it) against JAX's on its mesh, on every rank."""
    jax_runs, port, _ = runs
    want = jax_runs[case]["losses"]
    for rank in port[case]:
        got = rank["record_losses"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g == pytest.approx(w, rel=LOSS_REL)


@pytest.mark.parametrize("case", CASES)
def test_weights_match_jax(runs, case):
    """The gathered weights after training against JAX's, on every
    rank."""
    jax_runs, port, _ = runs
    want = jax_runs[case]["final"]
    for rank in port[case]:
        assert set(rank["params"]) == set(want)
        for op, ws in want.items():
            for w, v in ws.items():
                np.testing.assert_allclose(rank["params"][op][w], v,
                                           rtol=W_RTOL, atol=W_ATOL,
                                           err_msg=f"{case} {op}/{w}")


@pytest.mark.parametrize("case", CASES)
def test_shard_shapes_match_jax_per_device_shards(runs, case):
    jax_runs, port, _ = runs
    for rank in port[case]:
        assert rank["shard_shapes"] == jax_runs[case]["shards"]


def test_each_axis_runs_its_path(runs):
    """What each mesh ran: the positions cut over `seq` on every
    position-wise op and the attention, the expert weights cut four ways
    (8 experts over 2 ranks), the conv, batch norm and pool on their H
    rows, the row pair paired (rp_fc1 ungathered), and K = 2 dispatches
    uncaptured with the reason."""
    _, port, _ = runs
    plan = port["seq_ring"][0]["roles"]
    assert {"sp_attn0", "sp_attn1", "sp_ff0a", "sp_ln0", "sp_cls"} <= \
        set(plan["seq_local"])
    assert port["expert"][0]["shard_shapes"]["moe_experts"]["kernel"] == \
        (4, 16, 16)
    assert set(port["attr_bn"][0]["roles"]["attr_local"]) >= {
        "ap_c1", "ap_bn1", "ap_c2", "ap_bn2", "ap_p1"}
    row = port["row_pair_k2"][0]
    assert row["roles"]["row_parallel"] == ["rp_fc2"]
    assert row["roles"]["unsharded_outputs"] == ["rp_fc1"]
    assert row["shard_shapes"]["rp_fc2"] == {"kernel": (32, 32),
                                             "bias": (32,)}
    assert row["multi_step"]["captured"] is False
    assert "CPU" in row["multi_step"]["reason"]
    for case in CASES[:-1]:
        ranks = port[case]
        assert len({r["replicated_digest"] for r in ranks}) == 1, case


def test_search_picks_jax_plan_and_runs_it(runs):
    """Under the config where JAX's search cuts `seq` (data 2 x seq 2 on 4
    devices), the port's search picks the same plan, and the mesh trains
    it (the losses above)."""
    jax_runs, port, _ = runs
    jm = jax_runs["seq_search"]["model"]
    assert "seq" in jm.search_result.mesh_axes
    want = {op.name: [s.dp, s.tp, s.ep, s.ap, s.sp]
            for op in jm.graph.topo_order()
            for g, s in jm.search_result.strategies.items() if g == op.guid}
    for rank in port["seq_search"]:
        assert rank["plan"]["axes"] == jm.search_result.mesh_axes
        assert rank["plan"]["degrees"] == want
    assert "attn" in port["seq_search"][0]["roles"]["seq_local"]


def _jax_attention(fn, causal, inputs):
    """JAX's ring / Ulysses attention under shard_map on 4 CPU devices:
    the output and the gradients of q, k, v for the cotangent dout."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flexflow_tpu.kernels.ring_attention import ring_attention_sharded
    from flexflow_tpu.kernels.ulysses_attention import \
        ulysses_attention_sharded

    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    f = ring_attention_sharded if fn == "ring" else ulysses_attention_sharded
    q, k, v, dout = (jnp.asarray(inputs[n]) for n in ("q", "k", "v", "dout"))

    def run(q, k, v):
        return f(q, k, v, mesh, "seq", causal=causal)

    out, vjp = jax.vjp(jax.jit(run), q, k, v)
    return [np.asarray(t) for t in (out, *vjp(dout))]


@pytest.mark.parametrize("fn", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_kernels_match_jax(runs, fn, causal):
    """ring_attention / ulysses_attention alone on 4 ranks, each holding a
    quarter of the positions, against JAX's on the same inputs: the
    output and the gradients of q, k and v (f32)."""
    _, _, attn = runs
    i = [("ring", False), ("ring", True), ("ulysses", False),
         ("ulysses", True)].index((fn, causal))
    want = _jax_attention(fn, causal, _attention_inputs(10 + i))
    ranks = attn[(fn, causal)]
    for j, key in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([r[key] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want[j], err_msg=key, **KERNEL_TOL)
