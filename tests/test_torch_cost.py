"""The cost model on the CPU (ROADMAP A7.1, A7.2): the port's machine
models, op cost hooks, CostModel, Simulator, OpCostCache and the kernel
registry's cost side and residual evidence against the JAX package's,
on the same specs and the same graphs built from the same builder code
in both packages (no weights are drawn: pricing reads shapes only).

Tolerance: machine-model values 1e-12 relative; flops, bytes and memory
exact; forward / backward / simulated step times 1e-9 relative (the same
float expressions in the same order; the margin covers a reordered sum).
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu import models as jzoo
from flexflow_tpu.kernels import registry as jreg
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import simulator as jsim
from flexflow_tpu_torch import models as pzoo
from flexflow_tpu_torch.kernels import registry as preg
from flexflow_tpu_torch.search import machine_model as pmm
from flexflow_tpu_torch.search import simulator as psim
from tests.test_torch_zoo import one_torch_thread

# the modules (each package's obs/__init__ binds `refit` to the function)
jrefit = importlib.import_module("flexflow_tpu.obs.refit")
prefit = importlib.import_module("flexflow_tpu_torch.obs.refit")

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

MM_REL = 1e-12
SIM_REL = 1e-9
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, rel):
    if isinstance(a, dict):
        assert set(a) == set(b), (set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], rel)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=rel, abs=0.0), (a, b)
    else:
        assert a == b, (a, b)


# -- machine models --------------------------------------------------------
TIERED = {"chip": "tpu-v5e",
          "tiers": [{"name": "ici", "degree": 4, "gbps": 45.0, "links": 2},
                    {"name": "dcn", "degree": 2, "gbps": 3.125, "links": 1,
                     "latency_us": 10.0}]}
THREE_TIERS = {"tiers": [{"name": "chip", "degree": 2, "gbps": 90.0},
                         {"name": "host", "degree": 4, "gbps": 45.0},
                         {"name": "dcn", "degree": 2, "gbps": 3.125,
                          "links": 1}]}
ONE_TIER = {"tiers": [{"name": "ici", "degree": 8, "gbps": 45.0}]}
# the GPU cluster of the port's docstring: 8-card NVLink hosts on IB
GPU_TIERS = {"chip": "h100-sxm",
             "tiers": [{"name": "nvlink", "degree": 8, "gbps": 450.0,
                        "links": 1},
                       {"name": "ib", "degree": 4, "gbps": 50.0,
                        "links": 1}]}
TOPOLOGY = {"num_chips": 6, "links": [[0, 1, 40.0], [1, 2, 40.0],
                                      [2, 3, 40.0], [3, 4, 40.0],
                                      [4, 5, 40.0], [5, 0, 40.0],
                                      [0, 3, 40.0]],
            "segment_mb": 0.5, "routing": "single"}


def _machines(mm):
    v5e = mm.CHIP_SPECS["tpu-v5e"]
    grid = np.zeros((4, 4))
    for i in range(4):
        for j in (i ^ 1, i ^ 2):
            grid[i][j] = 1
    return {
        "simple8": mm.SimpleMachineModel(8, v5e),
        "pod8": mm.TpuPodModel(8),
        "pod16_v4": mm.TpuPodModel(16, mm.CHIP_SPECS["tpu-v4"]),
        "pod6_cross": mm.TpuPodModel(6, chips_per_pod=2),
        "ring8": mm.NetworkedMachineModel(8),
        "grid4": mm.NetworkedMachineModel(4, connection=grid, link_gbps=30.0),
        "topology": mm.NetworkedMachineModel.from_json(TOPOLOGY),
        "empty_links": mm.NetworkedMachineModel.from_json({"num_chips": 3}),
        "tiered": mm.HierarchicalMachineModel.from_json(TIERED),
        "three": mm.HierarchicalMachineModel.from_json(THREE_TIERS),
        "one_tier": mm.HierarchicalMachineModel.from_json(ONE_TIER),
    }


def _probe(m):
    """Every priced quantity of machine model `m` over a grid of sizes."""
    out = {"n": m.num_chips, "version": m.version(),
           "channels": m.comm_channels(),
           "budget": m.memory_budget_bytes()}
    for fl, by, db in ((1e9, 1e6, 2), (3e6, 8e8, 4), (0.0, 0.0, 2)):
        out[f"compute_{fl}_{by}_{db}"] = m.compute_time_us(fl, by, db)
    tiered = hasattr(m, "tier_path")
    for b in (1e3, 3.3e6, 2.5e8):
        out[f"p2p_{b}"] = m.p2p_time_us(b)
        out[f"p2p1_{b}"] = m.p2p_single_path_time_us(b)
        for n in (1, 2, 3, 4, 8, 16):
            out[f"bw_{n}"] = m.link_bw(n)
            inners = (1, 2, 4) if tiered else (1,)
            for inner in inners:
                kw = {"inner": inner} if tiered else {}
                key = f"{b}_{n}_{inner}"
                out["ar_" + key] = m.allreduce_time_us(b, n, **kw)
                out["ag_" + key] = m.allgather_time_us(b, n, **kw)
                out["rs_" + key] = m.reduce_scatter_time_us(b, n, **kw)
                out["a2a_" + key] = m.all_to_all_time_us(b, n, **kw)
                if tiered:
                    out["path_" + key] = [(t.name, k) for t, k
                                          in m.tier_path(n, inner)]
                    out["cross_" + key] = m.crosses_tier_boundary(n, inner)
                    out["choice_" + key] = m.reduction_choice(b, n, inner)
                    out["hop_" + key] = m.ring_hop_time_us(b, n, inner)
                    for st in ("auto",) + jmm.REDUCTION_STRATEGIES:
                        out[f"ar_{st}_{key}"] = m.allreduce_time_us(
                            b, n, inner=inner, strategy=st)
                        out[f"dcn_{st}_{key}"] = m.dcn_step_bytes(
                            b, n, inner=inner, strategy=st)
    if hasattr(m, "avg_hops"):
        out["hops"] = m.avg_hops()
        out["diversity"] = m.path_diversity()
    return out


@pytest.mark.parametrize("name", sorted(_machines(jmm)))
def test_machine_models_price_like_jax(name):
    _close(_probe(_machines(pmm)[name]), _probe(_machines(jmm)[name]),
           MM_REL)


@pytest.mark.parametrize("name", ["pod8", "ring8", "tiered", "one_tier"])
def test_machine_overlay_prices_like_jax(name):
    """A fitted profile's coefficients (per-dtype rates, memory and link
    scales, per-tier scales, latencies) overlaid in both packages."""
    def coeffs(mod):
        return mod.FittedCoefficients(
            compute_scale={"bf16": 0.5, "f32": 0.25}, hbm_scale=0.8,
            link_bw_scale=0.6, tier_link_scales={"dcn": 0.3},
            dispatch_latency_us=4.5, collective_latency_us=7.25,
            step_scale=1.7)

    jm, pm_ = _machines(jmm)[name], _machines(pmm)[name]
    jm.apply_overlay(coeffs(jrefit))
    pm_.apply_overlay(coeffs(prefit))
    _close(_probe(pm_), _probe(jm), MM_REL)
    assert pm_.step_time_scale == jm.step_time_scale == 1.7


@pytest.mark.parametrize("spec", [
    {}, {"tiers": []}, {"tiers": [{"name": "a", "gbps": 1.0}]},
    {"tiers": [{"name": "a", "degree": "x", "gbps": 1.0}]},
    {"tiers": [{"name": "a", "degree": 2, "gbps": 1.0},
               {"name": "a", "degree": 2, "gbps": 1.0}]},
    {"tiers": [{"name": "a", "degree": 0, "gbps": 1.0}]},
    {"chip": "tpu-v9", "tiers": [{"name": "a", "degree": 2, "gbps": 1.0}]},
    {"num_chips": 6, "tiers": [{"name": "a", "degree": 2, "gbps": 1.0}]},
])
def test_from_json_errors_like_jax(spec):
    with pytest.raises(ValueError) as je:
        jmm.HierarchicalMachineModel.from_json(spec)
    with pytest.raises(ValueError) as pe:
        pmm.HierarchicalMachineModel.from_json(spec)
    if "chip" in spec:
        # the choices listed differ by the port's h100-sxm
        assert str(pe.value).split(";")[0] == str(je.value).split(";")[0]
        assert "h100-sxm" in str(pe.value)
    else:
        assert str(pe.value) == str(je.value)


def test_routing_error_and_spec_num_chips_like_jax():
    for mm in (jmm, pmm):
        with pytest.raises(ValueError, match="routing"):
            mm.NetworkedMachineModel(2, routing="bogus")
    for spec in (TIERED, THREE_TIERS, TOPOLOGY, {"num_chips": 5},
                 {"links": [[0, 7, 1.0]]}, {}):
        assert pmm.spec_num_chips(spec) == jmm.spec_num_chips(spec)


def test_h100_spec_and_gpu_tiers():
    """The port's own entries: the H100's data-sheet figures, two-link
    NVSwitch ring (450 GB/s each way a card), and the GPU cluster spec:
    a collective inside a host rides NVLink, one across hosts the IB
    tier."""
    chip = pmm.CHIP_SPECS["h100-sxm"]
    assert (chip.peak_bf16_tflops, chip.peak_f32_tflops, chip.hbm_gb,
            chip.hbm_bw_gbps, chip.vmem_mb, chip.ici_link_gbps,
            chip.ici_links_per_chip, chip.dcn_gbps) == (
        989.0, 67.0, 80.0, 3350.0, 50.0, 225.0, 2, 50.0)
    assert pmm.TpuPodModel(8, chip).link_bw(8) == 450e9
    assert pmm.TpuPodModel(8, chip).memory_budget_bytes() == 80e9
    # 1 GFLOP of bf16 is 1e9 / 989e12 s; a 3.35 GB read is 1 ms
    m = pmm.SimpleMachineModel(1, chip)
    assert m.compute_time_us(989e9, 0, 2) == pytest.approx(1e3 + 1.0)
    assert m.compute_time_us(0, 3.35e9, 4) == pytest.approx(1e3 + 1.0)
    g = pmm.HierarchicalMachineModel.from_json(GPU_TIERS)
    assert g.num_chips == 32 and g.chip.name == "h100-sxm"
    assert [(t.name, n) for t, n in g.tier_path(8)] == [("nvlink", 8)]
    assert [(t.name, n) for t, n in g.tier_path(4, inner=8)] == [("ib", 4)]
    b = 1e8
    assert g.allreduce_time_us(b, 8) == pytest.approx(
        2.0 * 7 / 8 * b / 450e9 * 1e6 + 1.0)
    assert g.allreduce_time_us(b, 4, inner=8) == pytest.approx(
        2.0 * 3 / 4 * b / 50e9 * 1e6 + 1.0)
    strat, _, tiers = g.reduction_choice(b, 32)
    assert strat in (pmm.REDUCTION_RS_AR_AG, pmm.REDUCTION_HIER_RING)
    assert [t["tier"] for t in tiers] == ["nvlink", "ib"]
    assert g.dcn_step_bytes(b, 8) == 0.0 and g.dcn_step_bytes(b, 32) > 0


def test_make_machine_model_picks_the_chip_by_device(tmp_path):
    """CUDA config -> the H100 spec, CPU -> JAX's default v5e; a
    hierarchical spec's "chip" wins either way; version and file pick
    the class as in JAX."""
    for device, chip in (("cuda", "h100-sxm"), ("cuda:0", "h100-sxm"),
                         ("cpu", "tpu-v5e")):
        c = pt.FFConfig(device=device)
        m = pmm.make_machine_model(c, 4)
        assert type(m) is pmm.SimpleMachineModel and m.chip.name == chip
        c.machine_model_version = 1
        assert type(pmm.make_machine_model(c, 4)) is pmm.TpuPodModel
        path = str(tmp_path / "spec.json")
        json.dump({"tiers": TIERED["tiers"]}, open(path, "w"))
        c.machine_model_file = path
        m = pmm.make_machine_model(c, 4)
        assert type(m) is pmm.HierarchicalMachineModel
        assert m.chip.name == chip
        json.dump(TIERED, open(path, "w"))
        assert pmm.make_machine_model(c, 4).chip.name == "tpu-v5e"
        json.dump(TOPOLOGY, open(path, "w"))
        m = pmm.make_machine_model(c, 4)
        assert type(m) is pmm.NetworkedMachineModel and m.chip.name == chip
    # the same factory in JAX on the same CPU spec files
    jc = ff.FFConfig()
    jc.machine_model_file = path
    jm = jmm.make_machine_model(jc, 4)
    pc = pt.FFConfig(device="cpu", machine_model_file=path)
    _close(_probe(pmm.make_machine_model(pc, 4)), _probe(jm), MM_REL)


# -- graphs: the zoo at small widths ---------------------------------------
def _config(pkg, mixed=False, kernel_impl="auto"):
    if pkg is pt:
        return pt.FFConfig(batch_size=4, allow_mixed_precision=mixed,
                           device="cpu", kernel_impl=kernel_impl)
    c = ff.FFConfig()
    c.num_devices = 1
    c.batch_size = 4
    c.allow_mixed_precision = mixed
    c.kernel_impl = kernel_impl
    return c


def _bert(pkg, m):
    z = jzoo if pkg is ff else pzoo
    t = m.create_tensor([2, 16], pkg.DataType.DT_INT32)
    z.build_bert_encoder(m, t, z.TransformerConfig(
        hidden_size=32, embedding_size=32, num_heads=4, num_layers=2,
        sequence_length=16, vocab_size=50))


def _mlp(pkg, m):
    t = m.create_tensor([8, 16])
    t = m.dense(t, 32, pkg.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 32, pkg.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 4)
    m.softmax(t)


def _resnet(pkg, m):
    z = jzoo if pkg is ff else pzoo
    z.build_resnet(m, m.create_tensor([2, 3, 32, 32]), stages=(1, 1))


def _nmt(pkg, m):
    z = jzoo if pkg is ff else pzoo
    src = m.create_tensor([2, 6], pkg.DataType.DT_INT32)
    tgt = m.create_tensor([2, 6], pkg.DataType.DT_INT32)
    z.build_lstm_nmt(m, src, tgt, src_vocab=50, tgt_vocab=50, embed_dim=8,
                     hidden_size=16, num_layers=2)


def _dlrm(pkg, m):
    z = jzoo if pkg is ff else pzoo
    c = z.DLRMConfig(sparse_feature_size=8, embedding_size=[100, 100],
                     embedding_bag_size=2, mlp_bot=[4, 16, 8],
                     mlp_top=[8, 16, 2])
    dense = m.create_tensor([8, 4])
    sparse = [m.create_tensor([8, 2], pkg.DataType.DT_INT32)
              for _ in c.embedding_size]
    z.build_dlrm(m, dense, sparse, c)


def _moe(pkg, m):
    z = jzoo if pkg is ff else pzoo
    c = z.MoeTransformerConfig(hidden_size=16, num_heads=2, num_layers=2,
                               num_experts=4, top_k=2, moe_every=2,
                               vocab_size=50, capacity_factor=0.5)
    z.build_moe_lm(m, m.create_tensor([4, 8], pkg.DataType.DT_INT32), c)


def _moe_encoder(pkg, m):
    z = jzoo if pkg is ff else pzoo
    c = z.MoeConfig(hidden_size=16, num_attention_heads=2,
                    num_encoder_layers=1, num_exp=4, num_select=2)
    z.build_moe_encoder(m, m.create_tensor([4, 6, 16]), c)


GRAPHS = {"bert": _bert, "mlp": _mlp, "resnet": _resnet, "nmt": _nmt,
          "dlrm": _dlrm, "moe": _moe, "moe_encoder": _moe_encoder}


def _pair(name, **kw):
    """(jax model, port model), the same builder in each; the ops pair up
    by construction order and carry the same names."""
    out = []
    for pkg in (ff, pt):
        m = pkg.FFModel(_config(pkg, **kw))
        GRAPHS[name](pkg, m)
        out.append(m)
    jm, pm_ = out
    assert [o.name for o in jm.ops] == [o.name for o in pm_.ops]
    return jm, pm_


def _strategies(pkg_sim, model, kind):
    S = pkg_sim.OpStrategy
    if kind == "default":
        return {}
    if kind == "dp":
        return {op.guid: S(dp=4) for op in model.ops}
    return {op.guid: (S(dp=4, tp=2) if op.op_type.value in
                      {t.value for t in pkg_sim.TP_CAPABLE} else S(dp=4))
            for op in model.ops}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_op_hooks_match_jax(name):
    """flops, bytes_accessed, cost_key (its repr: the op-cost cache's
    file key) and op_memory_bytes under each strategy, op by op."""
    jm, pm_ = _pair(name)
    jc = jsim.CostModel(jmm.TpuPodModel(8), jm.config)
    pc = psim.CostModel(pmm.TpuPodModel(8), pm_.config)
    for kind in ("default", "dp", "dptp"):
        js, ps = (_strategies(jsim, jm, kind), _strategies(psim, pm_, kind))
        for jo, po in zip(jm.ops, pm_.ops):
            assert po.flops() == jo.flops(), po.name
            assert po.bytes_accessed() == jo.bytes_accessed(), po.name
            assert repr(po.cost_key()) == repr(jo.cost_key()), po.name
            assert pc.op_memory_bytes(po, ps.get(po.guid, psim.OpStrategy())) \
                == jc.op_memory_bytes(jo, js.get(jo.guid, jsim.OpStrategy()))


def _sim_probe(sim, cost, model, strategies, mod):
    default = mod.OpStrategy()
    out = {"step": sim.simulate(model.graph_for_test, strategies),
           "sync": sim.last_sync_stats,
           "memory": sim.memory_bytes(model.graph_for_test, strategies)}
    out["plan"] = cost.reduction_plan(model.graph_for_test, strategies)
    for b in out["sync"]["buckets"]:
        b["strategy"] = str(b["strategy"])
    for op in model.ops:
        s = strategies.get(op.guid, default)
        out[op.name] = (cost.forward_time_us(op, s),
                        cost.backward_time_us(op, s),
                        cost.grad_sync_time_us(op, s),
                        cost.tp_collective_time_us(op, s),
                        cost.kernel_time_factor(op, s))
    return out


@pytest.mark.parametrize("kernel_impl", ["auto", "pallas"])
@pytest.mark.parametrize("machine", ["pod8", "tiered"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_simulator_matches_jax(name, machine, kernel_impl):
    """CostModel forward / backward (with the kernel tier's factor) and
    Simulator.simulate, memory_bytes, last_sync_stats and reduction_plan
    under default, dp and dp x tp strategies; kernel_impl="pallas" holds
    kernel_time_factor and PALLAS_COST_GAIN (auto on the CPU: 1.0 in
    both)."""
    jm, pm_ = _pair(name, mixed=True, kernel_impl=kernel_impl)
    jm.graph_for_test = jsim.Graph(jm.ops)
    pm_.graph_for_test = psim.Graph(pm_.ops)
    for kind in ("default", "dp", "dptp"):
        js, ps = (_strategies(jsim, jm, kind), _strategies(psim, pm_, kind))
        jmach, pmach = _machines(jmm)[machine], _machines(pmm)[machine]
        jsm = jsim.Simulator(jmach, jm.config)
        psm = psim.Simulator(pmach, pm_.config)
        want = _sim_probe(jsm, jsm.cost, jm, js, jsim)
        got = _sim_probe(psm, psm.cost, pm_, ps, psim)
        _close(got, want, SIM_REL)


def test_kernel_factor_prices_pallas_and_gates_like_jax():
    """Forced kernels price at PALLAS_COST_GAIN in both; the structural
    gates (non-trailing norm axes, non-last softmax axis) keep 1.0."""
    assert preg.PALLAS_COST_GAIN == jreg.PALLAS_COST_GAIN
    assert {k.value: v for k, v in preg.OPTYPE_FAMILY.items()} == \
        {k.value: v for k, v in jreg.OPTYPE_FAMILY.items()}
    assert preg.RESIDUAL_ALIAS == jreg.RESIDUAL_ALIAS
    assert preg.RESIDUAL_CANDIDATE_THRESHOLD == \
        jreg.RESIDUAL_CANDIDATE_THRESHOLD
    factors = []
    for pkg, mm, sim in ((ff, jmm, jsim), (pt, pmm, psim)):
        m = pkg.FFModel(_config(pkg, kernel_impl="pallas"))
        inp = m.create_tensor([4, 16, 32])
        m.layer_norm(inp, [1], name="ln_axis1")
        m.softmax(inp, axis=0, name="sm_axis0")
        m.layer_norm(inp, [-1], name="ln")
        m.softmax(inp, name="sm")
        m.rms_norm(inp, [-1], name="rms")
        cost = sim.CostModel(mm.make_machine_model(m.config, 1), m.config)
        factors.append({op.name: cost.kernel_time_factor(op, sim.OpStrategy())
                        for op in m.ops[1:]})
    assert factors[0] == factors[1] == {"ln_axis1": 1.0, "sm_axis0": 1.0,
                                        "ln": 0.70, "sm": 0.75, "rms": 0.70}


def test_decode_step_time_matches_jax():
    jm, pm_ = _pair("bert", mixed=True, kernel_impl="pallas")
    for jo, po in zip(jm.ops, pm_.ops):
        if po.op_type.value != "multihead_attention":
            continue
        jc = jsim.CostModel(jmm.TpuPodModel(1), jm.config)
        pc = psim.CostModel(pmm.TpuPodModel(1), pm_.config)
        for b, m, c in ((8, 1024, 1), (1, 7, 4), (64, 512, 16)):
            assert pc.decode_step_time_us(po, b, m, c) == pytest.approx(
                jc.decode_step_time_us(jo, b, m, c), rel=SIM_REL)


def test_plan_sync_buckets_and_sp_helpers_match_jax():
    jm, pm_ = _pair("bert")
    for jo, po in zip(jm.ops, pm_.ops):
        assert psim.sp_capability(po) == jsim.sp_capability(jo)
        for sp in (1, 2, 4, 3):
            assert psim.sp_shardable(po, sp) == jsim.sp_shardable(jo, sp)
        assert psim.attn_kv_bytes(po, 2) == jsim.attn_kv_bytes(jo, 2)
        assert psim.attn_q_bytes(po, 2) == jsim.attn_q_bytes(jo, 2)
        assert psim.attn_sp_ulysses(po) == jsim.attn_sp_ulysses(jo)
        assert psim.ap_halo_elems(po) == jsim.ap_halo_elems(jo)
    jr, pr = _pair("resnet")
    assert [psim.ap_halo_elems(o) for o in pr.ops] == \
        [jsim.ap_halo_elems(o) for o in jr.ops]
    items = [(i, psim.OpStrategy(dp=2), ("k", i % 2), float(b))
             for i, b in enumerate((5, 9, 30, 1, 2, 40, 3))]
    jitems = [(i, jsim.OpStrategy(dp=2), k, b) for i, _, k, b in items]
    got = psim.plan_sync_buckets(items, 12.0)
    want = jsim.plan_sync_buckets(jitems, 12.0)
    assert [(b["key"], [o for o, _ in b["ops"]], b["bytes"]) for b in got] \
        == [(b["key"], [o for o, _ in b["ops"]], b["bytes"]) for b in want]


def test_reshard_cost_raises_naming_a8():
    """reshard_cost_us prices a schedule as JAX's does (a chunked gather
    and slice, and a cross-mesh transfer) on the pod model."""
    import numpy as np

    from flexflow_tpu import resharding as jrs
    from flexflow_tpu_torch import resharding as prs

    costs = {}
    for pkg, sim, mm in ((jrs, jsim, jmm), (prs, psim, pmm)):
        mesh = pkg.MeshSpec(device_ids=(0, 1, 2, 3),
                            axes=(("data", 2), ("model", 2)))
        old = pkg.ShardingPlan(mesh=mesh, arrays={
            "w": pkg.ArraySpec((2, 1), ("data", None))})
        new = pkg.ShardingPlan(mesh=mesh, arrays={
            "w": pkg.ArraySpec((1, 2), (None, "model"))})
        other = pkg.ShardingPlan(mesh=pkg.MeshSpec(
            device_ids=(0, 1, 2, 3), axes=(("data", 4),)))
        tree = {"w": np.zeros((64, 32), np.float32)}
        costs[pkg] = [sim.reshard_cost_us(pkg.plan_redistribution(
            tree, old, n, peak_bytes=p), mm.TpuPodModel(4))
            for n in (new, other) for p in (1 << 30, 2048)]
    assert all(c > 0 for c in costs[prs])
    assert costs[prs] == pytest.approx(costs[jrs], rel=1e-12)


# -- OpCostCache mechanics -------------------------------------------------
def _linear(model):
    return next(op for op in model.ops if op.op_type.value == "linear")


def _mlp_model(**kw):
    m = pt.FFModel(_config(pt, **kw))
    _mlp(pt, m)
    return m


def test_op_cost_cache_keys_hits_and_tp():
    """Keys are JAX's (cost_key, dp, mixed[, tp]); an identical op of a
    fresh model hits; a tp-sharded measurement is a fresh entry at the
    sharded weight shape; analytic scaling for the unmeasured degrees."""
    model = _mlp_model()
    cache = psim.OpCostCache(model.config, warmup=1, repeats=2)
    op = _linear(model)
    fwd, bwd = cache.measure_us(op, psim.OpStrategy())
    assert fwd > 0 and bwd >= 0
    assert cache.misses == 1 and cache.hits == 0
    assert list(cache.cache) == [(op.cost_key(), 1, False)]
    fwd2, _ = cache.measure_us(_linear(_mlp_model()), psim.OpStrategy())
    assert cache.hits == 1 and fwd2 == fwd
    fwd_tp, _ = cache.measure_us(op, psim.OpStrategy(tp=2))
    assert cache.misses == 2 and fwd_tp > 0
    assert (op.cost_key(), 1, False, 2) in cache.cache
    # a tp degree on an op that cannot shard reuses the unsharded point
    sm = next(o for o in model.ops if o.op_type.value == "softmax")
    assert cache.measure_us(sm, psim.OpStrategy(tp=4)) == \
        cache.measure_us(sm, psim.OpStrategy())
    assert cache.stats().startswith("measured-cost cache: ")


def test_op_cost_cache_failure_recorded_and_dp_fallback():
    """A failed measurement is recorded and logged (JAX
    tests/test_search.py:425): the simulator prices it analytically and
    counts the fallback; a failed tp-sharded key falls back to the
    measured dp point over tp on its next query."""
    model = _mlp_model()
    op = _linear(model)

    class BrokenCache(psim.OpCostCache):
        def _measure(self, op, dp, tp=1, **kw):
            raise RuntimeError("no device")

    cache = BrokenCache(model.config)
    sim = psim.Simulator(pmm.TpuPodModel(4), model.config, measured=cache)
    assert sim.op_step_time_us(op, psim.OpStrategy()) > 0
    assert sim.analytic_fallbacks == 1
    assert len(cache.failures) == 1
    assert "RuntimeError: no device" in next(iter(cache.failures.values()))

    class TpBroken(psim.OpCostCache):
        def _measure(self, op, dp, tp=1, **kw):
            if tp > 1:
                raise RuntimeError("tp shape")
            return 40.0, 80.0

    cache = TpBroken(model.config)
    assert cache.measure_us(op, psim.OpStrategy(tp=2)) == (-1.0, -1.0)
    assert cache.measure_us(op, psim.OpStrategy(tp=2)) == (20.0, 40.0)
    assert cache.failure_hits == 1


def test_op_cost_cache_file_reads_across_packages(tmp_path):
    """A file saved by the port's cache hits in JAX's loader for the same
    op, and JAX's file in the port's (the string keys are the same
    reprs)."""
    pm_ = _mlp_model()
    jm = ff.FFModel(_config(ff))
    _mlp(ff, jm)
    path = str(tmp_path / "costs.json")
    pc = psim.OpCostCache(pm_.config, warmup=0, repeats=1, path=path)
    pc.cache[pc._key(_linear(pm_), 1)] = (12.5, 30.0)
    pc.save()
    jc = jsim.OpCostCache(jm.config, path=path)
    assert jc.measure_us(_linear(jm), jsim.OpStrategy()) == (12.5, 30.0)
    assert jc.hits == 1 and jc.misses == 0
    path2 = str(tmp_path / "jax_costs.json")
    jc2 = jsim.OpCostCache(jm.config, path=path2)
    jc2.cache[jc2._key(_linear(jm), 2)] = (7.0, -1.0)
    jc2.save()
    pc2 = psim.OpCostCache(pm_.config, path=path2)
    assert pc2.measure_us(_linear(pm_), psim.OpStrategy(dp=2)) == (7.0, -1.0)
    assert pc2.hits == 1


def test_get_op_cost_cache_is_process_wide(tmp_path):
    c = pt.FFConfig(device="cpu", op_cost_cache_file=str(tmp_path / "a"))
    a = psim.get_op_cost_cache(c)
    assert psim.get_op_cost_cache(c) is a and a.path == str(tmp_path / "a")
    c2 = dataclasses.replace(c, op_cost_cache_file=str(tmp_path / "b"))
    assert psim.get_op_cost_cache(c2) is not a


def test_measurement_leaves_the_model_alone():
    """Measuring every op (batch norm's running statistics, dropout's
    generator, the weights) leaves the model's bits as they were."""
    import torch

    m = pt.FFModel(_config(pt))
    t = m.create_tensor([4, 3, 8, 8])
    t = m.conv2d(t, 4, 3, 3, 1, 1, 1, 1)
    t = m.batch_norm(t)
    t = m.dropout(m.flat(t), 0.5)
    t = m.dense(t, 4)
    m.softmax(t)
    m.compile(generator=torch.Generator().manual_seed(3))
    snap = [(n, b.clone()) for op in m.ops
            for n, b in list(op.named_parameters()) + list(op.named_buffers())]
    gen = m.executor.generator.get_state().clone()
    cache = psim.OpCostCache(m.config, warmup=1, repeats=1)
    for op in m.ops:
        cache.measure_us(op, psim.OpStrategy())
        cache.measure_us(op, psim.OpStrategy(tp=2))
    after = [(n, b) for op in m.ops
             for n, b in list(op.named_parameters()) + list(op.named_buffers())]
    assert len(snap) == len(after)
    for (n, a), (_, b) in zip(snap, after):
        assert torch.equal(a, b), n
    assert torch.equal(gen, m.executor.generator.get_state())


# -- the kernel registry's residual evidence -------------------------------
def _profile(mod, path, residuals, thresholds=None, backend="cpu"):
    mod.FittedProfile(chip="cpu-host", backend=backend,
                      coefficients=mod.FittedCoefficients(),
                      op_family_residuals=residuals,
                      kernel_residual_thresholds=thresholds or {}).save(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_registry_residual_evidence_like_jax(tmp_path, writer):
    """JAX tests/test_pallas_kernels.py:276-420 against the port: the same
    profile (written by either package) gives the same select reasons
    past the backend gate and the same cost_factor. JAX's gate is passed
    with backend="tpu", the port's by a kernel-capable device (the
    capability check stubbed: there is no card here)."""
    path = str(tmp_path / "prof.json")
    _profile(jrefit if writer == "jax" else prefit, path,
             {"layernorm": 1.8, "softmax": 1.01, "attention": 2.0},
             {"rmsnorm": 0.5})
    jc, pc = ff.FFConfig(), pt.FFConfig(device="cpu")
    jc.fitted_profile_file = pc.fitted_profile_file = path
    jr, pr = jreg.KernelRegistry(), preg.KernelRegistry()
    jr.configure(jc)
    pr.configure(pc)
    pr._has_kernels = lambda device: True
    assert pr.residual("layernorm") == jr.residual("layernorm") == 1.8
    assert pr.residual_source == jr.residual_source == path
    for fam in ("layernorm", "softmax", "attention_decode",
                "attention_decode_mq", "rmsnorm"):
        j = jr.select(fam, backend="tpu", record=False)
        p = pr.select(fam, record=False)
        if j:
            assert (p.impl, p.reason) == (j.impl, j.reason), fam
        else:
            # JAX's no-evidence default is the reference lowering, the
            # port's the kernel (registry.py's documented difference)
            assert (p.impl, p.reason) == ("pallas", "default"), fam
    for heur in (True, False):
        j = jr.select("attention", backend="tpu", heuristic=lambda: heur,
                      record=False)
        p = pr.select("attention", heuristic=lambda: heur, record=False)
        assert (p.impl, p.reason) == (j.impl, j.reason)
    # the per-call config: its profile, not the configure()d default
    pr2, jr2 = preg.KernelRegistry(), jreg.KernelRegistry()
    pr2._has_kernels = lambda device: True
    assert pr2.select("layernorm", config=pc, record=False).reason == \
        jr2.select("layernorm", config=jc, backend="tpu",
                   record=False).reason == "residual"
    # the knob: the threshold when the profile fitted none for the family
    pc.kernel_residual_threshold = jc.kernel_residual_threshold = 2.5
    assert pr2.select("layernorm", config=pc, record=False).reason == \
        "default"
    assert jr2.select("layernorm", config=jc, backend="tpu",
                      record=False).reason == "default"
    # cost factors (on the CPU both packages price the reference)
    pr = preg.KernelRegistry()
    for fam in ("layernorm", "softmax", "attention"):
        assert pr.cost_factor(fam, config=pc) == \
            jr.cost_factor(fam, config=jc) == 1.0
    pk = dataclasses.replace(pc, kernel_impl="pallas")
    jk = ff.FFConfig()
    jk.kernel_impl = "pallas"
    for fam in jreg.FAMILIES:
        assert pr.cost_factor(fam, config=pk) == \
            jr.cost_factor(fam, config=jk) == jreg.PALLAS_COST_GAIN[fam]
    assert pr.cost_factor(None) == 1.0


def test_registry_declines_mismatched_profile(tmp_path):
    """A profile fitted on the other backend, or corrupt, gives no
    evidence (the registry declines it; the machine model raises)."""
    path = str(tmp_path / "gpu.json")
    _profile(prefit, path, {"layernorm": 3.0}, backend="gpu")
    pc = pt.FFConfig(device="cpu", fitted_profile_file=path)
    pr = preg.KernelRegistry()
    pr.configure(pc)
    assert pr.residual("layernorm") is None and pr.residual_source is None
    with pytest.raises(prefit.FittedProfileMismatch):
        pmm.make_machine_model(pc, 1)
    bad = str(tmp_path / "bad.json")
    open(bad, "w").write("{not json")
    pr.configure(dataclasses.replace(pc, fitted_profile_file=bad))
    assert pr.residual("layernorm") is None


def test_flash_crossover_is_the_ports_own():
    """The port's crossover is its H100 constant, not JAX's v5e 1e8: the
    heuristic is the shared formula over it (tests written when it was 0
    assume flash at every shape the registry saw)."""
    assert jreg.FLASH_SCORE_BYTES_CROSSOVER == 1e8
    c = preg.FLASH_SCORE_BYTES_CROSSOVER
    assert c >= 0.0
    for b, h, lq, lk in ((1, 16, 16, 16), (8, 16, 512, 512), (64, 16, 512,
                                                             512)):
        bytes_ = 4.0 * b * h * lq * lk
        assert preg.flash_crossover(b, h, lq, lk) == (bytes_ > c)
        assert jreg.flash_crossover(b, h, lq, lk) == (bytes_ > 1e8)


# -- the task-graph export -------------------------------------------------
def test_task_graph_export_like_jax(tmp_path):
    """compile() writes the cost-annotated dot under
    export_strategy_task_graph_file: JAX's node labels and edges."""
    import torch

    paths = {}
    for pkg in (ff, pt):
        c = _config(pkg)
        paths[pkg] = str(tmp_path / f"{pkg.__name__}.dot")
        c.export_strategy_task_graph_file = paths[pkg]
        m = pkg.FFModel(c)
        _mlp(pkg, m)
        if pkg is pt:
            m.compile(generator=torch.Generator().manual_seed(0))
        else:
            m.compile()
    import re

    def norm(text):
        # guids differ between packages: number nodes by first appearance
        ids = {}
        return re.sub(r"n(\d+)", lambda mt: "n%d" % ids.setdefault(
            mt.group(1), len(ids)), text)

    got, want = (open(paths[pt]).read(), open(paths[ff]).read())
    # each label carries its op's machine view in both packages
    assert "\\nMV[1@0]\\n" in got
    assert norm(got) == norm(want)
    assert got.startswith("digraph PCG {") and "fwd=" in got


# -- the rule of the port --------------------------------------------------
def test_new_modules_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import flexflow_tpu_torch\n"
        "import flexflow_tpu_torch.search.machine_model\n"
        "import flexflow_tpu_torch.search.simulator\n"
        "import flexflow_tpu_torch.analysis\n"
        "import flexflow_tpu_torch.analysis.passes\n"
        "import flexflow_tpu_torch.obs.calibration\n"
        "import flexflow_tpu_torch.obs.refit\n"
        "import flexflow_tpu_torch.obs.stepstats\n"
        "import flexflow_tpu_torch.runtime.profiling\n"
        "import flexflow_tpu_torch.kernels.registry\n"
        "import flexflow_tpu_torch.serving.sched.kvpool\n"
        "import flexflow_tpu_torch.serving.sched.continuous\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'flexflow_tpu'\n"
        "             or m.startswith('flexflow_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


