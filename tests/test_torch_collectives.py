"""The explicit gradient sync of the port (runtime/collectives.py
GradSyncLowering under `collective_lowering`, obs/collective_bench.py)
against the JAX package's, on four gloo ranks on the CPU with a two-tier
2 x 2 machine spec (tests/test_collectives.py's SPEC_4x2 made 2 x 2).
Adapted from tests/test_collectives.py:

 - lower_allreduce: flat, rs_ar_ag and hier_ring sum exactly over the
   data axis at lengths 16, 13 and 3 (13 and 3: the reduce-scatter's
   padding), and in bf16 within 2e-2 of the flat sum;
 - parity: the MLP of JAX's `_train` from JAX's weights trained under
   "explicit" within 1e-5 relative of "gspmd" (f32, JAX's own tolerance:
   a decomposed sum differs from the flat one by rounding) and of JAX's
   explicit losses (1e-4); the executed plan equals the priced plan,
   which equals JAX's, with at least one decomposed entry; on a flat
   machine every entry is flat; auto lowers the tiered plan and skips the
   flat one;
 - the fallbacks: a `model` axis raises CollectiveLoweringError under
   "explicit" and falls back under "auto", and so do ops with running
   state (batch norm), each naming its reason as JAX's does;
 - the counters and spans (`ff_collective_lowered_total`,
   `exec.grad_sync`), FFTA072 clean on the compiled plan and raised for
   a divergent lowering at compile, and the buckets: several fused
   buckets whose executed assignment equals the priced one, in parity
   with the per-tensor lowering;
 - `sweep_collectives`' rows and `fit_collective_coefficients` on them.

All the ranks' jobs run in one spawn under one time limit.
"""
import json

import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt

JOIN_S = 240
WORLD = 4
SPEC_2x2 = {"chip": "tpu-v5e", "tiers": [
    {"name": "ici", "degree": 2, "gbps": 45.0, "links": 2},
    {"name": "dcn", "degree": 2, "gbps": 3.125, "links": 1,
     "latency_us": 10.0}]}


def tiered_machine(port: bool):
    """SPEC_2x2's machine model in the port or the JAX package."""
    if port:
        from flexflow_tpu_torch.search.machine_model import \
            HierarchicalMachineModel
    else:
        from flexflow_tpu.search.machine_model import \
            HierarchicalMachineModel
    return HierarchicalMachineModel.from_json(SPEC_2x2)


def _data():
    x = np.random.RandomState(0).randn(32, 64).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 4, size=(32, 1)).astype(np.int32)
    return x, y


def _graph(m):
    lib = pt if isinstance(m, pt.FFModel) else ff
    x_t = m.create_tensor([16, 64])
    t = m.dense(x_t, 256, lib.ActiMode.AC_MODE_RELU, name="fc_big")
    t = m.dense(t, 64, name="fc_small")
    m.softmax(m.dense(t, 4, name="cls"))


def _jax_train(lowering, spec, bucket_bytes=None):
    """JAX's `_train` on four CPU devices: losses, executed and priced
    plans, and the initial weights."""
    cfg = ff.FFConfig()
    cfg.num_devices = WORLD
    cfg.batch_size = 16
    cfg.allow_mixed_precision = False
    cfg.seed = 7
    cfg.collective_lowering = lowering
    if bucket_bytes is not None:
        cfg.grad_bucket_bytes = bucket_bytes
    if spec is not None:
        cfg.machine_model_file = spec
    m = ff.FFModel(cfg)
    _graph(m)
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.05),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[ff.MetricsType.METRICS_ACCURACY],
              parallel_axes={"data": WORLD})
    init = {o: {w: np.asarray(v) for w, v in ws.items()}
            for o, ws in m.params.items()}
    x, y = _data()
    hist = m.fit([x], y, batch_size=16, epochs=2)
    low = m.executor.grad_sync_lowering
    return {"losses": [h["loss"] for h in hist], "init": init,
            "executed": low.executed_plan() if low else None,
            "buckets": low.executed_buckets() if low else None,
            "priced": {k: v["strategy"]
                       for k, v in (m._reduction_plan or {}).items()}}


# -- the ranks' side ---------------------------------------------------------
def _port_model(lowering, spec, bucket_bytes=None, axes=None, bn=False):
    import torch

    cfg = pt.FFConfig(batch_size=16, device="cpu",
                      allow_mixed_precision=False, seed=7,
                      collective_lowering=lowering)
    if bucket_bytes is not None:
        cfg.grad_bucket_bytes = bucket_bytes
    if spec is not None:
        cfg.machine_model_file = spec
    m = pt.FFModel(cfg)
    if bn:
        inp = m.create_tensor([16, 3, 8, 8])
        t = m.conv2d(inp, 4, 3, 3, 1, 1, 1, 1, name="c1")
        t = m.flat(m.batch_norm(t, name="bn"))
        m.softmax(m.dense(t, 4, name="cls2"))
    else:
        _graph(m)
    m.compile(optimizer=pt.SGDOptimizer(m, lr=0.05),
              loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[pt.MetricsType.METRICS_ACCURACY],
              parallel_axes=axes or {"data": WORLD},
              generator=torch.Generator().manual_seed(0))
    return m


def _train_job(job):
    from flexflow_tpu_torch.obs.tracing import (disable_tracing,
                                                enable_tracing, get_tracer)
    from flexflow_tpu_torch.runtime.collectives import (lowered_counter,
                                                        overlap_bucket_counter)

    disable_tracing()
    enable_tracing()
    m = _port_model(job["lowering"], job["spec"], job.get("bucket_bytes"))
    m.load_params(job["init"])
    x, y = _data()
    hist = m.fit([x], y, batch_size=16, epochs=2)
    low = m.executor.grad_sync_lowering
    out = {"losses": [h["loss"] for h in hist],
           "priced": {k: v["strategy"]
                      for k, v in (m._reduction_plan or {}).items()},
           "priced_buckets": {k: v.get("bucket")
                              for k, v in (m._reduction_plan or {}).items()},
           "ffta072": [d.code for d in m.analyze_plan().diagnostics
                       if d.code == "FFTA072"]}
    if low is not None:
        out.update(
            executed=low.executed_plan(), buckets=low.executed_buckets(),
            bucket_map=low.bucket_map(),
            sizes={k: list(e["sizes"]) for k, e in low.entries.items()},
            lowered={f"{e['strategy']}/{t}": lowered_counter().value(
                strategy=e["strategy"], tier=t)
                for e in low.entries.values() for t in e["tiers"]},
            bucket_counter=sum(overlap_bucket_counter().value(strategy=s)
                               for s in ("flat", "rs_ar_ag", "hier_ring")),
            spans=[e["args"] for e in get_tracer().events("exec.grad_sync")],
            bucket_spans=len(get_tracer().events("exec.grad_sync.bucket")))
    return out


def _lowering_sums():
    """lower_allreduce of each rank's row of arange(4 * L) over the data
    axis of four ranks, tiers (2, 2)."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.core.machine import make_mesh
    from flexflow_tpu_torch.runtime.collectives import (lower_allreduce,
                                                        make_tier_groups)

    mesh = make_mesh({"data": WORLD})
    tiers = make_tier_groups(mesh, [2, 2])
    rank = dist.get_rank()
    out = {}
    for strategy in ("flat", "rs_ar_ag", "hier_ring"):
        for length in (16, 13, 3):
            x = torch.arange(WORLD * length, dtype=torch.float32).reshape(
                WORLD, length)[rank].clone()
            out[f"{strategy}/{length}"] = lower_allreduce(
                x, strategy, tiers, mesh.group("data")).numpy()
    x = torch.from_numpy(np.random.RandomState(0).randn(WORLD, 24)
                         .astype(np.float32))[rank].to(torch.bfloat16)
    for strategy in ("flat", "rs_ar_ag"):
        out[f"bf16/{strategy}"] = lower_allreduce(
            x, strategy, tiers, mesh.group("data")).float().numpy()
    return out


def _fallbacks(spec):
    from flexflow_tpu_torch.runtime.collectives import \
        CollectiveLoweringError

    out = {}
    try:
        _port_model("explicit", spec, axes={"data": 2, "model": 2})
        out["explicit_model"] = None
    except CollectiveLoweringError as exc:
        out["explicit_model"] = str(exc)
    m = _port_model("auto", spec, axes={"data": 2, "model": 2})
    out["auto_model"] = (m.executor.grad_sync_lowering is None,
                         m._grad_sync is None)
    m2 = _port_model("auto", spec, bn=True)
    out["auto_state"] = m2.executor.grad_sync_lowering is None
    from flexflow_tpu_torch.runtime.collectives import \
        plan_grad_sync_lowering

    out["reasons_model"] = plan_grad_sync_lowering(
        m.config, m.graph, m.mesh, m._reduction_plan)[1]
    out["reasons_state"] = plan_grad_sync_lowering(
        m2.config, m2.graph, m2.mesh, m2._reduction_plan)[1]
    return out


def _divergent(spec):
    from flexflow_tpu_torch.analysis import PlanAnalysisError
    from flexflow_tpu_torch.runtime.collectives import GradSyncLowering

    orig = GradSyncLowering.executed_plan

    def dropped(self):
        out = orig(self)
        out.pop(next(iter(out)))
        return out

    GradSyncLowering.executed_plan = dropped
    try:
        _port_model("explicit", spec)
        return None
    except PlanAnalysisError as exc:
        return sorted({d.code for d in exc.report.errors()})
    finally:
        GradSyncLowering.executed_plan = orig


def _sweep(spec):
    from flexflow_tpu_torch.obs.collective_bench import sweep_collectives

    cfg = pt.FFConfig(device="cpu", machine_model_file=spec)
    res = sweep_collectives(cfg, [65536, 262144], ["flat", "rs_ar_ag"],
                            warmup=0, repeats=1)
    return {"tiers": res["tiers"],
            "rows": [r.to_dict() for r in res["rows"]]}


def _rank(rank, world, init, spec, jobs):
    import torch

    from flexflow_tpu_torch.runtime import distributed

    distributed.initialize(init, world_size=world, rank=rank, device="cpu")
    torch.set_num_threads(1)
    try:
        return {"sums": _lowering_sums(),
                "train": [_train_job(j) for j in jobs],
                "fallbacks": _fallbacks(spec),
                "divergent": _divergent(spec),
                "sweep": _sweep(spec)}
    finally:
        distributed.shutdown()


TRAINS = [("explicit", True, None), ("gspmd", True, None),
          ("auto", True, None), ("explicit", False, None),
          ("auto", False, None), ("explicit", True, 4096),
          ("explicit", True, 0)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from flexflow_tpu_torch.runtime.distributed import spawn

    tmp = tmp_path_factory.mktemp("collectives")
    spec = str(tmp / "spec_2x2.json")
    with open(spec, "w") as f:
        json.dump(SPEC_2x2, f)
    jax_runs = {("explicit", True): _jax_train("explicit", spec),
                ("gspmd", True): _jax_train("gspmd", spec)}
    init = jax_runs[("explicit", True)]["init"]
    jobs = [{"lowering": lo, "spec": spec if tiered else None,
             "bucket_bytes": bb, "init": init}
            for lo, tiered, bb in TRAINS]
    rdv = "file://" + str(tmp / "rdv")
    ranks = spawn(_rank, WORLD, (WORLD, rdv, spec, jobs), timeout_s=JOIN_S)
    trains = {t: [r["train"][i] for r in ranks]
              for i, t in enumerate(TRAINS)}
    return ranks, trains, jax_runs


@pytest.mark.parametrize("strategy", ["flat", "rs_ar_ag", "hier_ring"])
@pytest.mark.parametrize("length", [16, 13, 3])
def test_lower_allreduce_sums_exactly(runs, strategy, length):
    want = np.arange(WORLD * length, dtype=np.float32).reshape(
        WORLD, length).sum(axis=0)
    for r in runs[0]:
        np.testing.assert_allclose(r["sums"][f"{strategy}/{length}"], want,
                                   rtol=1e-6)


def test_lower_allreduce_bf16(runs):
    for r in runs[0]:
        np.testing.assert_allclose(r["sums"]["bf16/rs_ar_ag"],
                                   r["sums"]["bf16/flat"], rtol=2e-2,
                                   atol=1e-2)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-8)


def test_explicit_parity_f32(runs):
    _, trains, jax_runs = runs
    jx = jax_runs[("explicit", True)]
    for e, g in zip(trains[("explicit", True, None)],
                    trains[("gspmd", True, None)]):
        assert e["executed"] == e["priced"] == jx["executed"]
        assert any(len(s) > 1 for s in e["sizes"].values())
        for le, lg, lj in zip(e["losses"], g["losses"], jx["losses"]):
            assert _rel(le, lg) < 1e-5, (e["losses"], g["losses"])
            assert _rel(le, lj) < 1e-4, (e["losses"], jx["losses"])
    for lg, lj in zip(trains[("gspmd", True, None)][0]["losses"],
                      jax_runs[("gspmd", True)]["losses"]):
        assert _rel(lg, lj) < 1e-4


def test_explicit_on_flat_machine_is_flat(runs):
    _, trains, _ = runs
    for e, g in zip(trains[("explicit", False, None)],
                    trains[("gspmd", True, None)]):
        assert set(e["executed"].values()) == {"flat"}
        for le, lg in zip(e["losses"], g["losses"]):
            assert _rel(le, lg) < 1e-5


def test_auto_lowers_cross_tier_and_skips_flat(runs):
    _, trains, _ = runs
    assert all("executed" in r for r in trains[("auto", True, None)])
    assert not any("executed" in r for r in trains[("auto", False, None)])


def test_explicit_raises_and_auto_falls_back(runs):
    for r in runs[0]:
        fb = r["fallbacks"]
        assert fb["explicit_model"] and "model" in fb["explicit_model"]
        assert fb["auto_model"] == (True, True)
        assert any("model" in s for s in fb["reasons_model"])
        assert fb["auto_state"]
        assert any("state" in s for s in fb["reasons_state"])


def test_lowered_counter_and_grad_sync_span(runs):
    _, trains, _ = runs
    for e in trains[("explicit", True, None)]:
        assert all(v >= 1 for v in e["lowered"].values()) and e["lowered"]
        assert e["spans"] and e["spans"][0]["mode"] == "explicit"
        assert e["spans"][0]["tensors"] == len(e["executed"])


def test_ffta072_clean_and_divergent(runs):
    _, trains, _ = runs
    for e in trains[("explicit", True, None)]:
        assert e["ffta072"] == []
    for r in runs[0]:
        assert r["divergent"] and "FFTA072" in r["divergent"]


def test_bucketed_lowering_parity_and_executed_schedule(runs):
    _, trains, _ = runs
    for b, p in zip(trains[("explicit", True, 4096)],
                    trains[("explicit", True, 0)]):
        assert len(b["bucket_map"]) >= 2, b["bucket_map"]
        assert b["buckets"] == b["priced_buckets"]
        assert p["bucket_map"] == {}
        assert b["bucket_counter"] >= len(b["bucket_map"])
        assert b["bucket_spans"] >= len(b["bucket_map"])
        for lb, lp in zip(b["losses"], p["losses"]):
            assert _rel(lb, lp) < 1e-5


def test_sweep_collectives_rows_and_fit(runs):
    from flexflow_tpu_torch.obs.calibration import CollectiveCalibration
    from flexflow_tpu_torch.obs.refit import fit_collective_coefficients

    sweep = runs[0][0]["sweep"]
    assert sweep["tiers"] == ["ici", "dcn"]
    rows = [CollectiveCalibration(**{k: v for k, v in r.items()
                                     if k != "ratio"})
            for r in sweep["rows"]]
    kinds = {(r.op, r.strategy, r.tier) for r in rows}
    assert {("allreduce", "flat", "dcn"), ("allreduce", "rs_ar_ag", "dcn"),
            ("psum", "tier_ring", "ici"), ("psum", "tier_ring", "dcn")} \
        <= kinds
    assert all(r.measured_us > 0 and r.predicted_us > 0 for r in rows)
    coeffs = fit_collective_coefficients(rows, tiered_machine(True))
    assert set(coeffs.tier_link_scales) == {"ici", "dcn"}
    assert all(v > 0 for v in coeffs.tier_link_scales.values())


def test_bad_knob_value_rejected():
    cfg = pt.FFConfig()
    with pytest.raises(ValueError):
        cfg.parse_args(["--collective-lowering", "magic"])
    cfg.parse_args(["--collective-lowering", "auto"])
    assert cfg.collective_lowering == "auto"


def test_sweep_collectives_refuses_cuda_without_a_card(monkeypatch):
    """The library entry runs on the card unless the config asks for the
    CPU: with no card visible a CUDA config raises before any timing."""
    import torch

    from flexflow_tpu_torch.obs.collective_bench import sweep_collectives

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_collectives(pt.FFConfig(), [65536], ["flat"])
