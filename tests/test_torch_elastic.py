"""The elastic coordinator and its parts (flexflow_tpu_torch/elastic/)
against the JAX package's (flexflow_tpu/elastic/).

Single-process cases hold the port's host-only pieces against JAX's on
the same inputs: the retry policy and its jitter, `call_with_retry`,
`classify_error`, fault plans, the slow-link EWMA, `shrink_topology_spec`
(flat and tiered), the event log, and the one-device coordinator's
retries-exhausted escalation.

The coordinator scenarios of tests/test_elastic.py, test_watchdog.py,
test_resharding.py, test_search_cache.py, test_refit.py, test_obs.py and
test_machine_hierarchy.py run on gloo ranks on the CPU, every scenario
of one world size in one `tools/tp_train.py spawn_jobs` call (4 ranks,
then 2), each scenario its own case; JAX's side runs in this process on
conftest's virtual CPU devices, from the same initial weights (JAX's,
carried by `params_from_jax`), with the Python search
(use_native_search=False, on the port's side too) and f32.
Each case holds the rank that led at the end against JAX's run: the same
(kind, step) sequence of events and their n_devices, axes, source and
cache details (the background planner's `plan.precompute` records land
at a time of the thread's choosing, and `detect.slow_step` reads the
wall clock: both are left out of the sequence), the same device_ids
after recovery, the same committed steps, and each committed loss
within rtol 1e-5. A rank that a scenario loses leaves `fit` at the loss
and takes part in nothing after it: a survivor waiting on it would hang
until the spawn's time limit.
"""
import random

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu import elastic as jel
from flexflow_tpu_torch import elastic as tel
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

LOSS_RTOL = 1e-5
JOIN_S = 240
IGNORED = ("plan.precompute", "detect.slow_step")
DETAILS = ("n_devices", "axes", "source", "cache")


# -- single-process parity ----------------------------------------------
@pytest.mark.parametrize("lib", [jel, tel], ids=["jax", "torch"])
def test_retry_policy_backoff_bounded(lib):
    p = lib.RetryPolicy(max_retries=10, base_delay_s=0.1, backoff=2.0,
                        max_delay_s=0.5)
    q = jel.RetryPolicy(max_retries=10, base_delay_s=0.1, backoff=2.0,
                        max_delay_s=0.5)
    delays = [p.delay_s(k) for k in range(8)]
    assert delays == [q.delay_s(k) for k in range(8)]
    assert delays[0] == pytest.approx(0.1)
    assert all(d <= 0.5 for d in delays) and delays[-1] == 0.5


def test_retry_jitter_seeded_deterministic():
    kw = dict(max_retries=5, base_delay_s=0.1, jitter_frac=0.5,
              max_delay_s=10.0)
    got = [tel.RetryPolicy(**kw).delay_s(k, random.Random(7))
           for k in range(5)]
    want = [jel.RetryPolicy(**kw).delay_s(k, random.Random(7))
            for k in range(5)]
    assert got == want
    for k, d in enumerate(got):
        base = min(0.1 * 2.0 ** k, 10.0)
        assert base <= d <= base * 1.5


def _flaky(lib, fails):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise lib.TransientFault("flaky")
        return "done"

    return fn, calls


@pytest.mark.parametrize("case", ["rng_delays", "then_success"])
def test_call_with_retry(case):
    outs = []
    for lib in (jel, tel):
        events = lib.EventLog()
        fn, calls = _flaky(lib, 3 if case == "rng_delays" else 2)
        policy = lib.RetryPolicy(
            max_retries=5 if case == "rng_delays" else 3,
            base_delay_s=0.125 if case == "rng_delays" else 0.0,
            jitter_frac=1.0 if case == "rng_delays" else 0.0)
        out = lib.call_with_retry(
            fn, policy, events=events, step=7, sleep=lambda s: None,
            rng=random.Random(3) if case == "rng_delays" else None)
        outs.append((out, calls["n"], [(e.kind, e.step, e.details)
                                       for e in events.events()]))
    assert outs[0][0] == outs[1][0] == "done"
    assert outs[0][1:] == outs[1][1:]


@pytest.mark.parametrize("lib", [jel, tel], ids=["jax", "torch"])
def test_call_with_retry_exhaustion_and_topology(lib):
    def always():
        raise lib.TransientFault("never heals")

    with pytest.raises(lib.RetriesExhausted) as ei:
        lib.call_with_retry(always, lib.RetryPolicy(max_retries=2,
                                                    base_delay_s=0.0),
                            sleep=lambda s: None)
    assert isinstance(ei.value.__cause__, lib.TransientFault)
    calls = {"n": 0}

    def topo():
        calls["n"] += 1
        raise lib.TopologyLoss([3])

    with pytest.raises(lib.TopologyLoss):
        lib.call_with_retry(topo, lib.RetryPolicy(max_retries=5,
                                                  base_delay_s=0.0),
                            sleep=lambda s: None)
    assert calls["n"] == 1


@pytest.mark.parametrize("message", [
    "DEADLINE_EXCEEDED: tunnel", "DATA_LOSS: chip went away",
    "slice has been preempted", "plain bug", "Connection reset by peer",
    "RESOURCE_EXHAUSTED: out of memory"])
def test_classify_error_patterns(message):
    """classify_error keeps JAX's two pattern lists: the same class for
    the same XLA-style text."""
    assert tel.classify_error(RuntimeError(message)) == \
        jel.classify_error(RuntimeError(message))
    assert tel.classify_error(tel.TransientFault("x")) == "transient"
    assert tel.classify_error(tel.TopologyLoss([0])) == "topology"


@pytest.mark.parametrize("exc, want", [
    (RuntimeError("NCCL error: unhandled system error, remote process "
                  "exited"), "topology"),
    (RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
                  "Read error: Connection reset by peer"), "topology"),
    (RuntimeError("Timed out waiting 1800000ms for recv"), "transient"),
    (RuntimeError("NCCL communicator was aborted on rank 1."), "topology"),
    (RuntimeError("[Rank 0] Watchdog caught collective operation timeout: "
                  "WorkNCCL(SeqNum=5, OpType=ALLREDUCE, NumelIn=1, "
                  "NumelOut=1, Timeout(ms)=600000) ran for 600013 "
                  "milliseconds before timing out."), "topology"),
    (RuntimeError("Application timeout caused pair closure"), "topology"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), "transient"),
], ids=["nccl-remote-exited", "gloo-reset", "gloo-timeout", "nccl-abort",
        "nccl-watchdog-timeout", "gloo-pair-closed", "cuda-oom"])
def test_classify_torch_runtime_errors(exc, want):
    """torch's, gloo's and NCCL's errors take their XLA analogue's class
    (a timeout DEADLINE_EXCEEDED's, a lost peer DATA_LOSS's, an out of
    memory RESOURCE_EXHAUSTED's, this one by its type). An error after
    which the communicator serves no further collective is topology:
    NCCL's abort and its watchdog's timeout (which aborts), and gloo's
    pair closed after a timeout."""
    assert tel.classify_error(exc) == want


def test_gloo_timeout_and_dead_peer_on_two_ranks(tmp_path):
    """On two gloo ranks: an all-reduce that rank 1 never joins, dispatched
    through the failure detector, times out on rank 0 with gloo's own
    text, which classifies transient; the retry on the same group fails
    at once, gloo having closed the pair, and that text classifies
    topology, so the detector escalates it (DETECT_TOPOLOGY, TopologyLoss)
    after one retry. Then, under the elastic coordinator, rank 1 exits
    inside its step-2 all-reduce. Rank 0's step fails with gloo's lost-peer text, the
    detector classifies it topology (a DETECT_TOPOLOGY event naming no
    rank), and the coordinator raises the typed RecoveryFailed with the
    restart-from-checkpoint hint, not the raw RuntimeError."""
    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    x, y = _rand_data(48, 32, 10)
    jobs = [{"collective_timeout": {"timeout_s": 1.0}},
            {"elastic": {"widths": MLP32, "batch": 12,
                         "config": {"search_budget": 0,
                                    "measure_op_costs": False},
                         "device_ids": [0, 1],
                         "coordinator": {"checkpoint_every": 2},
                         "checkpoint_dir": str(tmp_path / "ckpt"),
                         "x": x, "y": y, "steps": 6,
                         "exit_in_allreduce": (1, 2)}}]
    ranks = spawn_jobs(2, "cpu", jobs, timeout_s=120,
                       workdir=str(tmp_path), leavers=(1,))
    assert ranks[1] is None  # rank 1 exited in its all-reduce
    timeout, run = ranks[0]["jobs"]
    first, retry = timeout["errors"]
    assert "Timed out waiting 1000ms for recv" in first
    assert "Application timeout caused pair closure" in retry
    assert timeout["classes"] == ["transient", "topology"]
    assert [e[0] for e in timeout["events"]] == ["retry",
                                                 "detect.topology_loss"]
    assert timeout["raised"].startswith("TopologyLoss: ")
    detect = [e for e in run["events"] if e[0] == "detect.topology_loss"]
    assert [(e[1], e[2]["chips"]) for e in detect] == [(2, [])]
    err = detect[0][2]["error"]
    # gloo reads the dead peer's socket as closed, or as reset when the
    # peer died with bytes unread (tcp/pair.cc)
    assert "Connection closed by peer" in err or \
        "Connection reset by peer" in err
    assert tel.classify_error(RuntimeError(err)) == "topology"
    assert run["raised"].startswith("RecoveryFailed: ")
    assert "restart from the latest checkpoint" in run["raised"]
    assert "ckpt_000002" in run["raised"]
    assert "recovery.start" not in [e[0] for e in run["events"]]


def test_fault_plan_times_and_spending():
    for lib in (jel, tel):
        plan = lib.FaultPlan().add_transient(at_step=3, times=2)
        assert plan.take(2) == []
        assert len(plan.take(3)) == 1
        assert len(plan.take(3)) == 1
        assert plan.take(3) == [] and plan.pending() == []


def test_same_step_faults_fire_one_at_a_time():
    kinds = []
    for lib in (jel, tel):
        plan = (lib.FaultPlan().add_transient(at_step=5)
                .add_chip_loss(at_step=5, chips=[3]))
        seq = [[f.kind for f in plan.take(5)] for _ in range(3)]
        kinds.append(seq)
    assert kinds[0] == kinds[1] == [["transient"], ["chip_loss"], []]


def test_slow_link_stall_flagged_by_ewma():
    from flexflow_tpu.elastic.faults import FaultInjector as JInj
    from flexflow_tpu_torch.elastic.faults import FaultInjector as TInj

    seqs = []
    for lib, inj_cls in ((jel, JInj), (tel, TInj)):
        t = {"now": 0.0}
        events = lib.EventLog()
        plan = lib.FaultPlan().add_slow_link(at_step=5, stall_s=1.0)
        inj = inj_cls(plan, events=events,
                      sleep=lambda s, t=t: t.__setitem__("now",
                                                         t["now"] + s))
        det = lib.FailureDetector(events=events, injector=inj,
                                  warmup_steps=0, clock=lambda t=t: t["now"])

        def thunk(t=t):
            t["now"] += 0.01
            return 0

        for step in range(8):
            det.current_step = step
            det.dispatch(thunk)
        seqs.append([(e.kind, e.step, e.details) for e in events.events()])
    assert seqs[0] == seqs[1]
    assert [s for k, s, _ in seqs[1] if k == "detect.slow_step"] == [5]


@pytest.mark.parametrize("bad", [("chip_loss", 1, []), ("meteor", 0, [])])
def test_fault_plan_rejects_bad_faults(bad):
    kind, at, chips = bad
    for lib in (jel, tel):
        with pytest.raises(ValueError):
            lib.Fault(kind, at, chips=tuple(chips))


TIERED = {"chip": "tpu-v5e", "num_chips": 16,
          "tiers": [{"name": "ici", "degree": 8, "gbps": 45.0},
                    {"name": "dcn", "degree": 2, "gbps": 3.125,
                     "links": 1}]}


@pytest.mark.parametrize("spec,lost", [
    (("ring", 8), [6, 7]), (("ring", 3), [1, 2]), (("ring", 4), [0]),
    (TIERED, list(range(8, 16))), (TIERED, [3])],
    ids=["ring8", "ring3_to_1", "ring4_lose0", "tiered_whole_pod",
         "tiered_partial"])
def test_shrink_topology_spec(spec, lost):
    if isinstance(spec, tuple):
        got = tel.shrink_topology_spec(tel.ring_topology_spec(spec[1]),
                                       lost)
        want = jel.shrink_topology_spec(jel.ring_topology_spec(spec[1]),
                                        lost)
    else:
        got = tel.shrink_topology_spec(spec, lost)
        want = jel.shrink_topology_spec(spec, lost)
    assert got == want
    from flexflow_tpu_torch.search.machine_model import \
        make_machine_model
    from flexflow_tpu_torch.config import FFConfig
    import json
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(got, f)
    m = make_machine_model(FFConfig(device="cpu",
                                    machine_model_file=f.name),
                           got["num_chips"])
    assert m.num_chips == got["num_chips"]


def test_event_log_roundtrip_counts_and_endpoint(capsys):
    from flexflow_tpu_torch.runtime.profiling import print_event_log
    from flexflow_tpu_torch.serving.server import InferenceServer

    log = tel.EventLog()
    log.record("fault.chip_loss", step=5, chips=[6, 7])
    log.record("recovery.done", step=4, n_devices=6)
    log.record("recovery.done", step=9, n_devices=4)
    jlog = jel.EventLog.from_json(log.to_json())
    assert jlog.counts() == log.counts() == {"fault.chip_loss": 1,
                                             "recovery.done": 2}
    assert log.prometheus_text() == jlog.prometheus_text()
    srv = InferenceServer()
    srv.attach_elastic_events(log)
    assert 'ff_elastic_events_total{kind="recovery.done"} 2' in \
        srv.prometheus_text()
    print_event_log(log)
    assert "recovery.done" in capsys.readouterr().out


def test_retries_exhausted_escalates():
    """One device, one process: a transient that never clears escalates
    as RetriesExhausted from fit, as JAX's does."""
    from flexflow_tpu_torch import FFConfig, FFModel, LossType, \
        SGDOptimizer, ActiMode

    def builder(cfg):
        m = FFModel(cfg)
        t = m.create_tensor([cfg.batch_size, 32])
        t = m.dense(t, 64, ActiMode.AC_MODE_RELU)
        m.softmax(m.dense(t, 10))
        m.compile(optimizer=SGDOptimizer(m, lr=0.05),
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        return m

    cfg = FFConfig(batch_size=8, device="cpu", device_ids=[0],
                   allow_mixed_precision=False)
    x, y = _make_data(8)
    coord = tel.ElasticCoordinator(
        builder, cfg, fault_plan=tel.FaultPlan().add_transient(1, times=10),
        retry_policy=tel.RetryPolicy(max_retries=2, base_delay_s=0.0))
    with pytest.raises(tel.RetriesExhausted):
        coord.fit(x, y, steps=3)
    assert coord.detector.rng is not None
    assert len(coord.events.events("retry")) == 2


# -- a mesh over a rank list (core/machine.py) ----------------------------
@pytest.mark.parametrize("axes,ranks,rank,want", [
    # a full mesh: position == rank, the old rule's coordinates
    ((("data", 2), ("model", 2)), None, 3,
     {"data": 1, "model": 1, "position": 3, "leader": 0}),
    # survivors 2 and 3 of four: rank 3 at position 1
    ((("data", 2),), [2, 3], 3, {"data": 1, "position": 1, "leader": 2}),
    ((("data", 2),), [2, 3], 2, {"data": 0, "position": 0, "leader": 2}),
    # a 2 x 2 mesh over ranks 1..4: rank 3 at position 2
    ((("data", 2), ("model", 2)), [1, 2, 3, 4], 3,
     {"data": 1, "model": 0, "position": 2, "leader": 1}),
    # a mesh of 2 over three survivors: rank 5 is past it
    ((("data", 2),), [1, 4, 5], 5, {"position": None, "leader": 1}),
], ids=["full", "survivors_23_r3", "survivors_23_r2", "2x2_from_1",
        "past_the_mesh"])
def test_mesh_over_a_rank_list(axes, ranks, rank, want):
    import torch

    from flexflow_tpu_torch.core.machine import MachineView, Mesh

    mesh = Mesh(MachineView(axes=axes), rank, {}, torch.device("cpu"),
                ranks)
    assert mesh.leader == want["leader"]
    assert mesh.is_leader == (rank == want["leader"])
    if want["position"] is None:
        assert not mesh.holds_position
        return
    assert mesh.holds_position and mesh.position == want["position"]
    assert {a: mesh.index(a) for a, _ in axes} == \
        {a: want[a] for a, _ in axes}
    # the plan's view of the same mesh (resharding/plan.py) agrees
    from flexflow_tpu_torch.resharding.plan import MeshSpec

    spec = MeshSpec(device_ids=tuple(mesh.mesh_ranks), axes=axes)
    assert spec.coords(rank) == {a: want[a] for a, _ in axes}


def test_group_of_refuses_unordered_ranks():
    from flexflow_tpu_torch.runtime import distributed

    with pytest.raises(ValueError, match="ascend"):
        distributed.group_of([2, 1])


# -- the coordinator scenarios on gloo ranks ------------------------------
def _make_data(batch, n_batches=4, din=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch * n_batches, din).astype(np.float32)
    w = rng.randn(din, 10).astype(np.float32)
    y = np.argmax(x @ w, axis=1).reshape(-1, 1).astype(np.int32)
    return x, y


def _rand_data(n, din, classes):
    rng = np.random.RandomState(0)
    x = rng.randn(n, din).astype(np.float32)
    y = rng.randint(0, classes, size=(n, 1)).astype(np.int32)
    return x, y


MLP32 = {"din": 32, "hidden": 64, "classes": 10}
MLP16 = {"din": 16, "hidden": 32, "classes": 4}


def _scn(widths=MLP32, batch=12, budget=4, data=None, **kw):
    s = {"widths": widths, "batch": batch, "budget": budget,
         "data": data or _make_data(batch), "faults": [], "steps": 6,
         "coordinator": {}, "retry": {"max_retries": 3,
                                      "base_delay_s": 0.0}}
    s.update(kw)
    return s


def _nan(steps, times=1):
    return [("nan_step", s, (), times) for s in steps]


SCENARIOS = {
    4: {
        # tests/test_elastic.py
        "retry_in_place": _scn(
            faults=[("transient", 1, (), 2)], steps=3,
            coordinator={"checkpoint_every": 100}),
        "kill_research_restore_resume": _scn(
            faults=[("chip_loss", 3, (3,), 1)], steps=8,
            coordinator={"checkpoint_every": 2, "live_resharding": False}),
        # tests/test_watchdog.py
        "nan_skip_rollback_replay": _scn(
            faults=_nan(range(3, 7)), steps=10,
            coordinator={"checkpoint_every": 2}, skip_witness=True),
        "corrupt_checkpoint_falls_back": _scn(
            faults=[("corrupt_checkpoint", 4, (), 1),
                    ("chip_loss", 4, (3,), 1)], steps=8,
            coordinator={"checkpoint_every": 2, "live_resharding": False}),
        # tests/test_resharding.py
        "live_zero_disk_resume_at_failing_step": _scn(
            widths=MLP16, budget=8, data=_rand_data(48, 16, 4),
            faults=[("chip_loss", 3, (3,), 1)], steps=6,
            coordinator={"checkpoint_every": 2}),
        "poisoned_live_state_to_disk": _scn(
            widths=MLP16, budget=8, data=_rand_data(48, 16, 4),
            faults=[("poison_live_state", 4, (), 1),
                    ("chip_loss", 4, (3,), 1)], steps=8,
            coordinator={"checkpoint_every": 2}),
        "live_off_uses_disk": _scn(
            widths=MLP16, budget=8, data=_rand_data(48, 16, 4),
            faults=[("chip_loss", 3, (3,), 1)], steps=6,
            coordinator={"checkpoint_every": 2, "live_resharding": False}),
        # tests/test_search_cache.py
        "preplan_recovery_hit": _scn(
            widths={"din": 64, "hidden": 128, "classes": 10}, batch=32,
            data=_rand_data(64, 64, 10),
            faults=[("chip_loss", 3, (3,), 1)], steps=6,
            coordinator={"checkpoint_every": 2},
            retry={"max_retries": 2, "base_delay_s": 0.01}),
        "preplan_off_still_recovers": _scn(
            widths={"din": 64, "hidden": 0, "classes": 10}, batch=32,
            data=_rand_data(64, 64, 10),
            faults=[("chip_loss", 3, (3,), 1)], steps=6,
            coordinator={"checkpoint_every": 2, "preplan": False},
            retry={"max_retries": 2, "base_delay_s": 0.01}),
        # tests/test_refit.py
        "drift_one_budgeted_replan": _scn(
            batch=16, budget=0, data=_rand_data(64, 32, 10), steps=8,
            accuracy=True, coordinator={"checkpoint_every": 2},
            drift={"predicted_step_us": 1.0, "threshold": 0.5,
                   "warmup_steps": 1, "patience": 1, "max_replans": 1,
                   "refit": True}),
        "chip_loss_rearms_drift": _scn(
            budget=0, data=_rand_data(48, 32, 10), steps=8, accuracy=True,
            faults=[("chip_loss", 4, (3,), 1)],
            coordinator={"checkpoint_every": 2},
            drift={"predicted_step_us": 123456.0, "threshold": 10.0,
                   "warmup_steps": 10 ** 6, "max_replans": 1}),
        # tests/test_obs.py
        "recovery_spans": _scn(
            widths=MLP16, batch=8, budget=0, data=_rand_data(32, 16, 4),
            faults=[("chip_loss", 3, (3,), 1)], steps=6, trace=True,
            coordinator={"checkpoint_every": 2, "live_resharding": False},
            retry={"max_retries": 2, "base_delay_s": 0.01}),
        # rank 0 lost with another: rank 2 leads the survivors
        "lose_ranks_0_and_1": _scn(
            faults=[("chip_loss", 3, (0, 1), 1)], steps=8,
            coordinator={"checkpoint_every": 2}),
    },
    2: {
        "single_survivor": _scn(
            batch=8, faults=[("chip_loss", 2, (0,), 1)], steps=4,
            coordinator={"checkpoint_every": 2}),
        "unidentified_loss_fails_fast": _scn(
            batch=8, call="recover_unidentified"),
        "rollback_budget_exhausts": _scn(
            batch=8, faults=_nan([1], times=50), steps=5,
            watchdog={"max_consecutive_bad": 1, "warmup_steps": 0},
            coordinator={"max_rollbacks": 2}),
    },
}


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _jax_run(world, s, tmp):
    """JAX's coordinator on `world` of conftest's CPU devices."""
    from flexflow_tpu.obs.registry import REGISTRY
    from flexflow_tpu.runtime.durability import checkpoint_counters
    from flexflow_tpu.search.plan_cache import reset_plan_cache
    from flexflow_tpu_torch.tools.tp_train import MODELS

    reset_plan_cache()

    def builder(cfg):
        m = ff.FFModel(cfg)
        MODELS["elastic_mlp"](ff, m, {"batch": cfg.batch_size},
                              **s["widths"])
        m.compile(optimizer=ff.SGDOptimizer(m, lr=0.05),
                  loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[ff.MetricsType.METRICS_ACCURACY]
                  if s.get("accuracy") else [])
        return m

    cfg = ff.FFConfig()
    cfg.batch_size = s["batch"]
    cfg.seed = 0
    cfg.search_budget = s["budget"]
    cfg.measure_op_costs = False
    cfg.use_native_search = False
    cfg.allow_mixed_precision = False
    cfg.device_ids = list(range(world))
    plan = jel.FaultPlan([jel.Fault(k, at, chips=tuple(c), times=t)
                          for k, at, c, t in s["faults"]])
    events = jel.EventLog()
    wd = "auto" if s.get("watchdog") is None else jel.TrainingWatchdog(
        jel.WatchdogPolicy(**s["watchdog"]), events=events)
    restores = REGISTRY.counter("ff_recovery_restore_total", "",
                                labels=("source",))
    before = ({k: restores.value(source=k) for k in ("live", "disk")},
              checkpoint_counters())
    tracer = None
    if s.get("trace"):
        from flexflow_tpu import obs

        tracer = obs.enable_tracing()
        tracer.clear()
    coord = jel.ElasticCoordinator(
        builder, cfg, fault_plan=plan, events=events,
        checkpoint_dir=str(tmp), watchdog=wd,
        retry_policy=jel.RetryPolicy(**s["retry"]), **s["coordinator"])
    coord.preplan_join(timeout=120)
    init = _host(coord.model.params)
    out = {"init": init, "raised": None, "history": []}
    det = None
    if s.get("drift"):
        from flexflow_tpu.obs.refit import DriftDetector, refit

        drift = dict(s["drift"])
        do_refit = drift.pop("refit", False)
        det = DriftDetector(**drift)
        coord.drift_detector = det
        if do_refit:
            def hook(model, measured_us):
                prof, hist = refit(model, measured_us, [], rounds=3,
                                   tol=0.15)
                return prof.save(str(tmp / "fitted.json"))

            coord.drift_refit = hook
    x, y = s["data"]
    try:
        if s.get("call") == "recover_unidentified":
            coord._save(0)
            coord._recover(jel.TopologyLoss([]))
        else:
            out["history"] = coord.fit(x, y, steps=s["steps"])
    except jel.RecoveryFailed as exc:
        out["raised"] = f"RecoveryFailed: {exc}"
    if tracer is not None:
        from flexflow_tpu import obs

        out["spans"] = sorted(set(tracer.span_names()))
        obs.disable_tracing()
    out.update({
        "events": [(e.kind, e.step, e.details) for e in events.events()],
        "device_ids": list(coord.device_ids),
        "axes": dict(coord.model.parallel_axes),
        "mesh": coord.model.mesh is not None,
        "restores": {k: restores.value(source=k) - before[0][k]
                     for k in ("live", "disk")},
        "checkpoint_counts": {k: v - before[1].get(k, 0) for k, v in
                              checkpoint_counters().items()},
        "planner": coord.planner is not None})
    if det is not None:
        out["drift"] = {"replans": det.replans,
                        "predicted_step_us": det.predicted_step_us}
    return out


def _job(world, s, jax_init, tmp):
    x, y = s["data"]
    spec = {"widths": s["widths"], "batch": s["batch"],
            "config": {"search_budget": s["budget"],
                       "measure_op_costs": False,
                       "use_native_search": False},
            "device_ids": list(range(world)), "jax_params": jax_init,
            "faults": s["faults"], "coordinator": s["coordinator"],
            "checkpoint_dir": str(tmp), "retry": s["retry"],
            "watchdog": s.get("watchdog"), "preplan_join": True,
            "drift": s.get("drift"), "x": x, "y": y, "steps": s["steps"],
            "call": s.get("call", "fit"), "trace": s.get("trace", False),
            "accuracy": s.get("accuracy", False),
            "skip_witness": s.get("skip_witness", False)}
    return {"elastic": spec}


def _runs(world, tmp_path_factory):
    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    jax, jobs = {}, []
    for name, s in SCENARIOS[world].items():
        jax[name] = _jax_run(world, s, tmp_path_factory.mktemp(
            f"jax_{name}"))
        jobs.append(_job(world, s, jax[name]["init"],
                         tmp_path_factory.mktemp(f"torch_{name}")))
    ranks = spawn_jobs(world, "cpu", jobs, timeout_s=JOIN_S,
                       workdir=str(tmp_path_factory.mktemp("rdv")))
    port = {name: [r["jobs"][i] for r in ranks]
            for i, name in enumerate(SCENARIOS[world])}
    return jax, port


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return _runs(4, tmp_path_factory)


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    return _runs(2, tmp_path_factory)


def _seq(events):
    out = []
    for kind, step, details in events:
        if kind in IGNORED:
            continue
        out.append((kind, step, {k: details.get(k) for k in DETAILS
                                 if k in details}))
    return out


def _leader(ranks):
    """The rank that led at the end: the first of the survivors' list."""
    alive = [r for r in ranks if not r["departed"]]
    lead = alive[0]["device_ids"][0]
    return next(r for r in alive if r["rank"] == lead)


def _check_parity(jax, ranks):
    lead = _leader(ranks)
    assert _seq(lead["events"]) == _seq(jax["events"])
    assert lead["device_ids"] == jax["device_ids"]
    assert lead["axes"] == jax["axes"]
    assert [h["step"] for h in lead["history"]] == \
        [h["step"] for h in jax["history"]]
    np.testing.assert_allclose([h["loss"] for h in lead["history"]],
                               [h["loss"] for h in jax["history"]],
                               rtol=LOSS_RTOL)
    assert (lead["raised"] is None) == (jax["raised"] is None)
    if jax["raised"]:
        assert lead["raised"].split(":")[0] == jax["raised"].split(":")[0]
    # every survivor saw and committed the same, to the bit
    for r in ranks:
        if r["departed"]:
            continue
        assert r["device_ids"] == lead["device_ids"]
        assert [h["loss"] for h in r["history"]] == \
            [h["loss"] for h in lead["history"]]
        assert _seq(r["events"]) == _seq(lead["events"])
    return lead


def _lost_ranks_left(ranks, step, lost):
    for r in ranks:
        if r["rank"] in lost:
            assert r["departed"] == {"step": step, "lost_chips": list(lost)}
            # it left at the loss: nothing written, searched or restored
            assert [h["step"] for h in r["history"]] == list(range(step))
            assert r["restores"] == {"live": 0, "disk": 0}
            kinds = [e[0] for e in r["events"]]
            assert "recovery.start" not in kinds
            assert kinds[-2:] == ["fault.chip_loss", "detect.topology_loss"]
        else:
            assert r["departed"] is None


@pytest.mark.parametrize("name", list(SCENARIOS[4]))
def test_coordinator_scenario_4_ranks(runs4, name):
    jax, port = runs4
    j, ranks = jax[name], port[name]
    lead = _check_parity(j, ranks)
    hist = [h["step"] for h in lead["history"]]
    ev = lead["events"]

    def kinds(kind):
        return [e for e in ev if e[0] == kind]

    assert lead["restores"] == j["restores"]
    if name == "retry_in_place":
        assert hist == [0, 1, 2] and len(kinds("retry")) == 2
        assert not kinds("recovery.start")
    elif name == "kill_research_restore_resume":
        _lost_ranks_left(ranks, 3, [3])
        assert lead["total_devices"] == 3 and lead["mesh_ranks"] == [0, 1, 2]
        assert kinds("recovery.search")[0][2]["n_devices"] == 3
        assert kinds("recovery.restore")[0][1] == 2
        assert hist == list(range(8))
        # the leader searched and wrote every checkpoint
        assert lead["search_leader"] == 0
        assert lead["written"] == [0, 2, 4, 6]
        assert all(not r["written"] for r in ranks if r["rank"] != 0)
    elif name == "nan_skip_rollback_replay":
        assert len(kinds("watchdog.rollback")) == 1
        assert len(kinds("watchdog.skip")) == 3
        assert [e[1] for e in kinds("recovery.restore")] == [2]
        assert hist == [0, 1, 2, 3, 4, 5, 7, 8, 9]
        assert all(np.isfinite(h["loss"]) for h in lead["history"])
        # a SKIP left weights, optimizer state and step count to the bit
        for r in ranks:
            assert r["skips_identical"] and all(r["skips_identical"])
        # the seed failure compares step 9 with step 0 (other batches);
        # like with like: step 8 replays step 4's batch after training
        by = {h["step"]: h["loss"] for h in lead["history"]}
        assert by[8] < by[4] and by[9] < by[5]
    elif name == "corrupt_checkpoint_falls_back":
        _lost_ranks_left(ranks, 4, [3])
        assert len(kinds("checkpoint.corrupt")) == 1
        assert [e[1] for e in kinds("checkpoint.fallback")] == [2]
        assert hist == list(range(8))
    elif name == "live_zero_disk_resume_at_failing_step":
        _lost_ranks_left(ranks, 3, [3])
        counts = lead["checkpoint_counts"]
        assert counts.get("restored", 0) == 0
        assert counts.get("verified", 0) == 0
        restore = kinds("recovery.restore")
        assert len(restore) == 1 and restore[0][1] == 3
        assert restore[0][2]["source"] == "live"
        assert restore[0][2]["restore_ms"] > 0
        assert lead["reshard"]["bytes_moved"] > 0
        assert hist == list(range(6))
    elif name == "poisoned_live_state_to_disk":
        fb = kinds("recovery.live_fallback")
        assert len(fb) == 1 and fb[0][2]["reason"] == "verify"
        assert kinds("recovery.restore")[0][1] == 4
        assert hist == list(range(8))
    elif name == "live_off_uses_disk":
        assert not kinds("recovery.live_fallback")
    elif name == "preplan_recovery_hit":
        assert lead["planner"]
        pre = kinds("plan.precompute")
        assert pre and pre[0][2]["tag"] == "chip_loss"
        det = kinds("recovery.search")[0][2]
        assert det["cache"] == "hit" and det["search_ms"] >= 0
        # every rank pre-planned: any survivor could have led
        for r in ranks:
            assert any(e[0] == "plan.precompute" for e in r["events"])
    elif name == "preplan_off_still_recovers":
        assert not lead["planner"] and not kinds("plan.precompute")
        assert kinds("recovery.done")
    elif name == "drift_one_budgeted_replan":
        assert len(hist) == 8
        assert lead["drift"]["replans"] == 1 == j["drift"]["replans"]
        assert lead["replans"] == 1
        assert len(kinds("drift.replan")) == 1
        assert len(kinds("drift.refit")) == 1
        assert lead["fitted_profile"].endswith(f"fitted_{lead['rank']}.json")
    elif name == "chip_loss_rearms_drift":
        assert len(hist) == 8 and len(lead["device_ids"]) == 3
        d = lead["drift"]
        assert d["predicted_step_us"] != 123456.0
        assert d["predicted_step_us"] == pytest.approx(
            d["model_predicted_step_us"])
        assert d["replans"] == 0 and d["measured_step_us"] is None
    elif name == "recovery_spans":
        for required in ("elastic.recover", "elastic.replan",
                         "elastic.restore", "checkpoint.save",
                         "checkpoint.restore", "elastic.detect",
                         "elastic.resume", "compile",
                         "executor.train_step"):
            assert required in lead["spans"], required
        assert lead["recover_nested"]
        assert set(j["spans"]) >= {"elastic.recover", "elastic.restore"}
    elif name == "lose_ranks_0_and_1":
        _lost_ranks_left(ranks, 3, [0, 1])
        assert lead["rank"] == 2 and lead["device_ids"] == [2, 3]
        assert lead["mesh_ranks"] == [2, 3]
        # the new leader searched and wrote the checkpoints after the loss
        assert lead["search_leader"] == 2
        assert lead["written"] == [4, 6]
        assert kinds("recovery.restore")[0][2]["source"] == "live"
        assert hist == list(range(8))


@pytest.mark.parametrize("name", list(SCENARIOS[2]))
def test_coordinator_scenario_2_ranks(runs2, name):
    jax, port = runs2
    j, ranks = jax[name], port[name]
    lead = _check_parity(j, ranks)
    ev = lead["events"]
    if name == "single_survivor":
        _lost_ranks_left(ranks, 2, [0])
        assert lead["rank"] == 1 and lead["device_ids"] == [1]
        assert not lead["mesh"] and not j["mesh"]
        # the whole training state on the survivor's own device
        assert lead["param_devices"] == [lead["model_device"]]
        assert [h["step"] for h in lead["history"]] == [0, 1, 2, 3]
        assert sum(e[0] == "recovery.done" for e in ev) == 1
        # rank 0 wrote steps 0 and 2 before it was lost
        assert ranks[0]["written"] == [0, 2] and lead["written"] == []
    elif name == "unidentified_loss_fails_fast":
        assert "did not identify" in lead["raised"]
        assert all("did not identify" in r["raised"] for r in ranks)
    elif name == "rollback_budget_exhausts":
        assert "rollback budget" in lead["raised"]
        assert sum(e[0] == "watchdog.rollback" for e in ev) == 2
