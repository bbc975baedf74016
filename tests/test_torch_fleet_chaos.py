"""The fleet's failure domain in flexflow_tpu_torch on the CPU (ROADMAP
A10): tests/test_fleet_chaos.py's 13 scenarios through the port's
ChaosEngine, HealthMonitor, Router.fail_over, Autoscaler respawn and
FlightRecorder, over the port's ContinuousBatcher holding the JAX test
LM's weights.

Against the JAX package: `FleetFaultPlan.randomized(seed)` gives JAX's
schedule for the same seed and knobs (identical), and the tokens of a
failover after a crash mid-decode equal the JAX ContinuousBatcher's on
the same prompts (identical). The other scenarios hold the port's fleet
to an undisturbed run of itself. Monitors use heartbeat windows far
past any test's run unless the test is about heartbeats (those warm the
replicas first), so only the dead-thread probe fires; waits poll a
condition.
"""
import threading
import time

import numpy as np
import pytest

from flexflow_tpu.serving.fleet import FleetFaultPlan as JaxFaultPlan
from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
from flexflow_tpu_torch import params_from_jax
from flexflow_tpu_torch.serving.fleet import (Autoscaler, ChaosEngine,
                                              FleetFault, FleetFaultPlan,
                                              HealthMonitor, HealthState,
                                              Replica, ReplicaLost,
                                              ReplicaState, Router)
from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
from tests.conftest import module_xla_cache
from tests.test_generate import _build_lm
from tests.test_torch_zoo import one_torch_thread

_xla_cache = pytest.fixture(scope="module", autouse=True)(module_xla_cache)
_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def lms():
    """JAX's test LM and the port's copy of it holding JAX's weights."""
    jm = _build_lm(2, 12)
    pm = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm, jm.params)
    return jm, pm


@pytest.fixture(scope="module")
def lm(lms):
    return lms[1]


def _mk_replica(lm, name, slots=2, max_len=48, page_size=4, max_queue=32,
                **kw):
    return Replica(name, lm, max_len=max_len, num_slots=slots,
                   page_size=page_size, max_queue=max_queue, **kw)


def _mk_fleet(lm, n=2, **kw):
    router = Router(**{k: v for k, v in kw.items()
                       if k in ("policy", "slo_ttft_s", "route_depth")})
    rep_kw = {k: v for k, v in kw.items()
              if k not in ("policy", "slo_ttft_s", "route_depth")}
    for i in range(n):
        router.add_replica(f"r{i}", _mk_replica(lm, f"r{i}", **rep_kw))
    return router


def _prompt(n, seed=0, vocab=50):
    rng = np.random.RandomState(seed)
    return rng.randint(1, vocab, size=(n,)).astype(np.int32)


def _monitor(router, **kw):
    """A monitor that only ever fires on the dead-thread probe."""
    kw.setdefault("suspect_after_s", 300.0)
    kw.setdefault("dead_after_s", 600.0)
    return HealthMonitor(router, **kw)


def _poll_until_dead(mon, name, timeout=30.0):
    """Synchronous sweeps until the DEAD verdict lands (with it the
    default on_dead ran fail_over)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        mon.poll()
        if mon.state(name) is HealthState.DEAD:
            return
        time.sleep(0.02)
    raise AssertionError(f"{name} never went DEAD: {mon.states()}")


# ---------------------------------------------------------------------
# fault plans: determinism + validation
# ---------------------------------------------------------------------
def test_fault_plan_same_seed_identical_schedule():
    names = ["r0", "r1", "r2"]
    a = FleetFaultPlan.randomized(7, names).describe()
    b = FleetFaultPlan.randomized(7, names).describe()
    assert a == b
    assert FleetFaultPlan.randomized(8, names).describe() != a
    # JAX's schedule for the same seed and knobs, fault for fault
    for seed, kw in ((7, {}), (8, {"n_faults": 6, "max_token": 10}),
                     (3, {"kinds": ("crash", "straggle"),
                          "max_stall_s": 0.2})):
        assert FleetFaultPlan.randomized(seed, names, **kw).describe() \
            == JaxFaultPlan.randomized(seed, names, **kw).describe()
    # the schedule is pure config — no runtime state leaks into it
    assert all(set(f) == {"kind", "replica", "at_token", "stall_s",
                          "iterations", "submits"} for f in a)


def test_fault_plan_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FleetFault("meteor", "r0")
    with pytest.raises(ValueError):
        FleetFaultPlan.randomized(0, ["r0"], kinds=("crash", "meteor"))


def test_fault_plan_builders_and_for_replica():
    plan = FleetFaultPlan().crash("r0", at_token=5) \
        .hang("r1", stall_s=0.5).flaky_submit("r0", submits=2)
    assert [f.kind for f in plan.for_replica("r0")] == ["crash",
                                                        "flaky_submit"]
    assert plan.describe()[1]["stall_s"] == 0.5


# ---------------------------------------------------------------------
# crash -> DEAD -> token-exact failover
# ---------------------------------------------------------------------
def test_crash_mid_decode_failover_token_parity(lms):
    jm, lm = lms
    router = _mk_fleet(lm, 2)
    mon = _monitor(router)
    try:
        prompts = [_prompt(6, seed=s) for s in (1, 2, 3, 4)]
        # fault-free reference: greedy tokens are a pure function of the
        # prompt, so any healthy run of the same prompts is THE oracle
        ref = [list(router.submit(p, 10).result(timeout=300))
               for p in prompts]
        handles = [router.submit(p, 10) for p in prompts]
        # crash wherever the first request landed, on that replica's
        # next scheduler iteration — guaranteed mid-flight work
        victim = handles[0].replica
        at = router.replica(victim).batcher.tokens_emitted
        engine = ChaosEngine(FleetFaultPlan().crash(victim, at_token=at))
        engine.arm(router)
        _poll_until_dead(mon, victim)
        got = [list(h.result(timeout=300)) for h in handles]
        assert got == [list(map(int, r)) for r in ref]
        # the victim really was loaded: something failed over mid-flight
        assert any(h.failovers > 0 for h in handles)
        assert all(h.error is None and h.done() for h in handles)
        assert [f["kind"] for f in engine.fired] == ["crash"]
        assert victim not in router.replica_names()
        assert router.lost_replicas() == {victim: "scheduler_crashed"}
        assert router.health()["status"] == "degraded"
        # the failed-over tokens are the JAX batcher's
        jb = JaxBatcher(jm, max_len=48, num_slots=2, page_size=4)
        with jb:
            want = [list(map(int, jb.submit(p, 10).result(timeout=300)))
                    for p in prompts]
        assert got == want
    finally:
        router.shutdown()


def test_crash_with_queued_request_replays_from_prompt(lm):
    """A request caught between submit() and its slot bind has emitted
    nothing — failover must replay it from the bare prompt."""
    router = _mk_fleet(lm, 2)
    mon = _monitor(router)
    try:
        # home three same-prefix requests on one replica: 2 slots fill,
        # the third queues behind them
        prefix = _prompt(8, seed=11)
        mk = lambda s: np.concatenate([prefix, _prompt(3, seed=s)])
        lead = router.submit(mk(1), 12)
        victim = lead.replica
        # the prefix pages land in the victim's cache as the lead's
        # prefill completes — wait for its first token so the followers
        # route affine (to the victim) instead of racing the install
        deadline = time.monotonic() + 30.0
        while not lead.tokens and time.monotonic() < deadline:
            time.sleep(0.01)
        rest = [router.submit(mk(s), 12) for s in (2, 3)]
        assert rest[-1].replica == victim  # affine kept the tenant home
        at = router.replica(victim).batcher.tokens_emitted + 2
        engine = ChaosEngine(FleetFaultPlan().crash(victim, at_token=at))
        engine.arm(router)
        _poll_until_dead(mon, victim)
        got = [list(h.result(timeout=300)) for h in [lead] + rest]
        # oracle after the fact: the survivor decodes the same prompts
        ref = [list(router.submit(mk(s), 12).result(timeout=300))
               for s in (1, 2, 3)]
        assert got == ref
        assert all(h.error is None for h in [lead] + rest)
    finally:
        router.shutdown()


def test_crash_during_drain_handoff(lm):
    """Drain hands the queued work off, then the drained replica dies
    with sequences still decoding: fail_over replays them and
    `remove()`'s drain-wait exits instead of spinning to timeout."""
    router = _mk_fleet(lm, 2)
    mon = _monitor(router)
    try:
        prefix = _prompt(8, seed=21)
        mk = lambda s: np.concatenate([prefix, _prompt(3, seed=s)])
        lead = router.submit(mk(1), 16)
        victim = lead.replica
        more = [router.submit(mk(s), 16) for s in (2, 3, 4)]
        # straggle the victim so its actives provably outlive the drain
        # below — on a hot compile cache 16 greedy tokens take tens of
        # milliseconds, and the crash must land while they decode
        engine = ChaosEngine(FleetFaultPlan().straggle(
            victim, at_token=0, stall_s=0.08, iterations=1000))
        engine.arm(router)
        deadline = time.monotonic() + 30.0
        while router.replica(victim).live_sequences() < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.01)  # both slots bound -> exactly 2 queued
        stats = router.drain(victim)  # queued work re-homes now
        assert router.replica(victim).state is ReplicaState.DRAINING
        removed = threading.Event()

        def _remove():
            router.remove(victim, timeout=120.0)
            removed.set()

        t = threading.Thread(target=_remove, daemon=True)
        t.start()
        # kill it mid-drain, actives still decoding (the straggle
        # guarantees ~1.3 s of runway); re-arm to pick up the new fault
        at = router.replica(victim).batcher.tokens_emitted + 1
        engine.plan.crash(victim, at_token=at)
        engine.arm(router)
        # either the monitor's sweep or remove()'s own dead-scheduler
        # check wins the race to fail_over — both must replay the work
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            mon.poll()
            if victim in router.lost_replicas():
                break
            time.sleep(0.02)
        assert router.lost_replicas() == {victim: "scheduler_crashed"}
        assert removed.wait(timeout=30.0), \
            "remove() kept waiting on a DEAD replica's drain"
        got = [list(h.result(timeout=300)) for h in [lead] + more]
        ref = [list(router.submit(mk(s), 16).result(timeout=300))
               for s in (1, 2, 3, 4)]
        assert got == ref
        # both slots were bound when drain ran: the two queued requests
        # re-homed, the two actives stayed to finish (and then crashed)
        assert stats == {"handed_off": 2, "kept": 2}
    finally:
        router.shutdown()


def test_no_survivor_surfaces_typed_replica_lost(lm):
    """A fleet of one: the crash leaves nobody to replay on — the
    caller gets a typed ReplicaLost promptly, never a hang."""
    router = _mk_fleet(lm, 1)
    mon = _monitor(router)
    try:
        h = router.submit(_prompt(6, seed=31), 12)
        at = router.replica("r0").batcher.tokens_emitted + 2
        engine = ChaosEngine(FleetFaultPlan().crash("r0", at_token=at))
        engine.arm(router)
        _poll_until_dead(mon, "r0")
        with pytest.raises(ReplicaLost):
            h.result(timeout=30.0)
        assert isinstance(h.error, ReplicaLost)
        assert h.done()
        assert router.health()["status"] == "down"
    finally:
        router.shutdown()


def test_flaky_submit_is_invisible_to_callers(lm):
    router = _mk_fleet(lm, 2)
    try:
        engine = ChaosEngine(FleetFaultPlan().flaky_submit("r0",
                                                           submits=2))
        engine.arm(router)
        handles = [router.submit(_prompt(6, seed=s), 6)
                   for s in range(5, 11)]
        for h in handles:
            h.result(timeout=300.0)
        assert all(h.error is None for h in handles)
        fired = [f["kind"] for f in engine.fired]
        assert fired.count("flaky_submit") == 2
        engine.disarm()
        # submit is restored: no more injections
        router.submit(_prompt(6, seed=12), 4).result(timeout=300.0)
        assert len(engine.fired) == 2
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# respawn: degraded -> ok
# ---------------------------------------------------------------------
def test_autoscaler_respawns_dead_replica_to_ok(lm):
    router = _mk_fleet(lm, 2)
    mon = _monitor(router)
    asc = Autoscaler(router, min_slots=2, max_slots=2,
                     replica_factory=lambda: _mk_replica(lm, "respawn"),
                     max_replicas=2, min_replicas=2,
                     idle_ticks_before_drain=10**9, monitor=mon)
    try:
        h = router.submit(_prompt(6, seed=41), 8)
        # at_token = the CURRENT count: the crash fires on r0's very next
        # scheduler iteration (idle iterations run the hook too), so the
        # test never depends on where `h` was routed
        at = router.replica("r0").batcher.tokens_emitted
        engine = ChaosEngine(FleetFaultPlan().crash("r0", at_token=at))
        engine.arm(router)
        _poll_until_dead(mon, "r0")
        assert router.health()["status"] == "degraded"
        actions = asc.tick()
        assert [a["action"] for a in actions] == ["respawn"]
        assert sorted(router.replica_names()) == ["r0", "r1"]
        assert router.lost_replicas() == {}
        assert router.health()["status"] == "ok"
        # the verdict was reset: the respawned name is READY again
        assert mon.state("r0") is HealthState.READY
        h.result(timeout=300.0)
        # the replacement takes traffic under the old name
        router.submit(_prompt(6, seed=42), 4).result(timeout=300.0)
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# heartbeat + straggler probes (real stalls: slow lane)
# ---------------------------------------------------------------------
@pytest.mark.slow
def test_hang_detection_and_failover_via_heartbeat(lm):
    router = _mk_fleet(lm, 2)
    try:
        # warm the victim OUTSIDE the monitored window: a cold-dispatch
        # compile stalls the loop exactly like a hang would
        for name in router.replica_names():
            router.replica(name).submit(
                np.zeros(5, np.int32), 2).result(timeout=600.0)
        mon = HealthMonitor(router, suspect_after_s=0.2,
                            dead_after_s=0.6)
        # fault-free oracle first; affine then routes the real request
        # back to the same home (the prefix page is cached there)
        rh = router.submit(_prompt(6, seed=51), 10)
        ref = list(rh.result(timeout=300.0))
        victim = rh.replica
        at = router.replica(victim).batcher.tokens_emitted + 2
        engine = ChaosEngine(
            FleetFaultPlan().hang(victim, at_token=at, stall_s=30.0))
        engine.arm(router)
        h = router.submit(_prompt(6, seed=51), 10)
        assert h.replica == victim
        _poll_until_dead(mon, victim, timeout=30.0)
        # the hang was detected by heartbeat age, not thread death
        assert list(h.result(timeout=300.0)) == ref
        assert h.failovers == 1
        assert victim in router.lost_replicas()
        # the condemned thread bails out of its stall once aborted —
        # well before the scripted 30 s
        t0 = time.monotonic()
        deadline = t0 + 20.0
        batcher = engine._hooked[victim]
        thread = batcher._thread
        while thread is not None and thread.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert thread is None or not thread.is_alive()
    finally:
        router.shutdown()


@pytest.mark.slow
def test_straggler_goes_suspect_never_dead(lm):
    # THREE replicas: with two, the median of {slow, fast} is their
    # mean, and `slow > 2 * mean` can never hold — the relative score
    # needs a majority of healthy siblings, exactly like production
    router = _mk_fleet(lm, 3)
    try:
        for name in router.replica_names():
            router.replica(name).submit(
                np.zeros(5, np.int32), 2).result(timeout=600.0)
        mon = _monitor(router, slow_factor=2.0, straggle_probes=2)
        engine = ChaosEngine(FleetFaultPlan().straggle(
            "r0", at_token=0, stall_s=0.25, iterations=500))
        engine.arm(router)
        # keep EVERY replica busy so each has step-latency samples (the
        # relative score needs a fleet median of busy siblings)
        handles = [router.replica(n).submit(_prompt(6, seed=60 + i), 24)
                   for i, n in enumerate(router.replica_names())]
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            mon.poll()
            if mon.state("r0") is HealthState.SUSPECT:
                break
            time.sleep(0.1)
        assert mon.state("r0") is HealthState.SUSPECT, mon.states()
        # straggling alone never kills: the replica still finishes
        engine.disarm()
        for h in handles:
            h.result(timeout=600.0)
        assert mon.state("r0") is not HealthState.DEAD
        assert "r0" in router.replica_names()
    finally:
        router.shutdown()


def test_degraded_fleet_tightens_slo_budget(lm):
    """While a replica's capacity is missing, the SLO shed budget is
    multiplied by degraded_slo_factor — the fleet sheds EARLIER."""
    router = Router(slo_ttft_s=10.0, degraded_slo_factor=0.25)
    mon = _monitor(router)
    try:
        for i in range(2):
            router.add_replica(f"r{i}", _mk_replica(lm, f"r{i}"))
        h = router.submit(_prompt(6, seed=71), 8)
        # immediate trigger: fires on r0's next (possibly idle) iteration
        at = router.replica("r0").batcher.tokens_emitted
        engine = ChaosEngine(
            FleetFaultPlan().crash("r0", at_token=at))
        engine.arm(router)
        _poll_until_dead(mon, "r0")
        assert router.lost_replicas()
        # white-box: the effective budget is slo * factor while degraded
        assert router.degraded_slo_factor == 0.25
        assert router.health()["lost_replicas"] == {
            "r0": "scheduler_crashed"}
        router.clear_lost("r0")
        assert router.health()["lost_replicas"] == {}
        h.result(timeout=300.0)
    finally:
        router.shutdown()


# ---------------------------------------------------------------------
# observability: a failover CONTINUES the request's trace and
# the death auto-dumps a flight-recorder post-mortem
# ---------------------------------------------------------------------
def test_failover_continues_trace_and_dumps_postmortem(lm, tmp_path):
    import json
    import os

    from flexflow_tpu_torch.elastic.events import EventLog
    from flexflow_tpu_torch.obs.flightrecorder import FlightRecorder
    from flexflow_tpu_torch.obs.tracing import get_tracer

    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    router = _mk_fleet(lm, 2)
    elog = EventLog()
    router.events = elog
    rec = FlightRecorder(dump_dir=str(tmp_path / "fr"), tracer=tracer,
                         registries={"router": router.registry}
                         ).attach(elog)
    mon = _monitor(router, event_log=elog)
    try:
        prompts = [_prompt(6, seed=s) for s in (1, 2, 3, 4)]
        handles = [router.submit(p, 10) for p in prompts]
        victim = handles[0].replica
        at = router.replica(victim).batcher.tokens_emitted
        engine = ChaosEngine(FleetFaultPlan().crash(victim, at_token=at),
                             event_log=elog)
        engine.arm(router)
        _poll_until_dead(mon, victim)
        for h in handles:
            h.result(timeout=300.0)
        failed = [h for h in handles if h.failovers > 0]
        assert failed, "the crash caught no in-flight work"

        # each failed-over request's spans stitch under its ORIGINAL
        # trace_id: the survivor's scheduler track carries it, and a
        # mid-decode victim leaves its spans on the dead track too
        trace = tracer.to_chrome_trace()
        names = {e["tid"]: e["args"]["name"]
                 for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
        tracks = {}
        for e in trace["traceEvents"]:
            a = e.get("args")
            if e.get("ph") == "X" and isinstance(a, dict) \
                    and "trace_id" in a and e["tid"] in names:
                tracks.setdefault(a["trace_id"], set()).add(
                    names[e["tid"]])
        for h in failed:
            assert h.trace_id is not None
            got = tracks.get(h.trace_id, set())
            assert got - {victim}, (h.trace_id, got)
            if h.replayed_tokens:
                assert victim in got, (h.trace_id, got)
        # the replay leg itself is a span of the original trace
        fo = tracer.events("fleet.failover")
        assert fo
        assert all(e["args"]["trace_id"] in tracks for e in fo)

        # the DEAD verdict auto-dumped ONE bundle (the failover burst
        # right behind it is debounced) with the trace alongside
        assert len(rec.dumps) == 1, rec.dumps
        bundle = rec.dumps[0]
        with open(os.path.join(bundle, "recorder.json")) as f:
            dump = json.load(f)
        assert dump["meta"]["trigger"] == "fleet.dead"
        assert os.path.exists(os.path.join(bundle, "trace.json"))
    finally:
        rec.detach()
        tracer.disable()
        router.shutdown()
