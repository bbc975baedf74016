"""The fleet's measurement runs and their serve-bench front ends (the
port's copy of flexflow_tpu/serving/fleet/bench.py):

 - `run_fleet_static`: a shared-prefix tenant mix through N replicas
   behind the Router under one routing policy (leaders first, then the
   followers in fleet-capacity waves);
 - `run_fleet_autoscale`: a peak -> trough -> peak swing with the
   Autoscaler live (grow and shrink through `request_resize`) and one
   replica drained mid-burst (the handoff of its queued requests);
 - `run_fleet_chaos`: a loaded replica crashed at a token count under a
   live HealthMonitor and Autoscaler, its work failed over and the
   replica respawned; with `artifact_dir`, traced, with a flight
   recorder armed, and the failed-over requests' trace continuity;
 - `run_disagg_fleet`: one request stream through a fleet of `roles`
   (["unified", "unified"] or ["prefill", "decode"]) in a sliding window
   of `concurrency`, with the handoffs' prices and measured walls.

Each returns tokens/s, TTFT percentiles, drops, the greedy token lists
(for parity) and a summary of the merged exposition (`_render_fleet`).
`_warm` runs before any timing, monitor or chaos engine: on the card it
captures every replica's decode graph and every slot's chunk graph, so
no capture lands inside a timed or monitored window.

`run_fleet_cli`, `run_chaos_cli` and `run_disagg_cli` are the
`serve-bench --workload fleet|chaos|disagg` entries (dispatched from
serving/sched/bench.py `run_bench`, whose argparse namespace they take):
each builds the LM on `args.device`, makes its runs and holds them to
the JAX bench's hard checks; chaos with `--artifacts` merges the drill's
trace, events and flight bundle through obs/timeline.py.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ..sched.admission import PoolSaturated, QueueFull, SLOExceeded


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _submit_retry(router, w: Dict, deadline_s: float, t0: float,
                  shed_counts: Dict[str, int]):
    """A well-behaved fleet client: typed 429-class sheds (queue, pool,
    SLO) retry with backoff until the run deadline — zero-drop means
    every request eventually lands."""
    while True:
        try:
            return router.submit(w["prompt"], w["max_new"], seed=0)
        except (QueueFull, PoolSaturated, SLOExceeded) as e:
            shed_counts[e.reason] = shed_counts.get(e.reason, 0) + 1
            if time.monotonic() - t0 > deadline_s:
                raise
            time.sleep(0.02)


def _build_fleet(model, n_replicas: int, policy: str, slots: int,
                 page_size: int, max_len: int, prefix_cache_pages: int,
                 slo_ttft_s: Optional[float], max_queue: int):
    from .replica import Replica
    from .router import Router

    router = Router(policy=policy, slo_ttft_s=slo_ttft_s)
    for i in range(n_replicas):
        router.add_replica(f"r{i}", Replica(
            f"r{i}", model, max_len=max_len, num_slots=slots,
            page_size=page_size, prefix_cache_pages=prefix_cache_pages,
            max_queue=max_queue))
    return router


def _warm(router, max_len: int, page_size: int) -> None:
    """Run every replica's dispatches once outside the timed window (the
    all-zeros prompt of the single-replica workloads, which real prompts
    never share): a burst of one request a slot, twice, so on the card
    every slot's chunk graph, the decode graph and the prefix install
    are captured or run before anything is timed or monitored."""
    warm = np.zeros(max(1, min(page_size * 2 + 1, max_len - 2)), np.int32)
    for name in router.replica_names():
        rep = router.replica(name)
        for _ in range(2):
            reqs = [rep.submit(warm, 2) for _ in range(rep.num_slots())]
            for r in reqs:
                r.result(timeout=600.0)


def _collect(handles: List, workload: List[Dict], deadline_s: float,
             wall_s: float, n_chips: int, shed_counts: Dict[str, int]) \
        -> Dict:
    tokens = sum(len(h.tokens) for h in handles)
    ttfts = [(h, h.ttft_s * 1e3) for h in handles if h.ttft_s is not None]
    hit = [t for h, t in ttfts if h.cache_hit]
    miss = [t for h, t in ttfts if not h.cache_hit]
    all_ttft = [t for _, t in ttfts]
    # steady-state tail: followers only. Each tenant's FIRST session is
    # identically cold under every routing policy (somebody prefills the
    # prefix once); the policy-sensitive population is everything after,
    # so the affine-vs-round-robin assert compares this p99
    steady = [h.ttft_s * 1e3 for h, w in zip(handles, workload)
              if not w.get("leader") and h.ttft_s is not None]
    waits = [h.queue_wait_s or 0.0 for h in handles]
    return {
        "wall_s": round(wall_s, 3),
        "tokens": tokens,
        "tokens_per_s": round(tokens / wall_s, 2) if wall_s > 0 else 0.0,
        "tokens_per_s_per_chip": round(tokens / wall_s / n_chips, 2)
        if wall_s > 0 else 0.0,
        "dropped": sum(
            1 for h, w in zip(handles, workload)
            if h.error is not None or len(h.tokens) != w["max_new"]),
        "starved": sum(1 for w in waits if w > deadline_s),
        "requests": len(handles),
        "hits": len(hit),
        "misses": len(miss),
        "handoffs": sum(h.handoffs for h in handles),
        "ttft_ms_p50": round(_pct(all_ttft, 50), 2),
        "ttft_ms_p99": round(_pct(all_ttft, 99), 2),
        "ttft_steady_ms_p99": round(_pct(steady, 99), 2),
        "ttft_hit_ms_p99": round(_pct(hit, 99), 2),
        "ttft_miss_ms_p99": round(_pct(miss, 99), 2),
        "shed_retries": dict(shed_counts),
        "routes": {r: sum(1 for h in handles if h.route == r)
                   for r in sorted({h.route for h in handles})},
    }


def run_fleet_static(model, workload, *, policy: str, n_replicas: int,
                     slots: int, page_size: int, max_len: int,
                     prefix_cache_pages: int, slo_ttft_s: Optional[float],
                     deadline_s: float) -> Dict:
    """Leaders first (one cold prefill per tenant through the router
    under test), then followers in fleet-capacity waves so queue wait
    never pollutes the TTFT comparison between routing policies."""
    router = _build_fleet(model, n_replicas, policy, slots, page_size,
                          max_len, prefix_cache_pages, slo_ttft_s,
                          max_queue=max(len(workload), 16))
    leaders = [(i, w) for i, w in enumerate(workload) if w["leader"]]
    followers = [(i, w) for i, w in enumerate(workload) if not w["leader"]]
    handles: List = [None] * len(workload)
    shed: Dict[str, int] = {}
    try:
        _warm(router, max_len, page_size)
        t0 = time.monotonic()
        for i, w in leaders:
            handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
        for i, _ in leaders:
            handles[i].result(timeout=600.0)
        wave = n_replicas * slots
        for lo in range(0, len(followers), wave):
            for i, w in followers[lo:lo + wave]:
                handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
            for i, _ in followers[lo:lo + wave]:
                handles[i].result(timeout=600.0)
        wall = time.monotonic() - t0
        out = _collect(handles, workload, deadline_s, wall, n_replicas,
                       shed)
        out["policy"] = policy
        out["token_lists"] = [[int(t) for t in h.tokens] for h in handles]
        out["exposition"] = _render_fleet(router)
        return out
    finally:
        router.shutdown()


def run_fleet_autoscale(model, workload, *, n_replicas: int, slots: int,
                        min_slots: int, max_slots: int, page_size: int,
                        max_len: int, prefix_cache_pages: int,
                        slo_ttft_s: Optional[float], deadline_s: float,
                        drain_one: bool = True) -> Dict:
    """The diurnal swing: peak burst -> trough trickle -> peak burst,
    with the Autoscaler live (50 ms control loop) and one replica
    drained (handoff) during the second peak."""
    from .autoscaler import Autoscaler

    router = _build_fleet(model, n_replicas, "affine", slots, page_size,
                          max_len, prefix_cache_pages, slo_ttft_s,
                          max_queue=max(len(workload), 16))
    asc = Autoscaler(
        router, min_slots=min_slots, max_slots=max_slots,
        # decisive steps: every resize respecializes the decode dispatch
        # (a recompile stall on the CPU twin), so the bench scales in one
        # jump per direction instead of creeping
        grow_step=max(1, max_slots - slots),
        shrink_step=max(1, slots - min_slots),
        queue_hi=1, util_hi=0.8, util_lo=0.3,
        idle_ticks_before_shrink=6,
        # membership is pinned for the run: tokens/s-per-chip needs a
        # fixed chip count, and the drain below is explicit
        replica_factory=None, min_replicas=n_replicas,
        idle_ticks_before_drain=10**9)
    leaders = [(i, w) for i, w in enumerate(workload) if w["leader"]]
    followers = [(i, w) for i, w in enumerate(workload) if not w["leader"]]
    n_peak1 = max(1, int(len(followers) * 0.6))
    n_trough = max(1, int(len(followers) * 0.1))
    phases = {
        "peak1": followers[:n_peak1],
        "trough": followers[n_peak1:n_peak1 + n_trough],
        "peak2": followers[n_peak1 + n_trough:],
    }
    handles: List = [None] * len(workload)
    shed: Dict[str, int] = {}
    drained = None
    try:
        _warm(router, max_len, page_size)
        asc.start(interval_s=0.05)
        t0 = time.monotonic()
        for i, w in leaders:
            handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
        for i, _ in leaders:
            handles[i].result(timeout=600.0)
        # PEAK 1: burst everything at once — queues build, the
        # autoscaler grows replica meshes under load
        for i, w in phases["peak1"]:
            handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
        for i, _ in phases["peak1"]:
            handles[i].result(timeout=600.0)
        # TROUGH: one request at a time — idle replicas shrink back
        for i, w in phases["trough"]:
            handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
            handles[i].result(timeout=600.0)
        # PEAK 2: burst again (grow again); drain one replica mid-burst
        # to exercise the queued-request handoff path
        for i, w in phases["peak2"]:
            handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
        if drain_one and phases["peak2"]:
            drained = min(router.replica_names(),
                          key=lambda n: router.replica(n).live_sequences())
            drain_stats = router.drain(drained)
        else:
            drain_stats = {"handed_off": 0, "kept": 0}
        for i, _ in phases["peak2"]:
            handles[i].result(timeout=600.0)
        wall = time.monotonic() - t0
        # let in-flight resize tickets resolve before reading the logs
        deadline = time.monotonic() + deadline_s
        while asc.pending_resizes() and time.monotonic() < deadline:
            time.sleep(0.02)
        asc.stop()
        out = _collect(handles, workload, deadline_s, wall, n_replicas,
                       shed)
        resizes = []
        for name in router.replica_names():
            for r in router.replica(name).batcher.stats()["resizes"]:
                resizes.append(dict(r, replica=name))
        out.update({
            "policy": "affine+autoscale",
            "phases": {k: len(v) for k, v in phases.items()},
            "resizes": resizes,
            "grows_applied": sum(1 for r in resizes
                                 if r["direction"] == "grow"),
            "shrinks_applied": sum(1 for r in resizes
                                   if r["direction"] == "shrink"),
            "drained_replica": drained,
            "drain": drain_stats,
            "autoscale_log": [a for a in asc.log
                              if a.get("action") != "resize_applied"],
            "token_lists": [[int(t) for t in h.tokens] for h in handles],
            "exposition": _render_fleet(router),
        })
        return out
    finally:
        asc.stop()
        router.shutdown()


def _render_fleet(router) -> Dict:
    """Validate the fleet's merged exposition and summarize it: the
    router's own families plus every replica's registry merged under the
    `replica` label — the same text the fleet server's /metrics serves."""
    from ...obs.registry import render_merged, validate_exposition

    text = router.registry.render() + render_merged(
        router.replica_registries())
    families = validate_exposition(text)
    labeled = sorted(
        name for name, fam in families.items()
        if any("replica" in lbls for _, lbls, _ in fam["samples"]))
    return {"lines": len(text.splitlines()),
            "replica_labeled_families": labeled}


def _trace_continuity(trace: Dict, handles: List, victim: str) -> Dict:
    """Did every failed-over request's spans stitch under ONE trace_id
    across the NAMED scheduler tracks? Client threads are unnamed, so
    the named-tid filter keeps exactly the per-replica tracks.

    Two stitching grades: a request that died MID-DECODE
    (`replayed_tokens > 0`) left spans on the victim's track, so its
    trace must cover the victim AND a survivor (>= 2 named tracks). A
    request still queued (or prefilling) when the victim died never
    decoded there — its spans legitimately live on one track, and the
    check is only that the replay landed under the ORIGINAL trace_id on
    some named track (the respawned incarnation runs as 'respawn', so
    the victim's name is unambiguously the dead track)."""
    names = {e["tid"]: e["args"].get("name", "")
             for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    tracks: Dict[str, set] = {}
    for e in trace["traceEvents"]:
        args = e.get("args")
        if e.get("ph") != "X" or not isinstance(args, dict):
            continue
        if e.get("tid") in names and "trace_id" in args:
            tracks.setdefault(args["trace_id"], set()).add(
                names[e["tid"]])

    def _ok(h) -> bool:
        t = tracks.get(h.trace_id, ())
        if h.replayed_tokens > 0:
            return victim in t and len(t) >= 2
        return len(t) >= 1

    failed_over = [h for h in handles if h.failovers > 0]
    mid_decode = [h for h in failed_over if h.replayed_tokens > 0]
    stitched = [h for h in failed_over if _ok(h)]
    return {
        "failed_over": len(failed_over),
        "mid_decode": len(mid_decode),
        "stitched": len(stitched),
        "unstitched": sorted(str(h.trace_id) for h in failed_over
                             if h not in stitched),
        "victim_track": victim,
        "multi_track_traces": {t: sorted(v) for t, v in tracks.items()
                               if len(v) >= 2},
    }


def run_fleet_chaos(model, workload, *, n_replicas: int, slots: int,
                    page_size: int, max_len: int, prefix_cache_pages: int,
                    deadline_s: float, crash_after_tokens: int,
                    suspect_after_s: float, dead_after_s: float,
                    probe_interval_s: float,
                    artifact_dir: Optional[str] = None) -> Dict:
    """The failure-domain drill: crash a loaded replica
    mid-decode under a live HealthMonitor + Autoscaler and prove the
    blast radius is a TTFT blip, not an outage.

    Timeline: warm + leaders complete FIRST (compile stalls look exactly
    like hangs — monitors must never be armed across a cold dispatch),
    then the monitor, autoscaler (respawn factory wired), and a scripted
    ChaosEngine go live, then every follower bursts at once and the
    victim's scheduler raises InjectedCrash `crash_after_tokens`
    generated tokens later. The main thread watches the milestones —
    fault fired, DEAD verdict, eviction, same-name respawn — while the
    failover replays the victim's in-flight requests on survivors.
    Token parity vs the fault-free run is asserted by the caller."""
    from .autoscaler import Autoscaler
    from .chaos import ChaosEngine, FleetFaultPlan
    from .health import HealthMonitor
    from .replica import Replica
    from ...elastic.events import EventLog

    router = _build_fleet(model, n_replicas, "affine", slots, page_size,
                          max_len, prefix_cache_pages, None,
                          max_queue=max(len(workload), 16))
    elog = EventLog()
    router.events = elog
    mon = HealthMonitor(router, suspect_after_s=suspect_after_s,
                        dead_after_s=dead_after_s, event_log=elog)
    # observability leg: with an artifact dir, the drill runs
    # under request tracing and an armed flight recorder — the DEAD
    # verdict auto-dumps a post-mortem bundle, the trace + EventLog are
    # exported beside it, and trace continuity across the failover is
    # measured (every failed-over request's spans must share ONE
    # trace_id across the victim's and a survivor's scheduler tracks)
    tracer = recorder = None
    if artifact_dir is not None:
        import os

        from ...obs.flightrecorder import FlightRecorder
        from ...obs.tracing import get_tracer

        os.makedirs(artifact_dir, exist_ok=True)
        tracer = get_tracer()
        tracer.clear()
        tracer.enable()
        recorder = FlightRecorder(
            dump_dir=os.path.join(artifact_dir, "flight_recorder"),
            tracer=tracer, registries={"router": router.registry})
        recorder.attach(elog)
        recorder.start(interval_s=0.2)

    def factory():
        return Replica("respawn", model, max_len=max_len, num_slots=slots,
                       page_size=page_size,
                       prefix_cache_pages=prefix_cache_pages,
                       max_queue=max(len(workload), 16))

    asc = Autoscaler(router, min_slots=slots, max_slots=slots,
                     replica_factory=factory, max_replicas=n_replicas,
                     min_replicas=n_replicas,
                     idle_ticks_before_drain=10**9, monitor=mon)
    leaders = [(i, w) for i, w in enumerate(workload) if w["leader"]]
    followers = [(i, w) for i, w in enumerate(workload) if not w["leader"]]
    handles: List = [None] * len(workload)
    shed: Dict[str, int] = {}
    milestones: Dict[str, Optional[float]] = {
        "fault": None, "dead": None, "evicted": None, "respawned": None}
    engine = None
    victim = router.replica_names()[0]
    try:
        _warm(router, max_len, page_size)
        t0 = time.monotonic()
        for i, w in leaders:
            handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
        for i, _ in leaders:
            handles[i].result(timeout=600.0)
        # victim: the replica homing the most leaders — guaranteed loaded
        # when the crash fires (affinity sends its tenants' followers back)
        homes = [h.replica for i, _ in leaders for h in [handles[i]]]
        victim = max(router.replica_names(),
                     key=lambda n: homes.count(n))
        survivor = next(n for n in router.replica_names() if n != victim)
        at = router.replica(victim).batcher.tokens_emitted \
            + crash_after_tokens
        plan = FleetFaultPlan().crash(victim, at_token=at) \
            .flaky_submit(survivor, submits=2)
        engine = ChaosEngine(plan, registry=router.registry,
                             event_log=elog)
        engine.arm(router)
        mon.start(interval_s=probe_interval_s)
        asc.start(interval_s=probe_interval_s)
        for i, w in followers:
            handles[i] = _submit_retry(router, w, deadline_s, t0, shed)
        # watch the drill from the main thread: fault -> DEAD verdict ->
        # eviction -> same-name respawn, while results stream in
        watch_deadline = time.monotonic() + deadline_s
        while time.monotonic() < watch_deadline:
            if milestones["fault"] is None:
                crash = [f for f in engine.fired if f["kind"] == "crash"]
                if crash:
                    milestones["fault"] = crash[0]["t"]
            if milestones["dead"] is None \
                    and mon.states().get(victim) == "dead":
                milestones["dead"] = time.monotonic()
            names = router.replica_names()
            if milestones["evicted"] is None \
                    and milestones["dead"] is not None \
                    and (victim not in names
                         or victim in router.lost_replicas()):
                milestones["evicted"] = time.monotonic()
            if milestones["respawned"] is None \
                    and milestones["evicted"] is not None \
                    and victim in names \
                    and victim not in router.lost_replicas():
                milestones["respawned"] = time.monotonic()
            if milestones["respawned"] is not None \
                    and all(h.done() for h in handles):
                break
            time.sleep(0.02)
        for h in handles:
            try:
                h.result(timeout=600.0)
            except Exception:
                pass  # surfaces in _collect as dropped
        wall = time.monotonic() - t0
        mon.stop()
        asc.stop()
        out = _collect(handles, workload, deadline_s, wall, n_replicas,
                       shed)
        detect_s = (milestones["dead"] - milestones["fault"]
                    if milestones["dead"] and milestones["fault"]
                    else None)
        recover_s = (milestones["respawned"] - milestones["fault"]
                     if milestones["respawned"] and milestones["fault"]
                     else None)
        out.update({
            "policy": "affine+chaos",
            "victim": victim,
            "fault_plan": plan.describe(),
            "faults_fired": list(engine.fired),
            "failovers": sum(h.failovers for h in handles),
            "failed_over_requests": sum(
                1 for h in handles if h.failovers > 0),
            "detect_s": round(detect_s, 3) if detect_s is not None
            else None,
            "recover_s": round(recover_s, 3) if recover_s is not None
            else None,
            "health_after": router.health()["status"],
            "monitor_states": mon.states(),
            "fleet_events": [e.kind for e in elog.tail(50)]
            if hasattr(elog, "tail") else [],
            "token_lists": [[int(t) for t in h.tokens] for h in handles],
            "exposition": _render_fleet(router),
        })
        if recorder is not None:
            import json as _json
            import os

            recorder.detach()  # also stops the snapshot daemon
            trace_path = os.path.join(artifact_dir, "trace.json")
            tracer.export_chrome_trace(trace_path)
            events_path = os.path.join(artifact_dir, "events.json")
            with open(events_path, "w") as f:
                f.write(elog.to_json())
            with open(trace_path) as f:
                trace = _json.load(f)
            out["trace_continuity"] = _trace_continuity(
                trace, handles, victim)
            out["artifacts"] = {
                "trace": trace_path, "events": events_path,
                "flight_dumps": list(recorder.dumps),
            }
        return out
    finally:
        if engine is not None:
            engine.disarm()
        if recorder is not None:
            recorder.detach()
        if tracer is not None:
            tracer.disable()
        mon.stop()
        asc.stop()
        router.shutdown()


def _itl_gaps_ms(handles: List) -> List[float]:
    """Steady-state inter-token gaps across all requests, in ms. The
    FIRST gap (token 1 -> token 2) is excluded symmetrically from both
    runs: on the disagg fleet it is where the KV handoff settles, on the
    unified fleet it is where slot scheduling settles — neither is the
    steady decode cadence the ITL gate compares."""
    gaps: List[float] = []
    for h in handles:
        ts = h.token_times
        gaps.extend((b - a) * 1e3 for a, b in zip(ts[1:], ts[2:]))
    return gaps


def run_disagg_fleet(model, workload, *, roles: List[str], slots: int,
                     page_size: int, max_len: int, deadline_s: float,
                     concurrency: int, prefill_chunk: Optional[int] = None,
                     machine=None, device_ids=(0,),
                     trace: bool = False) -> Dict:
    """One serving run over `workload` on a fleet described by `roles`
    (e.g. ``["unified", "unified"]`` or ``["prefill", "decode"]``) —
    equal chips means equal role-list length. Requests stream through a
    sliding window of `concurrency` in-flight (sized to the decode
    pool's slots, same window for every configuration), so prefill of
    new arrivals continuously overlaps decode of resident ones — the
    regime the disagg split exists for."""
    from .replica import Replica
    from .router import Router

    router = Router(policy="least_loaded")
    extra = {} if prefill_chunk is None \
        else {"prefill_chunk_tokens": prefill_chunk}
    counts: Dict[str, int] = {}
    for role in roles:
        counts[role] = counts.get(role, 0) + 1
        name = f"{role[0]}{counts[role] - 1}"
        router.add_replica(name, Replica(
            name, model, role=role, max_len=max_len, num_slots=slots,
            page_size=page_size, max_queue=max(len(workload), 16),
            **extra))
    coord = None
    if "prefill" in roles:
        from .disagg import DisaggCoordinator

        coord = DisaggCoordinator(router, machine=machine,
                                  device_ids=device_ids)
        coord.attach_all()
    tracer = None
    if trace:
        from ...obs.tracing import get_tracer

        tracer = get_tracer()
        tracer.clear()
        tracer.enable()
    handles: List = [None] * len(workload)
    shed: Dict[str, int] = {}
    try:
        _warm(router, max_len, page_size)
        if coord is not None:
            # warm the handoff plane end to end (export gather, priced
            # schedule, import scatter) outside the timed window
            warm = np.zeros(max(1, min(page_size * 2 + 1, max_len - 2)),
                            np.int32)
            router.submit(warm, 2, seed=0).result(timeout=600.0)
        committed0 = coord.committed if coord is not None else 0
        t0 = time.monotonic()
        active: List = []
        idx = 0
        while idx < len(workload) or active:
            while idx < len(workload) and len(active) < concurrency:
                handles[idx] = _submit_retry(router, workload[idx],
                                             deadline_s, t0, shed)
                active.append(handles[idx])
                idx += 1
            still = [h for h in active if not h.done()]
            if len(still) == len(active):
                time.sleep(0.002)
            active = still
        for h in handles:
            try:
                h.result(timeout=600.0)
            except Exception:
                pass  # surfaces in _collect as dropped
        wall = time.monotonic() - t0
        out = _collect(handles, workload, deadline_s, wall, len(roles),
                       shed)
        gaps = _itl_gaps_ms(handles)
        out.update({
            "roles": list(roles),
            "concurrency": concurrency,
            "itl_gaps": len(gaps),
            "itl_ms_p50": round(_pct(gaps, 50), 3),
            "itl_ms_p99": round(_pct(gaps, 99), 3),
            "token_lists": [[int(t) for t in h.tokens] for h in handles],
            "exposition": _render_fleet(router),
        })
        if coord is not None:
            st = coord.stats()
            out["handoff_log"] = list(coord.log)
            text = router.registry.render()
            out["handoff"] = {
                **{k: st[k] for k in ("committed", "resumed", "failed",
                                      "last_error", "last_predicted_us",
                                      "us_per_byte", "bytes_per_token")},
                "committed_run": coord.committed - committed0,
                "requests_handed_off": sum(
                    1 for h in handles if h.handoffs >= 1),
                "disagg_families": sorted(
                    n for n in ("ff_disagg_handoffs_total",
                                "ff_disagg_handoff_bytes_total",
                                "ff_disagg_handoff_chunks_total",
                                "ff_disagg_handoff_ms",
                                "ff_disagg_predicted_transfer_us")
                    if n in text),
            }
        if tracer is not None:
            handoff_ids = {e["args"].get("trace_id")
                           for e in tracer.events("fleet.kv_handoff")}
            out["trace"] = {
                "span_names": tracer.span_names(),
                "stitched": sum(1 for h in handles
                                if h.trace_id in handoff_ids),
                "unstitched": [str(h.trace_id) for h in handles
                               if h.trace_id not in handoff_ids],
            }
        return out
    finally:
        if tracer is not None:
            tracer.disable()
        if coord is not None:
            coord.stop()
        router.shutdown()


def run_chaos_cli(args) -> int:
    """The `serve-bench --workload chaos` entry (dispatched from
    serving/sched/bench.py): fault-free affine reference first (token
    parity + baseline p99 TTFT), then the chaos drill against the same
    request list."""
    import json

    from .chaos import FleetFaultPlan
    from ..sched.bench import build_tiny_lm, make_shared_prefix_workload

    n_rep = args.replicas
    if n_rep < 2:
        print("[serve-bench] FAIL: chaos needs --replicas >= 2 — the"
              " failover replays in-flight work on survivors")
        return 1
    window = args.prefix_len + args.suffix_max
    max_len = window + args.out_max
    print(f"[serve-bench] chaos: {args.requests} sessions over"
          f" {args.prefix_groups} tenants x {n_rep} replicas of"
          f" {args.slots} slots | crash victim after"
          f" +{args.chaos_crash_after} tokens, heartbeat windows"
          f" {args.chaos_suspect}s/{args.chaos_dead}s")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    workload = make_shared_prefix_workload(
        args.requests, args.prefix_groups, args.prefix_len,
        args.suffix_min, args.suffix_max, args.out_min, args.out_max,
        args.vocab, args.seed)
    import math

    pages = 2 + args.prefix_groups * math.ceil(
        (args.prefix_len + args.suffix_max) / args.page_size)
    common = dict(n_replicas=n_rep, slots=args.slots,
                  page_size=args.page_size, max_len=max_len,
                  prefix_cache_pages=pages, deadline_s=args.deadline)

    # the determinism contract the seeded plans pin: same seed, same
    # schedule — byte-identical describe()
    names = [f"r{i}" for i in range(n_rep)]
    determinism_ok = (
        FleetFaultPlan.randomized(args.chaos_seed, names).describe()
        == FleetFaultPlan.randomized(args.chaos_seed, names).describe())

    ref = run_fleet_static(model, workload, policy="affine",
                           slo_ttft_s=None, **common)
    chaos = run_fleet_chaos(
        model, workload, crash_after_tokens=args.chaos_crash_after,
        suspect_after_s=args.chaos_suspect, dead_after_s=args.chaos_dead,
        probe_interval_s=args.chaos_interval,
        artifact_dir=args.artifacts, **common)

    def line(tag: str, r: Dict) -> None:
        print(f"[serve-bench] {tag:12s} {r['tokens']} tokens in"
              f" {r['wall_s']}s = {r['tokens_per_s']} tok/s |"
              f" ttft p99 {r['ttft_ms_p99']} ms |"
              f" dropped={r['dropped']} starved={r['starved']}")

    line("fault-free:", ref)
    line("chaos:", chaos)
    print(f"[serve-bench] drill: victim {chaos['victim']!r} |"
          f" faults {[f['kind'] for f in chaos['faults_fired']]} |"
          f" dead detected in {chaos['detect_s']}s, respawned in"
          f" {chaos['recover_s']}s | {chaos['failed_over_requests']}"
          f" requests failed over ({chaos['failovers']} replays) |"
          f" health after: {chaos['health_after']}")

    failures: List[str] = []
    if ref["dropped"] or ref["starved"]:
        failures.append(
            f"fault-free reference unhealthy: {ref['dropped']} dropped,"
            f" {ref['starved']} starved")
    if chaos["dropped"]:
        failures.append(
            f"{chaos['dropped']} requests dropped/short across the"
            " replica crash — failover must lose nothing")
    if chaos["starved"]:
        failures.append(f"{chaos['starved']} requests starved past"
                        f" {args.deadline}s")
    parity_bad = sum(1 for a, b in zip(chaos["token_lists"],
                                       ref["token_lists"]) if a != b)
    if parity_bad:
        failures.append(
            f"{parity_bad} requests' greedy tokens changed across the"
            " mid-decode failover (vs the fault-free run)")
    crash_fired = any(f["kind"] == "crash" for f in chaos["faults_fired"])
    if not crash_fired:
        failures.append("the scripted crash never fired — the drill"
                        " tested nothing")
    if chaos["detect_s"] is None:
        failures.append(
            f"victim {chaos['victim']!r} was never declared DEAD")
    elif chaos["detect_s"] > args.chaos_dead:
        failures.append(
            f"DEAD verdict took {chaos['detect_s']}s — outside the"
            f" {args.chaos_dead}s heartbeat window")
    if chaos["failed_over_requests"] < 1:
        failures.append(
            "no in-flight request was failed over — the crash missed"
            " the loaded window (raise --requests or lower"
            " --chaos-crash-after)")
    if chaos["recover_s"] is None:
        failures.append(
            f"victim {chaos['victim']!r} was never respawned")
    if chaos["health_after"] != "ok":
        failures.append(
            f"fleet health is {chaos['health_after']!r} after the"
            " respawn — expected 'ok'")
    if not determinism_ok:
        failures.append(
            "FleetFaultPlan.randomized is not deterministic by seed")
    fams = chaos["exposition"]["replica_labeled_families"]
    for required in ("ff_serving_ttft_ms", "ff_kvpool_pages_used"):
        if required not in fams:
            failures.append(
                f"chaos: {required} missing a replica-labeled series in"
                " the merged exposition")

    # the observability leg: failover trace continuity, the auto-dumped
    # post-mortem bundle, and the merged Perfetto timeline
    timeline_path = None
    if args.artifacts:
        import os

        from ...obs.timeline import run_timeline

        cont = chaos["trace_continuity"]
        tracks = sorted({n for v in cont["multi_track_traces"].values()
                         for n in v})
        print(f"[serve-bench] tracing: {cont['stitched']}/"
              f"{cont['failed_over']} failed-over requests' spans stitch"
              f" under one trace_id ({cont['mid_decode']} died"
              f" mid-decode) across replica tracks {tracks} |"
              f" flight dumps:"
              f" {len(chaos['artifacts']['flight_dumps'])}")
        if cont["failed_over"] and cont["stitched"] != cont["failed_over"]:
            failures.append(
                f"trace continuity broken: only {cont['stitched']} of"
                f" {cont['failed_over']} failed-over requests' spans"
                f" stitch across the dead replica and a survivor"
                f" (unstitched trace_ids: {cont['unstitched']})")
        if cont["failed_over"] and not cont["mid_decode"]:
            failures.append(
                "no failed-over request died mid-decode — the drill"
                " never exercised cross-replica span stitching (raise"
                " --chaos-crash-after or --requests)")
        if not chaos["artifacts"]["flight_dumps"]:
            failures.append(
                "the replica death triggered no flight-recorder"
                " post-mortem dump")
        timeline_path = os.path.join(args.artifacts, "timeline.json")
        rc = run_timeline([
            "--trace", chaos["artifacts"]["trace"],
            "--events", chaos["artifacts"]["events"],
            "--flight", os.path.join(args.artifacts, "flight_recorder"),
            "--out", timeline_path, "--device", args.device])
        if rc != 0:
            failures.append(
                "the merged post-mortem timeline failed validate_trace")

    blip = (chaos["ttft_ms_p99"] / ref["ttft_ms_p99"]
            if ref["ttft_ms_p99"] > 0 else 0.0)
    print(f"[serve-bench] ttft blip: chaos p99 / fault-free p99 ="
          f" {blip:.2f}x ({chaos['ttft_ms_p99']} /"
          f" {ref['ttft_ms_p99']} ms)")

    report = {
        "bench": "serving_fleet_chaos",
        "config": vars(args),
        "chips": n_rep,
        "fault_free": {k: v for k, v in ref.items()
                       if k != "token_lists"},
        "chaos": {k: v for k, v in chaos.items() if k != "token_lists"},
        "parity_mismatches_vs_fault_free": parity_bad,
        "plan_determinism_ok": determinism_ok,
        # THE pinned numbers: how big the blast radius of one replica
        # death is, and how fast the fleet closes it
        "pinned": {
            "ttft_blip_x": round(blip, 3),
            "ttft_ms_p99_under_failover": chaos["ttft_ms_p99"],
            "dead_detect_s": chaos["detect_s"],
            "respawn_recover_s": chaos["recover_s"],
            "failed_over_requests": chaos["failed_over_requests"],
        },
    }
    if args.artifacts:
        report["timeline"] = timeline_path
        report["trace_continuity"] = chaos["trace_continuity"]
        report["flight_dumps"] = chaos["artifacts"]["flight_dumps"]
        report["pinned"]["stitched_failovers"] = \
            chaos["trace_continuity"]["stitched"]
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[serve-bench] report -> {args.report}")
    if failures:
        for f in failures:
            print(f"[serve-bench] FAIL: {f}")
        return 1
    print("[serve-bench] OK")
    return 0


# the default machine that prices the disagg handoff: the JAX bench's,
# two pods of 8 bridged by DCN (examples/machines/multipod_2x8.json's
# tiers). The bench places the prefill pool on pod 0 and the decode pool
# on pod 1, so every KV shipment prices over the DCN hop; a priced time
# is the model's, not a measurement of this machine.
_DISAGG_MACHINE_SPEC = {
    "chip": "tpu-v5e",
    "num_chips": 16,
    "tiers": [
        {"name": "ici", "degree": 8, "gbps": 45.0, "links": 2},
        {"name": "dcn", "degree": 2, "gbps": 3.125, "links": 1,
         "latency_us": 10.0},
    ],
}


def run_disagg_cli(args) -> int:
    """The `serve-bench --workload disagg` entry (dispatched from
    serving/sched/bench.py): the SAME prefill-heavy request stream
    through a unified fleet and a disaggregated (prefill pool + decode
    pool + KV-handoff plane) fleet at equal chips, with the disagg
    contract hard-asserted — decode-tail win, token parity, zero drops,
    one priced handoff per routed request, handoff spans stitched into
    each request's trace."""
    import json

    from ..sched.bench import build_tiny_lm, make_workload
    from ...search.machine_model import (HierarchicalMachineModel,
                                         load_machine_spec)

    n_rep = args.replicas
    if n_rep < 2:
        print("[serve-bench] FAIL: disagg needs --replicas >= 2 — the"
              " prefill and decode pools are disjoint replicas")
        return 1
    n_prefill = max(1, n_rep // 2)
    n_decode = n_rep - n_prefill
    window = args.prompt_max
    max_len = args.prompt_max + args.out_max
    spec = load_machine_spec(args.machine_spec) if args.machine_spec \
        else dict(_DISAGG_MACHINE_SPEC)
    machine = HierarchicalMachineModel.from_json(spec)
    device_ids = tuple(range(machine.num_chips))
    concurrency = args.slots * n_decode
    print(f"[serve-bench] disagg: {args.requests} requests"
          f" (prompts {args.prompt_min}-{args.prompt_max}, outputs"
          f" {args.out_min}-{args.out_max}) | unified {n_rep}x{args.slots}"
          f" slots vs {n_prefill} prefill + {n_decode} decode |"
          f" window {concurrency} in flight | KV priced on"
          f" {machine.num_chips}-chip"
          f" {'/'.join(t['name'] for t in spec['tiers'])} machine")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    workload = make_workload(args.requests, args.prompt_min,
                             args.prompt_max, args.out_min, args.out_max,
                             args.vocab, args.seed)
    common = dict(slots=args.slots, page_size=args.page_size,
                  max_len=max_len, deadline_s=args.deadline,
                  concurrency=concurrency,
                  prefill_chunk=args.prefill_chunk)

    def best_of(**kw) -> Dict:
        """Best (lowest p99 ITL) of --repeats runs — the ITL comparison
        is a wall-clock measurement on shared runners, and one
        descheduling stall in either run would flip the hard assert.
        Every repeat's drop/starve/handoff counts still gate."""
        import gc

        runs = []
        for _ in range(max(1, args.repeats)):
            gc.collect()  # drop the previous fleet's cache arrays
            runs.append(run_disagg_fleet(model, workload, **common, **kw))
        best = min(runs, key=lambda r: r["itl_ms_p99"] or 1e18)
        best["repeats_dropped"] = sum(r["dropped"] for r in runs)
        best["repeats_starved"] = sum(r["starved"] for r in runs)
        if "handoff" in best:
            best["repeats_handed_off_min"] = min(
                r["handoff"]["requests_handed_off"] for r in runs)
        return best

    unified = best_of(roles=["unified"] * n_rep)
    disagg = best_of(
        roles=["prefill"] * n_prefill + ["decode"] * n_decode,
        machine=machine, device_ids=device_ids, trace=True)

    def line(tag: str, r: Dict) -> None:
        print(f"[serve-bench] {tag:9s} {r['tokens']} tokens in"
              f" {r['wall_s']}s = {r['tokens_per_s']} tok/s |"
              f" itl p50/p99 {r['itl_ms_p50']}/{r['itl_ms_p99']} ms"
              f" ({r['itl_gaps']} gaps) | ttft p99 {r['ttft_ms_p99']} ms |"
              f" dropped={r['dropped']} starved={r['starved']}")

    line("unified:", unified)
    line("disagg:", disagg)
    ho = disagg["handoff"]
    print(f"[serve-bench] handoff: {ho['committed_run']} committed"
          f" ({ho['resumed']} resumed, {ho['failed']} failed) |"
          f" {ho['requests_handed_off']}/{len(workload)} requests |"
          f" learned {round(ho['bytes_per_token'] or 0.0, 1)} B/token,"
          f" last priced {round(ho['last_predicted_us'] or 0.0, 1)} us |"
          f" routes {disagg['routes']}")

    failures: List[str] = []
    for tag, r in (("unified", unified), ("disagg", disagg)):
        dropped = r.get("repeats_dropped", r["dropped"])
        starved = r.get("repeats_starved", r["starved"])
        if dropped:
            failures.append(f"{tag}: {dropped} requests dropped/short")
        if starved:
            failures.append(f"{tag}: {starved} requests starved past"
                            f" {args.deadline}s")
    parity_bad = sum(1 for a, b in zip(disagg["token_lists"],
                                       unified["token_lists"]) if a != b)
    if parity_bad:
        failures.append(
            f"{parity_bad} requests' greedy tokens changed across the"
            " prefill->decode handoff (vs the unified fleet)")
    handed = disagg.get("repeats_handed_off_min",
                        ho["requests_handed_off"])
    if handed < len(workload):
        failures.append(
            f"only {handed} of {len(workload)} routed requests were"
            " handed off to the decode pool (the rest resumed locally)")
    if ho["committed_run"] < len(workload):
        failures.append(
            f"{ho['committed_run']} committed handoffs for"
            f" {len(workload)} requests — every routed request must ship"
            f" its KV once (last_error: {ho['last_error']})")
    if not (ho["last_predicted_us"] or 0.0) > 0.0:
        failures.append(
            "handoffs were not priced: ff_disagg_predicted_transfer_us"
            " stayed 0 despite a machine model")
    missing = [n for n in ("ff_disagg_handoffs_total",
                           "ff_disagg_handoff_bytes_total",
                           "ff_disagg_handoff_ms")
               if n not in ho["disagg_families"]]
    if missing:
        failures.append(f"disagg metric families missing from the fleet"
                        f" exposition: {missing}")
    tr = disagg["trace"]
    if tr["stitched"] < len(workload):
        failures.append(
            f"handoff trace continuity broken: only {tr['stitched']} of"
            f" {len(workload)} requests have a fleet.kv_handoff span"
            f" under their own trace_id (unstitched:"
            f" {tr['unstitched'][:4]})")
    ratio = (unified["itl_ms_p99"] / disagg["itl_ms_p99"]
             if disagg["itl_ms_p99"] > 0 else 0.0)
    print(f"[serve-bench] disagg win: unified p99 ITL / disagg p99 ITL ="
          f" {ratio:.2f}x ({unified['itl_ms_p99']} /"
          f" {disagg['itl_ms_p99']} ms; require >="
          f" {args.disagg_margin}x)")
    if ratio < args.disagg_margin:
        failures.append(
            f"disaggregation did not protect the decode tail: p99 ITL"
            f" ratio {ratio:.2f}x < required {args.disagg_margin}x")

    report = {
        "bench": "serving_disagg",
        "config": vars(args),
        "chips": n_rep,
        "machine": spec,
        "unified": {k: v for k, v in unified.items()
                    if k != "token_lists"},
        "disagg": {k: v for k, v in disagg.items() if k != "token_lists"},
        "unified_over_disagg_itl_p99": round(ratio, 3),
        "parity_mismatches_vs_unified": parity_bad,
        # THE pinned numbers: what phase separation buys the decode tail
        # at equal chips, and what one KV shipment costs
        "pinned": {
            "itl_ms_p99_unified": unified["itl_ms_p99"],
            "itl_ms_p99_disagg": disagg["itl_ms_p99"],
            "itl_p99_win_x": round(ratio, 3),
            "handoffs_committed": ho["committed_run"],
            "handoff_bytes_per_token": ho["bytes_per_token"],
            "handoff_predicted_us": ho["last_predicted_us"],
        },
    }
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[serve-bench] report -> {args.report}")
    if failures:
        for f in failures:
            print(f"[serve-bench] FAIL: {f}")
        return 1
    print("[serve-bench] OK")
    return 0


def run_fleet_cli(args) -> int:
    """The `serve-bench --workload fleet` entry (dispatched from
    serving/sched/bench.py)."""
    import json

    from ..sched.bench import build_tiny_lm, make_shared_prefix_workload

    n_rep = args.replicas
    window = args.prefix_len + args.suffix_max
    max_len = window + args.out_max
    min_slots = args.min_slots if args.min_slots is not None \
        else max(1, args.slots // 2)
    max_slots = args.max_slots if args.max_slots is not None \
        else args.slots * 2
    slo_s = None if args.slo_ttft is None else args.slo_ttft / 1e3
    print(f"[serve-bench] fleet: {args.requests} sessions over"
          f" {args.prefix_groups} tenants ({args.prefix_len}-token"
          f" prefixes) x {n_rep} replicas of {args.slots} slots"
          f" (autoscale {min_slots}..{max_slots}),"
          f" slo_ttft={args.slo_ttft} ms")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    workload = make_shared_prefix_workload(
        args.requests, args.prefix_groups, args.prefix_len,
        args.suffix_min, args.suffix_max, args.out_min, args.out_max,
        args.vocab, args.seed)
    # shuffle the FOLLOWER arrival order (same permutation for all three
    # runs, so per-index parity still compares like with like): the
    # generator emits tenants cyclically, and a cyclic tenant stream is
    # exactly the pattern a round-robin router accidentally routes
    # affine — real tenant arrivals are interleaved, not modular
    rng = np.random.RandomState(args.seed + 1)
    fidx = [i for i, w in enumerate(workload) if not w["leader"]]
    shuffled = [workload[i] for i in rng.permutation(fidx)]
    for i, w in zip(fidx, shuffled):
        workload[i] = w
    import math

    pages = 2 + args.prefix_groups * math.ceil(
        (args.prefix_len + args.suffix_max) / args.page_size)

    common = dict(n_replicas=n_rep, slots=args.slots,
                  page_size=args.page_size, max_len=max_len,
                  prefix_cache_pages=pages, slo_ttft_s=slo_s,
                  deadline_s=args.deadline)

    def best_of(policy: str) -> Dict:
        """Best (lowest steady-state p99) of --repeats runs: the routing
        comparison is a wall-clock measurement on shared runners, and a
        single descheduling stall in either run would flip a hard
        assert. Every repeat's drop/starve counts still gate."""
        import gc

        runs = []
        for _ in range(max(1, args.repeats)):
            gc.collect()  # drop the previous fleet's cache arrays
            runs.append(run_fleet_static(model, workload, policy=policy,
                                         **common))
        best = min(runs, key=lambda r: r["ttft_steady_ms_p99"] or 1e18)
        best["repeats_dropped"] = sum(r["dropped"] for r in runs)
        best["repeats_starved"] = sum(r["starved"] for r in runs)
        return best

    rr = best_of("round_robin")
    affine = best_of("affine")
    auto = run_fleet_autoscale(
        model, workload, min_slots=min_slots, max_slots=max_slots,
        **common)

    def line(tag: str, r: Dict) -> None:
        # the one-line summary, p99 TTFT split by cache outcome — the
        # affine-routing win must be readable off two BENCH lines
        print(f"[serve-bench] {tag:18s} {r['tokens']} tokens in"
              f" {r['wall_s']}s = {r['tokens_per_s']} tok/s"
              f" ({r['tokens_per_s_per_chip']}/chip) |"
              f" ttft p99 {r['ttft_ms_p99']} ms"
              f" (hit {r['ttft_hit_ms_p99']} / miss"
              f" {r['ttft_miss_ms_p99']} ms,"
              f" {r['hits']}h/{r['misses']}m) |"
              f" dropped={r['dropped']} starved={r['starved']}")

    line("round-robin:", rr)
    line("affine:", affine)
    line("affine+autoscale:", auto)
    applied = [(r["replica"], r["from"], r["to"]) for r in auto["resizes"]]
    print(f"[serve-bench] autoscale: {auto['grows_applied']} grows +"
          f" {auto['shrinks_applied']} shrinks applied ({applied}),"
          f" drained {auto['drained_replica']!r}"
          f" (handed off {auto['drain']['handed_off']},"
          f" kept {auto['drain']['kept']}), sheds {auto['shed_retries']}")

    failures: List[str] = []
    for tag, r in (("round-robin", rr), ("affine", affine),
                   ("autoscale", auto)):
        dropped = r.get("repeats_dropped", r["dropped"])
        starved = r.get("repeats_starved", r["starved"])
        if dropped:
            failures.append(f"{tag}: {dropped} requests dropped/short")
        if starved:
            failures.append(
                f"{tag}: {starved} requests starved past"
                f" {args.deadline}s")
    parity_bad = sum(1 for a, b in zip(auto["token_lists"],
                                       affine["token_lists"]) if a != b)
    if parity_bad:
        failures.append(
            f"{parity_bad} requests' greedy tokens changed across the"
            " autoscale grow+shrink cycle (vs the no-resize affine run)")
    if auto["grows_applied"] < 1 or auto["shrinks_applied"] < 1:
        failures.append(
            f"autoscale cycle incomplete: {auto['grows_applied']} grows,"
            f" {auto['shrinks_applied']} shrinks applied (need >= 1 each)")
    ratio = (rr["ttft_steady_ms_p99"] / affine["ttft_steady_ms_p99"]
             if affine["ttft_steady_ms_p99"] > 0 else 0.0)
    print(f"[serve-bench] affine win: rr steady-state p99 / affine"
          f" steady-state p99 = {ratio:.2f}x"
          f" ({rr['ttft_steady_ms_p99']} / {affine['ttft_steady_ms_p99']}"
          f" ms; leaders excluded — require >= {args.affine_margin}x)")
    if ratio < args.affine_margin:
        failures.append(
            f"prefix-affine routing did not beat round-robin:"
            f" steady-state p99 TTFT ratio {ratio:.2f}x < required"
            f" {args.affine_margin}x")
    for tag, r in (("affine", affine), ("autoscale", auto)):
        fams = r["exposition"]["replica_labeled_families"]
        for required in ("ff_serving_ttft_ms", "ff_serving_queue_depth",
                         "ff_kvpool_pages_used"):
            if required not in fams:
                failures.append(
                    f"{tag}: {required} missing a replica-labeled series"
                    " in the merged exposition")

    report = {
        "bench": "serving_fleet",
        "config": vars(args),
        "chips": n_rep,
        "round_robin": {k: v for k, v in rr.items()
                        if k != "token_lists"},
        "affine": {k: v for k, v in affine.items() if k != "token_lists"},
        "autoscale": {k: v for k, v in auto.items()
                      if k != "token_lists"},
        "affine_over_rr_ttft_p99": round(ratio, 3),
        "parity_mismatches_vs_noresize": parity_bad,
        # THE pinned numbers: fleet throughput per chip and tail TTFT
        # while meshes resize underneath the traffic
        "pinned": {
            "tokens_per_s_per_chip": auto["tokens_per_s_per_chip"],
            "ttft_ms_p99_under_resize": auto["ttft_ms_p99"],
            "ttft_hit_ms_p99_under_resize": auto["ttft_hit_ms_p99"],
            "ttft_miss_ms_p99_under_resize": auto["ttft_miss_ms_p99"],
        },
    }
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[serve-bench] report -> {args.report}")
    if failures:
        for f in failures:
            print(f"[serve-bench] FAIL: {f}")
        return 1
    print("[serve-bench] OK")
    return 0
