"""The fleet's measurement drivers (the port's copy of
flexflow_tpu/serving/fleet/bench.py, without its argparse front ends,
which come with the serve-bench CLI):

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
