"""Autoscaler: zero-drop capacity control for a serving fleet.

Watches every READY replica's load — admission queue depth, KV-pool page
utilization, and observed p99 TTFT read straight off the per-replica obs
registries (`Histogram.quantile` over `ff_serving_ttft_ms`) — and resizes
individual replica meshes through `ContinuousBatcher.request_resize`,
the live-resharding path (docs/resharding.md): a grow applies between
scheduler iterations, a shrink DEFERS until live sequences fit, held
admissions stay queued (never 429d), and in-flight requests keep
decoding token-identically. Nothing is ever dropped by a scale event —
that is the resize contract, not an autoscaler promise.

Beyond per-replica mesh resizes it can change fleet MEMBERSHIP: with a
`replica_factory`, sustained overload at max_slots adds a replica
(`Router.add_replica`); sustained fleet-wide idleness drains the
emptiest surplus replica through the router's handoff protocol and
removes it once empty. The same factory RESPAWNS replicas the
HealthMonitor declared DEAD (`Router.lost_replicas`): each tick builds
a fresh replacement under the dead replica's name, clears the lost
marker (health() returns to "ok", the degraded SLO tightening lifts),
and resets the replacement's health verdict and straggler baseline —
FailureDetector.reset_latency semantics, applied equally after a mesh
resize resolves, so recompile-slow first iterations never re-flag a
recovered replica.

`tick()` is the whole control loop, deliberately synchronous and
re-entrant-free so tests and serve-bench drive it deterministically;
`start(interval_s)` wraps it in a daemon thread for real deployments.
Scale decisions are edge-triggered with one pending resize ticket per
replica — a slow resize is never double-issued.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from ...elastic import events as ev
from ...obs.tracing import get_tracer
from .replica import ReplicaState
from .router import Router


class Autoscaler:
    def __init__(self, router: Router, min_slots: int = 1,
                 max_slots: int = 8, grow_step: int = 2,
                 shrink_step: int = 2, queue_hi: int = 2,
                 util_hi: float = 0.85, util_lo: float = 0.25,
                 ttft_p99_slo_ms: Optional[float] = None,
                 replica_factory: Optional[Callable] = None,
                 max_replicas: Optional[int] = None, min_replicas: int = 1,
                 idle_ticks_before_shrink: int = 2,
                 idle_ticks_before_drain: int = 3,
                 ttft_window_ticks: int = 20,
                 preplanner=None, preplan_fn: Optional[Callable] = None,
                 monitor=None, role: Optional[str] = None,
                 prefill_backlog_slo_s: Optional[float] = None,
                 itl_p99_slo_ms: Optional[float] = None):
        if not 1 <= int(min_slots) <= int(max_slots):
            raise ValueError(
                f"need 1 <= min_slots ({min_slots}) <= max_slots"
                f" ({max_slots})")
        self.router = router
        self.min_slots = int(min_slots)
        self.max_slots = int(max_slots)
        self.grow_step = max(1, int(grow_step))
        self.shrink_step = max(1, int(shrink_step))
        self.queue_hi = int(queue_hi)
        self.util_hi = float(util_hi)
        self.util_lo = float(util_lo)
        self.ttft_p99_slo_ms = ttft_p99_slo_ms
        self.replica_factory = replica_factory
        self.max_replicas = max_replicas
        self.min_replicas = max(1, int(min_replicas))
        # shrink hysteresis: one momentarily-empty wave must not bounce
        # the mesh (every resize respecializes the decode dispatch — on
        # a real chip that is a recompile stall worth avoiding)
        self.idle_ticks_before_shrink = max(1, int(idle_ticks_before_shrink))
        self.idle_ticks_before_drain = int(idle_ticks_before_drain)
        # the TTFT SLO signal reads a sliding window of the last
        # `ttft_window_ticks` ticks (per-replica Histogram.snapshot
        # baselines): the histogram is lifetime-cumulative, and judging
        # the SLO on lifetime p99 would turn one historic slow burst
        # into permanent overload (grow forever, shrink never)
        self.ttft_window_ticks = max(1, int(ttft_window_ticks))
        # background pre-planning (search/plan_cache.py, docs/search.md):
        # when overload first appears while room to grow remains, the
        # NEXT resize target's plan is pre-computed off the tick thread
        # (`preplan_fn` — typically a closure running the replica
        # model's Unity search for the grown mesh into the plan cache),
        # so the eventual replica add / resize consumes a cache hit
        # instead of paying a cold search under load. Re-armed when the
        # fleet returns to all-idle.
        self.preplanner = preplanner
        self.preplan_fn = preplan_fn
        self._preplanned = False
        # HealthMonitor (fleet/health.py), when the fleet runs one:
        # respawns and applied resizes reset the replica's health
        # verdict + straggler baseline through it
        self.monitor = monitor
        # disaggregated serving (docs/serving.md): role=None governs the
        # whole fleet (classic unified autoscaling); role="prefill" /
        # "decode" scopes EVERY decision — overload signals, resizes,
        # replica adds/drains, and respawns — to that pool, so the two
        # pools size independently from their OWN saturation currencies:
        # the prefill pool from queue depth + backlog-seconds at the
        # measured prefill rate, the decode pool from pages-used
        # utilization + windowed p99 inter-token latency
        if role is not None and role not in ("prefill", "decode",
                                             "unified"):
            raise ValueError(
                f"role={role!r}: choose prefill, decode, unified or None")
        self.role = role
        self.prefill_backlog_slo_s = prefill_backlog_slo_s
        self.itl_p99_slo_ms = itl_p99_slo_ms
        self._itl_snaps: Dict[str, Deque] = {}
        self._ttft_snaps: Dict[str, Deque] = {}
        self._replica_idle: Dict[str, int] = {}
        self.log: List[Dict] = []
        self._pending: Dict[str, object] = {}  # replica -> ResizeTicket
        self._idle_ticks = 0
        self._added = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._c_actions = router.registry.counter(
            "ff_fleet_autoscale_total",
            "Autoscaler actions by kind (grow/shrink/add_replica/"
            "drain_replica)", labels=("action",))

    # -- signals -----------------------------------------------------------
    def _overloaded(self, name: str, rep) -> bool:
        if self.role == "prefill":
            # prefill pool: pressure accumulates as queued prefill work,
            # not page residency (parked requests release pages at
            # handoff). Backlog-seconds is rate-aware: the same queue
            # depth on a slower mesh is more overloaded.
            if rep.queue_depth() > self.queue_hi:
                return True
            if self.prefill_backlog_slo_s is not None \
                    and rep.prefill_backlog_s() \
                    > self.prefill_backlog_slo_s:
                return True
            if self.ttft_p99_slo_ms is not None \
                    and self._windowed_ttft_p99(name, rep) \
                    > self.ttft_p99_slo_ms:
                return True
            return False
        if self.role == "decode":
            # decode pool: imports bypass the wait queue (the KV arrives
            # materialized), so saturation is pages USED and what the
            # user feels — windowed p99 inter-token latency
            if rep.utilization() > self.util_hi:
                return True
            if self.itl_p99_slo_ms is not None \
                    and self._windowed_itl_p99(name, rep) \
                    > self.itl_p99_slo_ms:
                return True
            return False
        if rep.queue_depth() > self.queue_hi:
            return True
        if rep.utilization() > self.util_hi:
            return True
        if self.ttft_p99_slo_ms is not None \
                and self._windowed_ttft_p99(name, rep) \
                > self.ttft_p99_slo_ms:
            return True
        return False

    def _windowed_ttft_p99(self, name: str, rep) -> float:
        """p99 TTFT over (at most) the last `ttft_window_ticks` ticks:
        quantile of the histogram delta since the oldest snapshot the
        per-tick `_advance_ttft_window` retained. 0.0 until the first
        tick has snapshotted, so pre-autoscaler history never counts."""
        snaps = self._ttft_snaps.get(name)
        if not snaps:
            return 0.0
        return rep.ttft_p99_ms(since=snaps[0])

    def _advance_ttft_window(self, name: str, rep) -> None:
        if self.ttft_p99_slo_ms is not None:
            self._ttft_snaps.setdefault(
                name, deque(maxlen=self.ttft_window_ticks)).append(
                rep.ttft_window())
        if self.itl_p99_slo_ms is not None:
            self._itl_snaps.setdefault(
                name, deque(maxlen=self.ttft_window_ticks)).append(
                rep.itl_window())

    def _windowed_itl_p99(self, name: str, rep) -> float:
        """Windowed p99 ITL, same snapshot-delta mechanics as the TTFT
        signal (`_windowed_ttft_p99`)."""
        snaps = self._itl_snaps.get(name)
        if not snaps:
            return 0.0
        return rep.itl_p99_ms(since=snaps[0])

    def _idle(self, rep) -> bool:
        return (rep.queue_depth() == 0
                and rep.utilization() < self.util_lo)

    # -- the control loop --------------------------------------------------
    def tick(self) -> List[Dict]:
        """One evaluation pass; returns the actions it took. Resize
        tickets resolve asynchronously (the batcher applies them between
        iterations) — completed ones are folded into the log on the next
        tick."""
        actions: List[Dict] = []
        tracer = get_tracer()
        with self._lock:
            # resolve tickets the schedulers finished since last tick
            for name, ticket in list(self._pending.items()):
                if ticket.done():
                    del self._pending[name]
                    if ticket.error is None:
                        applied = dict(ticket.result)
                        applied["replica"] = name
                        applied["action"] = "resize_applied"
                        self.log.append(applied)
                        # reset the straggler baseline: the resized mesh
                        # recompiles its dispatches, and those slow first
                        # iterations must not flag a healthy replica
                        # (FailureDetector.reset_latency semantics)
                        self._reset_health(name)
            # respawn replicas the HealthMonitor declared DEAD: a fresh
            # replacement under the SAME name, so affinity re-learns it
            # and health() walks back from degraded to ok
            if self.replica_factory is not None:
                lost_roles = self.router.lost_replica_roles()
                for name, reason in self.router.lost_replicas().items():
                    if self.role is not None \
                            and lost_roles.get(name, "unified") \
                            != self.role:
                        continue  # another pool's casualty
                    act = self._respawn(name, reason, tracer)
                    if act:
                        actions.append(act)
            ready = [(n, r) for n, r in
                     ((n, self.router.replica(n))
                      for n in self.router.replica_names())
                     if r.state is ReplicaState.READY
                     and (self.role is None or r.role == self.role)]
            all_idle = bool(ready) and all(self._idle(r) for _, r in ready)
            self._idle_ticks = self._idle_ticks + 1 if all_idle else 0
            if all_idle:
                self._preplanned = False  # next overload pre-plans again
            elif (not self._preplanned and self.preplanner is not None
                    and self.preplan_fn is not None
                    and any(self._overloaded(n, r) for n, r in ready)):
                # overload is building: pre-compute the next resize
                # target's plan off the tick thread, so the grow /
                # replica add consumes a cache hit instead of paying a
                # cold search at event time
                self._preplanned = True
                self.preplanner.submit("fleet.resize_target",
                                       self.preplan_fn)
                self._c_actions.inc(action="preplan")
                actions.append({"action": "preplan",
                                "t": time.monotonic()})
            for name, rep in ready:
                self._advance_ttft_window(name, rep)
                if name in self._pending:
                    continue  # one in-flight resize per replica
                slots = rep.num_slots()
                if self._idle(rep):
                    self._replica_idle[name] = \
                        self._replica_idle.get(name, 0) + 1
                else:
                    self._replica_idle[name] = 0
                if self._overloaded(name, rep):
                    if slots < self.max_slots:
                        target = min(self.max_slots,
                                     slots + self.grow_step)
                        act = self._resize(name, rep, target, "grow",
                                           tracer)
                        if act:
                            actions.append(act)
                    elif (self.replica_factory is not None
                          and (self.max_replicas is None
                               or self._pool_size() < self.max_replicas)):
                        act = self._add_replica(tracer)
                        if act:
                            actions.append(act)
                elif (self._replica_idle.get(name, 0)
                        >= self.idle_ticks_before_shrink
                        and slots > self.min_slots):
                    target = max(self.min_slots, slots - self.shrink_step)
                    act = self._resize(name, rep, target, "shrink", tracer)
                    if act:
                        actions.append(act)
                    self._replica_idle[name] = 0
            # fleet-wide sustained idleness: retire the emptiest surplus
            # replica (drain + handoff + remove happens off-thread so the
            # tick stays non-blocking)
            if (self._idle_ticks >= self.idle_ticks_before_drain
                    and len(ready) > self.min_replicas):
                act = self._drain_replica(ready, tracer)
                if act:
                    actions.append(act)
                    self._idle_ticks = 0
        self.log.extend(actions)
        return actions

    def _resize(self, name: str, rep, target: int, direction: str,
                tracer) -> Optional[Dict]:
        try:
            with tracer.span("fleet.autoscale", action=direction,
                             replica=name, target=target):
                ticket = rep.request_resize(target)
        except RuntimeError:
            return None  # a resize is already pending on the batcher
        self._pending[name] = ticket
        self._c_actions.inc(action=direction)
        return {"action": direction, "replica": name,
                "from": rep.num_slots(), "to": target,
                "t": time.monotonic()}

    def _reset_health(self, name: str) -> None:
        """Forget a replica's health verdict + step-latency EWMA after a
        respawn or an applied resize — through the monitor when one is
        wired, straight at the replica otherwise."""
        if self.monitor is not None:
            self.monitor.reset(name)
            return
        try:
            rep = self.router.replica(name)
        except KeyError:
            return
        rep.reset_latency()

    def _respawn(self, name: str, reason: str, tracer) -> Optional[Dict]:
        with tracer.span("fleet.autoscale", action="respawn",
                         replica=name):
            rep = self.router.add_replica(name, self.replica_factory)
        if rep is None:
            return None  # factory failed; router recorded it, retry next
        self.router.clear_lost(name)
        self._reset_health(name)
        if self.router.events is not None:
            self.router.events.record(ev.FLEET_RESPAWN, replica=name,
                                      reason=reason)
        self._c_actions.inc(action="respawn")
        return {"action": "respawn", "replica": name, "reason": reason,
                "t": time.monotonic()}

    def _pool_size(self) -> int:
        """Replicas this autoscaler governs (max_replicas bounds the
        POOL in a role-scoped autoscaler, not the whole fleet)."""
        if self.role is None:
            return len(self.router.replica_names())
        return sum(1 for n in self.router.replica_names()
                   if self.router.replica(n).role == self.role)

    def _add_replica(self, tracer) -> Optional[Dict]:
        self._added += 1
        # role-scoped autoscalers must not collide on replica names —
        # two pools each minting "auto1" would trip add_replica
        name = f"auto{self._added}" if self.role is None \
            else f"auto-{self.role}{self._added}"
        with tracer.span("fleet.autoscale", action="add_replica",
                         replica=name):
            rep = self.router.add_replica(name, self.replica_factory)
        if rep is None:
            return None  # factory failed; router recorded it
        self._c_actions.inc(action="add_replica")
        return {"action": "add_replica", "replica": name,
                "t": time.monotonic()}

    def _drain_replica(self, ready, tracer) -> Optional[Dict]:
        # retire the one with the fewest live sequences (fastest to empty)
        name, rep = min(ready, key=lambda nr: nr[1].live_sequences())
        with tracer.span("fleet.autoscale", action="drain_replica",
                         replica=name):
            self.router.drain(name)
        self._c_actions.inc(action="drain_replica")

        def _finish():
            try:
                self.router.remove(name, timeout=600.0)
            except Exception:
                pass  # replica stays draining; next drain attempt retries

        threading.Thread(target=_finish, daemon=True).start()
        return {"action": "drain_replica", "replica": name,
                "t": time.monotonic()}

    def pending_resizes(self) -> List[str]:
        with self._lock:
            return sorted(self._pending)

    # -- background loop ---------------------------------------------------
    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(timeout=interval_s):
                try:
                    self.tick()
                except Exception:
                    pass  # a torn tick must not kill the control loop

        self._thread = threading.Thread(target=_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
