"""Fleet health: heartbeat + straggler detection and the DEAD verdict.

The serving-side sibling of `elastic/detector.py` (training's
FailureDetector). Three independent signals feed one READY → SUSPECT →
DEAD state machine per replica:

 - **crash**: the replica's scheduler thread exited while the replica
   still claims to serve (state READY/DRAINING). A scheduler bug or an
   injected crash fails its loop (`_fail_all`) and leaves a dead thread
   — verdict DEAD immediately, no grace period: the thread cannot come
   back.
 - **heartbeat**: the scheduler stamps a heartbeat at the top of EVERY
   loop iteration and the idle wait wakes at least every 0.1 s, so a
   heartbeat older than `suspect_after_s` means a hung dispatch, not an
   empty queue. Older than `dead_after_s` ⇒ DEAD.
 - **straggler**: EWMA busy-iteration wall (`step_latency_s`) scored
   against the FLEET MEDIAN — a replica `slow_factor` x slower than its
   siblings for `straggle_probes` consecutive polls is SUSPECT (same
   relative-to-cohort scoring as FailureDetector, whose absolute knobs
   this mirrors: slow_factor 3.0, EWMA alpha 0.3, 2-step warmup lives
   in the batcher). Straggling alone never kills — a slow replica still
   makes progress; operators see the SUSPECT gauge and the autoscaler's
   latency signal already routes work away from it.

A DEAD verdict triggers `on_dead(name, reason)` — by default the
router's `fail_over`, which evicts the replica and re-dispatches its
in-flight requests token-exactly (router.py). State is exported as
`ff_fleet_health_state{replica}` (0 ready / 1 suspect / 2 dead) and
every transition lands in the elastic EventLog (FLEET_SUSPECT /
FLEET_DEAD), so serving incidents read from the same stream as
training faults.

`poll()` runs one synchronous sweep (what the tests drive);
`start(interval_s)` runs it from a daemon thread like the Autoscaler.
`reset(name)` forgets a replica's verdict and its latency baseline
after a respawn/resize (FailureDetector.reset_latency semantics — a
recovered replica's recompile iterations must not re-flag it).
"""
from __future__ import annotations

import enum
import statistics
import threading
from typing import Callable, Dict, Optional

from ...elastic import events as ev
from ...obs.registry import MetricsRegistry
from .replica import ReplicaState


class ReplicaLost(RuntimeError):
    """The replica serving this request died (crash, hang, eviction)
    before the request finished. The fleet layer catches this — a
    FleetRequest holds its consumer across the failover replay — and
    only surfaces it when the retry budget/deadline is exhausted or no
    survivor can take the work."""


class HealthState(enum.Enum):
    READY = 0
    SUSPECT = 1
    DEAD = 2


class HealthMonitor:
    """Heartbeat/straggler prober over a Router's replicas.

    on_dead: called once per DEAD verdict with (replica_name, reason);
    defaults to `router.fail_over` — eviction + token-exact replay. The
    callback runs on the polling thread with no monitor lock held.
    """

    def __init__(self, router, suspect_after_s: float = 1.0,
                 dead_after_s: float = 3.0, slow_factor: float = 3.0,
                 straggle_probes: int = 3,
                 registry: Optional[MetricsRegistry] = None,
                 event_log: Optional[ev.EventLog] = None,
                 on_dead: Optional[Callable[[str, str], None]] = None):
        if dead_after_s < suspect_after_s:
            raise ValueError(
                f"dead_after_s={dead_after_s} < suspect_after_s="
                f"{suspect_after_s}: a replica cannot die before it is"
                " suspect")
        self.router = router
        self.suspect_after_s = float(suspect_after_s)
        self.dead_after_s = float(dead_after_s)
        self.slow_factor = float(slow_factor)
        self.straggle_probes = max(1, int(straggle_probes))
        self.registry = registry if registry is not None \
            else getattr(router, "registry", None) or MetricsRegistry()
        self.events = event_log
        self.on_dead = on_dead if on_dead is not None else \
            (lambda name, reason: router.fail_over(name, reason=reason))
        self._lock = threading.Lock()
        self._state: Dict[str, HealthState] = {}
        self._streak: Dict[str, int] = {}   # consecutive straggle polls
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._g_state = self.registry.gauge(
            "ff_fleet_health_state",
            "Replica health verdict (0 ready / 1 suspect / 2 dead)",
            labels=("replica",))

    # -- verdicts ----------------------------------------------------------
    def state(self, name: str) -> HealthState:
        with self._lock:
            return self._state.get(name, HealthState.READY)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {n: s.name.lower() for n, s in self._state.items()}

    def reset(self, name: str) -> None:
        """Forget a replica's verdict and latency baseline — call after
        respawn/resize so recompile-slow first iterations are not scored
        (FailureDetector.reset_latency)."""
        with self._lock:
            self._state.pop(name, None)
            self._streak.pop(name, None)
        try:
            rep = self.router.replica(name)
        except KeyError:
            self._g_state.remove(replica=name)
            return
        rep.reset_latency()
        self._g_state.set(HealthState.READY.value, replica=name)

    def _transition(self, name: str, to: HealthState, reason: str,
                    **details) -> bool:
        """Record a state change; returns True when it is NEW (callbacks
        and events fire once per verdict, not once per poll)."""
        with self._lock:
            old = self._state.get(name, HealthState.READY)
            if old is to:
                return False
            if old is HealthState.DEAD:
                return False  # DEAD is terminal until reset()
            self._state[name] = to
        self._g_state.set(to.value, replica=name)
        if self.events is not None:
            kind = {HealthState.SUSPECT: ev.FLEET_SUSPECT,
                    HealthState.DEAD: ev.FLEET_DEAD}.get(to)
            if kind is not None:
                self.events.record(kind, replica=name, reason=reason,
                                   **details)
        return True

    # -- one sweep ---------------------------------------------------------
    def poll(self) -> Dict[str, str]:
        """One synchronous probe sweep over the router's replicas.
        Returns {replica: verdict} for the replicas probed; DEAD
        verdicts have already fired `on_dead` by the time it returns."""
        with getattr(self.router, "_lock"):
            reps = dict(self.router._replicas)
        # fleet-median step latency for the relative straggler score
        lats = {}
        for name, rep in reps.items():
            if rep.state in (ReplicaState.STOPPED, ReplicaState.DEAD):
                continue
            lat = rep.step_latency_s()
            if lat is not None and lat > 0:
                lats[name] = lat
        # a median needs siblings to compare against: with one sample the
        # replica would be scored against itself and never flag
        median = statistics.median(lats.values()) if len(lats) >= 2 else None
        out: Dict[str, str] = {}
        dead = []
        for name, rep in reps.items():
            if rep.state in (ReplicaState.STOPPED, ReplicaState.DEAD):
                continue
            verdict, reason, details = self._probe(
                name, rep, lats.get(name), median)
            out[name] = verdict.name.lower()
            if verdict is HealthState.DEAD:
                if self._transition(name, verdict, reason, **details):
                    dead.append((name, reason))
            elif verdict is HealthState.SUSPECT:
                self._transition(name, verdict, reason, **details)
            else:
                # recovered on its own (e.g. a hang shorter than
                # dead_after_s): walk SUSPECT back to READY
                with self._lock:
                    if self._state.get(name) is HealthState.SUSPECT:
                        self._state[name] = HealthState.READY
                self._g_state.set(HealthState.READY.value, replica=name)
        for name, reason in dead:
            self.on_dead(name, reason)
        return out

    def _probe(self, name, rep, lat, median):
        # 1) crash: scheduler thread gone while the replica claims to
        #    serve — no grace, the thread cannot come back
        if not rep.scheduler_alive():
            return HealthState.DEAD, "scheduler_crashed", {}
        # 2) heartbeat: stale top-of-loop stamp = hung dispatch
        age = rep.heartbeat_age_s()
        if age is not None:
            if age > self.dead_after_s:
                return (HealthState.DEAD, "heartbeat_timeout",
                        {"age_s": round(age, 3)})
            if age > self.suspect_after_s:
                return (HealthState.SUSPECT, "heartbeat_stale",
                        {"age_s": round(age, 3)})
        # 3) straggler: slow vs the fleet median for N consecutive polls
        if (lat is not None and median is not None and median > 0
                and lat > self.slow_factor * median):
            with self._lock:
                streak = self._streak.get(name, 0) + 1
                self._streak[name] = streak
            if streak >= self.straggle_probes:
                return (HealthState.SUSPECT, "straggler",
                        {"step_s": round(lat, 4),
                         "median_s": round(median, 4),
                         "probes": streak})
        else:
            with self._lock:
                self._streak.pop(name, None)
        return HealthState.READY, "", {}

    # -- background polling (Autoscaler-style daemon) ----------------------
    def start(self, interval_s: float = 0.25) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception:  # pragma: no cover - probe must not die
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-health")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
