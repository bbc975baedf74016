"""Structured fault/recovery event log (a host-only copy of
flexflow_tpu/elastic/events.py): the canonical event kinds, `ElasticEvent`
and the thread-safe `EventLog`.

Every fault the injector fires, every detector classification, every
retry, every watchdog verdict and every phase of the coordinator's
recoveries (search, restore, resume) lands here as one timestamped
record, so a post-mortem can replay what the runtime saw and did; on a
mesh every rank keeps its own log, and the survivors' logs agree. The
serving metrics endpoint exports its per-kind counters
(`InferenceServer.attach_elastic_events`), and
runtime/profiling.py `print_event_log` renders it.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# canonical event kinds (free-form kinds are allowed; these are the ones the
# runtime itself emits)
FAULT_TRANSIENT = "fault.transient"
FAULT_SLOW_LINK = "fault.slow_link"
FAULT_CHIP_LOSS = "fault.chip_loss"
DETECT_SLOW = "detect.slow_step"
DETECT_TOPOLOGY = "detect.topology_loss"
RETRY = "retry"
CHECKPOINT = "checkpoint"
RECOVERY_START = "recovery.start"
RECOVERY_SEARCH = "recovery.search"
RECOVERY_RESTORE = "recovery.restore"
RECOVERY_DONE = "recovery.done"
# plan-sanitizer verdict on a re-planned model (analysis/pipeline.py)
PLAN_ANALYSIS = "analysis.plan"
# durability layer (runtime/durability.py): checksum failures, fallback to
# an older verified checkpoint, retention GC
CHECKPOINT_CORRUPT = "checkpoint.corrupt"
CHECKPOINT_FALLBACK = "checkpoint.fallback"
CHECKPOINT_GC = "checkpoint.gc"
# training watchdog (elastic/watchdog.py)
WATCHDOG_BAD_STEP = "watchdog.bad_step"
WATCHDOG_SKIP = "watchdog.skip"
WATCHDOG_ROLLBACK = "watchdog.rollback"
# injected durability faults (elastic/faults.py)
FAULT_NAN_STEP = "fault.nan_step"
FAULT_CORRUPT_CKPT = "fault.corrupt_checkpoint"
# live-resharding faults + recovery-path routing (resharding/)
FAULT_POISON_LIVE = "fault.poison_live_state"
RECOVERY_LIVE_FALLBACK = "recovery.live_fallback"
# calibration-drift feedback loop (obs/refit.py + coordinator)
DRIFT_BREACH = "drift.breach"
DRIFT_REFIT = "drift.refit"
DRIFT_REPLAN = "drift.replan"
# the drift re-plan's search record (search_ms/cache/cost) — a separate
# kind from recovery.search so consumers of either stream never read
# the other's events
DRIFT_SEARCH = "drift.search"
# background pre-planning (search/plan_cache.py BackgroundPlanner): a
# plan for an ANTICIPATED topology was computed off the critical path
PLAN_PRECOMPUTE = "plan.precompute"
# serving-fleet failure domain (serving/fleet/{chaos,health,router}.py):
# injected faults, health-state transitions, and in-flight failover
FLEET_FAULT = "fleet.fault"
FLEET_SUSPECT = "fleet.suspect"
FLEET_DEAD = "fleet.dead"
FLEET_FAILOVER = "fleet.failover"
FLEET_RESPAWN = "fleet.respawn"


@dataclasses.dataclass(frozen=True)
class ElasticEvent:
    """One fault/recovery record."""

    kind: str
    step: int
    time_s: float  # wall-clock (time.time) at record time
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "step": self.step,
                "time_s": self.time_s, "details": dict(self.details)}


class EventLog:
    """Append-only, thread-safe log of ElasticEvents (the serving endpoint
    reads it from handler threads while training appends)."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._events: List[ElasticEvent] = []
        self._clock = clock
        self._lock = threading.Lock()
        self._subscribers: List[Callable[[ElasticEvent], None]] = []

    def subscribe(self, fn: Callable[[ElasticEvent], None]) -> Callable:
        """Register a live listener called (on the recording thread, no
        log lock held) with every ElasticEvent as it is recorded — how
        the flight recorder (obs/flightrecorder.py) mirrors the stream.
        Listener exceptions are swallowed: observation must never fail
        the recovery path being observed."""
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[ElasticEvent], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def record(self, kind: str, step: int = -1, **details) -> ElasticEvent:
        ev = ElasticEvent(kind=kind, step=step, time_s=self._clock(),
                          details=details)
        with self._lock:
            self._events.append(ev)
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(ev)
            except Exception:
                pass
        return ev

    def events(self, kind: Optional[str] = None) -> List[ElasticEvent]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events():
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def to_json(self) -> str:
        return json.dumps([e.to_dict() for e in self.events()])

    @classmethod
    def from_json(cls, text: str) -> "EventLog":
        log = cls()
        for d in json.loads(text):
            with log._lock:
                log._events.append(ElasticEvent(
                    kind=d["kind"], step=d["step"], time_s=d["time_s"],
                    details=dict(d.get("details", {}))))
        return log

    def prometheus_text(self, prefix: str = "ff_elastic") -> str:
        """Per-kind counters in Prometheus exposition format (merged into
        the serving /metrics endpoint)."""
        lines = [f"# TYPE {prefix}_events_total counter"]
        for kind, n in sorted(self.counts().items()):
            lines.append(f'{prefix}_events_total{{kind="{kind}"}} {n}')
        return "\n".join(lines) + "\n"

    def summary(self) -> str:
        """One line per kind with counts, for log tails."""
        c = self.counts()
        if not c:
            return "elastic: no events"
        return "elastic: " + ", ".join(
            f"{k}={n}" for k, n in sorted(c.items()))
