"""Always-on fleet flight recorder: a bounded ring over every telemetry
stream, dumped automatically as a post-mortem bundle on the events that
matter (a host-only copy of flexflow_tpu/obs/flightrecorder.py).

When a replica dies mid-decode, the evidence is scattered over four disjoint streams (the elastic EventLog,
the span tracer, health transitions, metric gauges) and gone by the time
anyone asks. The FlightRecorder closes that gap the way an aircraft
recorder does: always on, bounded (`capacity` entries, oldest dropped),
cheap enough to never turn off, and it WRITES THE BUNDLE BY ITSELF the
moment a trigger fires:

 - ``fleet.dead``       — a replica's DEAD verdict (HealthMonitor)
 - ``fleet.failover``   — in-flight work replayed on survivors
 - ``watchdog.rollback``— training rolled back to the last good step
 - ``recovery.start``   — an elastic chip-loss recovery began

Each dump is a directory `postmortem_<seq>_<kind>/` under `dump_dir`:

 - ``recorder.json`` — the ring contents (events, health transitions,
   manual records, periodic metric snapshots) plus trigger metadata
 - ``trace.json``    — the tracer's Chrome trace at dump time (when a
   tracer is attached), epoch + drop count stamped in its metadata
 - ``metrics_<source>.txt`` — a fresh exposition render per registry

The bundle's trace.json loads in Perfetto as it is.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..elastic import events as ev

# the event kinds that auto-trigger a post-mortem dump
DEFAULT_DUMP_KINDS = (ev.FLEET_DEAD, ev.FLEET_FAILOVER,
                      ev.WATCHDOG_ROLLBACK, ev.RECOVERY_START)
# health-verdict kinds are tagged as their own stream in the ring
_HEALTH_KINDS = (ev.FLEET_SUSPECT, ev.FLEET_DEAD, ev.FLEET_RESPAWN)


class FlightRecorder:
    """Bounded always-on recorder over EventLog / tracer / health /
    metric-snapshot streams, with automatic post-mortem dumps.

    `registries` is {source name: MetricsRegistry} — snapshotted on
    `snapshot_metrics()` (call it from a control loop, or `start()` a
    periodic daemon) and re-rendered fresh into every dump.
    """

    def __init__(self, dump_dir: str = "flight_recorder",
                 capacity: int = 4096, tracer=None,
                 registries: Optional[Dict[str, Any]] = None,
                 dump_kinds: Tuple[str, ...] = DEFAULT_DUMP_KINDS,
                 max_dumps: int = 8, debounce_s: float = 5.0):
        self.dump_dir = str(dump_dir)
        self.tracer = tracer
        self.registries = dict(registries or {})
        self.dump_kinds = tuple(dump_kinds)
        self.max_dumps = int(max_dumps)
        # auto-dump debounce: one replica death fans out into a burst of
        # trigger events (DEAD verdict + one failover per replayed
        # request) that all describe the SAME incident — the first one
        # writes the bundle, the rest within `debounce_s` are recorded in
        # the ring but don't each dump. Manual `dump()` always writes.
        self.debounce_s = float(debounce_s)
        self._last_auto_dump = -float("inf")
        self.dumps: List[str] = []
        self._ring: deque = deque(maxlen=int(capacity))
        self._dropped = 0
        self._seq = 0
        self._lock = threading.Lock()
        self._logs: List[Tuple[Any, Any]] = []   # (event_log, listener)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- wiring ------------------------------------------------------------
    def attach(self, event_log) -> "FlightRecorder":
        """Subscribe to an EventLog; every record lands in the ring and
        trigger kinds dump a bundle."""
        fn = event_log.subscribe(self._on_event)
        self._logs.append((event_log, fn))
        return self

    def detach(self) -> None:
        for log, fn in self._logs:
            log.unsubscribe(fn)
        self._logs.clear()
        self.stop()

    def _on_event(self, e) -> None:
        stream = "health" if e.kind in _HEALTH_KINDS else "events"
        self._append({"stream": stream, "kind": e.kind, "step": e.step,
                      "wall_s": e.time_s, "details": dict(e.details)})
        if e.kind in self.dump_kinds:
            now = time.monotonic()
            with self._lock:
                debounced = (now - self._last_auto_dump
                             < self.debounce_s)
                if not debounced:
                    self._last_auto_dump = now
            if not debounced:
                self.dump(trigger=e.kind)

    # -- recording ---------------------------------------------------------
    def record(self, stream: str, **payload) -> None:
        """A manual ring entry (e.g. a router noting a routing anomaly the
        event log has no kind for)."""
        self._append(dict(payload, stream=str(stream),
                          wall_s=time.time()))

    def snapshot_metrics(self) -> None:
        """One ring entry per attached registry with its full exposition
        render — the periodic state the post-mortem aligns against."""
        now = time.time()
        for source, reg in self.registries.items():
            try:
                text = reg.render()
            except Exception as exc:  # never fail the observed path
                text = f"# render failed: {exc}\n"
            self._append({"stream": "metrics", "source": source,
                          "wall_s": now, "text": text})

    def _append(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(entry)

    def entries(self, stream: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        if stream is not None:
            out = [e for e in out if e.get("stream") == stream]
        return out

    # -- periodic metric snapshots (Autoscaler-style daemon) ---------------
    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.snapshot_metrics()
                except Exception:  # pragma: no cover - must not die
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="flight-recorder")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- post-mortem dumps -------------------------------------------------
    def dump(self, trigger: str = "manual") -> Optional[str]:
        """Write one post-mortem bundle; returns its directory (None once
        `max_dumps` is reached — a crash-looping fleet must not fill the
        disk)."""
        with self._lock:
            if len(self.dumps) >= self.max_dumps:
                return None
            self._seq += 1
            seq = self._seq
            ring = list(self._ring)
            dropped = self._dropped
        name = f"postmortem_{seq:03d}_{trigger.replace('.', '_')}"
        path = os.path.join(self.dump_dir, name)
        os.makedirs(path, exist_ok=True)
        meta = {
            "trigger": trigger, "seq": seq, "wall_s": time.time(),
            "ring_entries": len(ring), "ring_dropped": dropped,
            "streams": sorted({e.get("stream", "?") for e in ring}),
        }
        with open(os.path.join(path, "recorder.json"), "w") as f:
            json.dump({"meta": meta, "entries": ring}, f, indent=1,
                      default=str)
        if self.tracer is not None:
            try:
                self.tracer.export_chrome_trace(
                    os.path.join(path, "trace.json"))
            except Exception:
                pass
        for source, reg in self.registries.items():
            try:
                with open(os.path.join(path,
                                       f"metrics_{source}.txt"), "w") as f:
                    f.write(reg.render())
            except Exception:
                pass
        with self._lock:
            self.dumps.append(path)
        return path
