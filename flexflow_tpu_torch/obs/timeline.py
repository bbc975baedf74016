"""`python -m flexflow_tpu_torch timeline`: merge every telemetry stream
into ONE Perfetto-loadable Chrome trace (counterpart of
flexflow_tpu/obs/timeline.py; host code, the same output dict).

The tracer, the elastic EventLog, health transitions, and the flight
recorder's periodic metric snapshots are four timelines with two
different clocks: span `ts` values are microseconds from the tracer's
`perf_counter` epoch, while events and snapshots are wall-clock stamped.
The tracer records the wall<->perf_counter epoch PAIR at construction
and exports it in its `trace_metadata` record, so this merger can place
every wall-clocked record onto the span axis exactly:

    ts_us = (wall_s - epoch_wall_s) * 1e6

Input streams:
 - ``--trace trace.json``  — a tracer export (spans, instants, flow
   arrows, per-replica thread names); its metadata supplies the epoch.
 - ``--events events.json``— an `EventLog.to_json` dump; every event
   becomes an instant on a dedicated "fleet events" track, health
   verdicts (fleet.suspect/dead/respawn) on their own "health verdicts"
   track.
 - ``--flight DIR``        — a flight-recorder post-mortem bundle (or a
   dump root, in which case the NEWEST `postmortem_*` bundle is taken):
   its metric snapshots land on a "metric snapshots" track, its
   recorded events fill in when no --events file is given, and its
   bundled trace.json is used when --trace is absent.

The merged file self-validates against the Chrome-trace spec checker
(`obs.cli.validate_trace`) before the CLI exits 0; the last stdout line
is a JSON summary (event counts per stream, distinct trace ids seen).
`--device cuda|cpu` is taken as every subcommand takes it; the merge
runs on the host either way.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

# synthetic track ids for the non-span streams — far above the tracer's
# small per-thread tids so they never collide
TID_EVENTS = 9001
TID_HEALTH = 9002
TID_METRICS = 9003

_HEALTH_KINDS = ("fleet.suspect", "fleet.dead", "fleet.respawn")


def _trace_epoch(trace: Dict[str, Any]) -> Optional[float]:
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "trace_metadata":
            wall = e.get("args", {}).get("epoch_wall_s")
            if wall is not None:
                return float(wall)
    return None


def _trace_pid(trace: Dict[str, Any]) -> int:
    for e in trace.get("traceEvents", []):
        if "pid" in e:
            return e["pid"]
    return os.getpid()


def merge_timeline(trace: Dict[str, Any],
                   events: Optional[List[Dict[str, Any]]] = None,
                   flight: Optional[Dict[str, Any]] = None,
                   epoch_wall_s: Optional[float] = None) -> Dict[str, Any]:
    """Merge a tracer export with EventLog records and a flight-recorder
    ring into one Chrome-trace container. `events` is the
    `EventLog.to_json` list; `flight` is a loaded `recorder.json` dict.
    When both carry the event stream, the explicit `events` list wins
    (the flight ring is a bounded copy of the same records)."""
    epoch = epoch_wall_s if epoch_wall_s is not None else _trace_epoch(trace)
    if epoch is None:
        raise ValueError(
            "no wall<->perf epoch: the trace has no trace_metadata record"
            " and no --epoch-wall was given; streams cannot be aligned")
    pid = _trace_pid(trace)

    def ts_us(wall_s: float) -> float:
        return (float(wall_s) - epoch) * 1e6

    merged: List[Dict[str, Any]] = list(trace.get("traceEvents", []))
    tracks = {TID_EVENTS: "fleet events", TID_HEALTH: "health verdicts",
              TID_METRICS: "metric snapshots"}
    for tid, name in tracks.items():
        merged.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    counts = {"spans": sum(1 for e in trace.get("traceEvents", [])
                           if e.get("ph") != "M"),
              "events": 0, "health": 0, "metrics": 0}

    ring = (flight or {}).get("entries", [])
    if events is None:
        events = [{"kind": r["kind"], "step": r.get("step", -1),
                   "time_s": r["wall_s"], "details": r.get("details", {})}
                  for r in ring if r.get("stream") in ("events", "health")]
    for e in events:
        kind = e["kind"]
        health = kind in _HEALTH_KINDS
        args = dict(e.get("details", {}))
        if e.get("step", -1) >= 0:
            args["step"] = e["step"]
        merged.append({
            "name": kind, "ph": "i", "s": "t",
            "ts": ts_us(e["time_s"]), "pid": pid,
            "tid": TID_HEALTH if health else TID_EVENTS,
            "args": args,
        })
        counts["health" if health else "events"] += 1
    for r in ring:
        if r.get("stream") != "metrics":
            continue
        merged.append({
            "name": f"metrics.{r.get('source', 'registry')}", "ph": "i",
            "s": "t", "ts": ts_us(r["wall_s"]), "pid": pid,
            "tid": TID_METRICS,
            "args": {"source": r.get("source", "registry"),
                     "lines": len(r.get("text", "").splitlines())},
        })
        counts["metrics"] += 1
    return {"traceEvents": merged, "displayTimeUnit": "ms",
            "metadata": {"merged_streams": counts,
                         "epoch_wall_s": epoch}}


def _load_flight(path: str) -> Dict[str, Any]:
    """Load a bundle's recorder.json; a dump ROOT resolves to its newest
    postmortem_* bundle."""
    if os.path.isdir(path):
        direct = os.path.join(path, "recorder.json")
        if os.path.exists(direct):
            with open(direct) as f:
                return json.load(f)
        bundles = sorted(glob.glob(os.path.join(path, "postmortem_*")))
        if not bundles:
            raise SystemExit(f"--flight {path}: no recorder.json and no"
                             " postmortem_* bundles inside")
        with open(os.path.join(bundles[-1], "recorder.json")) as f:
            out = json.load(f)
        out["_bundle_dir"] = bundles[-1]
        return out
    with open(path) as f:
        return json.load(f)


def run_timeline(argv: List[str]) -> int:
    from ..config import take_device
    from .cli import _take, validate_trace

    argv = list(argv)
    take_device(argv)
    trace_path = _take(argv, "--trace", None)
    events_path = _take(argv, "--events", None)
    flight_path = _take(argv, "--flight", None)
    out_path = _take(argv, "--out", "timeline.json")
    epoch = _take(argv, "--epoch-wall", None, cast=float)
    if argv:
        raise SystemExit(f"timeline: unrecognized arguments {argv}")
    if trace_path is None and flight_path is None:
        raise SystemExit("timeline: need --trace and/or --flight")

    flight = _load_flight(flight_path) if flight_path else None
    if trace_path is None:
        bundle_dir = (flight or {}).get("_bundle_dir") or flight_path
        candidate = os.path.join(bundle_dir, "trace.json")
        if not os.path.exists(candidate):
            raise SystemExit(
                f"timeline: no --trace and the bundle {bundle_dir!r}"
                " carries no trace.json")
        trace_path = candidate
    with open(trace_path) as f:
        trace = json.load(f)
    events = None
    if events_path:
        with open(events_path) as f:
            events = json.load(f)

    merged = merge_timeline(trace, events=events, flight=flight,
                            epoch_wall_s=epoch)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    try:
        names = validate_trace(out_path)
    except ValueError as exc:
        print(f"[timeline] FAIL: merged trace is not spec-compliant:"
              f" {exc}")
        return 1
    trace_ids = {e["args"]["trace_id"]
                 for e in merged["traceEvents"]
                 if isinstance(e.get("args"), dict)
                 and "trace_id" in e["args"]}
    summary = {"out": out_path,
               "events": len(merged["traceEvents"]),
               "streams": merged["metadata"]["merged_streams"],
               "span_names": len(names),
               "trace_ids": len(trace_ids)}
    print(json.dumps(summary))
    return 0
