"""`python -m flexflow_tpu_torch.elastic.drill`: scripted fail-and-recover
runs (the port's counterpart of flexflow_tpu/elastic/drill.py).

Runs the elastic + durability story end to end on `--devices N` ranks of
torch.distributed (gloo; on the CPU with `--device cpu`, else ranks that
share the card): train a small MLP under a scripted adversity scenario,
then compare the final loss against an uninterrupted reference run of
the same seed and data. Each run is one job of
tools/tp_train.py `spawn_jobs` (`elastic_job`); a lost rank leaves its
run at the loss, and every rank joins a fresh process group for the
next run.

    python -m flexflow_tpu_torch.elastic.drill --devices 8 --kill 2 \\
        --at-step 5 --device cpu
    python -m flexflow_tpu_torch.elastic.drill --scenario nan-step
    python -m flexflow_tpu_torch.elastic.drill --scenario corrupt-checkpoint
    python -m flexflow_tpu_torch.elastic.drill --scenario live-reshard

Scenarios (--scenario):
  default            a transient hiccup (retry absorbs it) + a K-rank kill
                     (re-plan on the survivors, restore, resume)
  nan-step           consecutive blown-up steps: the watchdog skips the
                     first bad batches, then rolls back to the last-good
                     verified checkpoint and replays
  corrupt-checkpoint the newest checkpoint file is torn on disk, THEN
                     ranks die: the recovery restore must fall back to the
                     previous verified checkpoint instead of crashing
                     (live resharding is off here — the scenario exists
                     to prove the disk path's verified fallback)
  live-reshard       two runs: (a) a clean kill recovers by redistributing
                     the survivors' LIVE state onto the re-planned mesh —
                     asserts ZERO checkpoint-file reads, resume from the
                     failing step, and a restore no slower than the disk
                     run's; (b) the live state is silently poisoned before
                     the kill — asserts the verification catches it and
                     the recovery falls back to disk

Exit code 0 iff the run finished, the scenario's recovery machinery
actually engaged, and the final loss landed within tolerance of the
reference. The last stdout line is a JSON summary (including the
`ff_watchdog_*` / `ff_checkpoint_*` lines the serving /metrics endpoint
of the rank that led at the end would export for the run).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

from ..config import require_device


def _take(argv: List[str], flag: str, default, cast=int):
    """Pop `flag VALUE` from argv (the last occurrence wins), cast;
    `default` when absent."""
    val = default
    while flag in argv:
        i = argv.index(flag)
        if i + 1 >= len(argv):
            raise SystemExit(f"{flag} needs a value")
        val = cast(argv[i + 1])
        del argv[i:i + 2]
    return val


SCENARIOS = ("default", "nan-step", "corrupt-checkpoint", "live-reshard")


def _leader(ranks: List[Dict]) -> Dict:
    """The result of the rank that led at the end of a run."""
    alive = [r for r in ranks if not r["departed"]]
    lead = alive[0]["device_ids"][0]
    return next(r for r in alive if r["rank"] == lead)


def run_drill(argv: Optional[List[str]] = None) -> int:
    argv = list(argv or [])
    scenario = _take(argv, "--scenario", "default", cast=str)
    devices = _take(argv, "--devices", 8)
    kill = _take(argv, "--kill", 2)
    at_step = _take(argv, "--at-step", 5)
    steps = _take(argv, "--steps", None)
    batch = _take(argv, "--batch-size", None)
    budget = _take(argv, "--budget", 8)
    seed = _take(argv, "--seed", 0)
    tolerance = _take(argv, "--tolerance", 0.5, cast=float)
    trace_out = _take(argv, "--trace-out", None, cast=str)
    device = _take(argv, "--device", "cuda", cast=str)
    timeout_s = _take(argv, "--timeout", 900.0, cast=float)
    if argv:
        print(f"warning: unrecognized drill flags {argv}", file=sys.stderr)
    if scenario not in SCENARIOS:
        raise SystemExit(f"--scenario {scenario!r}: choices are "
                         f"{', '.join(SCENARIOS)}")
    require_device(device)
    if scenario == "nan-step":
        kill = 0  # numerics drill: the mesh stays intact
    if kill >= devices:
        raise SystemExit(f"--kill {kill} must leave at least one of "
                         f"--devices {devices} alive")
    if device == "cuda":
        from ..kernels import _build

        _build.library()  # once, before the ranks start

    from .watchdog import WatchdogPolicy

    # nan-step scripts this many consecutive blown-up steps: enough to
    # exhaust the skip budget (forcing a rollback) plus one more that the
    # replay meets as a plain skip
    bad_run = WatchdogPolicy().max_consecutive_bad + 1
    survivors = devices - kill
    if batch is None:
        # one batch size every candidate dp degree divides, before AND
        # after the kill
        batch = int(np.lcm(devices, max(1, survivors))) * 2
    if steps is None:
        steps = at_step + (bad_run + 6 if scenario == "nan-step" else 6)

    rng = np.random.RandomState(seed)
    n_samples = batch * 4
    x = rng.randn(n_samples, 64).astype(np.float32)
    # learnable labels (a fixed random linear map of x): the loss has to
    # keep DECREASING through the recovery for the drill to prove resume
    w_true = rng.randn(64, 10).astype(np.float32)
    y = np.argmax(x @ w_true, axis=1).reshape(-1, 1).astype(np.int32)
    chips = tuple(range(survivors, devices))
    tmp = tempfile.mkdtemp(prefix="ff_drill_")

    def run(tag, faults, **coordinator):
        spec = {"widths": {"din": 64, "hidden": 128, "classes": 10},
                "batch": batch, "seed": seed, "accuracy": True,
                "config": {"search_budget": budget,
                           "measure_op_costs": False},
                "faults": faults, "x": x, "y": y, "steps": steps,
                "checkpoint_dir": os.path.join(tmp, tag),
                "retry": {"max_retries": 3, "base_delay_s": 0.01},
                "coordinator": dict({"checkpoint_every": 2},
                                    **coordinator),
                "trace": bool(trace_out) and tag != "ref",
                "trace_out": trace_out if tag in ("run", "live") else None}
        return {"elastic": spec}

    jobs: Dict[str, Dict] = {}
    if scenario == "live-reshard":
        jobs["live"] = run("live", [("chip_loss", at_step, chips, 1)])
        # both faults in the SAME dispatch (poison is non-raising and
        # listed first): the rot exists at recovery time
        jobs["disk"] = run("disk", [("poison_live_state", at_step, (), 1),
                                    ("chip_loss", at_step, chips, 1)])
    elif scenario == "nan-step":
        jobs["run"] = run("run", [("nan_step", s, (), 1) for s in
                                  range(at_step, at_step + bad_run)])
    elif scenario == "corrupt-checkpoint":
        jobs["run"] = run("run", [("corrupt_checkpoint", at_step, (), 1),
                                  ("chip_loss", at_step, chips, 1)],
                          live_resharding=False)
    else:
        jobs["run"] = run("run", [("transient", max(1, at_step // 2), (),
                                   1), ("chip_loss", at_step, chips, 1)])
    # uninterrupted reference: same data, seed and step count on all ranks
    jobs["ref"] = run("ref", [], checkpoint_every=10 ** 9)

    from ..tools.tp_train import spawn_jobs

    ranks = spawn_jobs(devices, device, list(jobs.values()),
                       timeout_s=timeout_s, workdir=tmp)
    runs = {tag: _leader([r["jobs"][i] for r in ranks])
            for i, tag in enumerate(jobs)}
    from ..runtime.profiling import print_event_log
    from .events import EventLog

    ref_final = runs["ref"]["history"][-1]["loss"]

    def within(v):
        return bool(np.isfinite(v) and abs(v - ref_final)
                    <= tolerance * max(1.0, abs(ref_final)))

    if scenario == "live-reshard":
        return _live_reshard_summary(runs, devices, kill, at_step, steps,
                                     within, ref_final, trace_out)
    lead = runs["run"]
    events = EventLog.from_json(lead["events_json"])
    print_event_log(events)
    history = lead["history"]
    final = history[-1]["loss"]
    counts = events.counts()
    if scenario == "nan-step":
        engaged = (counts.get("watchdog.rollback", 0) >= 1
                   and counts.get("watchdog.skip", 0) >= 1)
    elif scenario == "corrupt-checkpoint":
        engaged = (counts.get("recovery.done", 0) >= 1
                   and counts.get("checkpoint.fallback", 0) >= 1)
    else:
        engaged = (counts.get("recovery.done", 0) >= 1
                   and counts.get("retry", 0) >= 1)
    # loss must keep decreasing THROUGH the recovery: batches cycle, so
    # compare the last step against the first step that saw the same batch
    spe = n_samples // batch
    by_batch: Dict[int, List[float]] = {}
    for h in history:
        by_batch.setdefault(h["step"] % spe, []).append(h["loss"])
    same_batch = by_batch[history[-1]["step"] % spe]
    if len(same_batch) < 2:
        revisited = [v for v in by_batch.values() if len(v) >= 2]
        same_batch = revisited[-1] if revisited else None
    improved = same_batch is None or same_batch[-1] < same_batch[0]
    ok = bool(engaged and within(final) and improved)
    summary = {
        "ok": ok,
        "scenario": scenario,
        "devices": devices,
        "killed": kill,
        "n_devices_final": len(lead["device_ids"]),
        "recoveries": counts.get("recovery.done", 0),
        "retries": counts.get("retry", 0),
        "watchdog_skips": counts.get("watchdog.skip", 0),
        "watchdog_rollbacks": counts.get("watchdog.rollback", 0),
        "checkpoint_fallbacks": counts.get("checkpoint.fallback", 0),
        "steps": steps,
        "final_loss": round(float(final), 6),
        "reference_loss": round(float(ref_final), 6),
        "final_axes": lead["axes"],
        "events": counts,
        "metrics": lead["metrics"],
    }
    if trace_out:
        summary["trace"] = lead.get("trace")
        summary["trace_spans"] = lead.get("spans")
    print(json.dumps(summary))
    return 0 if ok else 1


def _live_reshard_summary(runs, devices, kill, at_step, steps, within,
                          ref_final, trace_out) -> int:
    """Run (a) proves the zero-disk path — a kill recovered by
    redistributing live state, with ZERO checkpoint-file reads, resume at
    the failing step, and a restore at least as fast as run (b)'s disk
    restore; run (b) poisons the live state first, proving verification
    routes the same kill to the checkpoint fallback."""
    from ..runtime.profiling import print_event_log
    from .events import EventLog

    a, b = runs["live"], runs["disk"]
    events_a = EventLog.from_json(a["events_json"])
    events_b = EventLog.from_json(b["events_json"])
    counts_a = a["checkpoint_counts"]
    # every path that touches a checkpoint FILE during a restore
    reads_a = (counts_a.get("restored", 0) + counts_a.get("verified", 0)
               + counts_a.get("corrupt", 0))
    restores_a = events_a.events("recovery.restore")
    restores_b = events_b.events("recovery.restore")
    live_ms = restores_a[0].details.get("restore_ms") if restores_a \
        else None
    disk_ms = restores_b[0].details.get("restore_ms") if restores_b \
        else None
    fallbacks = events_b.events("recovery.live_fallback")
    print("[drill] run (a): clean kill, live recovery")
    print_event_log(events_a)
    print("[drill] run (b): poisoned state, disk fallback")
    print_event_log(events_b)
    final_a = a["history"][-1]["loss"]
    final_b = b["history"][-1]["loss"]
    checks = {
        "live_recovery": a["restores"]["live"] == 1,
        "zero_checkpoint_reads": reads_a == 0,
        "resumed_at_failing_step": bool(restores_a
                                        and restores_a[0].step == at_step),
        "no_replay": [h["step"] for h in a["history"]] == list(range(steps)),
        "poison_detected": any(e.details.get("reason") == "verify"
                               for e in fallbacks),
        "disk_fallback": b["restores"]["disk"] == 1,
        "live_restore_not_slower": (live_ms is not None
                                    and disk_ms is not None
                                    and live_ms <= disk_ms),
        "loss_within_tolerance": within(final_a) and within(final_b),
    }
    ok = all(checks.values())
    summary = {
        "ok": ok,
        "scenario": "live-reshard",
        "devices": devices,
        "killed": kill,
        "steps": steps,
        "checks": checks,
        "live_restore_ms": live_ms,
        "disk_restore_ms": disk_ms,
        "live_restores": a["restores"]["live"],
        "disk_restores": b["restores"]["disk"],
        "checkpoint_file_reads_live_run": reads_a,
        "reshard": a["reshard"],
        "final_loss_live": round(float(final_a), 6),
        "final_loss_disk": round(float(final_b), 6),
        "reference_loss": round(float(ref_final), 6),
        "final_axes_live": a["axes"],
        "events_live": events_a.counts(),
        "events_disk": events_b.counts(),
    }
    if trace_out:
        summary["trace"] = a.get("trace")
        summary["trace_spans"] = a.get("spans")
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run_drill(sys.argv[1:]))
