"""Profiling utilities (counterpart of flexflow_tpu/runtime/profiling.py).

 - `profile_ops()` times each op's forward in isolation, with the cost
   simulator's own measurement (search/simulator.py OpCostCache: the op's
   lowering on a copy of the op, CUDA events on the card);
 - `trace(log_dir)` records a torch.profiler session (CPU and, on the
   card, CUDA activity) and writes its Chrome trace into `log_dir`;
 - `print_profile`, `print_event_log` and `IterationTimer` as in the JAX
   package (per-step wall timing lives in FFModel.fit's StepStats).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler session over the block; on exit its Chrome
    trace is written to `log_dir`/trace.json (the device's kernels too
    when CUDA is available)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_ops(model, warmup: int = 2, repeats: int = 5) -> List[Dict]:
    """Per-op forward timing on the model's device, sorted slowest-first
    (JAX `profile_ops`): the same measurement the cost simulator profiles
    with (OpCostCache ≙ Simulator::measure_operator_cost, simulator.cc:489),
    each op run over its actual input shapes."""
    from ..ffconst import OpType
    from ..search.simulator import OpCostCache, OpStrategy

    cache = OpCostCache(model.config, warmup=warmup, repeats=repeats)
    rows = []
    strategy = OpStrategy(dp=1, tp=1)
    for op in model.graph.topo_order():
        if op.op_type in (OpType.INPUT, OpType.WEIGHT, OpType.NOOP):
            continue
        try:
            us = cache.measure_forward_us(op, strategy)
        except Exception as e:  # unmeasurable ops (e.g. multi-output glue)
            rows.append({"op": op.name, "type": op.op_type.value,
                         "forward_us": float("nan"),
                         "error": f"{type(e).__name__}: {e}"})
            continue
        rows.append({
            "op": op.name,
            "type": op.op_type.value,
            "forward_us": us,
            "gflops": op.flops() / 1e9,
            "eff_tflops": (op.flops() / (us * 1e-6)) / 1e12 if us > 0 else 0.0,
        })
    rows.sort(key=lambda r: -(r["forward_us"]
                              if math.isfinite(r["forward_us"]) else -1))
    return rows


def print_profile(rows: List[Dict], top: Optional[int] = 20) -> None:
    print(f"{'op':<28} {'type':<20} {'fwd us':>10} {'eff TFLOP/s':>12}")
    for r in rows[:top]:
        if "error" in r:
            print(f"{r['op']:<28} {r['type']:<20} {'--':>10}  {r['error']}")
        else:
            print(f"{r['op']:<28} {r['type']:<20} {r['forward_us']:>10.1f} "
                  f"{r['eff_tflops']:>12.2f}")


def print_event_log(events, sink=print, tail: Optional[int] = None) -> None:
    """Render an elastic EventLog (elastic/events.py) next to the timing
    output: one line per fault/retry/recovery record, then the per-kind
    counts. tail=N limits to the last N events; tail=0 shows no per-event
    lines, only the counts summary."""
    all_evs = events.events()
    evs = all_evs if tail is None else (all_evs[-tail:] if tail > 0 else [])
    if not all_evs:
        sink("elastic: no events")
        return
    if evs:
        t0 = evs[0].time_s
        for e in evs:
            details = " ".join(
                f"{k}={v}" for k, v in sorted(e.details.items()))
            sink(f"+{e.time_s - t0:8.3f}s step {e.step:>5} "
                 f"{e.kind:<22} {details}")
    sink(events.summary())


class IterationTimer:
    """Rolling per-iteration wall timing (reference: per-`--print-freq`
    samples/s prints in the examples), a thin wrapper over
    `obs.StepStats` on a registry of its own, so a user's timer (eval
    loops etc.) never inflates the process-wide ff_train_steps_total /
    ff_step_* families that FFModel.fit's StepStats publishes."""

    def __init__(self, batch_size: int, print_freq: int = 10,
                 sink=print):
        from ..obs.registry import MetricsRegistry
        from ..obs.stepstats import StepStats

        self.batch_size = batch_size
        self.print_freq = print_freq
        self.sink = sink
        self._stats = StepStats(print_freq=print_freq, sink=sink,
                                registry=MetricsRegistry())
        self._started = False

    @property
    def _count(self) -> int:
        return self._stats.total_steps

    def tick(self):
        if not self._started:
            self._stats.start()
            self._started = True
            return
        self._stats.record_step(self.batch_size)
