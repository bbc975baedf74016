"""StepStats: per-step training statistics in a bounded ring buffer
(counterpart of flexflow_tpu/obs/stepstats.py).

`FFModel.fit`
records every committed optimizer step (or K-step dispatch chunk) here —
wall ms, samples/s, achieved TFLOP/s, and MFU against the machine spec's
peak — and summarizes at fit end. The ring (`capacity`) bounds memory on
long runs; the newest records also feed the registry metrics
`ff_train_steps_total`, `ff_step_wall_ms` (histogram),
`ff_step_samples_per_s` and `ff_step_mfu` (gauges).

FLOPs accounting: `op.flops()` is the per-batch FORWARD estimate; a
training step is priced at 3x forward (backward ~2x forward — the
standard accounting, e.g. PaLM appendix B). MFU = achieved TFLOP/s over
`n_devices * chip peak` from the cost model's machine spec (the H100's
989 bf16 / 67 f32 TFLOP/s on a CUDA config), so the number is comparable
with the cost simulator's roofline. The wall is the host clock between
two records: with a K-step graph, the per-dispatch interval that fit's
one-deep pipeline reads anyway, so recording adds no device sync.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

from .registry import REGISTRY, MetricsRegistry

TRAIN_FLOPS_FACTOR = 3.0  # fwd + bwd(≈2x fwd)

_WALL_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                    250.0, 500.0, 1000.0, 5000.0)


def model_train_flops_per_step(model) -> float:
    """Whole-graph per-step training FLOPs for a compiled FFModel."""
    if model.graph is None:
        return 0.0
    return TRAIN_FLOPS_FACTOR * sum(
        op.flops() for op in model.graph.ops.values())


def model_peak_tflops(model) -> float:
    """Aggregate peak TFLOP/s of the device set, from the same machine
    spec the cost simulator prices against."""
    from ..search.machine_model import make_machine_model

    n_dev = max(1, model.config.total_devices)
    chip = make_machine_model(model.config, n_dev).chip
    per_chip = (chip.peak_bf16_tflops if model.config.allow_mixed_precision
                else chip.peak_f32_tflops)
    return per_chip * n_dev


class StepStats:
    """Ring buffer of per-step records with derived throughput/MFU.

    Usage: `start()` arms the clock; `record_step(samples, loss,
    steps=K)` closes one dispatch (K optimizer steps) and opens the next
    interval. Zero-duration intervals (fast no-op steps on CPU CI) record
    wall_ms=0 with rates of 0 rather than dividing by zero."""

    def __init__(self, flops_per_step: float = 0.0,
                 peak_tflops: float = 0.0, capacity: int = 2048,
                 registry: Optional[MetricsRegistry] = None,
                 print_freq: int = 0, sink=print):
        self.flops_per_step = float(flops_per_step)
        self.peak_tflops = float(peak_tflops)
        self._records: deque = deque(maxlen=max(1, capacity))
        self._mark: Optional[float] = None
        self._total_steps = 0
        self._total_samples = 0
        # optional periodic print (the IterationTimer role)
        self.print_freq = int(print_freq)
        self.sink = sink
        reg = registry if registry is not None else REGISTRY
        self._m_steps = reg.counter(
            "ff_train_steps_total", "Committed optimizer steps")
        self._m_wall = reg.histogram(
            "ff_step_wall_ms", "Per-optimizer-step wall time (ms)",
            buckets=_WALL_MS_BUCKETS)
        self._m_rate = reg.gauge(
            "ff_step_samples_per_s", "Most recent step throughput")
        self._m_mfu = reg.gauge(
            "ff_step_mfu", "Most recent step model FLOPs utilization")

    # -- recording --------------------------------------------------------
    def start(self) -> None:
        self._mark = time.perf_counter()

    def record_step(self, samples: int, loss: Optional[float] = None,
                    steps: int = 1,
                    wall_s: Optional[float] = None) -> Dict[str, float]:
        """Close the current interval as `steps` optimizer steps that
        consumed `samples` samples total. `wall_s`, where the caller has
        timed the interval itself (fit: the committed step record's
        wall), is taken as it is and the clock is not read."""
        now = time.perf_counter()
        if wall_s is None:
            if self._mark is None:
                self._mark = now
            wall_s = max(0.0, now - self._mark)
        self._mark = now
        steps = max(1, int(steps))
        per_step_s = wall_s / steps
        rate = samples / wall_s if wall_s > 0 else 0.0
        tflops = (self.flops_per_step / per_step_s / 1e12
                  if per_step_s > 0 and self.flops_per_step > 0 else 0.0)
        mfu = tflops / self.peak_tflops if self.peak_tflops > 0 else 0.0
        rec = {
            "wall_ms": wall_s * 1e3,
            "step_ms": per_step_s * 1e3,
            "steps": float(steps),
            "samples": float(samples),
            "samples_per_s": rate,
            "tflops": tflops,
            "mfu": mfu,
        }
        if loss is not None:
            rec["loss"] = float(loss)
        self._records.append(rec)
        self._total_steps += steps
        self._total_samples += samples
        self._m_steps.inc(steps)
        self._m_wall.observe(per_step_s * 1e3)
        self._m_rate.set(rate)
        self._m_mfu.set(mfu)
        if self.print_freq > 0 and self.sink is not None \
                and self._total_steps % self.print_freq == 0:
            self.sink(
                f"iter {self._total_steps}: {rate:.1f} samples/s "
                f"({per_step_s * 1e3:.1f} ms/iter"
                + (f", mfu={mfu:.3f}" if self.peak_tflops > 0 else "")
                + ")")
        return rec

    # -- reading ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    @property
    def total_steps(self) -> int:
        return self._total_steps

    def records(self) -> List[Dict[str, float]]:
        return list(self._records)

    def last(self) -> Optional[Dict[str, float]]:
        return self._records[-1] if self._records else None

    def mean_step_ms(self) -> float:
        recs = self.records()
        if not recs:
            return 0.0
        return sum(r["step_ms"] for r in recs) / len(recs)

    def summary(self) -> Dict[str, Any]:
        recs = self.records()
        if not recs:
            return {"steps": self._total_steps, "recorded": 0}
        step_ms = sorted(r["step_ms"] for r in recs)

        def pct(p: float) -> float:
            return step_ms[min(len(step_ms) - 1,
                               int(p / 100.0 * len(step_ms)))]

        rated = [r for r in recs if r["samples_per_s"] > 0]
        return {
            "steps": self._total_steps,
            "recorded": len(recs),
            "samples": self._total_samples,
            "mean_step_ms": sum(step_ms) / len(step_ms),
            "p50_step_ms": pct(50),
            "p95_step_ms": pct(95),
            "mean_samples_per_s": (
                sum(r["samples_per_s"] for r in rated) / len(rated)
                if rated else 0.0),
            "mean_tflops": (sum(r["tflops"] for r in recs) / len(recs)),
            "mean_mfu": (sum(r["mfu"] for r in recs) / len(recs)),
            "last_loss": recs[-1].get("loss"),
        }

    def format_summary(self) -> str:
        s = self.summary()
        if not s.get("recorded"):
            return "step stats: no recorded steps"
        return (f"step stats: {s['steps']} step(s), "
                f"mean {s['mean_step_ms']:.2f} ms/step "
                f"(p95 {s['p95_step_ms']:.2f}), "
                f"{s['mean_samples_per_s']:.1f} samples/s, "
                f"{s['mean_tflops']:.2f} TFLOP/s, "
                f"mfu={s['mean_mfu']:.4f}")
