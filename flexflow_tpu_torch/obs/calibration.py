"""Simulator calibration: predicted vs measured cost, per op and per step
(counterpart of flexflow_tpu/obs/calibration.py).

The paper's central bet is that a profiling-based cost simulator can rank
parallelization strategies; this module measures how far the simulator's
predictions drift from reality on the current backend. Two levels:

 - STEP: the searched plan's predicted step cost
   (`SearchResult.predicted_step_us`, or an analytic re-simulation of the
   chosen strategies when no search ran) against the measured mean step
   wall time from `FFModel.step_stats`.
 - OP: the cost model's per-op forward estimate under each op's CHOSEN
   strategy against an on-device micro-benchmark of the same op
   (`search/simulator.OpCostCache` — the same measurement the measured-
   cost search mode uses), so a systematic bias is attributable to a
   specific op family.

The report renders as a table, serializes to JSON, and publishes
`ff_sim_step_calibration_ratio` — measured/predicted, 1.0 = perfectly
calibrated — on the registry. Its `backend` is the model device's, in
`jax.default_backend()`'s words for the same hardware ("gpu" for CUDA,
"cpu"), so a report or profile means the same in both packages.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional

from .registry import REGISTRY

def _tier_families() -> Dict[str, str]:
    """op_type value -> kernel-tier family, DERIVED from the registry's
    OPTYPE_FAMILY so the two layers cannot drift (a new tier op family
    automatically accumulates residual evidence here)."""
    from ..kernels.registry import OPTYPE_FAMILY

    return {k.value: v for k, v in OPTYPE_FAMILY.items()}


# materialized at import: rows store op_type as its string value
KERNEL_TIER_FAMILIES = _tier_families()


def op_family_residuals(rows) -> Dict[str, float]:
    """Per-kernel-family residual: the MEDIAN measured/predicted ratio
    over a family's calibrated ops (median, not mean — one bad
    micro-measurement must not nominate a kernel). Only finite ratios
    count; families with no measurable op are absent. This is the
    evidence `refit` persists into the FittedProfile and the
    KernelRegistry selects fused kernels from."""
    by_fam: Dict[str, List[float]] = {}
    for r in rows:
        fam = KERNEL_TIER_FAMILIES.get(getattr(r, "op_type", None))
        if fam is None:
            continue
        ratio = r.ratio
        if math.isfinite(ratio):
            by_fam.setdefault(fam, []).append(ratio)
    out: Dict[str, float] = {}
    for fam, ratios in by_fam.items():
        ratios.sort()
        n = len(ratios)
        out[fam] = (ratios[n // 2] if n % 2
                    else 0.5 * (ratios[n // 2 - 1] + ratios[n // 2]))
    return out


@dataclasses.dataclass
class OpCalibration:
    op: str
    op_type: str
    strategy: str
    predicted_us: float
    measured_us: float  # NaN when the op is unmeasurable in isolation
    error: Optional[str] = None
    # compute-dtype class ("bf16"/"f32") the prediction priced against —
    # the refit layer fits a separate effective flop rate per class
    dtype: str = ""

    @property
    def ratio(self) -> float:
        """measured/predicted, or NaN whenever either side is degenerate
        (non-positive or non-finite) — a zero/negative measured time
        (clock resolution on trivially small ops) must never produce a 0,
        negative, or inf ratio in a report."""
        if not (self.predicted_us > 0 and math.isfinite(self.predicted_us)
                and self.measured_us > 0
                and math.isfinite(self.measured_us)):
            return float("nan")
        return self.measured_us / self.predicted_us

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ratio"] = self.ratio
        return d


@dataclasses.dataclass
class CollectiveCalibration:
    """One measured collective: the obs.calibrate row type the explicit
    collective lowering emits (runtime/collectives.py via the
    collective-bench sweep) and the resharding executor's transfer
    rounds produce. `refit.fit_collective_coefficients` fits the
    per-tier link constants from these — measured collectives, not the
    step-level residual attribution the per-tier fit otherwise leans on.

    op: "allreduce" (a full strategy lowering), "psum" (one tier's ring
    phase in isolation — the per-tier fit's preferred evidence),
    "transfer"/"allgather" (resharding rounds). tier: the tier the
    traffic rides ("ici"/"dcn"/... on hierarchical machines, "mesh" on
    flat ones)."""

    op: str
    strategy: str
    tier: str
    bytes: float
    participants: int
    predicted_us: float
    measured_us: float
    dtype: str = "f32"

    @property
    def ratio(self) -> float:
        """measured/predicted — NaN when either side is degenerate, the
        same contract as OpCalibration.ratio."""
        if not (self.predicted_us > 0 and math.isfinite(self.predicted_us)
                and self.measured_us > 0
                and math.isfinite(self.measured_us)):
            return float("nan")
        return self.measured_us / self.predicted_us

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ratio"] = self.ratio
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CollectiveCalibration":
        return cls(op=str(d["op"]), strategy=str(d["strategy"]),
                   tier=str(d["tier"]), bytes=float(d["bytes"]),
                   participants=int(d["participants"]),
                   predicted_us=float(d["predicted_us"]),
                   measured_us=float(d["measured_us"]),
                   dtype=str(d.get("dtype", "f32")))


@dataclasses.dataclass
class CalibrationReport:
    backend: str
    predicted_step_us: Optional[float]
    measured_step_us: Optional[float]
    measured_steps: int
    ops: List[OpCalibration]

    @property
    def step_ratio(self) -> float:
        """measured/predicted step cost; NaN (an 'uncalibrated' record)
        when either side is missing, non-positive, or non-finite — a run
        whose steps were too fast for the clock, or a model compiled
        without any cost prediction, yields a clean n/a, never a
        div-by-zero or an inf."""
        p, m = self.predicted_step_us, self.measured_step_us
        if (p is None or m is None or not math.isfinite(p)
                or not math.isfinite(m) or p <= 0 or m <= 0):
            return float("nan")
        return m / p

    def to_dict(self) -> Dict[str, Any]:
        return {
            "backend": self.backend,
            "predicted_step_us": self.predicted_step_us,
            "measured_step_us": self.measured_step_us,
            "measured_steps": self.measured_steps,
            "step_ratio": self.step_ratio,
            "ops": [o.to_dict() for o in self.ops],
            "kernel_candidates": self.kernel_candidates(),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def kernel_candidates(self) -> List[Dict[str, Any]]:
        """Ranked fused-kernel candidates: per kernel-tier family, the
        median residual (measured/predicted) weighted by the family's
        share of predicted step time — `score = max(0, residual - 1) *
        share`. The family at the top is where a fused kernel buys the
        most wall clock; `format_kernel_report` renders this and the
        KernelRegistry auto-selects from the same residuals once a refit
        persists them (docs/kernels.md)."""
        residuals = op_family_residuals(self.ops)
        total_pred = sum(o.predicted_us for o in self.ops
                         if o.predicted_us > 0
                         and math.isfinite(o.predicted_us))
        # every tier family present in the graph is listed — one with no
        # measurable op shows residual NaN and score 0 rather than
        # disappearing (the reader should see it was considered)
        present = {fam for o in self.ops
                   for fam in [KERNEL_TIER_FAMILIES.get(o.op_type)]
                   if fam is not None}
        out: List[Dict[str, Any]] = []
        for fam in present:
            residual = residuals.get(fam, float("nan"))
            pred = sum(o.predicted_us for o in self.ops
                       if KERNEL_TIER_FAMILIES.get(o.op_type) == fam
                       and o.predicted_us > 0
                       and math.isfinite(o.predicted_us))
            share = pred / total_pred if total_pred > 0 else 0.0
            out.append({
                "family": fam,
                "residual": residual,
                "step_share": share,
                "score": (max(0.0, residual - 1.0) * share
                          if math.isfinite(residual) else 0.0),
                "ops": sum(
                    1 for o in self.ops
                    if KERNEL_TIER_FAMILIES.get(o.op_type) == fam),
            })
        out.sort(key=lambda c: (
            -c["score"],
            -(c["residual"] if math.isfinite(c["residual"]) else 0.0)))
        return out

    def format_kernel_report(self) -> str:
        cands = self.kernel_candidates()
        lines = [
            "kernel candidates (median calibration residual weighted by "
            "share of predicted step time; score>0 = fusion headroom)",
            f"  {'family':<16} {'residual':>9} {'step share':>11} "
            f"{'score':>8} {'ops':>5}",
        ]
        if not cands:
            lines.append("  (no kernel-tier op families measurable)")
        for c in cands:
            lines.append(
                f"  {c['family']:<16} {_r(c['residual']):>9} "
                f"{c['step_share']:>10.1%} {c['score']:>8.3f} "
                f"{c['ops']:>5}")
        return "\n".join(lines)

    def format(self) -> str:
        lines = [
            f"simulator calibration ({self.backend} backend; ratio = "
            "measured/predicted, 1.0 = perfectly calibrated)",
            f"  step: predicted={_us(self.predicted_step_us)} "
            f"measured={_us(self.measured_step_us)} "
            f"over {self.measured_steps} step(s) "
            f"ratio={_r(self.step_ratio)}",
            f"  {'op':<28} {'type':<20} {'strategy':<14} "
            f"{'pred us':>10} {'meas us':>10} {'ratio':>7}",
        ]
        for o in self.ops:
            if o.error:
                lines.append(
                    f"  {o.op:<28} {o.op_type:<20} {o.strategy:<14} "
                    f"{o.predicted_us:>10.1f} {'--':>10} {'--':>7}"
                    f"  {o.error}")
            else:
                lines.append(
                    f"  {o.op:<28} {o.op_type:<20} {o.strategy:<14} "
                    f"{o.predicted_us:>10.1f} {o.measured_us:>10.1f} "
                    f"{_r(o.ratio):>7}")
        return "\n".join(lines)


def _us(v: Optional[float]) -> str:
    return f"{v:.1f}us" if v else "n/a"


def _r(v: float) -> str:
    return f"{v:.2f}" if math.isfinite(v) else "n/a"


def predicted_step_us(model) -> Optional[float]:
    """The plan's predicted step cost: the search's own number when a
    search ran, otherwise an analytic re-simulation of the chosen (or
    default) strategies — so calibration works for plain data-parallel
    compiles too."""
    sr = getattr(model, "search_result", None)
    if sr is not None and getattr(sr, "predicted_step_us", None):
        return float(sr.predicted_step_us)
    if model.graph is None:
        return None
    from ..search.machine_model import make_machine_model
    from ..search.simulator import Simulator

    n_dev = max(1, model.config.total_devices)
    sim = Simulator(make_machine_model(model.config, n_dev), model.config)
    return float(sim.simulate(model.graph, op_strategies(model)))


def op_strategies(model) -> Dict[int, Any]:
    """op guid -> OpStrategy of the model's plan (JAX `_op_strategies`);
    {} (every op at the default) for the one-device plan."""
    return getattr(model, "_op_strategies", None) or {}


def calibrate(model, warmup: int = 1, repeats: int = 3,
              max_ops: Optional[int] = None) -> CalibrationReport:
    """Build the predicted-vs-profiled report for a compiled model.

    Per-op measurement runs each op's lowering over its real input shapes
    (OpCostCache) on a copy of the op holding zero weights, so the model's
    weights, state and generator are untouched; on the CPU the measured
    side reflects the host — the report states the backend to keep
    cross-backend numbers from being compared blindly."""
    from ..ffconst import OpType
    from ..search.machine_model import config_backend, make_machine_model
    from ..search.simulator import CostModel, OpCostCache, OpStrategy

    assert model.graph is not None, "compile() the model first"
    n_dev = max(1, model.config.total_devices)
    cost = CostModel(make_machine_model(model.config, n_dev), model.config)
    cache = OpCostCache(model.config, warmup=warmup, repeats=repeats)
    strategies = op_strategies(model)
    default = OpStrategy(dp=1, tp=1)

    rows: List[OpCalibration] = []
    for op in model.graph.topo_order():
        if op.op_type in (OpType.INPUT, OpType.WEIGHT, OpType.NOOP):
            continue
        if max_ops is not None and len(rows) >= max_ops:
            break
        s = strategies.get(op.guid, default)
        sdesc = f"dp={s.dp},tp={s.tp}" + (f",sp={s.sp}" if s.sp > 1 else "")
        pred = cost.forward_time_us(op, s)
        dtype = "bf16" if cost.op_dtype_bytes(op) <= 2 else "f32"
        try:
            meas = cache.measure_forward_us(op, s)
            rows.append(OpCalibration(op.name, op.op_type.value, sdesc,
                                      float(pred), float(meas),
                                      dtype=dtype))
        except Exception as e:  # unmeasurable ops (multi-output glue etc.)
            rows.append(OpCalibration(
                op.name, op.op_type.value, sdesc, float(pred),
                float("nan"), error=f"{type(e).__name__}: {e}",
                dtype=dtype))

    stats = getattr(model, "step_stats", None)
    measured_step = None
    n_steps = 0
    if stats is not None and len(stats):
        # median, not mean: the first recorded step carries the kernel
        # builds and graph captures and would swamp short runs
        measured_step = stats.summary()["p50_step_ms"] * 1e3
        n_steps = len(stats)
        if not (measured_step > 0 and math.isfinite(measured_step)):
            # steps faster than the clock's resolution (trivial models on
            # CPU CI): an uncalibrated record, not a 0 that would blow up
            # downstream ratios
            measured_step = None
    report = CalibrationReport(
        backend=config_backend(model.config),
        predicted_step_us=predicted_step_us(model),
        measured_step_us=measured_step,
        measured_steps=n_steps,
        ops=rows,
    )
    if math.isfinite(report.step_ratio):
        REGISTRY.gauge(
            "ff_sim_step_calibration_ratio",
            "Measured/predicted step cost (1.0 = calibrated)",
        ).set(report.step_ratio)
    return report
