"""Calibration-driven simulator refit + live drift detection
(counterpart of flexflow_tpu/obs/refit.py; the same profile format, so a
profile written by either package loads into the other).

Closes the observability loop (ROADMAP item 4): the Unity search is only
as trustworthy as the cost simulator, whose machine-model coefficients
(`ChipSpec` flop rates, `ici_link_gbps`, the latency constants) are
hand-set — yet the obs layer already records everything needed to FIT
them: per-op predicted-vs-profiled costs (`obs.calibrate`), the searched
plan's `predicted_step_us`, and live `StepStats`. Three pieces:

 - `FittedCoefficients` / `fit_coefficients`: a robust least-squares fit
   of the machine-model coefficients from calibration rows — per-dtype
   effective-flop-rate scale and dispatch latency from an L1-trimmed
   linear fit of measured-vs-predicted op costs, a link-bandwidth scale
   from the step-level communication residual, and a whole-step
   `step_scale` for systematic bias no per-op/per-link term can carry
   (fusion wins, host dispatch, bwd-factor error). `step_scale` is
   uniform across candidate plans, so it can never flip a search ranking.
 - `FittedProfile`: the versioned persisted form — JSON keyed by a
   machine-spec hash (chip name + backend + format version). Loading a
   profile fitted for a different chip/backend, a future format version,
   or a tampered file raises a TYPED error instead of silently
   mis-pricing. `make_machine_model` applies a loaded profile as an
   overlay (`config.fitted_profile_file`), so every subsequent search
   prices with measured reality.
 - `DriftDetector`: watches live step wall times during training (an EMA
   of measured/predicted), publishes the `ff_calibration_drift` gauge and
   `ff_drift_breaches_total` counter, and — past a configurable threshold
   for `patience` consecutive steps, within a re-plan budget — tells its
   caller to re-plan (in the JAX package the ElasticCoordinator's refit
   and budgeted re-search; the port's coordinator is ROADMAP A9.3, so
   here `FFModel.fit` marks the verdict only).

`refit(model, ...)` iterates fit rounds: apply the current coefficients
as an overlay, re-simulate the plan's predicted step cost and per-op
predictions, update the coefficients from the residuals, stop when
predicted-vs-measured converges within `tol`. A profile's backend is the
config device's in `jax.default_backend()`'s words ("gpu" for CUDA,
"cpu"). `FittedProfile.load` checks the backend the caller names
(make_machine_model and the kernel registry name their config's), else
the process's: "gpu" where a CUDA device is visible, as JAX checks
`jax.default_backend()`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, List, Optional, Tuple

from .calibration import op_strategies
from .registry import REGISTRY

PROFILE_FORMAT_VERSION = 1

# clamp band for every multiplicative coefficient: a fit outside this is a
# measurement pathology (e.g. a 0-time op row), not a machine property.
# The band must comfortably hold the LEGITIMATE cross-backend gap — a
# spec's prediction measured on a host CPU is ~1e3-1e4 off before any
# refit.
_SCALE_MIN, _SCALE_MAX = 1.0 / 65536.0, 65536.0


class FittedProfileError(ValueError):
    """A fitted-profile file could not be used (corrupt, future format)."""


class FittedProfileMismatch(FittedProfileError):
    """The profile was fitted for a different machine spec (chip/backend)
    than the one it is being loaded for."""


def _clamp(v: float, lo: float = _SCALE_MIN, hi: float = _SCALE_MAX) -> float:
    return min(hi, max(lo, float(v)))


@dataclasses.dataclass
class FittedCoefficients:
    """The machine-model coefficients a refit adjusts. All neutral at 1.0
    (latencies at the historical 1.0us constants), so an empty fit is an
    exact no-op overlay."""

    # effective-flop-rate multipliers per dtype class (bf16 = MXU path,
    # f32 = full-precision path); multiply the ChipSpec peak rates
    compute_scale: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"bf16": 1.0, "f32": 1.0})
    hbm_scale: float = 1.0
    # per-link bandwidth multiplier (ici_link_gbps / NetworkedMachineModel
    # link_gbps)
    link_bw_scale: float = 1.0
    # per-TIER bandwidth multipliers for hierarchical machine specs,
    # keyed by tier name ("ici", "dcn", ... — docs/machine.md). A tier
    # named here overrides link_bw_scale for that tier; unnamed tiers
    # (and every flat machine model) keep the single-scale path, so old
    # profiles — which lack this field — still load and apply.
    tier_link_scales: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # per-op dispatch/launch latency and per-collective base latency (us)
    dispatch_latency_us: float = 1.0
    collective_latency_us: float = 1.0
    # whole-step systematic-bias multiplier (see module docstring)
    step_scale: float = 1.0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FittedCoefficients":
        out = cls()
        for f in dataclasses.fields(cls):
            if f.name in d:
                setattr(out, f.name, d[f.name])
        out.compute_scale = {k: float(v)
                             for k, v in dict(out.compute_scale).items()}
        out.tier_link_scales = {str(k): float(v)
                                for k, v in dict(out.tier_link_scales
                                                 ).items()}
        return out


def _current_backend() -> str:
    """The process's backend in `jax.default_backend()`'s words: "gpu"
    where a CUDA device is visible, else "cpu"."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def spec_hash(chip_name: str, backend: str,
              version: int = PROFILE_FORMAT_VERSION) -> str:
    """Stable identity of the machine spec a profile was fitted for. Keyed
    by chip + backend + format version, NOT num_chips: the coefficients
    are per-chip / per-link properties, valid across mesh sizes — which is
    what lets an elastic re-plan on a shrunken mesh keep the overlay."""
    payload = json.dumps({"chip": chip_name, "backend": backend,
                          "format": version}, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclasses.dataclass
class FittedProfile:
    """Versioned, spec-keyed persisted form of a coefficient fit."""

    chip: str
    backend: str
    coefficients: FittedCoefficients
    spec_hash: str = ""
    version: int = PROFILE_FORMAT_VERSION
    # provenance (informational; not part of the identity hash)
    fitted_steps: int = 0
    fitted_ops: int = 0
    rounds: int = 0
    step_ratio: float = float("nan")
    num_chips: int = 0
    # per-kernel-family calibration residuals (median measured/predicted
    # at fit time, obs/calibration.op_family_residuals): the evidence the
    # KernelRegistry auto-selects fused Pallas kernels from
    # (kernels/registry.py, docs/kernels.md). Informational for the
    # machine model itself — apply_to never touches it.
    op_family_residuals: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # per-family FITTED selection thresholds (fit_kernel_thresholds):
    # derived from real before/after kernel measurements — a family's
    # threshold is the residual the FUSED impl itself achieves at the
    # profiled shapes (x a small safety margin), so reference evidence
    # past it means switching genuinely pays. A family present here
    # overrides the hand-set RESIDUAL_CANDIDATE_THRESHOLD /
    # --kernel-residual-threshold default in the registry; absent
    # families keep the knob. Informational for the machine model.
    kernel_residual_thresholds: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if not self.spec_hash:
            self.spec_hash = spec_hash(self.chip, self.backend, self.version)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["coefficients"] = self.coefficients.to_dict()
        return d

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")
        return path

    def apply_to(self, machine) -> None:
        """Overlay this profile's coefficients onto a MachineModel."""
        machine.apply_overlay(self.coefficients)

    @classmethod
    def load(cls, path: str, expect_chip: Optional[str] = None,
             expect_backend: Optional[str] = None) -> "FittedProfile":
        """Load + verify. Raises FittedProfileError on unreadable/corrupt
        files or a future format version, FittedProfileMismatch when the
        stored spec hash does not match the machine it is loaded for
        (wrong chip, wrong `expect_backend` (default: the process's,
        `_current_backend()`), or a tampered/stale hash)."""
        try:
            with open(path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise FittedProfileError(
                f"fitted profile {path!r} unreadable: {e}") from e
        try:
            version = int(d["version"])
            chip = str(d["chip"])
            backend = str(d["backend"])
            coeffs = FittedCoefficients.from_dict(d["coefficients"])
            stored_hash = str(d["spec_hash"])
        except (KeyError, TypeError, ValueError) as e:
            raise FittedProfileError(
                f"fitted profile {path!r} malformed: {e}") from e
        if version > PROFILE_FORMAT_VERSION:
            raise FittedProfileError(
                f"fitted profile {path!r} is format v{version}; this "
                f"runtime reads up to v{PROFILE_FORMAT_VERSION}")
        expected_hash = spec_hash(chip, backend, version)
        if stored_hash != expected_hash:
            raise FittedProfileMismatch(
                f"fitted profile {path!r}: stored spec hash "
                f"{stored_hash!r} does not match its own spec "
                f"(chip={chip!r}, backend={backend!r} -> "
                f"{expected_hash!r}) — stale or tampered file")
        if expect_chip is not None and chip != expect_chip:
            raise FittedProfileMismatch(
                f"fitted profile {path!r} was fitted for chip {chip!r}, "
                f"but the machine model is {expect_chip!r}")
        check_backend = (expect_backend if expect_backend is not None
                         else _current_backend())
        if check_backend is not None and backend != check_backend:
            raise FittedProfileMismatch(
                f"fitted profile {path!r} was fitted on the {backend!r} "
                f"backend, but this process runs {check_backend!r} — "
                "refit on this backend instead of reusing it")
        return cls(chip=chip, backend=backend, coefficients=coeffs,
                   spec_hash=stored_hash, version=version,
                   fitted_steps=int(d.get("fitted_steps", 0)),
                   fitted_ops=int(d.get("fitted_ops", 0)),
                   rounds=int(d.get("rounds", 0)),
                   step_ratio=float(d.get("step_ratio", float("nan"))),
                   num_chips=int(d.get("num_chips", 0)),
                   op_family_residuals={
                       str(k): float(v) for k, v in dict(
                           d.get("op_family_residuals", {})).items()},
                   kernel_residual_thresholds={
                       str(k): float(v) for k, v in dict(
                           d.get("kernel_residual_thresholds",
                                 {})).items()})


# -- the coefficient fit ---------------------------------------------------

def _trimmed_linear_fit(xs: List[float], ys: List[float]
                        ) -> Tuple[float, float]:
    """Least-squares y ~= a*x + b, robustified: fit once, drop the 20%
    largest absolute residuals, fit again (L1-style trimming — one bad op
    measurement must not poison the machine coefficients). Falls back to a
    through-origin ratio-of-medians when the data cannot support an
    intercept (fewer than 3 points or degenerate x)."""
    import numpy as np

    x = np.asarray(xs, dtype=float)
    y = np.asarray(ys, dtype=float)

    def ratio_fallback() -> Tuple[float, float]:
        r = np.median(y / x)
        return float(max(r, 1e-12)), 0.0

    if len(x) == 2 and x[1] != x[0]:
        # two distinct points: an exact line still beats through-origin —
        # on dispatch-dominated backends the intercept IS the signal
        a = (y[1] - y[0]) / (x[1] - x[0])
        if a > 0 and math.isfinite(a):
            return float(a), float(max(0.0, y[0] - a * x[0]))
    if len(x) < 3 or float(np.ptp(x)) <= 0:
        return ratio_fallback()

    def lstsq(xv, yv):
        A = np.stack([xv, np.ones_like(xv)], axis=1)
        sol, *_ = np.linalg.lstsq(A, yv, rcond=None)
        return float(sol[0]), float(sol[1])

    a, b = lstsq(x, y)
    resid = np.abs(y - (a * x + b))
    keep = resid <= np.quantile(resid, 0.8)
    if keep.sum() >= 3:
        a, b = lstsq(x[keep], y[keep])
    if not (a > 0) or not math.isfinite(a) or not math.isfinite(b):
        return ratio_fallback()
    return a, b


def usable_rows(rows) -> List:
    """Calibration rows the fit can learn from: a positive finite
    prediction AND a positive finite measurement. Zero/negative measured
    times (clock resolution on trivially small ops) and failed
    measurements are excluded — the degenerate inputs the hardened
    calibration layer records as uncalibrated."""
    out = []
    for r in rows:
        pred = getattr(r, "predicted_us", None)
        meas = getattr(r, "measured_us", None)
        if (pred is not None and meas is not None
                and math.isfinite(pred) and math.isfinite(meas)
                and pred > 0 and meas > 0):
            out.append(r)
    return out


def fit_compute_coefficients(rows, prior: FittedCoefficients,
                             machine) -> FittedCoefficients:
    """One round of the per-op compute fit. `rows` carry predictions made
    UNDER `prior` (via the overlaid `machine`); the fit solves, per dtype
    class, measured ~= a * roofline + b where roofline = predicted minus
    the machine's current dispatch overhead — slope `a` divides the
    effective flop rate, intercept `b` (averaged across dtype groups,
    clamped >= 0) becomes the new dispatch latency."""
    rows = usable_rows(rows)
    out = dataclasses.replace(
        prior, compute_scale=dict(prior.compute_scale))
    by_dtype: Dict[str, List] = {}
    for r in rows:
        by_dtype.setdefault(getattr(r, "dtype", "") or "f32", []).append(r)
    overhead = float(getattr(machine, "dispatch_overhead_us", 1.0))
    intercepts = []
    for dtype, group in by_dtype.items():
        if dtype not in out.compute_scale:
            continue
        xs = [max(r.predicted_us - overhead, 1e-9) for r in group]
        ys = [r.measured_us for r in group]
        a, b = _trimmed_linear_fit(xs, ys)
        # measured = a * predicted_roofline: the effective rate is 1/a of
        # what the prior believed
        out.compute_scale[dtype] = _clamp(out.compute_scale[dtype] / a)
        intercepts.append(b)
    if intercepts:
        out.dispatch_latency_us = _clamp(
            sum(intercepts) / len(intercepts), 0.0, 1e4)
    return out


def _simulate_step_us(model, coeffs: FittedCoefficients,
                      comm_free: bool = False,
                      free_tier: Optional[str] = None) -> float:
    """The plan's predicted step cost under a coefficient overlay —
    `comm_free=True` re-prices with (near-)infinite link bandwidth and
    zero collective latency, isolating the communication share of the
    prediction for the bandwidth fit. `free_tier` frees ONE tier of a
    hierarchical machine instead (its comm share = total - this), which
    is how the per-tier bandwidth fit attributes the step-level residual
    to the tiers that actually carry traffic."""
    from ..search.machine_model import make_machine_model
    from ..search.simulator import Simulator

    cfg = model.config
    n_dev = max(1, cfg.total_devices)
    machine = make_machine_model(
        dataclasses.replace(cfg, fitted_profile_file=None), n_dev)
    applied = coeffs
    if comm_free:
        tier_free = {name: scale * 1e9
                     for name, scale in _effective_tier_scales(
                         machine, coeffs).items()}
        applied = dataclasses.replace(
            coeffs, compute_scale=dict(coeffs.compute_scale),
            link_bw_scale=coeffs.link_bw_scale * 1e9,
            tier_link_scales=tier_free,
            collective_latency_us=0.0)
        # a tier's EXPLICIT latency_us bypasses the fitted
        # collective_latency_us (machine_model.tier_latency); zero those
        # too, or latency-dominated DCN syncs would be misread as compute
        tiers = getattr(machine, "tiers", None)
        if tiers:
            machine.tiers = [dataclasses.replace(t, latency_us=0.0)
                             for t in tiers]
    elif free_tier is not None:
        scales = _effective_tier_scales(machine, coeffs)
        scales[free_tier] = scales.get(free_tier,
                                       coeffs.link_bw_scale) * 1e9
        applied = dataclasses.replace(
            coeffs, compute_scale=dict(coeffs.compute_scale),
            tier_link_scales=scales)
        # zero the freed tier's EXPLICIT latency too (mirroring the
        # comm_free branch): a latency-dominated DCN tier must still
        # show its comm share when freed, or it is never attributed
        machine.tiers = [dataclasses.replace(t, latency_us=0.0)
                         if t.name == free_tier else t
                         for t in machine.tiers]
    machine.apply_overlay(applied)
    sim = Simulator(machine, cfg)
    return float(sim.simulate(model.graph, op_strategies(model)))


def _effective_tier_scales(machine, coeffs: FittedCoefficients
                           ) -> Dict[str, float]:
    """The per-tier scales an overlay of `coeffs` would apply to
    `machine` — named tiers from tier_link_scales, the rest falling back
    to the global link_bw_scale. {} for flat machines."""
    tiers = getattr(machine, "tiers", None)
    if not tiers:
        return {}
    return {t.name: float(coeffs.tier_link_scales.get(
        t.name, coeffs.link_bw_scale)) for t in tiers}


def _predict_op_rows(model, coeffs: FittedCoefficients, rows) -> List:
    """Re-predict each measured op's forward cost under a coefficient
    overlay, keeping the measured side — the input of the next fit round."""
    from ..ffconst import OpType
    from ..search.machine_model import make_machine_model
    from ..search.simulator import CostModel, OpStrategy

    cfg = model.config
    n_dev = max(1, cfg.total_devices)
    machine = make_machine_model(
        dataclasses.replace(cfg, fitted_profile_file=None), n_dev)
    machine.apply_overlay(coeffs)
    cost = CostModel(machine, cfg)
    strategies = op_strategies(model)
    default = OpStrategy(dp=1, tp=1)
    by_name = {op.name: op for op in model.graph.ops.values()
               if op.op_type not in (OpType.INPUT, OpType.WEIGHT,
                                     OpType.NOOP)}
    out = []
    for r in rows:
        op = by_name.get(r.op)
        if op is None:
            continue
        s = strategies.get(op.guid, default)
        out.append(dataclasses.replace(
            r, predicted_us=float(cost.forward_time_us(op, s))))
    return out


@dataclasses.dataclass
class RefitRound:
    """One refit round's verdict, for the convergence report."""

    round: int
    predicted_step_us: float
    measured_step_us: float

    @property
    def ratio(self) -> float:
        if not (self.predicted_step_us > 0 and self.measured_step_us > 0):
            return float("nan")
        return self.measured_step_us / self.predicted_step_us

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ratio"] = self.ratio
        return d


def fit_kernel_thresholds(pallas_rows, margin: float = 1.02
                          ) -> Dict[str, float]:
    """Per-family kernel-selection thresholds from real BEFORE/AFTER
    measurements, replacing the hand-set
    `RESIDUAL_CANDIDATE_THRESHOLD = 1.10` guess (kernels/registry.py).

    `pallas_rows` are calibration rows measured with the fused Pallas
    impls FORCED (the "after" side; the ordinary profile run is the
    "before" side whose residuals ride in `op_family_residuals`). The
    registry selects pallas when the reference residual
    (measured_ref/predicted) exceeds the threshold; switching genuinely
    pays exactly when the reference runs slower than the fused kernel —
    i.e. when the reference residual exceeds the residual the FUSED impl
    itself achieves. So the fitted threshold per family is the fused
    impl's own median measured/predicted at the profiled shapes, times a
    small `margin` (switching for a sub-2% win is churn), floored at 1.0
    (a fused impl beating the roofline still should not be selected on
    noise-level reference evidence). Families without usable pallas rows
    are omitted — they keep the knob/default."""
    from .calibration import op_family_residuals

    out: Dict[str, float] = {}
    for fam, resid in op_family_residuals(usable_rows(pallas_rows)).items():
        if math.isfinite(resid) and resid > 0:
            out[fam] = max(1.0, float(resid)) * float(margin)
    return out


def refit(model, measured_step_us: float, op_rows,
          prior: Optional[FittedCoefficients] = None,
          rounds: int = 3, tol: float = 0.15, pallas_rows=None,
          ) -> Tuple[FittedProfile, List[RefitRound]]:
    """Fit machine-model coefficients for `model`'s compiled plan until
    the re-simulated predicted step cost lands within `tol` of
    `measured_step_us` (or `rounds` is exhausted). Returns the persistable
    profile and the per-round convergence history.

    Round structure (all inside a `refit.fit` span):
      1. per-op robust linear fit -> per-dtype compute scale + dispatch
         latency (fit_compute_coefficients);
      2. step-level communication residual -> link bandwidth scale, but
         only when the prediction has a meaningful comm share to attribute
         it to (>= 2%);
      3. remaining whole-step residual -> step_scale;
      4. re-simulate; converged when |measured/predicted - 1| <= tol.
    """
    from .tracing import get_tracer

    assert model.graph is not None, "compile() the model first"
    if not (measured_step_us and measured_step_us > 0
            and math.isfinite(measured_step_us)):
        raise FittedProfileError(
            f"cannot refit against measured_step_us={measured_step_us!r}; "
            "run enough steps to measure first")
    coeffs = prior if prior is not None else FittedCoefficients()
    coeffs = dataclasses.replace(
        coeffs, compute_scale=dict(coeffs.compute_scale))
    rows = usable_rows(op_rows)
    history: List[RefitRound] = []
    # tier names are invariant across rounds: resolve them once instead
    # of rebuilding the machine model (a spec-file read) per round
    from ..search.machine_model import make_machine_model

    tier_names = [t.name for t in getattr(
        make_machine_model(
            dataclasses.replace(model.config, fitted_profile_file=None),
            max(1, model.config.total_devices)), "tiers", [])]
    with get_tracer().span("refit.fit", rounds=rounds) as sp:
        converged = False
        for rnd in range(1, max(1, rounds) + 1):
            predicted = _simulate_step_us(model, coeffs)
            history.append(RefitRound(rnd, predicted, measured_step_us))
            ratio = history[-1].ratio
            if math.isfinite(ratio) and abs(ratio - 1.0) <= tol:
                converged = True
                break
            # 1. compute terms from the op rows (re-predicted under the
            # current coefficients so each round fits fresh residuals)
            if rows:
                machine = make_machine_model(
                    dataclasses.replace(model.config,
                                        fitted_profile_file=None),
                    max(1, model.config.total_devices))
                machine.apply_overlay(coeffs)
                coeffs = fit_compute_coefficients(rows, coeffs, machine)
                rows = _predict_op_rows(model, coeffs, rows)
            # 2. comm residual -> bandwidth, when there is comm to blame
            total = _simulate_step_us(model, coeffs)
            comp_only = _simulate_step_us(model, coeffs, comm_free=True)
            comm_share = max(0.0, total - comp_only) / max(total, 1e-9)
            if comm_share > 0.02 and measured_step_us > comp_only:
                k = (measured_step_us - comp_only) / max(
                    total - comp_only, 1e-9)
                if tier_names:
                    # hierarchical machine: fit PER-TIER scales, keyed by
                    # tier name — the correction lands only on tiers that
                    # carry an attributable share of the step's comm
                    # (freeing a tier the plan never crosses changes
                    # nothing, so its share is 0 and its prior survives)
                    scales = dict(coeffs.tier_link_scales)
                    for name in tier_names:
                        t_free = _simulate_step_us(model, coeffs,
                                                   free_tier=name)
                        share_t = max(0.0, total - t_free) / max(total,
                                                                 1e-9)
                        if share_t > 0.02:
                            prior_t = scales.get(name,
                                                 coeffs.link_bw_scale)
                            scales[name] = _clamp(prior_t / k)
                    coeffs.tier_link_scales = scales
                else:
                    # flat machine spec: the single-scale path, unchanged
                    coeffs.link_bw_scale = _clamp(coeffs.link_bw_scale / k)
            # 3. whatever residual remains is whole-step systematic bias
            predicted = _simulate_step_us(model, coeffs)
            if predicted > 0:
                coeffs.step_scale = _clamp(
                    coeffs.step_scale * measured_step_us / predicted)
        if not converged:
            # the last round updated coefficients after its history entry:
            # record where they actually landed
            final = _simulate_step_us(model, coeffs)
            history.append(RefitRound(len(history) + 1, final,
                                      measured_step_us))
        sp.set(rounds_run=len(history), final_ratio=history[-1].ratio)

    machine = make_machine_model(
        dataclasses.replace(model.config, fitted_profile_file=None),
        max(1, model.config.total_devices))
    from ..search.machine_model import config_backend
    from .calibration import op_family_residuals

    profile = FittedProfile(
        chip=machine.chip.name, backend=config_backend(model.config),
        coefficients=coeffs, fitted_steps=1, fitted_ops=len(rows),
        rounds=len(history), step_ratio=history[-1].ratio,
        num_chips=max(1, model.config.total_devices),
        # residuals from the ORIGINAL rows (usable_rows(op_rows)), not
        # the re-predicted ones: the registry wants the gap the backend
        # showed against the un-refit roofline, which is what nominates
        # a fused kernel
        op_family_residuals=op_family_residuals(usable_rows(op_rows)),
        # before/after threshold fit: rows measured with the fused impls
        # forced turn the hand-set selection threshold into a measured
        # per-family one (fit_kernel_thresholds); without them the
        # profile carries none and the knob/default stays in charge
        kernel_residual_thresholds=(
            fit_kernel_thresholds(pallas_rows) if pallas_rows else {}))
    REGISTRY.gauge(
        "ff_refit_step_ratio",
        "Measured/predicted step cost after the last refit "
        "(1.0 = converged)").set(history[-1].ratio)
    return profile, history


def fit_collective_coefficients(rows, machine,
                                prior: Optional[FittedCoefficients] = None
                                ) -> FittedCoefficients:
    """Fit per-tier link-bandwidth scales from MEASURED collectives
    (obs.calibration.CollectiveCalibration rows from the
    collective-bench sweep), rather than from the step-level residual
    attribution `refit()` uses when only op rows exist.

    The evidence is the per-tier ring phases (op="psum",
    strategy="tier_ring"): one tier's grouped psum in isolation is
    linear in bytes, `measured ~= slope/scale * bytes + latency`, so the
    robust linear fit of measured-vs-bytes against predicted-vs-bytes
    gives that tier's scale directly — `scale = slope_pred/slope_meas`.
    Whole-strategy rows (op="allreduce") mix tiers, and resharding
    transfer rows (`ReshardResult.calibration_rows`) mix a round's
    gather/transfer/slice components into one prediction — both are
    report/trace artifacts, not fit evidence, and are ignored here. On
    flat machines the single "mesh" tier fits
    `link_bw_scale`. The mean positive intercept across tiers becomes
    the fitted collective latency. Tiers with fewer than 2 usable rows
    keep their prior."""
    coeffs = prior if prior is not None else FittedCoefficients()
    coeffs = dataclasses.replace(
        coeffs, compute_scale=dict(coeffs.compute_scale),
        tier_link_scales=dict(coeffs.tier_link_scales))
    by_tier: Dict[str, List] = {}
    for r in usable_rows(rows):
        if getattr(r, "op", None) == "psum" \
                and getattr(r, "strategy", None) == "tier_ring":
            by_tier.setdefault(str(r.tier), []).append(r)
    tier_names = {t.name for t in getattr(machine, "tiers", [])}
    intercepts: List[float] = []
    for tier, group in by_tier.items():
        if len(group) < 2:
            continue
        xs = [float(r.bytes) for r in group]
        if max(xs) <= min(xs):
            continue  # one byte size cannot separate slope from latency
        a_meas, b_meas = _trimmed_linear_fit(xs,
                                             [r.measured_us for r in group])
        a_pred, _ = _trimmed_linear_fit(xs,
                                        [r.predicted_us for r in group])
        if not (a_meas > 0 and a_pred > 0):
            continue
        scale = _clamp(a_pred / a_meas)
        if tier in tier_names:
            prior_t = coeffs.tier_link_scales.get(tier,
                                                  coeffs.link_bw_scale)
            coeffs.tier_link_scales[tier] = _clamp(prior_t * scale)
        else:
            # flat machine ("mesh" tier): the single-scale path
            coeffs.link_bw_scale = _clamp(coeffs.link_bw_scale * scale)
        intercepts.append(max(0.0, b_meas))
    if intercepts:
        coeffs.collective_latency_us = _clamp(
            sum(intercepts) / len(intercepts), 0.0, 1e4)
    return coeffs


# -- live drift detection --------------------------------------------------

class DriftDetector:
    """EMA watch of measured-vs-predicted step time during training.

    `observe(measured_step_us)` is called once per committed optimizer
    step (FFModel.fit feeds it; in the JAX package the ElasticCoordinator
    loop too). It
    maintains an EMA of the measured step time, publishes
    `ff_calibration_drift` (|ema/predicted - 1|, 0 = perfectly
    calibrated), and returns True when the drift has exceeded `threshold`
    for `patience` consecutive post-warmup steps AND the re-plan budget
    (`max_replans`) is not exhausted — a caller that can re-plan then
    runs the budgeted refit + re-search. Plain `FFModel.fit` cannot
    re-plan; there a breach only marks the gauge/counter and an
    `obs.drift` trace instant (same contract as the watchdog's
    no-rollback guard mode).

    `rearm(new_predicted_step_us)` resets the EMA after a re-plan so the
    detector measures drift against the NEW plan's prediction."""

    def __init__(self, predicted_step_us: float, threshold: float = 0.5,
                 alpha: float = 0.25, warmup_steps: int = 3,
                 patience: int = 2, max_replans: int = 1,
                 registry=None):
        if not (predicted_step_us and predicted_step_us > 0):
            raise ValueError(
                f"DriftDetector needs a positive predicted_step_us, got "
                f"{predicted_step_us!r}")
        self.predicted_step_us = float(predicted_step_us)
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.warmup_steps = int(warmup_steps)
        self.patience = max(1, int(patience))
        self.max_replans = int(max_replans)
        self.replans = 0
        reg = registry if registry is not None else REGISTRY
        self._g_drift = reg.gauge(
            "ff_calibration_drift",
            "|EMA(measured step)/predicted - 1|; 0 = calibrated")
        self._c_breach = reg.counter(
            "ff_drift_breaches_total",
            "Post-warmup steps whose drift exceeded the threshold")
        self._ema: Optional[float] = None
        self._seen = 0
        self._breach_run = 0

    @property
    def measured_step_us(self) -> Optional[float]:
        """The current EMA of measured step time (None pre-warmup)."""
        return self._ema

    @property
    def drift(self) -> float:
        if self._ema is None:
            return 0.0
        return abs(self._ema / self.predicted_step_us - 1.0)

    def observe(self, measured_step_us: float) -> bool:
        """Feed one committed step's measured wall time (us). Returns True
        when a budgeted re-plan should fire NOW. Observing never consumes
        the budget — only the caller that actually PERFORMS the re-plan
        does (`note_replan()`, then `rearm()`); plain FFModel.fit, which
        can only mark the breach, leaves the budget intact for a
        coordinator to spend later."""
        v = float(measured_step_us)
        if not (v > 0 and math.isfinite(v)):
            return False  # clock-resolution zero steps teach nothing
        self._seen += 1
        if self._seen <= self.warmup_steps:
            # warmup absorbs the jit-compile first steps; they would
            # permanently poison the EMA
            return False
        self._ema = (v if self._ema is None
                     else self.alpha * v + (1 - self.alpha) * self._ema)
        d = self.drift
        self._g_drift.set(d)
        if d <= self.threshold:
            self._breach_run = 0
            return False
        self._breach_run += 1
        self._c_breach.inc()
        if self._breach_run < self.patience:
            return False
        self._breach_run = 0  # a fresh patience window either way
        if self.replans >= self.max_replans:
            return False  # budget spent: keep gauging, stop firing
        return True

    def note_replan(self) -> None:
        """Record that a re-plan was actually performed (consumes one unit
        of `max_replans`). Called by a coordinator that re-plans, never by
        observers that cannot re-plan."""
        self.replans += 1

    def rearm(self, predicted_step_us: float) -> None:
        """Re-anchor after a re-plan: drift is now measured against the
        re-searched plan's prediction, with a fresh warmup/EMA."""
        if predicted_step_us and predicted_step_us > 0:
            self.predicted_step_us = float(predicted_step_us)
        self._ema = None
        self._seen = 0
        self._breach_run = 0
        self._g_drift.set(0.0)
