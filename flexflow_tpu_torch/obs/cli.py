"""`python -m flexflow_tpu_torch profile`: one-command observability
capture (counterpart of flexflow_tpu/obs/cli.py).

Trains a zoo model on synthetic data with the span tracer enabled and
writes the observability bundle into --out (default ./profile_out):

    trace.json        Chrome-trace-event / Perfetto-loadable span timeline
                      (search, compile, per-step executor dispatches,
                      checkpoint saves when any happen)
    calibration.json  simulator calibration: the plan's predicted step
    calibration.txt   cost next to the measured steps, plus per-op
                      predicted-vs-profiled forward costs
    metrics.txt       Prometheus exposition dump of the process registry
                      (validated against the exposition format before
                      writing)
    bench.json        a BENCH-style perf point (samples/s/chip, MFU over
                      the machine model's chip peak: h100-sxm's 989 / 67
                      TFLOP/s on the card, predicted vs measured step us)

`--kernel-report` also prints (and writes kernel_report.txt) the ranked
kernel candidates: per kernel-tier family, the median calibration
residual weighted by the family's share of the predicted step time.
`--refit` fits the machine-model coefficients from the calibration data
(obs/refit.py) until the re-simulated step converges on the measured one
(`--refit-rounds`, `--refit-tol`) and writes `fitted_profile.json`;
`--fit-kernel-thresholds` (with `--refit`) calibrates the same model
again with every kernel family forced and persists per-family selection
thresholds. `--miscalibrate flops=2.0,ici=0.5` seeds the run with
deliberately wrong constants. `--drift-replan` trains under an
ElasticCoordinator with a DriftDetector armed: sustained drift triggers
ONE budgeted refit and re-plan (`refit.replan` span).

`--device cuda|cpu` (default cuda) picks the device; every FFConfig flag
passes through. Exit code 0 iff the run finished AND the artifacts
self-validate (trace JSON loads with spec-compliant events; metrics
parse; refit converged when asked). The last stdout line is a JSON
summary.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

# each entry is a set of alternatives: one of them must appear. A
# steps_per_execution > 1 run dispatches executor.multi_step instead of
# per-step executor.train_step — both are "per-step spans"
REQUIRED_SPANS = (
    ("search",),
    ("compile",),
    ("executor.train_step", "executor.multi_step"),
)


def _take(argv: List[str], flag: str, default, cast=str):
    """Pop `flag value` out of argv, or return default (JAX `_take`, which
    obs/collective_bench.py and obs/timeline.py share)."""
    if flag in argv:
        i = argv.index(flag)
        if i + 1 >= len(argv):
            raise SystemExit(f"missing value for {flag}")
        val = cast(argv[i + 1])
        del argv[i:i + 2]
        return val
    return default


def validate_trace(path: str) -> List[str]:
    """Load a Chrome trace JSON and check the events are spec-compliant:
    valid JSON, every complete event carries name/ph/ts/dur/pid/tid, and
    same-thread spans nest properly. Returns the span names present;
    raises ValueError on any violation."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents is not a list")
    by_tid = {}
    for e in events:
        ph = e.get("ph")
        if ph == "M":
            continue
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in e:
                raise ValueError(f"event missing {field!r}: {e}")
        if ph == "X":
            if "dur" not in e:
                raise ValueError(f"X event missing dur: {e}")
            by_tid.setdefault(e["tid"], []).append(e)
    # nesting: within a thread, sort by (start, -end); a running stack of
    # end times must contain each span inside its enclosing span
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -(e["ts"] + e["dur"])))
        stack: List[float] = []
        eps = 1e-3  # us; perf_counter_ns jitter guard
        for e in evs:
            end = e["ts"] + e["dur"]
            while stack and e["ts"] >= stack[-1] - eps:
                stack.pop()
            if stack and end > stack[-1] + eps:
                raise ValueError(
                    f"span {e['name']!r} (tid {tid}) overlaps its parent "
                    "instead of nesting")
            stack.append(end)
    return sorted({e["name"] for e in events
                   if e.get("ph") in ("X", "i")})


def _parse_miscalibration(spec: str):
    """`--miscalibrate flops=2.0,ici=0.5[,hbm=0.8]` -> FittedCoefficients
    seeding the run with deliberately wrong machine constants."""
    from .refit import FittedCoefficients

    vals: Dict[str, float] = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep:
            raise SystemExit(f"--miscalibrate: bad term {part!r} "
                             "(want k=v[,k=v...])")
        try:
            vals[k.strip()] = float(v)
        except ValueError:
            raise SystemExit(f"--miscalibrate: {k.strip()}={v!r} is not "
                             "a number") from None
    unknown = set(vals) - {"flops", "ici", "hbm"}
    if unknown:
        raise SystemExit(f"--miscalibrate: unknown keys {sorted(unknown)}; "
                         "choices: flops, ici, hbm")
    f = vals.get("flops", 1.0)
    return FittedCoefficients(
        compute_scale={"bf16": f, "f32": f},
        link_bw_scale=vals.get("ici", 1.0),
        hbm_scale=vals.get("hbm", 1.0))


def _bench_point(model_name: str, model, predicted_us, measured_us,
                 backend: str) -> Dict[str, Any]:
    """The BENCH-style perf point `profile` always writes (bench.json and
    a `BENCH {...}` stdout line)."""
    from .stepstats import model_peak_tflops, model_train_flops_per_step

    n_dev = max(1, model.config.total_devices)
    bs = model.config.batch_size
    samples_per_s_per_chip = mfu = None
    if measured_us and measured_us > 0:
        step_s = measured_us / 1e6
        samples_per_s_per_chip = bs / step_s / n_dev
        peak = model_peak_tflops(model)
        flops = model_train_flops_per_step(model)
        if peak > 0 and flops > 0:
            mfu = flops / step_s / 1e12 / peak
    ratio = (measured_us / predicted_us
             if measured_us and predicted_us else None)
    return {
        "metric": f"{model_name}_profile_throughput",
        "unit": "samples/sec/chip",
        "value": samples_per_s_per_chip,
        "mfu": mfu,
        "predicted_step_us": predicted_us,
        "measured_step_us": measured_us,
        "step_ratio": ratio,
        "model": model_name,
        "backend": backend,
        "n_devices": n_dev,
        "batch_size": bs,
    }


def _compile_synthetic(model_name: str, config):
    """A zoo model on synthetic data, compiled as the CLI trains it: SGD,
    sparse categorical cross-entropy, accuracy."""
    import flexflow_tpu_torch as ff

    from ..__main__ import _synthetic

    model, xs, y = _synthetic(model_name, config)
    model.compile(
        optimizer=ff.SGDOptimizer(model, lr=config.learning_rate),
        loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[ff.MetricsType.METRICS_ACCURACY])
    return model, xs, y


def _drift_replan_fit(model_name: str, config, out_dir: str, prior,
                      refit_rounds: int, refit_tol: float,
                      drift_threshold: float, drift_warmup: int,
                      drift_patience: int, max_ops):
    """Train under an ElasticCoordinator with a DriftDetector armed:
    sustained measured-vs-predicted drift triggers ONE budgeted re-plan
    (refit the coefficients, persist the profile, re-plan with it
    overlaid, restore, resume). Returns (coordinator, detector, refit
    state)."""
    from ..elastic.coordinator import ElasticCoordinator
    from . import calibrate
    from .calibration import predicted_step_us
    from .refit import DriftDetector, refit

    data: Dict[str, Any] = {}

    def builder(cfg):
        m, xs, y = _compile_synthetic(model_name, cfg)
        data.setdefault("xs", xs)
        data.setdefault("y", y)
        return m

    state: Dict[str, Any] = {"history": None, "profile": None}

    def refit_hook(model, measured_step_us: float) -> str:
        rep = calibrate(model, max_ops=max_ops)
        profile, history = refit(model, measured_step_us, rep.ops,
                                 prior=prior, rounds=refit_rounds,
                                 tol=refit_tol)
        state["history"], state["profile"] = history, profile
        return profile.save(os.path.join(out_dir, "fitted_profile.json"))

    coord = ElasticCoordinator(
        builder, config,
        checkpoint_dir=os.path.join(out_dir, "ckpt"),
        checkpoint_every=2)
    predicted = predicted_step_us(coord.model)
    detector = DriftDetector(
        predicted, threshold=drift_threshold, warmup_steps=drift_warmup,
        patience=drift_patience, max_replans=1)
    coord.drift_detector = detector
    coord.drift_refit = refit_hook
    coord.fit(data["xs"], data["y"], epochs=config.epochs,
              batch_size=config.batch_size)
    return coord, detector, state


def _forced_kernel_rows(model_name: str, config, max_ops):
    """The AFTER side of the threshold fit: calibrate the same synthetic
    model with every kernel family forced while its ops lower, then
    predict outside the override (whose PALLAS_COST_GAIN discount would
    inflate every fitted threshold) at neutral coefficients."""
    import contextlib

    from ..kernels.registry import FAMILIES, KERNELS
    from . import calibrate
    from .refit import FittedCoefficients, _predict_op_rows

    with contextlib.ExitStack() as st:
        for fam in FAMILIES:
            st.enter_context(KERNELS.override(fam, "pallas"))
        fused, _, _ = _compile_synthetic(model_name, config)
        raw_rows = calibrate(fused, max_ops=max_ops).ops
    return _predict_op_rows(fused, FittedCoefficients(), raw_rows)


def run_profile(argv: Optional[List[str]] = None) -> int:
    from ..config import FFConfig, take_device
    from ..search.machine_model import config_backend

    argv = list(argv or [])
    device = take_device(argv)
    model_name = _take(argv, "--model", "mnist_mlp")
    out_dir = _take(argv, "--out", "profile_out")
    epochs = _take(argv, "--epochs", None, cast=int)
    saw_ffconfig_epochs = "-e" in argv  # FFConfig's own flag wins if given
    max_ops = _take(argv, "--calibration-max-ops", None, cast=int)
    refit_mode = "--refit" in argv
    if refit_mode:
        argv.remove("--refit")
    kernel_report = "--kernel-report" in argv
    if kernel_report:
        argv.remove("--kernel-report")
    fit_thresholds = "--fit-kernel-thresholds" in argv
    if fit_thresholds:
        argv.remove("--fit-kernel-thresholds")
    refit_rounds = _take(argv, "--refit-rounds", 3, cast=int)
    refit_tol = _take(argv, "--refit-tol", 0.15, cast=float)
    miscal_spec = _take(argv, "--miscalibrate", None)
    drift_replan = "--drift-replan" in argv
    if drift_replan:
        argv.remove("--drift-replan")
        refit_mode = True  # the re-plan IS a refit
    drift_threshold = _take(argv, "--drift-threshold", 0.5, cast=float)
    drift_warmup = _take(argv, "--drift-warmup", 2, cast=int)
    drift_patience = _take(argv, "--drift-patience", 2, cast=int)
    if fit_thresholds and (not refit_mode or drift_replan):
        raise SystemExit(
            "--fit-kernel-thresholds needs --refit (and is not supported"
            " under --drift-replan): the thresholds ride on the profile"
            " the refit persists")

    from . import calibrate, enable_tracing, get_registry, \
        validate_exposition

    tracer = enable_tracing()
    tracer.clear()

    config = FFConfig(device=device)
    rest = config.parse_args(argv)
    if rest:
        print(f"warning: unrecognized flags {rest}", file=sys.stderr)
    if epochs is not None:
        config.epochs = epochs
    elif not saw_ffconfig_epochs:
        config.epochs = 2  # profile default: steps past the warm-up
    backend = config_backend(config)

    os.makedirs(out_dir, exist_ok=True)
    prior = None
    if miscal_spec:
        # the wrong constants as a (mis)fitted profile: the overlay path
        # a real fit takes
        from ..search.machine_model import make_machine_model
        from .refit import FittedProfile

        prior = _parse_miscalibration(miscal_spec)
        chip = make_machine_model(config,
                                  max(1, config.total_devices)).chip
        config.fitted_profile_file = FittedProfile(
            chip=chip.name, backend=backend, coefficients=prior,
        ).save(os.path.join(out_dir, "miscalibrated_profile.json"))
    elif config.fitted_profile_file:
        from .refit import FittedProfile

        prior = FittedProfile.load(config.fitted_profile_file,
                                   expect_backend=backend).coefficients

    refit_summary: Optional[Dict[str, Any]] = None
    replans = 0
    if drift_replan:
        coord, det, state = _drift_replan_fit(
            model_name, config, out_dir, prior, refit_rounds, refit_tol,
            drift_threshold, drift_warmup, drift_patience, max_ops)
        model = coord.model
        replans = det.replans
        history = state["history"] or []
        refit_summary = {
            "rounds": [h.to_dict() for h in history],
            "converged": bool(history
                              and abs(history[-1].ratio - 1.0)
                              <= refit_tol),
            "final_ratio": history[-1].ratio if history else None,
            "replans": replans,
            "post_replan_drift": det.drift,
            "profile": os.path.join(out_dir, "fitted_profile.json"),
        }
        report = calibrate(model, max_ops=max_ops)
        if report.measured_step_us is None and det.measured_step_us:
            # the coordinator measures through the drift detector
            report.measured_step_us = det.measured_step_us
    else:
        model, xs, y = _compile_synthetic(model_name, config)
        model.fit(xs, y, batch_size=config.batch_size,
                  epochs=config.epochs,
                  steps_per_execution=config.steps_per_execution)
        report = calibrate(model, max_ops=max_ops)
        print(model.step_stats.format_summary())
        if refit_mode:
            from .refit import FittedProfileError, refit

            try:
                pallas_rows = (_forced_kernel_rows(model_name, config,
                                                   max_ops)
                               if fit_thresholds else None)
                profile, history = refit(
                    model, report.measured_step_us, report.ops,
                    prior=prior, rounds=refit_rounds, tol=refit_tol,
                    pallas_rows=pallas_rows)
                path = profile.save(
                    os.path.join(out_dir, "fitted_profile.json"))
                refit_summary = {
                    "rounds": [h.to_dict() for h in history],
                    "converged": abs(history[-1].ratio - 1.0) <= refit_tol,
                    "final_ratio": history[-1].ratio,
                    "replans": 0,
                    "profile": path,
                    "kernel_thresholds": dict(
                        profile.kernel_residual_thresholds),
                }
            except FittedProfileError as e:
                refit_summary = {"rounds": [], "converged": False,
                                 "final_ratio": None, "replans": 0,
                                 "error": str(e)}
    print(report.format())
    if kernel_report:
        print(report.format_kernel_report())
        with open(os.path.join(out_dir, "kernel_report.txt"), "w") as f:
            f.write(report.format_kernel_report() + "\n")
    trace_path = tracer.export_chrome_trace(
        os.path.join(out_dir, "trace.json"))
    with open(os.path.join(out_dir, "calibration.json"), "w") as f:
        f.write(report.to_json())
    with open(os.path.join(out_dir, "calibration.txt"), "w") as f:
        f.write(report.format() + "\n")
    metrics_text = get_registry().render()
    metrics_path = os.path.join(out_dir, "metrics.txt")
    with open(metrics_path, "w") as f:
        f.write(metrics_text)

    # self-validate the artifacts: a bundle that does not load in
    # Perfetto or scrape as Prometheus text is a failure, not a warning
    problems: List[str] = []
    spans: List[str] = []
    try:
        spans = validate_trace(trace_path)
    except (ValueError, KeyError, json.JSONDecodeError) as e:
        problems.append(f"trace: {e}")
    missing = [alts for alts in REQUIRED_SPANS
               if not any(s in spans for s in alts)]
    # a search span only exists when a search ran; the single-device
    # quick path does not fail on it
    if ("search",) in missing and model.search_result is None:
        missing.remove(("search",))
    if missing:
        problems.append(
            "trace: missing required span(s) "
            + str([" | ".join(alts) for alts in missing]))
    try:
        validate_exposition(metrics_text)
    except ValueError as e:
        problems.append(f"metrics: {e}")
    if refit_mode:
        if refit_summary is None or not refit_summary.get("converged"):
            problems.append(
                "refit: did not converge within "
                f"{refit_rounds} round(s) to ±{refit_tol:.0%} "
                f"({(refit_summary or {}).get('error', 'see rounds')})")
        if fit_thresholds and not (refit_summary or {}).get(
                "kernel_thresholds"):
            problems.append(
                "fit-kernel-thresholds: the forced-kernel measurement"
                " produced no per-family thresholds — no usable"
                " calibration rows (see kernel_thresholds in the"
                " summary)")
        if drift_replan:
            if replans != 1:
                problems.append(
                    f"drift-replan: expected exactly 1 budgeted re-plan, "
                    f"saw {replans}")
            if "refit.replan" not in spans:
                problems.append(
                    "trace: drift re-plan ran but no refit.replan span")
    sr = model.search_result
    predicted = (sr.predicted_step_us if sr is not None
                 else report.predicted_step_us)
    bench = _bench_point(model_name, model, predicted,
                         report.measured_step_us, report.backend)
    with open(os.path.join(out_dir, "bench.json"), "w") as f:
        json.dump(bench, f, indent=2)
        f.write("\n")
    print("BENCH " + json.dumps(bench))
    summary = {
        "ok": not problems,
        "model": model_name,
        "out": out_dir,
        "trace": trace_path,
        "spans": spans,
        "steps_recorded": (len(model.step_stats)
                           if model.step_stats is not None else 0),
        "predicted_step_us": predicted,
        "measured_step_us": report.measured_step_us,
        "refit": refit_summary,
        "kernel_candidates": (report.kernel_candidates()
                              if kernel_report else None),
        "problems": problems,
    }
    print(json.dumps(summary))
    return 0 if not problems else 1
