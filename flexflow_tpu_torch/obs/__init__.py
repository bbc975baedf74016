"""Observability of the port: labelled counters, gauges and histograms
and their Prometheus exposition (obs/registry.py), the MoE router's
families (obs/moe.py), the span tracer with its Chrome-trace export
(obs/tracing.py), the exposition parser and checker, `StepStats`
(obs/stepstats.py: per-step wall, samples/s, TFLOP/s and MFU, recorded
by FFModel.fit), and the calibration loop: `calibrate()`
(obs/calibration.py: the simulator's predicted step and op costs against
measured ones) and `refit()` with its persisted `FittedProfile` overlay
and the `DriftDetector` (obs/refit.py), with the collective sweep whose
rows the per-tier fit reads (obs/collective_bench.py, run as
`python -m flexflow_tpu_torch.obs.collective_bench`), the merged render
of many registries (`render_labeled`, `render_merged`: the fleet's
`/metrics`) and the fleet's `FlightRecorder` (obs/flightrecorder.py).
`reset_all` zeroes the default registry and the tracer. The timeline
merge comes with `obs/cli.py` (ROADMAP A11 item 2)."""
from .calibration import (CalibrationReport, CollectiveCalibration,
                          OpCalibration, calibrate)
from .moe import moe_router_families, publish_moe_metrics, \
    reset_moe_publisher
from .refit import (DriftDetector, FittedCoefficients, FittedProfile,
                    FittedProfileError, FittedProfileMismatch, refit)
from .flightrecorder import DEFAULT_DUMP_KINDS, FlightRecorder
from .registry import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                       get_registry, iter_samples, parse_exposition,
                       render_labeled, render_merged, validate_exposition)
from .stepstats import (StepStats, model_peak_tflops,
                        model_train_flops_per_step)
from .tracing import (Handoff, TraceContext, Tracer, current_context,
                      current_trace_id, disable_tracing, enable_tracing,
                      get_tracer, new_trace_id, root_context, span,
                      traced_dispatch, use_context)


def reset_all() -> None:
    """Zero every metric family of the default registry and drop the
    tracer's buffered events (JAX `obs.reset_all`): no counter or span
    state is left over from an earlier run."""
    REGISTRY.reset_all()
    reset_moe_publisher()
    tr = get_tracer()
    tr.disable()
    tr.clear()


__all__ = ["CalibrationReport", "CollectiveCalibration", "Counter",
           "DEFAULT_DUMP_KINDS", "DriftDetector", "FlightRecorder",
           "FittedCoefficients", "FittedProfile", "FittedProfileError",
           "FittedProfileMismatch", "Gauge", "Handoff", "Histogram",
           "MetricsRegistry", "OpCalibration", "REGISTRY", "StepStats",
           "TraceContext", "Tracer", "calibrate", "current_context",
           "current_trace_id", "disable_tracing", "enable_tracing",
           "get_registry", "get_tracer", "iter_samples",
           "model_peak_tflops", "model_train_flops_per_step",
           "moe_router_families", "new_trace_id", "parse_exposition",
           "publish_moe_metrics", "refit", "render_labeled",
           "render_merged", "reset_all", "reset_moe_publisher",
           "root_context", "span", "traced_dispatch", "use_context",
           "validate_exposition"]
