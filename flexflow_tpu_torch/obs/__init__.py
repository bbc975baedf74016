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
`python -m flexflow_tpu_torch.obs.collective_bench`). The fleet's
merged render, the
timeline and the flight recorder come with ROADMAP A9.2's rest and A10."""
from .calibration import (CalibrationReport, CollectiveCalibration,
                          OpCalibration, calibrate)
from .moe import moe_router_families, publish_moe_metrics, \
    reset_moe_publisher
from .refit import (DriftDetector, FittedCoefficients, FittedProfile,
                    FittedProfileError, FittedProfileMismatch, refit)
from .registry import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                       iter_samples, parse_exposition, validate_exposition)
from .stepstats import (StepStats, model_peak_tflops,
                        model_train_flops_per_step)
from .tracing import (Tracer, disable_tracing, enable_tracing, get_tracer,
                      span)

__all__ = ["CalibrationReport", "CollectiveCalibration", "Counter",
           "DriftDetector", "FittedCoefficients", "FittedProfile",
           "FittedProfileError", "FittedProfileMismatch", "Gauge",
           "Histogram", "MetricsRegistry", "OpCalibration", "REGISTRY",
           "StepStats", "Tracer", "calibrate", "disable_tracing",
           "enable_tracing", "get_tracer", "iter_samples",
           "model_peak_tflops", "model_train_flops_per_step",
           "moe_router_families", "parse_exposition", "publish_moe_metrics",
           "refit", "reset_moe_publisher", "span", "validate_exposition"]
