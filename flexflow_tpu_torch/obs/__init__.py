"""Observability of the port: labelled counters, gauges and histograms
and their Prometheus exposition (obs/registry.py), the MoE router's
families (obs/moe.py) and the span tracer with its Chrome-trace export
(obs/tracing.py), and the exposition parser and checker; step stats
and the fleet's merged render come with ROADMAP A9.2 and A10."""
from .moe import moe_router_families, publish_moe_metrics, \
    reset_moe_publisher
from .registry import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                       iter_samples, parse_exposition, validate_exposition)
from .tracing import (Tracer, disable_tracing, enable_tracing, get_tracer,
                      span)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "Tracer", "disable_tracing", "enable_tracing", "get_tracer",
           "iter_samples", "moe_router_families", "parse_exposition",
           "publish_moe_metrics", "reset_moe_publisher", "span",
           "validate_exposition"]
