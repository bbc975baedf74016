"""Observability of the port: labelled counters, gauges and histograms
and their Prometheus exposition (obs/registry.py); tracing, step stats
and the fleet's merged render come with ROADMAP A9 and A10."""
from .registry import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY"]
