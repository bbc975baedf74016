"""Observability of the port: labelled counters, gauges and histograms
and their Prometheus exposition (obs/registry.py), and the MoE router's
families (obs/moe.py); tracing, step stats and the fleet's merged render
come with ROADMAP A9 and A10."""
from .moe import moe_router_families, publish_moe_metrics, \
    reset_moe_publisher
from .registry import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "moe_router_families", "publish_moe_metrics",
           "reset_moe_publisher"]
