"""Observability of the port: so far the labelled counters
(obs/registry.py); tracing, step stats and the exposition renderer come
with ROADMAP A9."""
from .registry import REGISTRY, Counter, MetricsRegistry

__all__ = ["Counter", "MetricsRegistry", "REGISTRY"]
