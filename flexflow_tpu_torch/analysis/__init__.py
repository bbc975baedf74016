"""Plan analysis (counterpart of flexflow_tpu/analysis/): for now only the
plan's memory model, `plan_memory_bytes`, which the serving KV pool sizes
its slots with; the analysis passes and their diagnostics come with
ROADMAP A7.4."""
from .passes import plan_memory_bytes

__all__ = ["plan_memory_bytes"]
