"""MoE router observability (counterpart of flexflow_tpu/obs/moe.py).

The fused ExpertsOp (ops/moe.py) keeps two pieces of router health in its
state buffers: `dropped`, a running count of capacity-overflow
token-assignments, and `load`, the last walk's per-expert assignment
shares. They stay on the device until `publish_moe_metrics(model)` reads
them and mirrors them into the registry as

 - ff_moe_router_dropped_tokens_total  Counter, labels=(op,)
 - ff_moe_expert_load                  Gauge,   labels=(op, expert)
 - ff_moe_expert_load_imbalance        Gauge,   labels=(op,)
   (max/mean of the load vector: 1.0 balanced, n collapsed onto one
   expert)

FFModel.fit publishes once an epoch; the serving MoE run publishes after
its router check.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ffconst import OpType
from .registry import REGISTRY, MetricsRegistry


def moe_router_families(registry: Optional[MetricsRegistry] = None):
    """(dropped counter, load gauge, imbalance gauge), registered
    idempotently; they render as zeros until the first publish."""
    reg = registry if registry is not None else REGISTRY
    c_dropped = reg.counter(
        "ff_moe_router_dropped_tokens_total",
        "Token-assignments dropped by capacity overflow, per experts op",
        labels=("op",))
    g_load = reg.gauge(
        "ff_moe_expert_load",
        "Per-expert share of router assignments, last published step",
        labels=("op", "expert"))
    g_imb = reg.gauge(
        "ff_moe_expert_load_imbalance",
        "max/mean of the expert load vector (1.0 = balanced)",
        labels=("op",))
    return c_dropped, g_load, g_imb


# per (registry id, op) the last published dropped total, so the counter
# only ever receives non-negative deltas
_LAST_DROPPED: Dict[tuple, float] = {}


def _host(value) -> np.ndarray:
    if hasattr(value, "detach"):
        value = value.detach().float().cpu().numpy()
    return np.asarray(value, np.float64)


def publish_moe_metrics(model,
                        registry: Optional[MetricsRegistry] = None) -> Dict:
    """Mirror every EXPERTS op's router state into the registry. Returns
    {op name: {"dropped": float, "load": [...]}}."""
    reg = registry if registry is not None else REGISTRY
    c_dropped, g_load, g_imb = moe_router_families(reg)
    out: Dict[str, Dict] = {}
    state = getattr(model, "state", None) or {}
    for op in model.graph.ops.values():
        if op.op_type != OpType.EXPERTS:
            continue
        vars_ = state.get(op.name)
        if not vars_ or "dropped" not in vars_:
            continue
        dropped = float(_host(vars_["dropped"]))
        load = _host(vars_["load"])
        key = (id(reg), op.name)
        delta = dropped - _LAST_DROPPED.get(key, 0.0)
        if delta > 0:
            c_dropped.inc(delta, op=op.name)
        _LAST_DROPPED[key] = dropped
        for e, frac in enumerate(load):
            g_load.set(float(frac), op=op.name, expert=str(e))
        mean = float(load.mean()) if load.size else 0.0
        g_imb.set(float(load.max()) / mean if mean > 0 else 0.0,
                  op=op.name)
        out[op.name] = {"dropped": dropped, "load": load.tolist()}
    return out


def reset_moe_publisher() -> None:
    """Forget the per-op published baselines (test isolation: once the
    registry is zeroed, the deltas restart from 0)."""
    _LAST_DROPPED.clear()
