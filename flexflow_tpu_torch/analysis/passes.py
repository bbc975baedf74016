"""The plan's memory model (flexflow_tpu/analysis/passes.py
`plan_memory_bytes`). It lives here, beside the passes that will gate on
it (ROADMAP A7.4), so "what fits in device memory" has one definition:
the serving slot count (serving/sched/kvpool.py derive_num_slots) reads
it now."""
from __future__ import annotations

from typing import Optional

from ..core.graph import Graph


def plan_memory_bytes(graph: Graph, machine, config=None, strategies=None,
                      optimizer_state_factor: Optional[float] = None):
    """Per-chip bytes of a plan (sharded weights x optimizer-state factor +
    saved activations) via CostModel.op_memory_bytes. Returns
    (total_bytes, worst_op, worst_op_bytes). optimizer_state_factor=1.0
    sizes an inference deployment (weights only, no optimizer moments)."""
    from ..search.simulator import CostModel, OpStrategy

    cost = CostModel(machine, config)
    if optimizer_state_factor is not None:
        cost.opt_state_factor = float(optimizer_state_factor)
    default = OpStrategy()
    total = 0.0
    worst_op, worst_bytes = None, -1.0
    for op in graph.ops.values():
        s = (strategies or {}).get(op.guid) or default
        try:
            b = cost.op_memory_bytes(op, s)
        except Exception:
            continue  # exotic op the cost model can't size: not a verdict
        total += b
        if b > worst_bytes:
            worst_op, worst_bytes = op, b
    return total, worst_op, worst_bytes
