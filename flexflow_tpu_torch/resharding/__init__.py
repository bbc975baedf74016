"""Live resharding: redistribution of a running model's tensors between
two plans' layouts over the ranks of a torch.distributed world (the
port's copy of flexflow_tpu/resharding, arXiv:2112.01075).

`redistribute(tree, old_plan, new_plan, peak_bytes=...)` plans a
bounded-scratch all-gather / slice / transfer schedule (plan.py, numpy
only), proves it legal through the analysis gate's FFTA06x family, and
applies it on the ranks (executor.py): each rank gives its local shards
under the old plan and gets its shards under the new one. cost.py prices
a schedule with the machine model's collective terms.
"""
from .cost import schedule_cost_us, step_cost_us
from .executor import (ReshardResult, apply_schedule, live_tree,
                       load_live_tree, redistribute, verify_live_tree)
from .plan import (ALLGATHER, PERMUTE, SLICE, TRANSFER, ArrayMove,
                   ArraySpec, MeshSpec, ReshardPlanError, ReshardSchedule,
                   ReshardStep, ShardingPlan, flatten_tree, leaf_itemsize,
                   plan_move, plan_of, plan_redistribution,
                   plan_slot_migration, uncovered_arrays, unflatten_tree)

__all__ = [
    "ALLGATHER", "PERMUTE", "SLICE", "TRANSFER",
    "ArrayMove", "ArraySpec", "MeshSpec", "ReshardPlanError",
    "ReshardResult", "ReshardSchedule", "ReshardStep", "ShardingPlan",
    "apply_schedule", "flatten_tree", "leaf_itemsize", "live_tree",
    "load_live_tree", "plan_move", "plan_of",
    "plan_redistribution", "plan_slot_migration", "redistribute",
    "schedule_cost_us", "step_cost_us", "uncovered_arrays",
    "unflatten_tree", "verify_live_tree",
]
