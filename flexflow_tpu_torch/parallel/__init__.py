"""Parallel planning of the port (counterpart of flexflow_tpu/parallel):
the pipeline planner (`pipeline_plan`) and the explicit parallel ops
(`parallel_ops`)."""
from .parallel_ops import (AllReduceOp, CombineOp, FusedParallelOp,
                           ReductionOp, RepartitionOp, ReplicateOp)

__all__ = ["AllReduceOp", "CombineOp", "FusedParallelOp", "ReductionOp",
           "RepartitionOp", "ReplicateOp"]
