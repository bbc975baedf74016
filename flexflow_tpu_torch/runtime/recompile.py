"""Dynamic recompilation hook (counterpart of
flexflow_tpu/runtime/recompile.py).

A RecompileState holds a user trigger, checked by `FFModel.fit` before
every optimizer step, and an alter function that changes the model when
the trigger fires (reference: RecompileState, recompile.h:28-44). The
reference's user is the MoE example: once the expert assignments settle
it switches the Cache ops to serve their cached tensors
(examples/cpp/mixture_of_experts/moe.cc:64-98).

Here the walk is eager, so an op's new params take effect at its next
walk; `FFModel.invalidate_compiled_steps` drops the captured K-step
graphs so the next dispatch captures the new dataflow. Weights and
optimizer state carry over.
"""
from __future__ import annotations

from typing import Callable

from ..ffconst import OpType


class RecompileState:
    """trigger(model) -> bool; alter(model) -> None, called when the
    trigger fires (once, with `one_shot`, like the reference's)."""

    def __init__(self, trigger: Callable, alter: Callable,
                 one_shot: bool = True):
        self.trigger = trigger
        self.alter = alter
        self.one_shot = one_shot
        self.fired = 0

    def step(self, model) -> bool:
        """Called by fit before each optimizer step."""
        if self.one_shot and self.fired:
            return False
        if not self.trigger(model):
            return False
        self.fired += 1
        self.alter(model)
        return True


def moe_cache_trigger(threshold: float = 0.05, warmup_steps: int = 10):
    """The reference moe_trigger (moe.cc:65-81): fires once every Cache
    op's staleness score (the mean L1 divergence of its input from the
    cached tensor) is below `threshold`, after `warmup_steps` steps."""
    def trigger(model) -> bool:
        if model._step_count < warmup_steps:
            return False
        state = model.state
        scores = [float(state[op.name]["score"])
                  for op in model.graph.ops.values()
                  if op.op_type == OpType.CACHE and op.name in state]
        return bool(scores) and max(scores) < threshold

    return trigger


def moe_cache_alter(model) -> None:
    """The reference moe_alter (moe.cc:83-98): the Cache ops serve their
    cached tensors from the next step on."""
    for op in model.graph.ops.values():
        if op.op_type == OpType.CACHE:
            op.params["use_cached"] = True
    model.invalidate_compiled_steps()
