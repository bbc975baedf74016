"""Executor: walks the graph eagerly on one torch device, inference only
(counterpart of flexflow_tpu/runtime/executor.py `forward_values`).

The JAX executor traces the walk into one jitted program; here each op
runs as it is reached. Every op output is cast to its boundary storage
dtype (`emit_dtype`: bf16 under mixed precision), exactly where the JAX
executor casts.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.graph import Graph
from ..core.op import LoweringContext
from ..ffconst import CompMode, OpType
from ..ops.common import emit_dtype


class Executor:
    def __init__(self, graph: Graph, config):
        self.graph = graph
        self.config = config
        self.topo = graph.topo_order()

    def forward_values(
        self,
        input_values: Dict[str, torch.Tensor],
        state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        decode_pos=None,
        mode: CompMode = CompMode.COMP_MODE_INFERENCE,
    ) -> Dict[int, torch.Tensor]:
        """Returns tensor guid -> value. state: op name -> {var: tensor},
        e.g. each attention op's "k_cache"/"v_cache", updated in place.
        decode_pos: an int chunk offset or a (B,) int32 tensor of per-row
        positions (ops/attention.py)."""
        if mode != CompMode.COMP_MODE_INFERENCE:
            raise NotImplementedError(
                "training comes with the training slice (ROADMAP A2); this "
                "executor runs inference only")
        ctx = LoweringContext(self.config, mode)
        ctx.decode_pos = decode_pos
        ctx.state = state if state is not None else {}
        with torch.no_grad():
            for op in self.topo:
                if op.op_type == OpType.INPUT:
                    ctx.values[op.outputs[0].guid] = input_values[op.name]
                    continue
                outs = op.lower(ctx, [ctx.values[t.guid] for t in op.inputs])
                for t, v in zip(op.outputs, outs):
                    ctx.values[t.guid] = v.to(emit_dtype(self.config,
                                                         t.dtype))
        return ctx.values
