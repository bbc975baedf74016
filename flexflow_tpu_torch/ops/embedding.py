"""Embedding lookup (counterpart of flexflow_tpu/ops/embedding.py), the
per-token form (AGGR_MODE_NONE); the SUM/AVG bag forms come with the
op-set slice (ROADMAP A6).

`jnp.take` clamps an out-of-range id where torch indexing raises; the
batcher rejects such ids at submit, so the port keeps torch's check
instead of emulating the clamp.

On a mesh the table is sharded on its feature dim (TP_WEIGHT_SHARD_DIMS):
each rank looks up its slice of every row, then the rows are
all-gathered (runtime/collectives.py)."""
from __future__ import annotations

from typing import List

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import AggrMode, DataType, OpType
from ..runtime.collectives import gather_last
from ..runtime.initializers import NormInitializer


@register_op
class EmbeddingOp(Op):
    op_type = OpType.EMBEDDING

    def output_shapes(self):
        (ids,) = self.inputs
        if self.params.get("aggr", AggrMode.AGGR_MODE_NONE) \
                != AggrMode.AGGR_MODE_NONE:
            raise NotImplementedError(
                "embedding bags (SUM/AVG) come with the op-set slice "
                "(ROADMAP A6)")
        return ([ids.dims + (self.params["out_dim"],)],
                [self.params.get("dtype", DataType.DT_FLOAT)])

    def weight_specs(self) -> List[WeightSpec]:
        return [WeightSpec(
            "weight", (self.params["num_entries"], self.params["out_dim"]),
            self.params.get("dtype", DataType.DT_FLOAT),
            self.params.get("kernel_initializer")
            or NormInitializer(stddev=0.05))]

    def lower(self, ctx, inputs):
        y = self.w("weight")[inputs[0].long()]
        if self.tp_degree > 1:
            y = gather_last(y, ctx.mesh.group("model"),
                            ctx.mesh.index("model"), self.tp_degree)
        return [y]
