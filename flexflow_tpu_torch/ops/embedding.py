"""Embedding lookup (counterpart of flexflow_tpu/ops/embedding.py):
AGGR_MODE_NONE keeps a vector a token; the bags, AGGR_MODE_SUM and
AGGR_MODE_AVG, sum or average the looked-up rows over the ids' last
axis, the bag (ids (..., bag) -> (..., out_dim)). The gradient into the
table is dense, as JAX's `take` VJP is.

`jnp.take` clamps an out-of-range id where torch indexing raises; the
batcher rejects such ids at submit, so the port keeps torch's check
instead of emulating the clamp.

On a mesh the table is sharded on its feature dim (TP_WEIGHT_SHARD_DIMS):
each rank looks up its slice of every row (and reduces its bags), then
the rows are all-gathered (runtime/collectives.py)."""
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
        dims = ids.dims
        if self.params.get("aggr", AggrMode.AGGR_MODE_NONE) \
                != AggrMode.AGGR_MODE_NONE:
            dims = dims[:-1]
        return ([dims + (self.params["out_dim"],)],
                [self.params.get("dtype", DataType.DT_FLOAT)])

    def weight_specs(self) -> List[WeightSpec]:
        return [WeightSpec(
            "weight", (self.params["num_entries"], self.params["out_dim"]),
            self.params.get("dtype", DataType.DT_FLOAT),
            self.params.get("kernel_initializer")
            or NormInitializer(stddev=0.05))]

    def lower(self, ctx, inputs):
        y = self.w("weight")[inputs[0].long()]
        aggr = self.params.get("aggr", AggrMode.AGGR_MODE_NONE)
        if aggr == AggrMode.AGGR_MODE_SUM:
            y = y.sum(dim=-2)
        elif aggr == AggrMode.AGGR_MODE_AVG:
            y = y.mean(dim=-2)
        if self.tp_degree > 1:
            y = gather_last(y, ctx.mesh.group("model"),
                            ctx.mesh.index("model"), self.tp_degree)
        return [y]
