"""The tensor-parallel tables of flexflow_tpu/search/simulator.py, copied
host-only (no cost model yet: that is ROADMAP A7).

TP_CAPABLE (simulator.py:73): the ops whose weights can shard over the
`model` mesh axis. TP_WEIGHT_SHARD_DIMS (:93): per op type, the weight
dim each shards on — FFModel._assign_tp_weights reads it to shard the
weights, and the ops read the same shards in their lowering.
"""
from __future__ import annotations

from ..ffconst import OpType

TP_CAPABLE = {
    OpType.LINEAR,
    OpType.MULTIHEAD_ATTENTION,
    OpType.EMBEDDING,
    OpType.BATCHMATMUL,
}

TP_WEIGHT_SHARD_DIMS = {
    OpType.LINEAR: {"kernel": -1, "bias": 0},
    OpType.EMBEDDING: {"weight": -1},
    OpType.MULTIHEAD_ATTENTION: {
        "wq": 1, "wk": 1, "wv": 1, "wo": 0,
        "bq": 0, "bk": 0, "bv": 0,
    },
}
