"""Counterpart of flexflow_tpu/models/xdl.py, the same graph, op names
and defaults. XDL click-through-rate model (reference: examples/cpp/XDL/xdl.cc) —
many large embedding tables concatenated into a dense MLP."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..ffconst import ActiMode, AggrMode


@dataclass
class XDLConfig:
    """Defaults mirror XDLConfig's ctor (xdl.cc:26-33)."""
    sparse_feature_size: int = 64
    embedding_size: List[int] = field(default_factory=lambda: [1000000] * 4)
    embedding_bag_size: int = 1
    mlp_dims: List[int] = field(default_factory=lambda: [256, 128, 2])


def build_xdl(model, sparse_inputs, config: XDLConfig = None):
    """embedding per sparse feature → concat → MLP → softmax
    (xdl.cc:49-82, 121-135)."""
    cfg = config or XDLConfig()
    ff = model
    embedded = [
        ff.embedding(sp, vocab, cfg.sparse_feature_size,
                     AggrMode.AGGR_MODE_SUM, name=f"emb{i}")
        for i, (sp, vocab) in enumerate(zip(sparse_inputs, cfg.embedding_size))
    ]
    t = ff.concat(embedded, axis=-1)
    for i, dim in enumerate(cfg.mlp_dims):
        act = (ActiMode.AC_MODE_RELU if i < len(cfg.mlp_dims) - 1
               else ActiMode.AC_MODE_NONE)
        t = ff.dense(t, dim, act, use_bias=False, name=f"mlp{i}")
    return ff.softmax(t)
