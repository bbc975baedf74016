"""Counterpart of flexflow_tpu/models/dlrm.py, the same graph, op names
and defaults. DLRM recommendation model (reference: examples/cpp/DLRM/dlrm.cc) —
sparse embedding tables + bottom/top MLPs + feature interaction. The
embedding tables are the attribute-parallel sharding target in the
reference's benchmarks (BASELINE.md config 5)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..ffconst import ActiMode, AggrMode


@dataclass
class DLRMConfig:
    """Defaults mirror DLRMConfig's ctor (dlrm.cc:26-42)."""
    sparse_feature_size: int = 64
    embedding_size: List[int] = field(default_factory=lambda: [1000000] * 4)
    embedding_bag_size: int = 1
    mlp_bot: List[int] = field(default_factory=lambda: [4, 64, 64])
    mlp_top: List[int] = field(default_factory=lambda: [64, 64, 2])
    arch_interaction_op: str = "cat"
    sigmoid_bot: int = -1
    sigmoid_top: int = -1


def _mlp(ff, t, layer_dims, sigmoid_layer: int, name: str):
    """Dense stack with ReLU (sigmoid at one chosen layer), dlrm.cc:44-66."""
    for i in range(len(layer_dims) - 1):
        act = (ActiMode.AC_MODE_SIGMOID if i == sigmoid_layer
               else ActiMode.AC_MODE_RELU)
        t = ff.dense(t, layer_dims[i + 1], act, use_bias=False,
                     name=f"{name}{i}")
    return t


def build_dlrm(model, dense_input, sparse_inputs, config: DLRMConfig = None):
    """dense→bot-MLP; each sparse id list→embedding; interact (concat or
    pairwise dot); →top-MLP (dlrm.cc top_level_task)."""
    cfg = config or DLRMConfig()
    ff = model
    assert len(sparse_inputs) == len(cfg.embedding_size)

    x = _mlp(ff, dense_input, cfg.mlp_bot, cfg.sigmoid_bot, "bot")
    embedded = [
        ff.embedding(sp, vocab, cfg.sparse_feature_size,
                     AggrMode.AGGR_MODE_SUM, name=f"emb{i}")
        for i, (sp, vocab) in enumerate(zip(sparse_inputs, cfg.embedding_size))
    ]

    if cfg.arch_interaction_op == "cat":
        z = ff.concat(embedded + [x], axis=-1)
    elif cfg.arch_interaction_op == "dot":
        # Capability extension: the reference's interact_features only
        # implements "cat" (dlrm.cc:88-99, dot is a TODO/assert). DLRM-paper
        # dot semantics: the n(n-1)/2 distinct pairwise dot products. One
        # batched Gram matmul, then O(n) slices pick the strict lower
        # triangle (not n^2 flatten — no duplicate/self-dot features).
        d = cfg.sparse_feature_size
        assert cfg.mlp_bot[-1] == d, "dot interaction needs bot-MLP out == sparse_feature_size"
        feats = ff.concat(
            [ff.reshape(t, [t.dims[0], 1, d]) for t in embedded + [x]], axis=1)
        gram = ff.batch_matmul(feats, ff.transpose(feats, [0, 2, 1]))  # (b,n,n)
        n_feat = len(embedded) + 1
        rows = ff.split(gram, [1] * n_feat, axis=1)  # row i: (b, 1, n)
        pairs = []
        for i in range(1, n_feat):
            row = ff.reshape(rows[i], [gram.dims[0], n_feat])
            left = ff.split(row, [i, n_feat - i], axis=1)[0]  # cols 0..i-1
            pairs.append(left)
        z = ff.concat(pairs + [x], axis=-1)
    else:
        raise ValueError(f"unknown interaction op {cfg.arch_interaction_op}")

    z = _mlp(ff, z, [z.dims[-1]] + list(cfg.mlp_top[1:]), cfg.sigmoid_top, "top")
    return ff.softmax(z)
