"""The serve-bench model builder (counterpart of
flexflow_tpu/serving/sched/bench.py `build_tiny_lm`). The serve-bench CLI
itself comes with a later slice."""
from __future__ import annotations

from typing import Optional

import torch

from ...config import FFConfig
from ...ffconst import ActiMode, AggrMode, CompMode, DataType
from ...model import FFModel


def build_tiny_lm(batch: int, window: int, vocab: int = 64,
                  hidden: int = 32, heads: int = 4, layers: int = 2,
                  mixed_precision: bool = False, device: str = "cuda",
                  generator: Optional[torch.Generator] = None) -> FFModel:
    """A causal transformer LM, the same graph and op names as the JAX
    builder: embedding, then per layer attention + add + layer_norm and a
    GELU FFN of 2 x hidden + add + layer_norm, then lm_head and the
    vocabulary softmax. Compiled for `batch` slots on `device`, weights
    drawn from `generator`."""
    config = FFConfig()
    config.batch_size = batch
    config.allow_mixed_precision = mixed_precision
    config.device = device
    model = FFModel(config)
    tokens = model.create_tensor([batch, window], DataType.DT_INT32)
    t = model.embedding(tokens, vocab, hidden, AggrMode.AGGR_MODE_NONE,
                        name="emb")
    for i in range(layers):
        attn = model.multihead_attention(t, t, t, hidden, heads,
                                         causal=True, name=f"l{i}_attn")
        t = model.layer_norm(model.add(t, attn), [-1], name=f"l{i}_ln1")
        h = model.dense(t, hidden * 2, ActiMode.AC_MODE_GELU,
                        name=f"l{i}_ff1")
        h = model.dense(h, hidden, name=f"l{i}_ff2")
        t = model.layer_norm(model.add(t, h), [-1], name=f"l{i}_ln2")
    model.softmax(model.dense(t, vocab, name="lm_head"))
    model.compile(comp_mode=CompMode.COMP_MODE_INFERENCE,
                  generator=generator)
    return model
