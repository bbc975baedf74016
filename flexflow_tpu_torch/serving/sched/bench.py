"""The serve-bench model builder and the shared-prefix workload
(counterparts of flexflow_tpu/serving/sched/bench.py `build_tiny_lm` and
`make_shared_prefix_workload`). The serve-bench CLI itself comes with a
later slice."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
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


def make_shared_prefix_workload(n: int, groups: int, prefix_len: int,
                                suffix_min: int, suffix_max: int,
                                out_min: int, out_max: int, vocab: int,
                                seed: int) -> List[Dict]:
    """N requests over `groups` distinct system prompts: request i carries
    prefix (i % groups) plus a unique suffix. The first request of each
    group is the LEADER (a cold prefill that fills the prefix cache); the
    rest should hit. The JAX serve-bench defaults: 4 groups, a 128-token
    prefix, 2-8 suffix tokens."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(1, vocab, size=(prefix_len,)).astype(np.int32)
                for _ in range(groups)]
    reqs = []
    for i in range(n):
        g = i % groups
        slen = int(rng.randint(suffix_min, suffix_max + 1))
        reqs.append({
            "prompt": np.concatenate(
                [prefixes[g],
                 rng.randint(1, vocab, size=(slen,)).astype(np.int32)]),
            "max_new": int(rng.randint(out_min, out_max + 1)),
            "group": g,
            "leader": i < groups,
        })
    return reqs
