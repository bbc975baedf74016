"""Builds the gpt2-medium configuration (configs/gpt2-medium.json)
through the port's FFModel layer API, for serving: token embedding, the
pre-LN blocks with causal attention, the final LayerNorm, the untied LM
head and the vocabulary softmax the ContinuousBatcher picks from."""
from __future__ import annotations

import torch

from flexflow_tpu_torch import CompMode, DataType, FFConfig, FFModel
from flexflow_tpu_torch.ffconst import ActiMode, AggrMode


def build_serve(cfg: dict, device: str) -> FFModel:
    """The model compiled for inference over a window of the serving
    span (`serving.max_len`); the port draws its own weights, which the
    runner replaces by the seed's."""
    e, heads = cfg["n_embd"], cfg["n_head"]
    eps = cfg["layer_norm_epsilon"]
    ffn = cfg["n_inner"] or 4 * e
    model = FFModel(FFConfig(batch_size=1, device=device,
                             allow_mixed_precision=cfg["dtype"]
                             == "bfloat16"))
    tokens = model.create_tensor([1, cfg["serving"]["max_len"]],
                                 DataType.DT_INT32)
    t = model.embedding(tokens, cfg["vocab_size"], e,
                        AggrMode.AGGR_MODE_NONE, name="wte")
    for i in range(cfg["n_layer"]):
        x = model.layer_norm(t, [-1], eps=eps, name=f"h{i}_ln1")
        a = model.multihead_attention(x, x, x, e, heads, causal=True,
                                      name=f"h{i}_attn")
        t = model.add(t, a)
        x = model.layer_norm(t, [-1], eps=eps, name=f"h{i}_ln2")
        x = model.dense(x, ffn, ActiMode.AC_MODE_GELU, name=f"h{i}_fc")
        t = model.add(t, model.dense(x, e, name=f"h{i}_proj"))
    t = model.layer_norm(t, [-1], eps=eps, name="ln_f")
    model.softmax(model.dense(t, cfg["vocab_size"], use_bias=False,
                              name="lm_head"))
    model.compile(comp_mode=CompMode.COMP_MODE_INFERENCE,
                  generator=torch.Generator().manual_seed(0))
    return model
