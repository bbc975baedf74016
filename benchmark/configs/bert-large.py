"""Builds the bert-large configuration (configs/bert-large.json) through
the port's FFModel layer API, for training: token embedding, LayerNorm,
the post-LN encoder layers (as models/transformer.py builds them, with
BERT's LayerNorm epsilon), the masked-LM head, sparse cross-entropy on
its logits and Adam with the configuration's moments."""
from __future__ import annotations

import torch

from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig, FFModel,
                                LossType)
from flexflow_tpu_torch.ffconst import ActiMode, AggrMode


def build_train(cfg: dict, mix: dict, device: str) -> FFModel:
    """The model compiled for training at the mix's batch and sequence
    length; the port draws its own weights, which the runner replaces by
    the seed's."""
    e, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    eps = cfg["layer_norm_eps"]
    batch, seq = int(mix["batch"]), int(mix["seq"])
    model = FFModel(FFConfig(batch_size=batch, device=device,
                             allow_mixed_precision=cfg["dtype"]
                             == "bfloat16"))
    tokens = model.create_tensor([batch, seq], DataType.DT_INT32)
    t = model.embedding(tokens, cfg["vocab_size"], e,
                        AggrMode.AGGR_MODE_NONE, name="tok_emb")
    t = model.layer_norm(t, [-1], eps=eps, name="emb_ln")
    for i in range(cfg["num_hidden_layers"]):
        a = model.multihead_attention(t, t, t, e, heads,
                                      name=f"layer{i}_attn")
        t = model.layer_norm(model.add(t, a), [-1], eps=eps,
                             name=f"layer{i}_ln1")
        h = model.dense(t, cfg["intermediate_size"], ActiMode.AC_MODE_GELU,
                        name=f"layer{i}_ff1")
        h = model.dense(h, e, name=f"layer{i}_ff2")
        t = model.layer_norm(model.add(t, h), [-1], eps=eps,
                             name=f"layer{i}_ln2")
    t = model.dense(t, e, ActiMode.AC_MODE_GELU, name="mlm_dense")
    t = model.layer_norm(t, [-1], eps=eps, name="mlm_ln")
    model.dense(t, cfg["vocab_size"], name="mlm_decoder")
    opt = cfg["optimizer"]
    model.compile(
        optimizer=AdamOptimizer(
            model, alpha=opt["alpha"], beta1=opt["beta1"],
            beta2=opt["beta2"], epsilon=opt["epsilon"],
            moments_dtype=(torch.bfloat16 if opt["moments_dtype"]
                           == "bfloat16" else None)),
        loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[], generator=torch.Generator().manual_seed(0))
    return model
