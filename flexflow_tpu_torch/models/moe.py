"""Mixture-of-experts model builders (counterpart of
flexflow_tpu/models/moe.py), with the JAX builders' graphs, op names and
defaults:

 - `build_moe_encoder` (reference examples/cpp/mixture_of_experts/
   moe.cc:100-135): attention and the unfused MoE (group_by, a dense per
   expert, aggregate), the model of the recompile / cache machinery;
 - `build_moe_transformer` / `build_moe_lm`: the switch / top-k MoE
   transformer, a softmax router per MoE block, capacity dropping
   (ops/moe.py moe_capacity) and the Switch load-balance loss
   (lambda_bal) added to fit's loss; every MoE block the fused
   ExpertsOp on the native (batch, seq, hidden) states, so the serving
   walks run it at their own leading dims.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..ffconst import ActiMode, AggrMode, OpType


@dataclass
class MoeConfig:
    """Defaults mirror MoeConfig (moe.h)."""
    hidden_size: int = 64
    num_attention_heads: int = 16
    num_encoder_layers: int = 6
    num_exp: int = 5
    num_select: int = 2
    alpha: float = 2.0       # group_by capacity factor
    lambda_bal: float = 0.04  # load-balance aux loss weight


def build_moe_encoder(model, input, cfg: MoeConfig = None):
    """Per layer: x = LN(x + MHA(x)); x = LN(x + MoE(x)) (moe.cc:105-126).
    `input` is [batch, seq, hidden_size]."""
    cfg = cfg or MoeConfig()
    ff = model
    x = input
    for i in range(cfg.num_encoder_layers):
        attn = ff.multihead_attention(
            x, x, x, cfg.hidden_size, cfg.num_attention_heads,
            name=f"l{i}_attn")
        x = ff.layer_norm(ff.add(x, attn), [-1], name=f"l{i}_ln1")
        expert_out = ff.moe(x, cfg.num_exp, cfg.num_select,
                            cfg.hidden_size, cfg.alpha, cfg.lambda_bal,
                            name=f"l{i}_moe")
        x = ff.layer_norm(ff.add(x, expert_out), [-1], name=f"l{i}_ln2")
    return x


@dataclass
class MoeTransformerConfig:
    """Switch / top-k MoE transformer (dense attention, an MoE FFN every
    `moe_every` layers). Defaults are test-sized."""
    hidden_size: int = 64
    num_heads: int = 4
    num_layers: int = 2
    num_experts: int = 8
    top_k: int = 2           # num_select: 1 = switch routing
    capacity_factor: float = 2.0   # alpha in moe_capacity
    lambda_bal: float = 0.01       # load-balance aux loss weight
    moe_every: int = 1       # every k-th layer gets an MoE FFN
    vocab_size: int = 64


def _moe_layer(ff, t, cfg: MoeTransformerConfig, name: str,
               causal: bool = False):
    attn = ff.multihead_attention(t, t, t, cfg.hidden_size, cfg.num_heads,
                                  causal=causal, name=f"{name}_attn")
    t = ff.layer_norm(ff.add(t, attn), [-1], name=f"{name}_ln1")
    h = ff.moe(t, cfg.num_experts, cfg.top_k, cfg.hidden_size,
               alpha=cfg.capacity_factor, lambda_bal=cfg.lambda_bal,
               fused=True, name=f"{name}_moe")
    return ff.layer_norm(ff.add(t, h), [-1], name=f"{name}_ln2")


def _dense_layer(ff, t, cfg: MoeTransformerConfig, name: str,
                 causal: bool = False):
    attn = ff.multihead_attention(t, t, t, cfg.hidden_size, cfg.num_heads,
                                  causal=causal, name=f"{name}_attn")
    t = ff.layer_norm(ff.add(t, attn), [-1], name=f"{name}_ln1")
    h = ff.dense(t, cfg.hidden_size * 2, ActiMode.AC_MODE_GELU,
                 name=f"{name}_ff1")
    h = ff.dense(h, cfg.hidden_size, name=f"{name}_ff2")
    return ff.layer_norm(ff.add(t, h), [-1], name=f"{name}_ln2")


def _stack(ff, t, cfg: MoeTransformerConfig, causal: bool):
    for i in range(cfg.num_layers):
        if cfg.moe_every > 0 and i % cfg.moe_every == cfg.moe_every - 1:
            t = _moe_layer(ff, t, cfg, f"l{i}", causal=causal)
        else:
            t = _dense_layer(ff, t, cfg, f"l{i}", causal=causal)
    return t


def build_moe_transformer(model, token_input,
                          cfg: MoeTransformerConfig = None,
                          num_classes: int = 2):
    """Token ids -> embedding -> MoE encoder stack -> classifier softmax;
    compile with the sparse categorical cross-entropy, and the blocks'
    load-balance losses join fit's loss (runtime/executor.py)."""
    cfg = cfg or MoeTransformerConfig()
    ff = model
    t = ff.embedding(token_input, cfg.vocab_size, cfg.hidden_size,
                     AggrMode.AGGR_MODE_NONE, name="tok_emb")
    t = _stack(ff, t, cfg, causal=False)
    t = ff.dense(t, num_classes, name="cls")
    return ff.softmax(t)


def build_moe_lm(model, token_input, cfg: MoeTransformerConfig = None):
    """Causal MoE LM, the serving builder (GenerativeSession,
    ContinuousBatcher): the same MoE blocks, causal attention and an LM
    head over the vocabulary."""
    cfg = cfg or MoeTransformerConfig()
    ff = model
    t = ff.embedding(token_input, cfg.vocab_size, cfg.hidden_size,
                     AggrMode.AGGR_MODE_NONE, name="tok_emb")
    t = _stack(ff, t, cfg, causal=True)
    return ff.softmax(ff.dense(t, cfg.vocab_size, name="lm_head"))


def moe_expert_ops(model):
    """The graph's EXPERTS ops in build order (before compile, the
    model's op list), the hook obs/moe.py and the expert-affine batcher
    use."""
    ops = (model.graph.ops.values() if getattr(model, "graph", None)
           is not None else model.ops)
    return [op for op in ops if op.op_type == OpType.EXPERTS]
