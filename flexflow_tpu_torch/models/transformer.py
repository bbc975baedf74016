"""Transformer / BERT builders (counterpart of
flexflow_tpu/models/transformer.py): the same graph, op names and
defaults — 12 layers, hidden 1024, 16 heads, seq 512, FFN 4 x hidden,
vocab 30522, the OSDI'22 BERT benchmark config.

`use_flash` is the JAX builders' per-op switch of the attention path:
None leaves it to the kernel registry (kernels/registry.py: the flash
kernel on the card, the einsum reference core on the CPU), True forces
the flash kernel (its plain version on the CPU), False the einsum
core."""
from __future__ import annotations

from dataclasses import dataclass

from ..ffconst import ActiMode, AggrMode


@dataclass
class TransformerConfig:
    hidden_size: int = 1024
    embedding_size: int = 1024
    num_heads: int = 16
    num_layers: int = 12
    sequence_length: int = 512
    ffn_mult: int = 4
    vocab_size: int = 30522


def _encoder_layer(ff, t, cfg: TransformerConfig, name: str,
                   sequence_parallel: bool = False, use_flash=None,
                   dropout: float = 0.0):
    attn = ff.multihead_attention(
        t, t, t, cfg.hidden_size, cfg.num_heads, dropout=dropout,
        sequence_parallel=sequence_parallel, use_flash=use_flash,
        name=f"{name}_attn")
    t = ff.layer_norm(ff.add(t, attn), [-1], name=f"{name}_ln1")
    h = ff.dense(t, cfg.hidden_size * cfg.ffn_mult, ActiMode.AC_MODE_GELU,
                 name=f"{name}_ff1")
    h = ff.dense(h, cfg.hidden_size, name=f"{name}_ff2")
    return ff.layer_norm(ff.add(t, h), [-1], name=f"{name}_ln2")


def build_transformer(model, input, cfg: TransformerConfig = None,
                      num_classes: int = 2):
    """Encoder stack on an already-embedded [batch, seq, hidden] float
    tensor, the shape of the reference benchmark
    (examples/cpp/Transformer/transformer.cc:60-76)."""
    cfg = cfg or TransformerConfig()
    ff = model
    t = input
    for i in range(cfg.num_layers):
        t = _encoder_layer(ff, t, cfg, f"layer{i}")
    t = ff.dense(t, num_classes, name="cls")
    return ff.softmax(t)


def build_bert_encoder(model, token_input, cfg: TransformerConfig = None,
                       num_classes: int = 2, sequence_parallel: bool = False,
                       use_flash=None):
    """Token ids -> embedding -> encoder stack -> classifier -> softmax,
    the flagship model of bench.py / __graft_entry__.py. use_flash: None
    = the registry's choice, True/False forces the attention path."""
    cfg = cfg or TransformerConfig()
    ff = model
    t = ff.embedding(token_input, cfg.vocab_size, cfg.hidden_size,
                     AggrMode.AGGR_MODE_NONE, name="tok_emb")
    for i in range(cfg.num_layers):
        t = _encoder_layer(ff, t, cfg, f"layer{i}",
                           sequence_parallel=sequence_parallel,
                           use_flash=use_flash)
    t = ff.dense(t, num_classes, name="cls")
    return ff.softmax(t)
