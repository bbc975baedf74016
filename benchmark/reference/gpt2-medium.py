"""Plain reference of the gpt2-medium configuration
(configs/gpt2-medium.json): GPT-2 Medium's causal forward pass in
float32 with TF32 off.

Architecture (Radford et al. 2019; openai-community/gpt2-medium's
config.json, as the configuration runs it): token embedding; 24 pre-LN
blocks of LayerNorm, causal self-attention (biases, 1/sqrt(d)), add,
LayerNorm, dense 4096 with tanh GELU (gelu_new), dense 1024, add; a
final LayerNorm; the untied LM head over the vocabulary, no bias.
Departures from the published model: configs/gpt2-medium.json.

Tolerance (limits/gpt2-medium.*.json): the port serves in bf16 and picks
each token from bf16 probabilities, so a served token may lie below the
reference's best by bf16's rounding of near ties; the limit sits between
the port's widest gap over a dozen seeds and the widest gap of the token
this reference computed on fp8 operands puts first, the control
(PERF.md).
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.common import (attention, dense, draw, gelu_tanh,
                                        layer_norm, matmul, strict_f32)


def dims(cfg: dict) -> dict:
    h = cfg["n_embd"]
    return {"hidden": h, "layers": cfg["n_layer"], "heads": cfg["n_head"],
            "ffn": cfg["n_inner"] or 4 * h, "vocab": cfg["vocab_size"],
            "head_params": h * cfg["vocab_size"]}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weights both sides start from, drawn on `device` from the
    seed, one call a block: matrices normal(0, initializer_range), the
    two projections into the residual stream scaled by 1/sqrt(2 n_layer)
    as GPT-2 initializes them, biases and betas 0, gammas 1; {op:
    {weight: f32 tensor}} by the port's op and weight names."""
    d = dims(cfg)
    e, f, v, heads = d["hidden"], d["ffn"], d["vocab"], d["heads"]
    hd, std = e // heads, cfg["initializer_range"]
    res = std / math.sqrt(2 * d["layers"])
    groups = [[("wte", "weight", (v, e), std)]]
    for i in range(d["layers"]):
        a = f"h{i}_attn"
        groups.append([(a, "wq", (e, heads, hd), std),
                       (a, "wk", (e, heads, hd), std),
                       (a, "wv", (e, heads, hd), std),
                       (a, "wo", (heads, hd, e), res),
                       (f"h{i}_fc", "kernel", (e, f), std),
                       (f"h{i}_proj", "kernel", (f, e), res)])
    groups.append([("lm_head", "kernel", (e, v), std)])
    g = torch.Generator(device=device).manual_seed(int(seed))
    tree = draw(g, groups, device)
    z = {"device": device, "dtype": torch.float32}
    for i in range(d["layers"]):
        tree[f"h{i}_attn"].update(
            bq=torch.zeros(heads, hd, **z), bk=torch.zeros(heads, hd, **z),
            bv=torch.zeros(heads, hd, **z), bo=torch.zeros(e, **z))
        tree[f"h{i}_fc"]["bias"] = torch.zeros(f, **z)
        tree[f"h{i}_proj"]["bias"] = torch.zeros(e, **z)
    for op in ["ln_f"] + [f"h{i}_ln{j}" for i in range(d["layers"])
                          for j in (1, 2)]:
        tree[op] = {"gamma": torch.ones(e, **z), "beta": torch.zeros(e, **z)}
    return tree


@torch.no_grad()
def logits(cfg: dict, w: dict, tokens: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """(n, V) float32 logits at every position of one sequence (n,)."""
    strict_f32()
    d, eps = dims(cfg), cfg["layer_norm_epsilon"]

    def ln(t, op):
        return layer_norm(t, w[op]["gamma"], w[op]["beta"], eps)

    def fc(t, op):
        return dense(t, w[op]["kernel"], w[op]["bias"], precision)

    t = w["wte"]["weight"][tokens.long()][None]
    for i in range(d["layers"]):
        t = t + attention(ln(t, f"h{i}_ln1"), w[f"h{i}_attn"], d["heads"],
                          True, precision)
        t = t + fc(gelu_tanh(fc(ln(t, f"h{i}_ln2"), f"h{i}_fc")),
                   f"h{i}_proj")
    return matmul(ln(t, "ln_f"), w["lm_head"]["kernel"], precision)[0]
