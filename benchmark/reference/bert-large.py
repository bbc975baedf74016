"""Plain reference of the bert-large configuration
(configs/bert-large.json): BERT-Large's post-LN encoder under its
masked-LM head, trained with Adam, in float32 with TF32 off.

Architecture (Devlin et al. 2018, as the configuration runs it): token
embedding, LayerNorm; 24 layers of self-attention (biases, 1/sqrt(d)),
add, LayerNorm, dense 4096 with tanh GELU, dense 1024, add, LayerNorm;
the MLM head: dense 1024 with tanh GELU, LayerNorm, the untied decoder
to the vocabulary with its bias; cross-entropy over every position,
averaged. Adam as the port states it: m, v in float32 here,
alpha_t = alpha sqrt(1 - beta2^t) / (1 - beta1^t), w -= alpha_t m /
(sqrt(v) + eps). Departures from the paper: configs/bert-large.json.

Tolerances (limits/bert-large.*.json): the port computes in bf16 with
f32 masters and bf16 Adam moments, so each number differs from this
float32 run by bf16's rounding carried through 24 layers and the steps;
the limits sit between the port's readings over a dozen seeds and those
of this reference computed on fp8 operands, the control (PERF.md).
"""
from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F

from benchmark.reference.common import (attention, dense, draw, gelu_tanh,
                                        layer_norm, strict_f32)


def dims(cfg: dict) -> dict:
    h = cfg["hidden_size"]
    return {"hidden": h, "layers": cfg["num_hidden_layers"],
            "heads": cfg["num_attention_heads"],
            "ffn": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "head_params": h * h + h * cfg["vocab_size"]}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The weights both sides start from, drawn on `device` from the
    seed, one call a layer: matrices normal(0, initializer_range), biases
    and LayerNorm betas 0, gammas 1; {op: {weight: f32 tensor}} by the
    port's op and weight names."""
    d = dims(cfg)
    e, f, v, heads = d["hidden"], d["ffn"], d["vocab"], d["heads"]
    hd, std = e // heads, cfg["initializer_range"]
    groups = [[("tok_emb", "weight", (v, e), std)]]
    for i in range(d["layers"]):
        a = f"layer{i}_attn"
        groups.append([(a, "wq", (e, heads, hd), std),
                       (a, "wk", (e, heads, hd), std),
                       (a, "wv", (e, heads, hd), std),
                       (a, "wo", (heads, hd, e), std),
                       (f"layer{i}_ff1", "kernel", (e, f), std),
                       (f"layer{i}_ff2", "kernel", (f, e), std)])
    groups.append([("mlm_dense", "kernel", (e, e), std),
                   ("mlm_decoder", "kernel", (e, v), std)])
    g = torch.Generator(device=device).manual_seed(int(seed))
    tree = draw(g, groups, device)
    z = {"device": device, "dtype": torch.float32}
    for i in range(d["layers"]):
        tree[f"layer{i}_attn"].update(
            bq=torch.zeros(heads, hd, **z), bk=torch.zeros(heads, hd, **z),
            bv=torch.zeros(heads, hd, **z), bo=torch.zeros(e, **z))
        tree[f"layer{i}_ff1"]["bias"] = torch.zeros(f, **z)
        tree[f"layer{i}_ff2"]["bias"] = torch.zeros(e, **z)
    tree["mlm_dense"]["bias"] = torch.zeros(e, **z)
    tree["mlm_decoder"]["bias"] = torch.zeros(v, **z)
    for op in (["emb_ln", "mlm_ln"]
               + [f"layer{i}_ln{j}" for i in range(d["layers"])
                  for j in (1, 2)]):
        tree[op] = {"gamma": torch.ones(e, **z), "beta": torch.zeros(e, **z)}
    return tree


def logits(cfg: dict, w: dict, x: torch.Tensor, precision: str = "f32"):
    """(b, l, V) logits of token ids x (b, l)."""
    d, eps = dims(cfg), cfg["layer_norm_eps"]

    def ln(t, op):
        return layer_norm(t, w[op]["gamma"], w[op]["beta"], eps)

    def fc(t, op):
        return dense(t, w[op]["kernel"], w[op]["bias"], precision)

    t = ln(w["tok_emb"]["weight"][x], "emb_ln")
    for i in range(d["layers"]):
        a = attention(t, w[f"layer{i}_attn"], d["heads"], False, precision)
        t = ln(t + a, f"layer{i}_ln1")
        h = fc(gelu_tanh(fc(t, f"layer{i}_ff1")), f"layer{i}_ff2")
        t = ln(t + h, f"layer{i}_ln2")
    t = ln(gelu_tanh(fc(t, "mlm_dense")), "mlm_ln")
    return fc(t, "mlm_decoder")


def _norms(tree: dict) -> dict:
    return {f"{op}/{k}": float(t.float().norm())
            for op, ws in tree.items() for k, t in ws.items()}


def train_readings(cfg: dict, x, y, steps_per_dispatch: int, device,
                   seed: int, precision: str = "f32",
                   half_batch: bool = False, rows: int = 8) -> dict:
    """Train from the seed's weights on the batches x[i], y[i] (numpy,
    (n, b, l) and (n, b, l, 1)), `steps_per_dispatch` steps a dispatch,
    as many dispatches as x holds whole, `rows` rows of a batch at a time
    (their summed losses over the batch's token count: the same mean).
    Returns each dispatch's mean loss, every leaf's first gradient norm
    (`grad`), the norm of Adam's first moment after the first dispatch
    (`moment`) and of the change over all the steps (`change`).
    half_batch: each step's loss is the mean over the first half of the
    rows alone (a planted fault)."""
    strict_f32()
    opt = cfg["optimizer"]
    b1, b2, eps, lr = opt["beta1"], opt["beta2"], opt["epsilon"], \
        opt["alpha"]
    w = make_weights(cfg, seed, device)
    start = {op: {k: t.clone() for k, t in ws.items()} for op, ws in w.items()}
    leaves = [t.requires_grad_() for ws in w.values() for t in ws.values()]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    out = {"loss": []}
    k = steps_per_dispatch
    step = 0
    for dispatch in range(len(x) // k):
        losses = []
        for j in range(k):
            xb = torch.from_numpy(x[dispatch * k + j]).to(device).long()
            yb = torch.from_numpy(y[dispatch * k + j]).to(device).long()
            if half_batch:
                xb, yb = xb[:len(xb) // 2], yb[:len(yb) // 2]
            n = yb.numel()
            total = 0.0
            for lo in range(0, len(xb), rows):
                z = logits(cfg, w, xb[lo:lo + rows], precision)
                loss = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                                       yb[lo:lo + rows].reshape(-1),
                                       reduction="sum") / n
                loss.backward()
                total += float(loss.detach())
                del z, loss
            losses.append(total)
            step += 1
            with torch.no_grad():
                a_t = lr * math.sqrt(1 - b2 ** step) / (1 - b1 ** step)
                for p, mi, vi in zip(leaves, m, v):
                    g = p.grad
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.sub_(a_t * mi / (vi.sqrt() + eps))
            if step == 1:
                out["grad"] = _norms({op: {k2: t.grad for k2, t in ws.items()}
                                      for op, ws in w.items()})
            for p in leaves:
                p.grad = None
        out["loss"].append(statistics.fmean(losses))
        if dispatch == 0:
            it = iter(m)
            out["moment"] = _norms({op: {k2: next(it) for k2 in ws}
                                    for op, ws in w.items()})
    with torch.no_grad():
        out["change"] = _norms({op: {k2: t - start[op][k2]
                                     for k2, t in ws.items()}
                                for op, ws in w.items()})
    return out
