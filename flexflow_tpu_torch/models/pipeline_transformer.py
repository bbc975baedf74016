"""Pipeline-parallel transformer: GPipe over a `stage` mesh axis
(counterpart of flexflow_tpu/models/pipeline_transformer.py).

Homogeneous encoder stages, each a block of identical post-LN layers,
hold their slice of a stacked parameter tree: every leaf is (stages,
layers_per_stage, ...), and a rank of the `stage` axis keeps its stage's
(1, layers_per_stage, ...) slice (`stage_slice`). kernels/pipeline.py
streams the microbatches between the stages. The math is the JAX
module's: q/k/v einsums, f32 logits and softmax, the probabilities cast
to the activations' dtype, the tanh GELU, LayerNorm eps 1e-5.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def _layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    """One post-LN encoder layer on (B, L, D): self-attention + FFN."""
    d = x.shape[-1]
    q = torch.einsum("ble,ehd->blhd", x, p["wq"])
    k = torch.einsum("ble,ehd->blhd", x, p["wk"])
    v = torch.einsum("ble,ehd->blhd", x, p["wv"])
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
        x.shape[0], x.shape[1], d)
    x = _ln(x + torch.einsum("bqe,ef->bqf", ctx, p["wo"]), p["g1"], p["b1"])
    hdn = F.gelu(torch.einsum("ble,ef->blf", x, p["w1"]), approximate="tanh")
    return _ln(x + torch.einsum("blf,fe->ble", hdn, p["w2"]), p["g2"],
               p["b2"])


def _stage_fn(stage_params: Params, x: torch.Tensor) -> torch.Tensor:
    """This stage's layers (leading dim = layers per stage), in order."""
    for i in range(next(iter(stage_params.values())).shape[0]):
        x = _layer({k: v[i] for k, v in stage_params.items()}, x)
    return x


def init_pipeline_params(generator: torch.Generator, n_layers: int,
                         hidden: int, heads: int, ffn_mult: int = 4,
                         stages: int = 1, dtype=torch.float32,
                         device="cpu") -> Params:
    """Parameters stacked (stages, layers_per_stage, ...), drawn on the
    host from `generator` (normal / sqrt(fan_in) for the projections, ones
    and zeros for the norms, in the JAX module's order)."""
    assert n_layers % stages == 0, (n_layers, stages)
    hd = hidden // heads
    shapes = {
        "wq": (hidden, heads, hd), "wk": (hidden, heads, hd),
        "wv": (hidden, heads, hd), "wo": (hidden, hidden),
        "w1": (hidden, ffn_mult * hidden), "w2": (ffn_mult * hidden, hidden),
        "g1": (hidden,), "b1": (hidden,), "g2": (hidden,), "b2": (hidden,),
    }
    params = {}
    for name, shp in shapes.items():
        full = (stages, n_layers // stages) + shp
        if name.startswith("g"):
            val = torch.ones(full, dtype=dtype)
        elif name.startswith("b"):
            val = torch.zeros(full, dtype=dtype)
        else:
            val = torch.randn(full, generator=generator, dtype=dtype) \
                / math.sqrt(shp[0])
        params[name] = val.to(device)
    return params


def stage_slice(params: Params, mesh, axis_name: str = "stage") -> Params:
    """This rank's (1, layers_per_stage, ...) slice of stacked `params`,
    as trainable leaves of their own."""
    i = mesh.index(axis_name)
    return {k: v[i:i + 1].detach().clone().requires_grad_(True)
            for k, v in params.items()}


def pipeline_forward(params: Params, x: torch.Tensor, mesh,
                     microbatches: int = 4,
                     axis_name: str = "stage") -> torch.Tensor:
    """GPipe forward over the mesh's stage axis. x: (B, L, hidden);
    params: this rank's slice (`stage_slice`)."""
    from ..kernels.pipeline import gpipe

    local = {k: v[0] for k, v in params.items()}
    return gpipe(lambda xm: _stage_fn(local, xm), x, mesh, axis_name,
                 microbatches)


def sequential_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Reference: the whole stacked params applied stage by stage on one
    device."""
    stages = next(iter(params.values())).shape[0]
    for s in range(stages):
        x = _stage_fn({k: v[s] for k, v in params.items()}, x)
    return x


def make_train_step(mesh, microbatches: int = 4, lr: float = 1e-3):
    """An SGD train step over embedding + pipelined encoder + LM head:
    step(params, emb, head, tokens, labels) -> (params, emb, head, loss),
    `params` this rank's stage slice, emb and head replicated; the loss
    is the same on every rank. `mesh` None runs the encoder sequentially
    (params whole)."""

    def train_step(params: Params, emb: torch.Tensor, head: torch.Tensor,
                   tokens: torch.Tensor, labels: torch.Tensor,
                   mesh_: Optional[object] = mesh):
        leaves = [emb, head] + list(params.values())
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        emb_, head_ = leaves[0], leaves[1]
        p = dict(zip(params, leaves[2:]))
        x = emb_[tokens.long()]
        x = (pipeline_forward(p, x, mesh_, microbatches) if mesh_ is not None
             else sequential_forward(p, x))
        logits = torch.einsum("ble,ev->blv", x, head_)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, labels.long()[..., None]).mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            new = [t - lr * g for t, g in zip(leaves, grads)]
        return (dict(zip(params, new[2:])), new[0], new[1],
                loss.detach())

    return train_step
