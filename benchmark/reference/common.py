"""Plain torch pieces the references share: float32 with TF32 off, and,
for the control, the same arithmetic with every matrix product's operands
rounded to fp8. Imports nothing of the port."""
from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def strict_f32() -> None:
    """Float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """x rounded to fp8 with one scale for the tensor (its largest
    magnitude to the format's largest), back in float32."""
    dtype, top = ((torch.float8_e4m3fn, E4M3_MAX) if fmt == "e4m3"
                  else (torch.float8_e5m2, E5M2_MAX))
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b on fp8 operands (e4m3), its gradient on an e5m2 output
    gradient, the usual fp8 training recipe; b of rank 2 is a weight."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g, "e5m2")
        da = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(
                -1, qg.shape[-1])
        else:
            db = qa.transpose(-1, -2) @ qg
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return a @ b
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def layer_norm(x, gamma, beta, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma + beta


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def dense(x, kernel, bias, precision: str):
    y = matmul(x, kernel, precision)
    return y if bias is None else y + bias


def attention(x, w: dict, heads: int, causal: bool, precision: str):
    """Multi-head self-attention of x (b, l, H): projections with biases,
    softmax(q k^T / sqrt(d)) v over each head, the output projection;
    w holds wq, wk, wv (H, h, d), wo (h, d, H), bq, bk, bv (h, d), bo."""
    b, l, e = x.shape
    d = e // heads

    def proj(name):
        y = matmul(x, w["w" + name].reshape(e, e), precision)
        return (y + w["b" + name].reshape(e)).view(b, l, heads, d) \
            .transpose(1, 2)

    q, k, v = proj("q"), proj("k"), proj("v")
    s = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(d)
    if causal:
        mask = torch.ones(l, l, dtype=torch.bool, device=x.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    o = matmul(torch.softmax(s, dim=-1), v, precision)
    o = o.transpose(1, 2).reshape(b, l, e)
    return matmul(o, w["wo"].reshape(e, e), precision) + w["bo"]


def draw(generator, groups, device):
    """Normal draws for groups of leaves, one call a group: each group a
    list of (op, weight, shape, std); returns {op: {weight: tensor}}."""
    tree: dict = {}
    for group in groups:
        sizes = [math.prod(shape) for _, _, shape, _ in group]
        flat = torch.randn(sum(sizes), generator=generator, device=device)
        for (op, name, shape, std), part in zip(
                group, torch.split(flat, sizes)):
            tree.setdefault(op, {})[name] = (part * std).view(shape)
    return tree
