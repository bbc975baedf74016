"""Operations and bytes that the models and kernels need, counted from
their shapes by the benchmark itself (never from the program's own
counts, which a change to the program may change).

A model's sizes come as `dims`: hidden H, layers L, heads h, FFN width
F, vocabulary V and `head_params`, the matrix parameters of its output
head (reference/<config>.py `dims`). A matrix product of m x k by k x n
is 2mkn operations; biases, norms, activations and the softmax are not
counted, and recomputation is never counted.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def matmul_params(dims: dict) -> int:
    """Parameters that multiply each token: the layers' four attention
    projections and two FFN matrices, and the head."""
    h, f = dims["hidden"], dims["ffn"]
    return dims["layers"] * (4 * h * h + 2 * h * f) + dims["head_params"]


def train_step_flops(dims: dict, batch: int, seq: int) -> float:
    """One training step of an encoder over batch x seq tokens: 6 x the
    matrix parameters a token (forward 2, backward 4), and attention's
    two products over every pair of positions, 12 L b l^2 H (forward 4,
    backward 8), with no recomputation."""
    tokens = batch * seq
    return (6.0 * matmul_params(dims) * tokens
            + 12.0 * dims["layers"] * batch * seq * seq * dims["hidden"])


def forward_flops(dims: dict, offset: int, n: int) -> float:
    """The causal forward of n tokens at positions offset .. offset+n-1,
    each attending to itself and every position before it: 2 x the matrix
    parameters a token, and 4 H a layer for each key a query attends."""
    keys = n * offset + n * (n + 1) // 2
    return (2.0 * matmul_params(dims) * n
            + 4.0 * dims["layers"] * dims["hidden"] * keys)


def attn_bwd_cost(b: int, h: int, l: int, d: int, itemsize: int = 2):
    """(operations, bytes) that attention backward needs at least, with
    no mask: the four products dP = dO V^T, dV = P^T dO, dQ = dS K and
    dK = dS^T Q, 8 b h l^2 d (P itself not recomputed); q, k, v and dO
    read once, lse and delta (f32, one a row and head) read once, dQ, dK
    and dV written once."""
    flops = 8.0 * b * h * l * l * d
    nbytes = 7 * b * l * h * d * itemsize + 2 * b * h * l * 4
    return flops, nbytes


def least_time_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAKS["bf16_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])
