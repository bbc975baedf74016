"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam
(counterpart of flexflow_tpu/runtime/optimizers.py).

The same update math as the JAX package, written as plain tensor updates
under `torch.no_grad()` rather than `torch.optim`: the parameters and the
moments are updated IN PLACE (JAX returns new arrays), which is what lets
the port keep one copy of each. State is a dict like the JAX opt_state —
{"step", "lr", and "v" / "m" trees of op name -> weight name -> tensor} —
so one can be carried across (FFModel.load_opt_state).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def _zeros(params: Tree, dtype: Optional[torch.dtype] = None) -> Tree:
    return {op: {w: torch.zeros_like(p, dtype=dtype or p.dtype)
                 for w, p in ws.items()} for op, ws in params.items()}


def _leaves(*trees: Tree):
    for op, ws in trees[0].items():
        for w in ws:
            yield op, w, tuple(t[op][w] for t in trees)


class Optimizer:
    def init_state(self, params: Tree) -> dict:
        raise NotImplementedError

    def update(self, params: Tree, grads: Tree, state: dict) -> None:
        """Apply one step to `params` and `state`, in place."""
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    """v = momentum * v + g (+ weight_decay * w); w -= lr * v, or with
    nesterov w -= lr * (g + momentum * v)."""

    def __init__(self, model=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params: Tree) -> dict:
        state = {"step": 0, "lr": float(self.lr)}
        if self.momentum != 0.0:
            state["v"] = _zeros(params)
        return state

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state: dict) -> None:
        mom, wd, lr = self.momentum, self.weight_decay, state["lr"]
        if mom == 0.0:
            for _, _, (w, g) in _leaves(params, grads):
                w.sub_(lr * (g + wd * w if wd else g))
        else:
            for _, _, (w, g, v) in _leaves(params, grads, state["v"]):
                gt = g + wd * w if wd else g
                v.mul_(mom).add_(gt)
                w.sub_(lr * (gt + mom * v if self.nesterov else v))
        state["step"] += 1


class AdamOptimizer(Optimizer):
    """The reference's Adam: alpha_t = alpha * sqrt(1 - beta2^t) /
    (1 - beta1^t), w -= alpha_t * m / (sqrt(v) + eps) — eps added to
    sqrt(v) itself, not to the bias-corrected sqrt(v) of torch.optim.Adam.
    The update math runs in f32; with `moments_dtype` (torch.bfloat16)
    only the stored m and v round."""

    def __init__(self, model=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8,
                 moments_dtype: Optional[torch.dtype] = None):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon
        self.moments_dtype = moments_dtype

    def init_state(self, params: Tree) -> dict:
        return {"step": 0, "lr": float(self.alpha),
                "m": _zeros(params, self.moments_dtype),
                "v": _zeros(params, self.moments_dtype)}

    def alpha_t(self, alpha: float, step: int) -> float:
        """alpha * sqrt(1 - b2^t) / (1 - b1^t) in f32, as the JAX package
        computes it from its f32 step count."""
        f = np.float32
        t = f(step)
        return float(f(alpha) * np.sqrt(f(1.0) - f(self.beta2) ** t)
                     / (f(1.0) - f(self.beta1) ** t))

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state: dict) -> None:
        b1, b2, wd, eps = self.beta1, self.beta2, self.weight_decay, \
            self.epsilon
        step = state["step"] + 1
        a_t = self.alpha_t(state["lr"], step)
        for _, _, (w, g, m, v) in _leaves(params, grads, state["m"],
                                          state["v"]):
            g32 = g.float()
            if wd:
                g32 = g32 + wd * w.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32 * g32
            w.copy_(w.float() - a_t * m32 / (torch.sqrt(v32) + eps))
            m.copy_(m32)
            v.copy_(v32)
        state["step"] = step
