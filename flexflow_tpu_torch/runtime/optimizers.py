"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam
(counterpart of flexflow_tpu/runtime/optimizers.py).

The same update math as the JAX package, through kernels/optimizer.py:
one launch of the fused multi-tensor kernel on the card over every
weight tensor, its plain per-tensor loop on the CPU. The kernel
registry's "optimizer" family decides (kernels/registry.py): auto takes
the kernel on a Hopper card, `kernel_impl="reference"` the loop there
too. The parameters and
the moments are updated IN PLACE (JAX returns new arrays), which is
what lets the port keep one copy of each. State is a dict like the JAX
opt_state — {"step": int32 and "lr": f32 device scalars, and "v" / "m"
trees of op name -> weight name -> tensor} — so one can be carried
across (FFModel.load_opt_state). `step` and `lr` live on the weights'
device and change in place, so a step captured in a CUDA graph reads
the current ones and a schedule changes lr without a new capture.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels import optimizer as _kernel
from ..kernels.registry import KERNELS

Tree = Dict[str, Dict[str, torch.Tensor]]


def _zeros(params: Tree, dtype: Optional[torch.dtype] = None) -> Tree:
    return {op: {w: torch.zeros_like(p, dtype=dtype or p.dtype)
                 for w, p in ws.items()} for op, ws in params.items()}


def _flat(params: Tree, *trees: Tree):
    """The leaves of each tree in the order of `params`."""
    return [[t[op][w] for op, ws in params.items() for w in ws]
            for t in (params, *trees)]


def _scalars(params: Tree, lr: float) -> dict:
    """step (int32) and lr (f32) as 0-dim tensors on the weights' device."""
    device = next((p.device for ws in params.values() for p in ws.values()),
                  torch.device("cpu"))
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "lr": torch.tensor(float(lr), dtype=torch.float32,
                               device=device)}


class Optimizer:
    def init_state(self, params: Tree) -> dict:
        raise NotImplementedError

    def update(self, params: Tree, grads: Tree, state: dict,
               config=None) -> None:
        """Apply one step to `params` and `state`, in place; `config` the
        model's FFConfig, whose `kernel_impl` picks kernel or loop."""
        raise NotImplementedError

    def _fused(self, state: dict, config) -> bool:
        """The registry's choice for the "optimizer" family on the
        weights' device (resolved once, as the ops resolve theirs)."""
        memo = self.__dict__.setdefault("_kernel_memo", {})
        return bool(KERNELS.resolve(memo, "optimizer",
                                    device=state["lr"].device,
                                    config=config))

    def set_lr(self, state: dict, lr: float) -> None:
        """Write a new learning rate into `state["lr"]`, in place: a
        captured step reads it at its next replay (the JAX package carries
        lr as a traced scalar for the same reason)."""
        state["lr"].fill_(float(lr))


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
        state = _scalars(params, self.lr)
        if self.momentum != 0.0:
            state["v"] = _zeros(params)
        return state

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state: dict,
               config=None) -> None:
        if self.momentum != 0.0:
            ws, gs, bufs = _flat(params, grads, state["v"])
        else:
            (ws, gs), bufs = _flat(params, grads), None
        if self._fused(state, config):
            _kernel.sgd(ws, gs, bufs, state["lr"], momentum=self.momentum,
                        nesterov=self.nesterov,
                        weight_decay=self.weight_decay)
        else:
            _kernel.sgd_plain(ws, gs, bufs, state["lr"], self.momentum,
                              self.nesterov, self.weight_decay)
        state["step"].add_(1)


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
        return {**_scalars(params, self.alpha),
                "m": _zeros(params, self.moments_dtype),
                "v": _zeros(params, self.moments_dtype)}

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state: dict,
               config=None) -> None:
        ws, gs, ms, vs = _flat(params, grads, state["m"], state["v"])
        if self._fused(state, config):
            _kernel.adam(ws, gs, ms, vs, state["step"], state["lr"],
                         beta1=self.beta1, beta2=self.beta2,
                         eps=self.epsilon, weight_decay=self.weight_decay)
        else:
            _kernel.adam_plain(ws, gs, ms, vs, state["step"], state["lr"],
                               self.beta1, self.beta2, self.epsilon,
                               self.weight_decay)
        state["step"].add_(1)
