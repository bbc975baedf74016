"""Executor: walks the graph eagerly on one torch device (counterpart of
flexflow_tpu/runtime/executor.py `forward_values` and the step builders).

The JAX executor traces the walk into one jitted program; here each op
runs as it is reached. Every op output is cast to its boundary storage
dtype (`emit_dtype`: bf16 under mixed precision), exactly where the JAX
executor casts. Inference runs under `torch.no_grad()`; training runs the
same walk under autograd, and its step functions update the parameters
in place. Parameters stay f32, so their gradients arrive in f32, as
`jax.value_and_grad` gives them.

On a mesh (core/machine.py) each process walks the graph on its slice of
the batch with its shards of the weights; the ops restore replicated
activations themselves (runtime/collectives.py). After the backward, the
gradients and the reported metrics are averaged over the `data` axis, so
every rank's optimizer sees the gradient of the global batch's loss, as
`jax.grad` under GSPMD gives it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.graph import Graph
from ..core.op import LoweringContext
from ..ffconst import CompMode, OpType
from ..ops.common import emit_dtype
from .collectives import mean_

Tree = Dict[str, Dict[str, torch.Tensor]]


class Executor:
    def __init__(self, graph: Graph, config, mesh=None):
        self.graph = graph
        self.config = config
        self.mesh = mesh
        self.topo = graph.topo_order()

    def parameters(self) -> Tree:
        """op name -> weight name -> the op's parameter (the master)."""
        return {op.name: {ws.name: op._parameters[ws.name]
                          for ws in op.specs}
                for op in self.topo if op.specs}

    def forward_values(
        self,
        input_values: Dict[str, torch.Tensor],
        state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        decode_pos=None,
        mode: CompMode = CompMode.COMP_MODE_INFERENCE,
    ) -> Dict[int, torch.Tensor]:
        """Returns tensor guid -> value. state: op name -> {var: tensor},
        e.g. each attention op's "k_cache"/"v_cache", updated in place.
        decode_pos: an int chunk offset or a (B,) int32 tensor of per-row
        positions (ops/attention.py). COMP_MODE_TRAINING records the walk
        for autograd and takes no caches."""
        training = mode == CompMode.COMP_MODE_TRAINING
        if training and (state or decode_pos is not None):
            raise ValueError("a training walk takes no KV caches and no "
                             "decode position")
        ctx = LoweringContext(self.config, mode)
        ctx.mesh = self.mesh
        ctx.decode_pos = decode_pos
        ctx.state = state if state is not None else {}
        with torch.set_grad_enabled(training):
            for op in self.topo:
                if op.op_type == OpType.INPUT:
                    ctx.values[op.outputs[0].guid] = input_values[op.name]
                    continue
                outs = op.lower(ctx, [ctx.values[t.guid] for t in op.inputs])
                for t, v in zip(op.outputs, outs):
                    ctx.values[t.guid] = v.to(emit_dtype(self.config,
                                                         t.dtype))
        return ctx.values

    # -- step builders -----------------------------------------------------
    def build_grad_metrics_step(self, loss_fn, metrics, final_tensor):
        """(inputs, label) -> (grads, metric values incl. loss): one
        training-mode walk, the loss, and its backward. Gradients are
        returned as a tree like the parameters' (zeros where a weight got
        none, as jax.grad gives); on a mesh with a `data` axis, gradients
        and metrics are the means over it."""
        params = self.parameters()
        flat = [(op, w, p) for op, ws in params.items()
                for w, p in ws.items()]

        def gstep(inputs, label):
            values = self.forward_values(inputs,
                                         mode=CompMode.COMP_MODE_TRAINING)
            pred = values[final_tensor.guid]
            loss = loss_fn(pred, label)
            with torch.no_grad():
                mvals = metrics.compute(pred, label) if metrics else {}
            got = torch.autograd.grad(loss, [p for _, _, p in flat],
                                      allow_unused=True)
            grads: Tree = {op: {} for op in params}
            for (op, w, p), g in zip(flat, got):
                grads[op][w] = torch.zeros_like(p) if g is None else g
            mvals["loss"] = loss.detach()
            self._data_mean([grads[op][w] for op, w, _ in flat], mvals)
            return grads, mvals

        return gstep

    def _data_mean(self, grads, mvals) -> None:
        """Average gradients (one bucket) and metric values over the mesh's
        `data` axis, in place; nothing without one."""
        size = self.mesh.size("data") if self.mesh is not None else 1
        if size == 1:
            return
        group = self.mesh.group("data")
        with torch.no_grad():
            mean_(grads, group, size)
            keys = sorted(mvals)
            vals = torch.stack([mvals[k].float() for k in keys])
            mean_([vals], group, size)
        mvals.update(zip(keys, vals.unbind()))

    def build_train_step(self, optimizer, loss_fn, metrics, final_tensor):
        """(inputs, label, opt_state) -> metric values: forward, loss,
        backward, then the optimizer's in-place update of the parameters
        and of `opt_state`."""
        gstep = self.build_grad_metrics_step(loss_fn, metrics, final_tensor)
        params = self.parameters()

        def train_step(inputs, label, opt_state):
            grads, mvals = gstep(inputs, label)
            optimizer.update(params, grads, opt_state)
            return mvals

        return train_step

    def build_eval_step(self, loss_fn, metrics, final_tensor):
        """(inputs, label) -> (metric values incl. loss, pred), inference
        mode, no gradients."""

        def eval_step(inputs, label):
            values = self.forward_values(inputs)
            pred = values[final_tensor.guid]
            with torch.no_grad():
                mvals = metrics.compute(pred, label) if metrics else {}
                mvals["loss"] = loss_fn(pred, label)
            self._data_mean([], mvals)
            return mvals, pred

        return eval_step
