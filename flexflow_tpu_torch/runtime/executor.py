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

Several optimizer steps a dispatch (`build_multi_step`, the JAX
package's jitted `lax.scan` of K steps) run on the card as one CUDA
graph of K captured steps, and on the CPU as K eager steps. Gradient
accumulation (`build_accum_step`) sums the microbatches' gradients in
place and runs one optimizer update on their mean.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
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

    @property
    def device(self) -> torch.device:
        return self.mesh.device if self.mesh is not None \
            else torch.device(self.config.device)

    def device_batch(self, inputs: Dict[str, np.ndarray], label: np.ndarray
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One step's host arrays on this executor's device, each input
        cast there to its declared dtype (a bf16 input arrives as f32:
        numpy has no bf16)."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return self.cast_inputs({k: dev(v) for k, v in inputs.items()}), \
            dev(label)

    def cast_inputs(self, inputs: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Each input in its declared dtype (no copy where it has it)."""
        dtypes = {op.name: op.outputs[0].dtype.torch_dtype
                  for op in self.topo if op.op_type == OpType.INPUT}
        return {k: v.to(dtypes[k]) for k, v in inputs.items()}

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
            optimizer.update(params, grads, opt_state, self.config)
            return mvals

        return train_step

    def build_accum_step(self, optimizer, loss_fn, metrics, final_tensor):
        """(batches, opt_state) -> (summed metric values, k): the gradients
        of k microbatches (an iterable of device (inputs, label)) summed
        in place, divided by k, then one optimizer update (JAX
        `_build_accum_fns`). The metric values are sums over the k
        microbatches; the caller divides (on the host, as JAX does)."""
        gstep = self.build_grad_metrics_step(loss_fn, metrics, final_tensor)
        params = self.parameters()

        def accum_step(batches, opt_state):
            acc, msum, k = None, None, 0
            for inputs, label in batches:
                grads, mvals = gstep(inputs, label)
                k += 1
                with torch.no_grad():
                    if acc is None:
                        # autograd may hand one tensor to two weights (the
                        # gradient of a sum): own each accumulator
                        seen: set = set()
                        acc = {op: {} for op in grads}
                        for op, ws in grads.items():
                            for w, g in ws.items():
                                if g.data_ptr() in seen:
                                    g = g.clone()
                                seen.add(g.data_ptr())
                                acc[op][w] = g
                        msum = dict(mvals)
                        continue
                    for op, ws in grads.items():
                        for w, g in ws.items():
                            acc[op][w].add_(g)
                    msum = {key: msum[key] + mvals[key] for key in msum}
            with torch.no_grad():
                for ws in acc.values():
                    for g in ws.values():
                        g.div_(float(k))
            optimizer.update(params, acc, opt_state, self.config)
            return msum, k

        return accum_step

    def build_multi_step(self, optimizer, loss_fn, metrics, final_tensor,
                         steps: int) -> "MultiStep":
        """K = `steps` training steps a dispatch (JAX `build_multi_step`):
        see MultiStep."""
        if self.mesh is not None and self.device.type == "cuda":
            raise NotImplementedError(
                "steps_per_execution > 1 on a mesh of CUDA ranks is not "
                "ported yet (ROADMAP A8): gloo stages every collective "
                "through host memory, which a CUDA graph cannot capture, "
                "and NCCL capture is untried")
        return MultiStep(self, self.build_train_step(
            optimizer, loss_fn, metrics, final_tensor),
            metrics.keys() + ["loss"], steps)

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


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (an optimizer state)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return []


class MultiStep:
    """K training steps a dispatch. Called with K host batches (a list of
    (inputs, label) numpy arrays), it runs them in order and returns a
    (len(keys), K) f32 tensor on the device: row i is metric keys[i]
    (the compiled metrics, then "loss") of each step. On the card the
    result is queued, not waited for: reading it to the host waits.

    On the CPU the K steps run eagerly, one after another. On the card
    they are one CUDA graph: the steps read their batches from static
    stacked (K, batch, ...) buffers, packed into one byte buffer that a
    dispatch fills by ONE copy from pinned host memory (two pinned
    buffers alternate, each reused after its copy's event), then the
    graph replays. The first dispatch runs its K steps eagerly on a side
    stream (the warm-up that capture needs: cuBLAS workspaces, kernel
    attributes, the autograd engine's streams), then captures the K
    steps; later dispatches replay. A launch counter counts the first
    dispatch's K eager steps and the capture's K, and nothing for a
    replay. A failed capture or replay raises: there is no eager
    fallback on the card. The graph's private memory pool holds one
    step's activations and gradients for the graph's lifetime. A replay
    writes the weights and the optimizer state behind autograd's back, so
    each replay bumps their version counters, as an in-place op would:
    what caches a weight by its version (core/op.py `Op.w`) sees the
    change."""

    _ALIGN = 16

    def __init__(self, executor: Executor, train_step, keys: List[str],
                 steps: int):
        self.executor = executor
        self.train_step = train_step
        self.keys = list(keys)
        self.steps = int(steps)
        self.device = executor.device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.layout = None

    def __call__(self, batches: Sequence[Tuple[Dict[str, np.ndarray],
                                               np.ndarray]], opt_state):
        if len(batches) != self.steps:
            raise ValueError(f"MultiStep of {self.steps} steps given "
                             f"{len(batches)} batches")
        if self.device.type != "cuda":
            out = torch.empty((len(self.keys), self.steps),
                              dtype=torch.float32)
            for j, (inputs, label) in enumerate(batches):
                mvals = self.train_step(
                    *self.executor.device_batch(inputs, label), opt_state)
                for i, k in enumerate(self.keys):
                    out[i, j] = mvals[k]
            return out
        layout = self._layout(batches[0])
        if self.layout is None:
            self._allocate(layout)
        elif layout != self.layout:
            raise ValueError(f"MultiStep: batch layout {layout} differs "
                             f"from the captured {self.layout}")
        self._stage(batches)
        if self.graph is None:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._steps(opt_state)
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._steps(opt_state)
            self.graph = graph
            self.written = [p for ws in self.executor.parameters().values()
                            for p in ws.values()] + _leaves(opt_state)
        else:
            self.graph.replay()
            torch.autograd.graph.increment_version(self.written)
        return self.out.clone()

    # -- the card ---------------------------------------------------------
    def _layout(self, batch):
        inputs, label = batch
        arrays = [*sorted(inputs.items()), ("", label)]
        return tuple((k, tuple(a.shape), np.dtype(a.dtype).str)
                     for k, a in arrays)

    def _allocate(self, layout) -> None:
        """The static byte buffer on the card, two pinned twins, and each
        (K, batch, ...) array's view into them (16-byte aligned)."""
        self.layout = layout
        spans, off = [], 0
        for name, shape, dt in layout:
            nbytes = self.steps * int(np.prod(shape)) * np.dtype(dt).itemsize
            spans.append((name, off, nbytes, shape, np.dtype(dt)))
            off += -(-nbytes // self._ALIGN) * self._ALIGN
        self.static = torch.empty(max(off, 1), dtype=torch.uint8,
                                  device=self.device)
        self.pinned = [torch.empty(max(off, 1), dtype=torch.uint8,
                                   pin_memory=True) for _ in range(2)]
        self.copied = [None, None]
        self.turn = 0
        self.spans = spans
        self.views = {}
        for name, start, nbytes, shape, dt in spans:
            seg = self.static[start:start + nbytes]
            tdt = torch.from_numpy(np.empty(0, dt)).dtype
            self.views[name] = seg.view(tdt).view(self.steps, *shape)
        self.out = torch.zeros((len(self.keys), self.steps),
                               dtype=torch.float32, device=self.device)

    def _stage(self, batches) -> None:
        buf = self.pinned[self.turn]
        if self.copied[self.turn] is not None:
            self.copied[self.turn].synchronize()
        host = buf.numpy()
        for name, start, nbytes, shape, dt in self.spans:
            dst = host[start:start + nbytes].view(dt).reshape(
                self.steps, *shape)
            for j, (inputs, label) in enumerate(batches):
                dst[j] = label if name == "" else inputs[name]
        self.static.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.copied[self.turn] = event
        self.turn ^= 1

    def _steps(self, opt_state) -> None:
        """The K steps from the static buffers, each writing its metrics
        into column j of `out`."""
        label_k = self.views[""]
        inputs_k = {k: v for k, v in self.views.items() if k}
        for j in range(self.steps):
            inputs = self.executor.cast_inputs(
                {k: v[j] for k, v in inputs_k.items()})
            mvals = self.train_step(inputs, label_k[j], opt_state)
            for i, k in enumerate(self.keys):
                self.out[i, j].copy_(mvals[k])
