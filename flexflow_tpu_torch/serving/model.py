"""Compile-once inference executor with batch buckets (counterpart of
flexflow_tpu/serving/model.py).

The JAX `InferenceModel` jits one forward a static batch bucket and pads
every request up to the nearest bucket, so each server-side shape is
compiled once. Here each bucket is one `runtime/graphs.py CapturedCall`
over the model's inference walk (`FFModel._infer_fn`, the walk `predict`
runs: batch norm reads its running statistics, dropout is off, no op
state is written):

 - inputs: one static device buffer an input, (bucket, *dims) in the
   input's staging dtype (`DataType.host_np_dtype`: int32 tokens, f32
   pixels), filled by one copy a call from two pinned buffers used in
   turn (`Staging`); the pad rows are zeros, as JAX's `np.pad`;
 - output: one static f32 device buffer that the walk's final tensor is
   widened into inside the graph, copied to pinned host memory once a
   call;
 - on the card the first call of a bucket runs the walk eagerly, then
   captures it; later calls replay it. A failed capture or replay
   raises: there is no eager fallback. All of a model's buckets share
   one graph memory pool, and a lock serialises staging, replay and
   read-back (a DynamicBatcher thread and a direct `predict` caller may
   race);
 - a bucket re-captures when the weights' versions change
   (`load_params`, a checkpoint restore in place, `fit`), and every
   bucket is dropped when the model's executor or its inference walk is
   rebuilt (`fold_batchnorm`, `invalidate_compiled_steps`): a graph
   captured before a graph rewrite never replays after it;
 - on the CPU each call runs the walk eagerly.

On a mesh of ranks `predict` is collective: every rank calls it with the
same rows (serving/batcher.py's leader-driven DynamicBatcher does that
for requests that arrive on rank 0), and each bucket walks eagerly as
`FFModel.predict` does on a mesh, each rank its part of the `data` axis,
every rank returning the whole output. On CUDA ranks that walk runs on
the card uncaptured: gloo stages every collective through host memory,
which a CUDA graph cannot capture (runtime/distributed.py
`graph_capture`, which also keeps `fit(steps_per_execution=K)` eager
there). `counts` shows the eager walks and no capture, and `stats()`
carries the reason.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..runtime.distributed import graph_capture
from ..runtime.graphs import (CapturedCall, Staging, graph_counts,
                              model_weights, new_pool)


class _Bucket:
    """The static buffers and the captured walk of one batch bucket."""

    def __init__(self, model, dev: torch.device, bucket: int, pool,
                 counts: Dict[str, int]):
        self.bucket = bucket
        self.staging: Dict[str, Staging] = {}
        self.views: Dict[str, torch.Tensor] = {}
        for op in model.input_ops:
            dims = tuple(op.outputs[0].dims[1:])
            host_dt = np.dtype(op.outputs[0].dtype.host_np_dtype)
            tdt = torch.from_numpy(np.empty(0, host_dt)).dtype
            st = Staging(bucket * int(np.prod(dims, dtype=np.int64)), dev,
                         tdt)
            self.staging[op.name] = st
            self.views[op.name] = st.buf.view(bucket, *dims)
        out_dims = (bucket,) + tuple(model.final_tensor.dims[1:])
        self.out = torch.zeros(out_dims, dtype=torch.float32, device=dev)
        self.host_out = (torch.empty(out_dims, dtype=torch.float32,
                                     pin_memory=True)
                         if dev.type == "cuda" else None)
        ex, infer = model.executor, model._infer_fn
        views, out = self.views, self.out

        def walk() -> None:
            out.copy_(infer(ex.cast_inputs(views)))

        self.call = CapturedCall(walk, dev, model_weights(model), counts,
                                 pool)

    def run(self, arrays: Dict[str, np.ndarray], rows: int) -> np.ndarray:
        for name, st in self.staging.items():
            host = st.host().reshape(self.views[name].shape)
            host[:rows] = arrays[name]
            host[rows:] = 0
            st.send()
        self.call()
        if self.host_out is None:
            return self.out[:rows].numpy().copy()
        self.host_out.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.out.device).synchronize()
        return self.host_out[:rows].numpy().copy()


class InferenceModel:
    """Wraps a compiled FFModel for serving.

    The model must already be compiled (any comp_mode); serving always runs
    the inference-mode walk (dropout off, batchnorm in eval mode).
    `counts`: the buckets' warm-ups, captures, replays and eager walks
    (runtime/graphs.py `graph_counts`); on a mesh each bucket call is
    one eager walk (see the module docstring)."""

    def __init__(self, model, batch_buckets: Sequence[int] = (1, 4, 16, 64)):
        if model.executor is None:
            raise RuntimeError(model.outside_mesh
                               or "InferenceModel needs a compiled model")
        self.model = model
        self.capture, self.capture_reason = graph_capture(model.device,
                                                          model.mesh)
        # the card with its index (`cuda` alone names the current one):
        # the threads that call the buckets make it theirs
        self.device = model.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.buckets = sorted(set(int(b) for b in batch_buckets))
        self.counts = graph_counts()
        self._lock = threading.Lock()
        # the walk the buckets were captured over (executor, inference
        # function), their pool, and bucket -> _Bucket
        self._walk = None
        self._pool = None
        self._fns: Dict[int, _Bucket] = {}

    def stats(self) -> Dict[str, object]:
        """The buckets' dispatch counts, whether a bucket is a captured
        CUDA graph, and why not."""
        return {"graphs": dict(self.counts), "graph_capture": self.capture,
                "reason": self.capture_reason}

    @property
    def input_names(self) -> List[str]:
        return [op.name for op in self.model.input_ops]

    @property
    def input_specs(self) -> Dict[str, tuple]:
        """name -> trailing (per-row) dims of each input, the shape
        contract DynamicBatcher.submit validates requests against so one
        malformed request cannot fail a whole coalesced batch."""
        return {op.name: tuple(op.outputs[0].dims[1:])
                for op in self.model.input_ops}

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _forward_fn(self, bucket: int) -> _Bucket:
        """The bucket's buffers and walk over the model's current
        executor: all buckets are dropped (and a new pool taken) when the
        executor or its inference walk was rebuilt since their capture."""
        ex, infer = self.model.executor, self.model._infer_fn
        if self._walk is None or self._walk[0] is not ex \
                or self._walk[1] is not infer:
            self._fns = {}
            self._walk = (ex, infer)
            self._pool = new_pool(self.device)
        fn = self._fns.get(bucket)
        if fn is None:
            fn = self._fns[bucket] = _Bucket(self.model, self.device, bucket,
                                             self._pool, self.counts)
        return fn

    def _run(self, bucket: int, arrays: Dict[str, np.ndarray],
             rows: int) -> np.ndarray:
        model = self.model
        if model.mesh is not None:
            # every rank walks its `data` part eagerly and gathers, as
            # predict does on a mesh
            padded = [np.concatenate([a, np.zeros((bucket - rows,)
                                                  + a.shape[1:], a.dtype)])
                      for a in (arrays[n] for n in self.input_names)]
            with self._lock:
                out = model.predict(padded, batch_size=bucket)[:rows]
                self.counts["eager_walks"] += 1
            return out
        dev = self.device
        with self._lock, torch.no_grad(), (
                torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext()):
            return self._forward_fn(bucket).run(arrays, rows)

    def predict(self, inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """inputs: name -> array whose leading dim is the request batch.
        Returns the final tensor's values (f32) for the un-padded batch;
        a batch over the largest bucket is chunked."""
        names = self.input_names
        missing = [n for n in names if n not in inputs]
        if missing:
            raise KeyError(f"missing inputs {missing}; expected {names}")
        n = next(iter(inputs.values())).shape[0]
        bucket = self._bucket_for(n)
        chunks = []
        for lo in range(0, n, bucket):
            hi = min(lo + bucket, n)
            chunks.append(self._run(
                bucket, {name: np.asarray(inputs[name])[lo:hi]
                         for name in names}, hi - lo))
        return np.concatenate(chunks, axis=0)
