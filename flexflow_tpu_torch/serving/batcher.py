"""Dynamic request batching (counterpart of flexflow_tpu/serving/batcher.py).

Requests enqueue individually; a background thread coalesces whatever is
queued (up to max_batch_size rows exactly, waiting at most max_delay_ms
for stragglers) into one device batch, which an `InferenceModel` pads to
its bucket and runs as one CUDA graph replay on the card. The loop thread
makes the model's card its current device before its first call, so a
bucket it captures lands on the model's device.

On a mesh of ranks (an InferenceModel over a model compiled with
`parallel_axes`) the batcher is leader-driven: requests enter at rank 0,
which forms each batch and, before walking it, broadcasts it over the
world (its bucket, its number of real rows and the stacked inputs); every
other rank runs the follower loop (`follow`, or `start` / `stop` around
it), which walks each broadcast batch with the leader, since a walk on a
mesh is collective, until the leader stops. `submit` on a follower
raises.

`BatcherStopped` is defined here, as in the JAX package, and shared with
the continuous batcher (serving/sched/continuous.py).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np


def _broadcast(obj=None):
    """Rank 0's `obj` on every rank of the world."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class BatcherStopped(RuntimeError):
    """Typed shutdown error: the batcher stopped before this request ran.
    Raised from pending futures on stop() — waiters get a clean signal
    instead of hanging forever. Shared with the continuous batcher
    (serving/sched/continuous.py)."""


class DynamicBatcher:
    def __init__(self, inference_model, max_batch_size: int = 64,
                 max_delay_ms: float = 2.0):
        self.model = inference_model
        self.max_batch_size = max_batch_size
        self.max_delay = max_delay_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: threading.Thread = None
        self._running = False
        self._stopped = False  # stop() was called; submits fail fast
        # on a mesh: whether this rank leads (rank 0), and the batches a
        # follower walked
        self.mesh = getattr(getattr(inference_model, "model", None),
                            "mesh", None)
        self.leader = True
        self.followed = 0
        if self.mesh is not None:
            import torch.distributed as dist

            world = dist.get_world_size()
            if self.mesh.view.num_devices != world:
                raise ValueError(
                    f"a DynamicBatcher on a mesh broadcasts each batch over "
                    f"the world: the mesh holds {self.mesh.view.num_devices}"
                    f" of its {world} ranks")
            self.leader = dist.get_rank() == 0

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._running:
            return
        self._running = True
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop if self.leader else self.follow, daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the loop, then DRAIN: every request still queued fails
        with BatcherStopped instead of hanging its waiter. Later submits
        fail fast with the same error (nothing consumes the queue any
        more) until a start() revives the batcher. On a mesh the leader's
        loop tells the followers to stop as it ends; a follower's stop
        waits for that."""
        self._running = False
        self._stopped = True
        if self._thread is not None:
            if not self.leader:
                self._thread.join()
                self._thread = None
                return
            self._queue.put(None)  # wake the loop
            # a walk on a mesh is collective and host-staged: it may take
            # longer than one device's
            self._thread.join(timeout=5.0 if self.mesh is None else 600.0)
            self._thread = None
        err = BatcherStopped("batcher stopped before running this request")
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(err)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- client API ----------------------------------------------------
    def submit(self, inputs: Dict[str, np.ndarray]) -> Future:
        """inputs: one request (leading dim = that request's batch, usually
        1). Returns a Future resolving to the output rows for this request.

        Malformed requests (wrong input names, wrong trailing shape,
        inconsistent leading dims) fail HERE — only the offending future,
        never the batch they would have been coalesced into. On a mesh
        only the leader (rank 0) takes requests."""
        if not self.leader:
            raise RuntimeError(
                "DynamicBatcher.submit on a follower rank: on a mesh "
                "requests enter at rank 0, whose batches every other rank "
                "walks (follow)")
        fut: Future = Future()
        try:
            if self._stopped:
                raise BatcherStopped(
                    "batcher stopped; submit after stop() would hang")
            self._validate(inputs)
        except Exception as e:
            fut.set_exception(e)
            return fut
        self._queue.put((inputs, fut))
        if self._stopped and not fut.done():
            # raced with a concurrent stop() whose drain already ran: the
            # loop is gone, so resolve the future here (the item left in
            # the queue is inert; drain double-checks done())
            fut.set_exception(BatcherStopped(
                "batcher stopped; submit after stop() would hang"))
        return fut

    def infer(self, inputs: Dict[str, np.ndarray], timeout=None) -> np.ndarray:
        return self.submit(inputs).result(timeout)

    def _validate(self, inputs: Dict[str, np.ndarray]) -> None:
        names = self.model.input_names
        missing = [n for n in names if n not in inputs]
        if missing:
            raise KeyError(f"missing inputs {missing}; expected {names}")
        extra = [n for n in inputs if n not in names]
        if extra:
            raise KeyError(f"unknown inputs {extra}; expected {names}")
        specs = getattr(self.model, "input_specs", None) or {}
        rows: Optional[int] = None
        for n in names:
            arr = np.asarray(inputs[n])
            if arr.ndim < 1 or arr.shape[0] < 1:
                raise ValueError(
                    f"input {n!r}: need a non-empty leading batch dim,"
                    f" got shape {arr.shape}")
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ValueError(
                    f"input {n!r} has {arr.shape[0]} rows but another"
                    f" input has {rows}: one request, one batch")
            want = specs.get(n)
            if want is not None and tuple(arr.shape[1:]) != tuple(want):
                raise ValueError(
                    f"input {n!r}: trailing shape {tuple(arr.shape[1:])}"
                    f" does not match the model's {tuple(want)}")

    # -- batching loop -------------------------------------------------
    def _use_device(self):
        device = getattr(self.model, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            torch.cuda.set_device(device)

    def follow(self) -> int:
        """A follower's loop: walk each batch the leader broadcasts until
        the leader stops; returns the number of batches walked."""
        self._use_device()
        while True:
            msg = _broadcast()
            if msg is None:
                return self.followed
            if self.model._bucket_for(msg["rows"]) != msg["bucket"]:
                raise RuntimeError(
                    f"the leader's bucket {msg['bucket']} for "
                    f"{msg['rows']} rows is not this rank's")
            self.model.predict(msg["inputs"])
            self.followed += 1

    def _loop(self):
        self._use_device()
        try:
            self._batches()
        finally:
            if self.mesh is not None:
                _broadcast(None)  # the followers stop

    def _batches(self):
        carry = None  # popped but over-budget for the previous batch
        while self._running:
            if carry is not None:
                item, carry = carry, None
            else:
                item = self._queue.get()
            if item is None:
                continue
            batch: List = [item]
            rows = next(iter(item[0].values())).shape[0]
            deadline = _now() + self.max_delay
            while rows < self.max_batch_size:
                remaining = deadline - _now()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    continue
                n = next(iter(nxt[0].values())).shape[0]
                if rows + n > self.max_batch_size:
                    # coalescing is capped EXACTLY: the overflow request
                    # leads the next batch instead of blowing past the
                    # compiled batch dimension
                    carry = nxt
                    break
                batch.append(nxt)
                rows += n
            self._run_batch(batch)
        if carry is not None and not carry[1].done():
            carry[1].set_exception(
                BatcherStopped("batcher stopped before running this request"))

    def _run_batch(self, batch):
        names = self.model.input_names
        counts = [next(iter(req.values())).shape[0] for req, _ in batch]
        try:
            merged = {
                name: np.concatenate([np.asarray(req[name]) for req, _ in batch])
                for name in names
            }
            if self.mesh is not None:
                rows = sum(counts)
                _broadcast({"bucket": self.model._bucket_for(rows),
                            "rows": rows, "inputs": merged})
            out = self.model.predict(merged)
            lo = 0
            for (_, fut), n in zip(batch, counts):
                fut.set_result(out[lo:lo + n])
                lo += n
        except Exception as e:  # propagate to every waiter
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def _now() -> float:
    import time

    return time.monotonic()
