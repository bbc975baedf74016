"""Dispatches as CUDA graphs (the port's counterpart of the JAX package's
jitted functions: the batcher's `decode_all` and `prefill_chunk`, the
session's `lax.scan` of K decode steps, and training's K steps a dispatch,
runtime/executor.py `MultiStep`).

A `CapturedCall` wraps a function of no arguments that reads its inputs
from static device buffers and writes its results into static device
buffers in place (the caches, the tokens, the probabilities). On the card
its first call runs the function eagerly on a side stream (the warm-up
that capture needs: cuBLAS workspaces, the kernels' shared-memory
attributes, the weights' cached bf16 casts), then captures it into a CUDA
graph; later calls replay the graph. Capture runs in the calling thread
only (`capture_error_mode="thread_local"`), so other threads may use the
card meanwhile, and one capture at a time in the process (`_CAPTURE_LOCK`:
the replicas of a fleet capture on their own scheduler threads). It
begins and ends the capture itself, on the warm-up's side stream:
`torch.cuda.graph`'s entry synchronizes the whole device first, which the
card refuses while another thread captures. Inside the lock it empties
the device and pinned-host caching allocators as that entry does (a pool
whose graphs were all dropped must be released before a capture reuses
its handle). A failed capture or replay raises: there is no eager
fallback on the card. The graph reads the weights (and their cached
casts, `core/op.py Op.w`) at the addresses it was captured with, so each
call compares the weights' version counters with those of the capture and
captures again when any changed (`load_params`, `fit`); a graph that
writes the weights itself watches none. A graph that draws random
numbers registers its generators (`torch.cuda.CUDAGraph.
register_generator_state`): each replay then reads the generator's
offset and advances it by the capture's draws, so replays draw new
numbers, those an eager call from the same state would draw. The
garbage collector is off while any capture runs (a graph freed while
another is captured breaks the capture): `gc_paused` keeps a
process-wide count of captures in flight, so with several threads
capturing at once (the replicas of a fleet on one card) the first to
enter turns the collector off and the last to leave restores it. On the
CPU every call runs the function
eagerly, and so does a call made with `capture=False` (a mesh of CUDA
ranks: runtime/distributed.py `graph_capture` says why), counted as an
eager walk.

`Staging` fills one static device buffer from host memory by one copy a
dispatch, through two pinned buffers used in turn (each rewritten only
after its last copy finished).

Launch counters count the wrappers called by the warm-up and by the
capture; a replay runs no Python and counts nothing, so `graph_counts()`
keeps warm-ups, captures and replays, and the walks run eagerly outside
any graph.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def graph_counts() -> Dict[str, int]:
    """A fresh counter of warm-ups, captures, replays and eager walks."""
    return {"warmups": 0, "captures": 0, "replays": 0, "eager_walks": 0}


# one capture at a time in the process (see the module docstring)
_CAPTURE_LOCK = threading.Lock()
# captures in flight in this process, and whether the collector was on
# when the first of them entered (`gc_paused`)
_GC_LOCK = threading.Lock()
_GC_HOLDERS = 0
_GC_WAS_ENABLED = False


@contextlib.contextmanager
def gc_paused():
    """No garbage collection inside the block, whichever threads hold it
    at once: the first holder turns the collector off (only if it was
    on), the last to leave restores it."""
    global _GC_HOLDERS, _GC_WAS_ENABLED
    with _GC_LOCK:
        if _GC_HOLDERS == 0:
            _GC_WAS_ENABLED = gc.isenabled()
            gc.disable()
        _GC_HOLDERS += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HOLDERS -= 1
            if _GC_HOLDERS == 0 and _GC_WAS_ENABLED:
                gc.enable()


class CapturedCall:
    """fn() as a CUDA graph on the card (see the module docstring), fn()
    itself on the CPU. `weights`: the parameters whose versions decide a
    re-capture; `pool`: a graph memory pool shared with the caller's other
    graphs, which must replay one at a time on one stream; `generators`:
    the CUDA generators fn draws from; `capture=False`: every call runs fn
    eagerly on the card too."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 weights: List[torch.Tensor], counts: Dict[str, int],
                 pool=None, generators: Sequence[torch.Generator] = (),
                 capture: bool = True):
        self.fn = fn
        self.capture = capture
        self.generators = list(generators)
        self.device = device
        self.weights = weights
        self.counts = counts
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.versions: Optional[List[int]] = None

    def __call__(self) -> None:
        if self.device.type != "cuda" or not self.capture:
            self.fn()
            self.counts["eager_walks"] += 1
            return
        versions = [p._version for p in self.weights]
        if self.graph is not None and versions == self.versions:
            self.graph.replay()
            self.counts["replays"] += 1
            return
        self.graph = None
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn()
        cur.wait_stream(side)
        self.counts["warmups"] += 1
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        # a dead graph freed during the capture (a model dropped in a
        # reference cycle, collected when fn allocates) would destroy its
        # executable while this thread captures, which invalidates the
        # capture: no collection runs inside it
        with _CAPTURE_LOCK, gc_paused(), torch.cuda.stream(side):
            torch.cuda.empty_cache()
            if hasattr(torch._C, "_host_emptyCache"):
                torch._C._host_emptyCache()
            graph.capture_begin(*(() if self.pool is None else (self.pool,)),
                                capture_error_mode="thread_local")
            try:
                self.fn()
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        self.graph = graph
        self.versions = versions
        self.counts["captures"] += 1


class Staging:
    """One static buffer of n `dtype` elements on `device`, filled from
    host memory by one copy a call (see the module docstring): fill
    `host()`, then `send()`; or `put(array)`. On the CPU `host()` is the
    buffer itself."""

    def __init__(self, n: int, device: torch.device,
                 dtype: torch.dtype = torch.int32):
        self.device = device
        self.buf = torch.zeros(n, dtype=dtype, device=device)
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.pinned = [torch.empty(n, dtype=dtype, pin_memory=True)
                           for _ in range(2)]
            self.copied: List[Optional[torch.cuda.Event]] = [None, None]
            self.turn = 0

    def host(self) -> np.ndarray:
        """The host array the next `send()` copies (waits until its
        pinned buffer's last copy finished)."""
        if not self.cuda:
            return self.buf.numpy()
        event = self.copied[self.turn]
        if event is not None:
            event.synchronize()
        return self.pinned[self.turn].numpy()

    def send(self) -> None:
        if not self.cuda:
            return
        self.buf.copy_(self.pinned[self.turn], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.copied[self.turn] = event
        self.turn ^= 1

    def put(self, host: np.ndarray) -> None:
        self.host()[:] = host
        self.send()


def model_weights(model) -> List[torch.Tensor]:
    """Every parameter of the model's executor, in a fixed order."""
    return [p for ws in model.executor.parameters().values()
            for p in ws.values()]


def new_pool(device: torch.device):
    """A graph memory pool on the card (None on the CPU)."""
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None
