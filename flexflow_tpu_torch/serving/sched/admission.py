"""Admission control for continuous-batching serving (a copy of
flexflow_tpu/serving/sched/admission.py; its metric families, the queue
gauge `ff_serving_queue_depth{pool}` and the rejection counter
`ff_serving_rejections_total{reason}`, go to the process-wide registry
unless one is passed).

The contract: a request is either rejected AT SUBMIT with a typed error
or it is guaranteed to finish.
 - STATIC: prompt + max_new_tokens must fit one slot's cache span, and,
   only when prefill is one-shot (`window` set), the prompt must fit the
   prefill window (`RequestTooLarge`, HTTP 400). Because the pool is
   slot-dense, an admitted request that reaches a slot owns every page it
   can ever need, so `extend()` cannot fail mid-decode.
 - DYNAMIC: backpressure. The wait queue is bounded by request count
   (`max_queue`, `QueueFull`) and by the pages admitted-but-unscheduled
   requests reserve (`queue_pages_budget`, default two pool turnovers,
   `PoolSaturated`). Both are HTTP 429: retry with backoff.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .kvpool import PagedKVPool


class AdmissionError(RuntimeError):
    """Base of all admission rejections; http_status is what a server
    replies with."""

    http_status = 429
    reason = "rejected"


class QueueFull(AdmissionError):
    reason = "queue_full"

    def __init__(self, depth: int, limit: int):
        super().__init__(
            f"admission queue full ({depth}/{limit} waiting); retry later")


class PoolSaturated(AdmissionError):
    reason = "pool_saturated"

    def __init__(self, need: int, backlog: int, budget: int):
        super().__init__(
            f"KV pool saturated: request needs {need} pages but queued"
            f" requests already reserve {backlog}/{budget} backlog pages;"
            " retry later")


class RequestTooLarge(AdmissionError):
    http_status = 400
    reason = "too_large"


class AdmissionController:
    """Bounded queue + page budget over one PagedKVPool. `admit()` is the
    single gate; `on_scheduled()` moves a request's pages out of the
    backlog when it gets a slot; `release()` clears a request that leaves.
    All three are idempotent per request id."""

    def __init__(self, pool: PagedKVPool, window: Optional[int],
                 max_queue: int = 64,
                 queue_pages_budget: Optional[int] = None,
                 registry=None):
        self.pool = pool
        # None = no prefill-window cap (chunked prefill)
        self.window = None if window is None else int(window)
        self.max_queue = int(max_queue)
        self.queue_pages_budget = int(
            2 * pool.total_pages if queue_pages_budget is None
            else queue_pages_budget)
        self._lock = threading.Lock()
        self._queued_pages: Dict[object, int] = {}  # req id -> pages
        self._admit_times: Dict[object, float] = {}
        # this controller's rejections by reason (`stats()`); the counter
        # family below sums every controller of its registry
        self.rejections: Dict[str, int] = {}
        if registry is None:
            from ...obs.registry import REGISTRY as registry  # noqa: N813
        # the queue gauge carries the pool's label: two controllers in one
        # process must not clobber each other's series
        self._pool_label = pool.label
        self._g_queue = registry.gauge(
            "ff_serving_queue_depth",
            "Admitted requests waiting for a decode slot",
            labels=("pool",))
        self._g_queue.set(0, pool=self._pool_label)
        self._c_rejected = registry.counter(
            "ff_serving_rejections_total",
            "Requests rejected at admission by reason", labels=("reason",))

    def _reject(self, err: AdmissionError) -> AdmissionError:
        self.rejections[err.reason] = self.rejections.get(err.reason, 0) + 1
        self._c_rejected.inc(reason=err.reason)
        return err

    def admit(self, req_id, prompt_len: int, max_new_tokens: int,
              shared_pages: int = 0) -> None:
        """Admit or raise. On success the request's worst-case pages count
        against the backlog budget until `on_scheduled`. shared_pages:
        prefix pages the pool's cache is expected to install rather than
        prefill (a probe at submit), credited against the backlog budget,
        never against the static per-slot capacity check."""
        prompt_len = int(prompt_len)
        max_new_tokens = int(max_new_tokens)
        if prompt_len < 1:
            raise self._reject(RequestTooLarge("empty prompt"))
        if self.window is not None and prompt_len > self.window:
            raise self._reject(RequestTooLarge(
                f"prompt length {prompt_len} exceeds the prefill window"
                f" ({self.window})"))
        worst = prompt_len + max(0, max_new_tokens)
        if worst > self.pool.max_len:
            raise self._reject(RequestTooLarge(
                f"prompt ({prompt_len}) + max_new_tokens"
                f" ({max_new_tokens}) = {worst} exceeds the cache capacity"
                f" ({self.pool.max_len})"))
        need = max(1, self.pool.pages_for(worst) - max(0, int(shared_pages)))
        with self._lock:
            depth = len(self._queued_pages)
            if depth >= self.max_queue:
                raise self._reject(QueueFull(depth, self.max_queue))
            backlog = sum(self._queued_pages.values())
            if backlog + need > self.queue_pages_budget:
                raise self._reject(PoolSaturated(need, backlog,
                                                 self.queue_pages_budget))
            self._queued_pages[req_id] = need
            self._admit_times[req_id] = time.monotonic()
            self._g_queue.set(len(self._queued_pages), pool=self._pool_label)

    def on_scheduled(self, req_id) -> float:
        """The scheduler moved the request into a slot. Returns its queue
        wait in seconds."""
        with self._lock:
            self._queued_pages.pop(req_id, None)
            t = self._admit_times.pop(req_id, None)
            self._g_queue.set(len(self._queued_pages), pool=self._pool_label)
            return 0.0 if t is None else time.monotonic() - t

    def release(self, req_id) -> None:
        """Clear a request that left without being scheduled."""
        with self._lock:
            self._queued_pages.pop(req_id, None)
            self._admit_times.pop(req_id, None)
            self._g_queue.set(len(self._queued_pages), pool=self._pool_label)

    def backlog_pages(self) -> int:
        with self._lock:
            return sum(self._queued_pages.values())

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queued_pages)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "queue_depth": len(self._queued_pages),
                "max_queue": self.max_queue,
                "backlog_pages": sum(self._queued_pages.values()),
                "queue_pages_budget": self.queue_pages_budget,
                "pages_total": self.pool.total_pages,
                "rejections": dict(self.rejections),
            }
