"""Admission control for continuous-batching serving (a copy of
flexflow_tpu/serving/sched/admission.py without the metrics registry,
which comes with the observability slice, ROADMAP A9).

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
                 queue_pages_budget: Optional[int] = None):
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
        self.rejections: Dict[str, int] = {}

    def _reject(self, err: AdmissionError) -> AdmissionError:
        self.rejections[err.reason] = self.rejections.get(err.reason, 0) + 1
        return err

    def admit(self, req_id, prompt_len: int, max_new_tokens: int) -> None:
        """Admit or raise. On success the request's worst-case pages count
        against the backlog budget until `on_scheduled`."""
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
        need = self.pool.pages_for(worst)
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

    def on_scheduled(self, req_id) -> float:
        """The scheduler moved the request into a slot. Returns its queue
        wait in seconds."""
        with self._lock:
            self._queued_pages.pop(req_id, None)
            t = self._admit_times.pop(req_id, None)
            return 0.0 if t is None else time.monotonic() - t

    def release(self, req_id) -> None:
        """Clear a request that left without being scheduled."""
        with self._lock:
            self._queued_pages.pop(req_id, None)
            self._admit_times.pop(req_id, None)

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
