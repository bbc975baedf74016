"""Span tracer: nestable wall-clock spans with Chrome-trace-event export
and request-scoped tracing (a copy of flexflow_tpu/obs/tracing.py, which
imports no jax, kept here because the port imports nothing of the JAX
package).

The runtime is instrumented with `with tracer.span("name"):` blocks at
its phase boundaries: compile and its step build, the executor's
dispatches (`traced_dispatch`), checkpoint save and restore
(runtime/durability.py), and the continuous batcher's request handling
(serving/sched/continuous.py). The contract that keeps this free to
leave in hot loops:

 - DISABLED (the default): `span()` is one attribute check returning a
   shared no-op context manager: no allocation, no clock read, no lock.
 - ENABLED: each span costs two monotonic clock reads plus one append
   under a lock; the buffer is a ring (`max_events`) so a long run cannot
   grow memory without bound. Ring overflow is COUNTED (`dropped_events`,
   mirrored onto `ff_trace_events_dropped_total` and stamped into the
   exported trace metadata) so a truncated timeline is never mistaken for
   a complete one.

A span reads the host clock only: it queues nothing on the card and
waits for nothing, so a span opened or closed while a CUDA graph is
being captured leaves the capture as it would be without it.

Request-scoped tracing: a `TraceContext` (trace_id / span_id /
parent_id) rides a contextvar. While a context is current, every span
becomes a CHILD of it: the span allocates its own span_id, records
trace_id/span_id/parent_id in its args, and re-parents the contextvar
for its duration. Thread crossings are EXPLICIT: the sending side
captures `tracer.handoff(name)` (which emits a Chrome flow-start "s"
event so Perfetto draws the arrow) and the receiving thread runs its
work under `with tracer.resume(handoff):` (flow-finish "f" on first
resume, context restored on every resume). Both return no-ops when
tracing is disabled or no context is current.

Export is the Chrome trace-event JSON format (complete "X" events with
`name`/`ph`/`ts`/`dur`/`pid`/`tid`, flow "s"/"f" events for handoffs),
loadable in Perfetto / chrome://tracing. `ts` is microseconds from
tracer start; the wall-clock epoch captured at the same instant is
exported as trace metadata. Spans on one thread nest by construction,
so parent events always contain their children.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional


class _NullSpan:
    """The disabled-path context manager: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):  # matches _Span.set; still a no-op
        return self


_NULL_SPAN = _NullSpan()


# -- request context -------------------------------------------------------
class TraceContext:
    """One request's position in its trace: which trace it belongs to
    (`trace_id`), the id of the span currently open for it (`span_id`),
    and that span's parent (`parent_id`, None at the root). Immutable —
    spans and handoffs derive CHILD contexts instead of mutating."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def __repr__(self):
        return (f"TraceContext(trace_id={self.trace_id!r},"
                f" span_id={self.span_id!r}, parent_id={self.parent_id!r})")


_CTX: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("ff_trace_context", default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def current_context() -> Optional[TraceContext]:
    """The TraceContext current on this thread/task, or None."""
    return _CTX.get()


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


class _CtxScope:
    """`with use_context(ctx):` — install a TraceContext on the current
    thread, restore the previous one on exit."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self):
        self._token = _CTX.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _CTX.reset(self._token)
        return False


def use_context(ctx: Optional[TraceContext]) -> _CtxScope:
    """Run a block under `ctx` (None clears the context — e.g. scheduler
    work not attributable to any request)."""
    return _CtxScope(ctx)


def root_context(trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None) -> TraceContext:
    """A fresh root context: new trace unless `trace_id` is given (the
    server passes the id from an incoming `traceparent` header, with the
    caller's span as `parent_id`)."""
    return TraceContext(trace_id or new_trace_id(), _new_span_id(),
                        parent_id)


class Handoff:
    """An explicit thread-crossing token: the captured TraceContext plus
    the Chrome flow id binding the sending span to the receiving one.
    Created by `Tracer.handoff()`, consumed by `Tracer.resume()` —
    resumable any number of times (the flow-finish event is emitted once)."""

    __slots__ = ("ctx", "flow_id", "name", "_consumed")

    def __init__(self, ctx: TraceContext, flow_id: int, name: str):
        self.ctx = ctx
        self.flow_id = flow_id
        self.name = name
        self._consumed = False

    @property
    def trace_id(self) -> str:
        return self.ctx.trace_id


class _Resume:
    """`with tracer.resume(handoff):` — restore the handed-off context on
    the receiving thread; first resume emits the flow-finish event."""

    __slots__ = ("_tracer", "_handoff", "_token")

    def __init__(self, tracer: "Tracer", handoff: Handoff):
        self._tracer = tracer
        self._handoff = handoff

    def __enter__(self):
        h = self._handoff
        self._token = _CTX.set(h.ctx)
        if not h._consumed:
            h._consumed = True
            self._tracer._emit_flow("f", h)
        return h.ctx

    def __exit__(self, *exc):
        _CTX.reset(self._token)
        return False


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_ctx", "_token")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any],
                 parent: Optional[TraceContext]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._ctx = parent.child() if parent is not None else None

    def set(self, **args) -> "_Span":
        """Attach/override args mid-span (e.g. a result count discovered
        while the span is open)."""
        self.args.update(args)
        return self

    def __enter__(self):
        self._token = _CTX.set(self._ctx) if self._ctx is not None else None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._token is not None:
            _CTX.reset(self._token)
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        ctx = self._ctx
        if ctx is not None:
            self.args["trace_id"] = ctx.trace_id
            self.args["span_id"] = ctx.span_id
            if ctx.parent_id is not None:
                self.args["parent_id"] = ctx.parent_id
        self._tracer._emit(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """A span buffer. One process-wide instance (`get_tracer()`) backs the
    whole runtime; independent Tracers exist for tests."""

    def __init__(self, enabled: bool = False, max_events: int = 200_000):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        # wall <-> perf_counter epoch pair, captured back-to-back: `ts`
        # microseconds are relative to _epoch_ns, and _epoch_wall_s is
        # the SAME instant on the wall clock — the alignment anchor the
        # timeline CLI uses to merge wall-clocked streams (EventLog,
        # metric snapshots) onto the trace axis
        self._epoch_wall_s = time.time()
        self._epoch_ns = time.perf_counter_ns()
        # per-thread-LIFETIME track ids. Keyed through threading.local —
        # NOT threading.get_ident(), which the interpreter recycles the
        # moment a thread dies: a respawned replica's scheduler would
        # inherit the dead one's ident, fold both incarnations onto one
        # track, and rename the victim's spans after the fact.
        self._tid_local = threading.local()
        self._next_tid = itertools.count(1)
        self._thread_names: Dict[int, str] = {}
        self._dropped = 0
        self._flow_ids = itertools.count(1)

    # -- recording --------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing a block. Near-zero cost when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args, _CTX.get())

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (Chrome "i" event) — e.g. the moment a
        topology loss is detected, before recovery spans open."""
        if not self.enabled:
            return
        ctx = _CTX.get()
        if ctx is not None:
            args.setdefault("trace_id", ctx.trace_id)
        now = time.perf_counter_ns()
        self._append({
            "name": name, "ph": "i", "s": "t",
            "ts": (now - self._epoch_ns) / 1e3,
            "pid": os.getpid(), "tid": self._tid(),
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    # -- request context / thread handoff ---------------------------------
    def handoff(self, name: str = "handoff") -> Optional[Handoff]:
        """Capture the current TraceContext for an explicit thread
        crossing, emitting the Chrome flow-start ("s") event so Perfetto
        draws the arrow from here to the receiving thread's resume().
        Returns None (a no-op token) when disabled or there is no
        current context."""
        if not self.enabled:
            return None
        ctx = _CTX.get()
        if ctx is None:
            return None
        h = Handoff(ctx, next(self._flow_ids), name)
        self._emit_flow("s", h)
        return h

    def resume(self, handoff: Optional[Handoff]):
        """Run a block on the receiving thread under the handed-off
        context (no-op for a None token)."""
        if handoff is None or not self.enabled:
            return _NULL_SPAN
        return _Resume(self, handoff)

    def _emit_flow(self, ph: str, h: Handoff) -> None:
        now = time.perf_counter_ns()
        ev = {
            "name": h.name, "ph": ph, "cat": "handoff",
            "id": h.flow_id,
            "ts": (now - self._epoch_ns) / 1e3,
            "pid": os.getpid(), "tid": self._tid(),
            "args": {"trace_id": h.ctx.trace_id},
        }
        if ph == "f":
            ev["bp"] = "e"  # bind the arrow to the enclosing slice
        self._append(ev)

    def set_thread_name(self, name: str) -> None:
        """Label the CURRENT thread's track in the exported trace (Chrome
        `thread_name` metadata) — e.g. a replica's scheduler thread, so
        the merged timeline shows one track per replica. Cheap and valid
        before `enable()`."""
        self._thread_names[self._tid()] = str(name)

    def _tid(self) -> int:
        # Chrome trace tids render best small and stable per thread;
        # threading.local dies with its thread, so a tid is never reused
        tid = getattr(self._tid_local, "tid", None)
        if tid is None:
            tid = self._tid_local.tid = next(self._next_tid)
        return tid

    def _emit(self, name: str, t0_ns: int, t1_ns: int,
              args: Dict[str, Any]) -> None:
        self._append({
            "name": name, "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": os.getpid(), "tid": self._tid(),
            "args": {k: _jsonable(v) for k, v in args.items()},
        })

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    # -- control ----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    # -- export -----------------------------------------------------------
    @property
    def dropped_events(self) -> int:
        """Ring-buffer overflow count since the last clear() — also
        mirrored onto `ff_trace_events_dropped_total` at export."""
        with self._lock:
            return self._dropped

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        return evs

    def span_names(self) -> List[str]:
        return sorted({e["name"] for e in self.events()})

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event container Perfetto loads. Prepends
        process/thread names plus a `trace_metadata` record carrying the
        wall<->perf_counter epoch pair and the ring-drop count."""
        dropped = self.dropped_events
        self._sync_dropped_metric(dropped)
        pid = os.getpid()
        meta = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "flexflow_tpu_torch"},
        }, {
            "name": "trace_metadata", "ph": "M", "pid": pid, "tid": 0,
            "args": {"epoch_wall_s": self._epoch_wall_s,
                     "dropped_events": dropped},
        }]
        for tid, tname in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def _sync_dropped_metric(self, dropped: int) -> None:
        if dropped <= 0:
            return
        from .registry import REGISTRY

        REGISTRY.counter(
            "ff_trace_events_dropped_total",
            "Trace events dropped by the tracer's ring buffer"
            " (a nonzero value means exported timelines are truncated)"
        ).set_total(dropped)

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


# -- the process-wide tracer ----------------------------------------------
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enable_tracing() -> Tracer:
    _TRACER.enable()
    return _TRACER


def disable_tracing() -> None:
    _TRACER.disable()


def span(name: str, **args):
    """Module-level convenience over the process tracer. Hot loops should
    hoist `tr = get_tracer()` and call `tr.span` directly."""
    return _TRACER.span(name, **args)


def traced_dispatch(fn, name: str):
    """Wrap a step function so each host-side dispatch becomes a span.
    On the card the span covers the host call: the kernels (or a graph
    replay) queued, not their completion, as a JAX dispatch's span covers
    its asynchronous dispatch; a step that reads a result back to the
    host waits inside it. Disabled tracing is one attribute check per
    call."""
    tr = _TRACER

    def wrapper(*a, **k):
        if not tr.enabled:
            return fn(*a, **k)
        with tr.span(name):
            return fn(*a, **k)

    wrapper.__wrapped__ = fn
    wrapper.__name__ = getattr(fn, "__name__", name)
    return wrapper
