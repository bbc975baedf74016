"""Multi-model inference server (counterpart of
flexflow_tpu/serving/server.py).

The Triton server role: a registry of named models with per-model
batching policy, plus an optional stdlib HTTP JSON endpoint (POST
/v2/models/<name>/infer with {"inputs": {name: nested lists}}) mirroring
the KServe-style API Triton speaks. No external web framework; serving
stays dependency-free.

Serving modes per name: `register` (an InferenceModel behind a
DynamicBatcher: one CUDA graph per batch bucket on the card),
`register_generative` (a lockstep GenerativeSession) and
`register_continuous` (a ContinuousBatcher), each answering over HTTP
with typed 429 / 400 / 404 bodies. `/metrics` renders this server's
per-model families and the process-wide registry, which carries the
serving (`ff_serving_*`, `ff_kvpool_*`), durability (`ff_checkpoint_*`),
training-watchdog (`ff_watchdog_*`) and plan-analysis
(`ff_plan_diagnostics_total`) families; `stats()` carries the analysis'
per-code counts under `_analysis`, as JAX's does.

`register_fleet` puts a fleet Router (serving/fleet/) behind a name:
`/generate`, plain and NDJSON, routes through it; `/metrics` is ONE
exposition over this server's registry, the process-wide one, the
router's `ff_fleet_*` families and every replica's registry under a
`replica` label (obs/registry.py `render_labeled`); `/healthz`
aggregates the replicas' health ("degraded" while one drains, is lost
or failed to load, "down" with none ready). The model repository
(repository.py) registers its entries through these calls and notes an
entry it could not load with `record_load_failure`
(`ff_model_load_failures_total`).
"""
from __future__ import annotations

import json
import re
import threading
import time
import uuid
from typing import Dict, Optional

import numpy as np

from ..obs.registry import REGISTRY, MetricsRegistry
from ..obs.tracing import get_tracer, root_context, use_context
from .batcher import DynamicBatcher
from .model import InferenceModel

# W3C trace-context inbound header: 00-<trace_id:32 hex>-<span_id:16
# hex>-<flags:2 hex> — the span_id becomes the server root span's parent
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def _request_scope(headers):
    """(TraceContext | None, request_id) for one HTTP request: an inbound
    `traceparent` header CONTINUES the caller's trace (its ids are echoed
    back and every span lands under them); otherwise a fresh trace root
    is minted while tracing is enabled. The request id — taken from
    `X-Request-Id` or minted — is always present, so rejection bodies
    and streaming trailers can name the request even with tracing off."""
    rid = (headers.get("X-Request-Id") or "").strip() or uuid.uuid4().hex[:16]
    m = _TRACEPARENT_RE.match(
        (headers.get("traceparent") or "").strip().lower())
    if m:
        return root_context(trace_id=m.group(1), parent_id=m.group(2)), rid
    if get_tracer().enabled:
        return root_context(), rid
    return None, rid


def _format_traceparent(ctx) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


class ModelMetrics:
    """Per-model request metrics (the Triton metrics-endpoint role):
    request/failure counts and latency aggregates, exported as JSON stats
    and — via the server's MetricsRegistry (obs/registry.py) — as
    `ff_inference_requests_total` / `ff_inference_failures_total` /
    `ff_inference_latency_ms` series on /metrics. The class keeps its
    pre-registry `record()`/`stats()` API; it is now a thin per-model
    view over the registry families plus a max-latency aggregate the
    exposition format has no primitive for."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 model: str = ""):
        self.model = model
        reg = registry if registry is not None else MetricsRegistry()
        (self._requests, self._failures, self._avg,
         self._latency) = _inference_families(reg)
        self.max_ms = 0.0
        self._lock = threading.Lock()
        # a fresh ModelMetrics starts from zero even when the name was
        # served before (register() after unregister(), or a repository
        # reload): pre-registry behavior, and stats() must not mix two
        # lifetimes (old requests with a reset max_ms). Zero-valued
        # request/failure/avg series are then re-seeded so a freshly
        # registered, idle model still renders on /metrics (dashboards
        # join on series existence) — also pre-registry behavior.
        self.remove_series()
        self._requests.inc(0, model=model)
        self._failures.inc(0, model=model)
        self._avg.set(0.0, model=model)

    @property
    def requests(self) -> int:
        return int(self._requests.value(model=self.model))

    @property
    def failures(self) -> int:
        return int(self._failures.value(model=self.model))

    def record(self, ms: float, ok: bool) -> None:
        self._requests.inc(model=self.model)
        if not ok:
            self._failures.inc(model=self.model)
        else:
            self._latency.observe(ms, model=self.model)
            with self._lock:
                self.max_ms = max(self.max_ms, ms)

    def stats(self) -> Dict[str, float]:
        # the three families lock independently, so a concurrent record()
        # can land between reads. Read failures BEFORE requests: done can
        # then only over-count by an in-flight success whose latency sum
        # is still pending — the avg skews transiently low instead of a
        # success being mis-bucketed as a failure (done = 0 with recorded
        # latency). max(done, 0) guards the remaining race.
        failures = self.failures
        requests = self.requests
        done = max(0, requests - failures)
        total_ms = self._latency.sum(model=self.model)
        return {
            "requests": requests,
            "failures": failures,
            "avg_latency_ms": round(total_ms / done, 3) if done else 0.0,
            "max_latency_ms": round(self.max_ms, 3),
        }

    def remove_series(self) -> None:
        """Drop this model's series from the registry (unregister, or a
        fresh registration under the same name) so stale values neither
        render on /metrics nor seed the next incarnation's stats."""
        for fam in (self._requests, self._failures, self._avg,
                    self._latency):
            fam.remove(model=self.model)
        with self._lock:
            self.max_ms = 0.0


def _inference_families(reg: MetricsRegistry):
    """The per-server inference metric families, registered eagerly so
    /metrics always carries their TYPE headers (pre-registry behavior)."""
    return (
        reg.counter("ff_inference_requests_total",
                    "Inference requests", labels=("model",)),
        reg.counter("ff_inference_failures_total",
                    "Failed inference requests", labels=("model",)),
        reg.gauge("ff_inference_avg_latency_ms",
                  "Mean successful-request latency", labels=("model",)),
        reg.histogram("ff_inference_latency_ms",
                      "Successful-request latency distribution",
                      labels=("model",)),
    )


class InferenceServer:
    def __init__(self):
        self._models: Dict[str, DynamicBatcher] = {}
        self._metrics: Dict[str, ModelMetrics] = {}
        self._start_time = time.time()
        # per-server metric registry: per-model series live here (two
        # servers in one process must not cross-pollute each other's
        # request counts); process-wide families (ff_checkpoint_*,
        # ff_watchdog_*, the serving batchers') render from the default
        # registry — prometheus_text() concatenates both through the one
        # shared exposition renderer
        self.registry = MetricsRegistry()
        _inference_families(self.registry)
        self._load_failures_counter = self.registry.counter(
            "ff_model_load_failures_total",
            "Repository scans that failed to load a model",
            labels=("model",))
        # name -> (GenerativeSession, lock, policy dict): sessions
        # serialize on their device state chain (one request at a time per
        # session); the policy dict holds the registration-time decode
        # knobs (tokens_per_dispatch/temperature/top_k)
        self._generative: Dict[str, tuple] = {}
        # name -> ContinuousBatcher (serving/sched/): iteration-level
        # scheduling over the paged KV pool — requests from many clients
        # interleave in one decode batch instead of serializing on a lock
        self._continuous: Dict[str, object] = {}
        # name -> fleet Router (serving/fleet/): N replicas behind
        # prefix-affine routing and SLO admission
        self._fleets: Dict[str, object] = {}
        # elastic runtime event log (elastic/events.py), exported on
        # /metrics when attached
        self._elastic_events = None
        # models a repository scan failed to load: name -> latest error
        # string (serving keeps running on the models that DID load); the
        # cumulative per-model failure counts live on the registry family
        self._load_failures: Dict[str, str] = {}

    def record_load_failure(self, name: str, error: BaseException) -> None:
        """Note a model the repository could not load; surfaced in stats()
        under "_load_failures" and on /metrics. Counts accumulate across
        repeated scans so rate()-style alerting keeps firing while the
        entry stays broken."""
        self._load_failures[name] = f"{type(error).__name__}: {error}"
        self._load_failures_counter.inc(model=name)

    def attach_elastic_events(self, events) -> None:
        """Surface an elastic EventLog's per-kind counters on the metrics
        endpoint (ff_elastic_events_total{kind=...}) and in stats()."""
        self._elastic_events = events

    def register(self, name: str, model, max_batch_size: int = 64,
                 max_delay_ms: float = 2.0,
                 batch_buckets=(1, 4, 16, 64)) -> None:
        """model: a compiled FFModel."""
        im = InferenceModel(model, batch_buckets=batch_buckets)
        batcher = DynamicBatcher(im, max_batch_size=max_batch_size,
                                 max_delay_ms=max_delay_ms)
        batcher.start()
        self._models[name] = batcher
        self._metrics[name] = ModelMetrics(self.registry, name)

    def _metrics_for(self, name: str) -> ModelMetrics:
        """Existing ModelMetrics for `name`, or a fresh one — constructed
        LAZILY: ModelMetrics.__init__ zeroes the model's series, so an
        eagerly-built setdefault default would wipe live counters on
        every call."""
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = ModelMetrics(self.registry, name)
        return m

    def unregister(self, name: str) -> None:
        b = self._models.pop(name, None)
        self._generative.pop(name, None)
        cb = self._continuous.pop(name, None)
        fleet = self._fleets.pop(name, None)
        m = self._metrics.pop(name, None)
        if m is not None:
            m.remove_series()
        if b:
            b.stop()
        if cb is not None:
            cb.stop()
        if fleet is not None:
            fleet.shutdown()

    def models(self):
        return sorted(self._models)

    def infer(self, name: str, inputs: Dict[str, np.ndarray],
              timeout: Optional[float] = None) -> np.ndarray:
        batcher = self._models.get(name)
        if batcher is None:
            raise KeyError(f"model {name!r} not registered; have {self.models()}")
        # captured up front: a concurrent unregister() must not turn a
        # completed request into a KeyError at record time
        metrics = self._metrics.get(name)
        t0 = time.perf_counter()
        try:
            with get_tracer().span("serve.infer", model=name):
                out = batcher.infer(inputs, timeout=timeout)
        except Exception:
            if metrics is not None:
                metrics.record(0.0, ok=False)
            raise
        if metrics is not None:
            metrics.record((time.perf_counter() - t0) * 1e3, ok=True)
        return out

    def register_generative(self, name: str, session,
                            tokens_per_dispatch: int = 8,
                            temperature: float = 0.0,
                            top_k: Optional[int] = None) -> None:
        """Register a GenerativeSession for POST
        /v2/models/<name>/generate (the incremental-decoding half of the
        reference's Triton prototype). The session's model has a fixed
        batch size; prompts must match it. tokens_per_dispatch,
        temperature, and top_k are SERVER-side policy — each distinct
        combination captures its own CUDA graph of decode steps, so
        letting clients choose them would be a capture-DoS surface.
        Per-request `seed` is free (it is an operand, not a cache key)."""
        # validate policy HERE: a bad registration must fail at server
        # setup, not surface per-request (where a policy ValueError would
        # be misreported as a client 400)
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k={top_k}: must be >= 1")
        if float(temperature) < 0.0:
            raise ValueError(f"temperature={temperature}: must be >= 0")
        if name in self._continuous or name in self._fleets:
            raise ValueError(
                f"{name!r} already has a continuous batcher or fleet;"
                " pick one serving mode per name")
        self._generative[name] = (
            session, threading.Lock(),
            {"tokens_per_dispatch": max(1, int(tokens_per_dispatch)),
             "temperature": float(temperature), "top_k": top_k})
        self._metrics_for(name)

    def register_continuous(self, name: str, batcher,
                            start: bool = True) -> None:
        """Register a ContinuousBatcher (serving/sched/continuous.py) for
        POST /v2/models/<name>/generate: requests stream through the
        iteration-level scheduler instead of serializing on a per-session
        lock, and AdmissionError rejections surface as HTTP 429/400
        backpressure. Prompts from many clients that share a system-prompt
        prefix are prefilled once (the batcher's prefix cache installs
        cached KV by device copy; streaming responses report `cache_hit`
        and `prefix_tokens` in the done trailer), and long prompts are
        chunk-prefilled without stalling other clients' decodes. The
        batcher's decode policy (temperature/top_k) is fixed at
        construction — same capture-DoS rule as register_generative."""
        if name in self._generative or name in self._fleets:
            raise ValueError(
                f"{name!r} already has a lockstep generative session or"
                " fleet; pick one serving mode per name")
        old = self._continuous.get(name)
        if old is not None and old is not batcher:
            # re-registration (model reload): the old scheduler thread and
            # its KV-cache device arrays must not leak
            old.stop()
        self._continuous[name] = batcher
        if start:
            batcher.start()
        self._metrics_for(name)

    def register_fleet(self, name: str, router) -> None:
        """Register a fleet Router (serving/fleet/) for POST
        /v2/models/<name>/generate: requests route across its replicas
        with its SLO admission, AdmissionError rejections (SLOExceeded
        too) answer as typed HTTP backpressure, /metrics merges every
        replica's registry under a `replica` label beside the router's
        ff_fleet_* families, and /healthz aggregates the replicas'.
        The router's replica load failures count in
        ff_model_load_failures_total as "<name>/<replica>"."""
        if name in self._generative or name in self._continuous:
            raise ValueError(
                f"{name!r} already has a serving mode; pick one per name")
        old = self._fleets.get(name)
        if old is not None and old is not router:
            old.shutdown()
        router.on_load_failure = (
            lambda rep, exc, _name=name:
            self.record_load_failure(f"{_name}/{rep}", exc))
        self._fleets[name] = router
        self._metrics_for(name)

    def generate(self, name: str, prompt_ids: np.ndarray,
                 max_new_tokens: int, eos_id: Optional[int] = None,
                 seed: int = 0):
        if name in self._fleets:
            return self._generate_fleet(
                name, prompt_ids, max_new_tokens, eos_id=eos_id, seed=seed)
        if name in self._continuous:
            return self._generate_continuous(
                name, prompt_ids, max_new_tokens, eos_id=eos_id, seed=seed)
        if name not in self._generative:
            raise KeyError(f"no generative session {name!r}")
        session, lock, policy = self._generative[name]
        metrics = self._metrics_for(name)
        t0 = time.perf_counter()
        ok = False
        try:
            with lock, get_tracer().span("serve.generate", model=name):
                # partial batches are handled by the session itself
                # (padding by tiling; rows decode independently); its
                # ValueErrors describe malformed client prompts
                out = session.generate(
                    np.asarray(prompt_ids), max_new_tokens, eos_id=eos_id,
                    seed=seed, **policy)
            ok = True
            return out
        finally:
            metrics.record((time.perf_counter() - t0) * 1e3, ok)

    def _generate_continuous(self, name: str, prompt_ids, max_new_tokens,
                             eos_id=None, seed: int = 0):
        """Fan an (n, L) prompt array out as n independent requests and
        gather their token lists (ragged when eos fires at different
        steps). Admission is ALL-OR-NOTHING per HTTP request: if row k is
        rejected, rows 0..k-1 are cancelled (best-effort — rows a slot
        already picked up run to completion and are discarded) and the
        AdmissionError propagates for the 429/400 mapping, so a retrying
        client does not leave orphaned work compounding the overload."""
        batcher = self._continuous[name]
        metrics = self._metrics_for(name)
        prompts = _prompt_rows(prompt_ids)
        t0 = time.perf_counter()
        ok = False
        try:
            with get_tracer().span("serve.generate", model=name,
                                   requests=len(prompts)):
                reqs = []
                try:
                    for row in prompts:
                        reqs.append(batcher.submit(
                            row, max_new_tokens, eos_id=eos_id, seed=seed))
                except Exception:
                    for r in reqs:
                        batcher.cancel(r)
                    raise
                out = [r.result(timeout=600.0).tolist() for r in reqs]
            ok = True
            return out
        finally:
            metrics.record((time.perf_counter() - t0) * 1e3, ok)

    def _generate_fleet(self, name: str, prompt_ids, max_new_tokens,
                        eos_id=None, seed: int = 0):
        """The continuous fan-out contract over a fleet Router: ragged
        rows become independent routed requests, admission all or nothing
        per HTTP request (a rejected row cancels its accepted siblings
        before the error propagates)."""
        router = self._fleets[name]
        metrics = self._metrics_for(name)
        prompts = _prompt_rows(prompt_ids)
        t0 = time.perf_counter()
        ok = False
        try:
            with get_tracer().span("serve.generate", model=name,
                                   requests=len(prompts)):
                reqs = []
                try:
                    for row in prompts:
                        reqs.append(router.submit(
                            row, max_new_tokens, eos_id=eos_id, seed=seed))
                except Exception:
                    for r in reqs:
                        router.cancel(r)
                    raise
                out = [r.result(timeout=600.0).tolist() for r in reqs]
            ok = True
            return out
        finally:
            metrics.record((time.perf_counter() - t0) * 1e3, ok)

    def generate_stream(self, name: str, prompt_ids, max_new_tokens,
                        eos_id=None, seed: int = 0):
        """Submit ONE prompt to a continuous batcher (or fleet router)
        and return the request handle — its .stream() yields tokens as
        the scheduler emits them (the HTTP endpoint's "stream": true
        path)."""
        if name in self._fleets:
            return self._fleets[name].submit(
                np.asarray(prompt_ids, np.int32), max_new_tokens,
                eos_id=eos_id, seed=seed)
        if name not in self._continuous:
            raise KeyError(f"no continuous batcher {name!r}")
        return self._continuous[name].submit(
            np.asarray(prompt_ids, np.int32), max_new_tokens,
            eos_id=eos_id, seed=seed)

    def stats(self, name: Optional[str] = None):
        if name is not None:
            return self._metrics[name].stats()
        out = {n: m.stats() for n, m in sorted(self._metrics.items())}
        if self._continuous:
            out["_continuous"] = {n: b.stats()
                                  for n, b in sorted(self._continuous.items())}
        if self._fleets:
            out["_fleet"] = {n: r.stats()
                             for n, r in sorted(self._fleets.items())}
        if self._elastic_events is not None:
            out["_elastic"] = self._elastic_events.counts()
        analysis = self._analysis_counters()
        if analysis:
            out["_analysis"] = analysis
        if self._load_failures:
            out["_load_failures"] = dict(self._load_failures)
        durability = self._durability_counters()
        if durability:
            out["_checkpoint"] = durability
        watchdog = self._watchdog_counters()
        if watchdog:
            out["_watchdog"] = watchdog
        return out

    @staticmethod
    def _analysis_counters():
        """The plan analysis' per-code counters (analysis/diagnostics.py):
        process-wide, so every compile, search and import in this process
        shows."""
        from ..analysis import diagnostic_counters

        return diagnostic_counters()

    @staticmethod
    def _durability_counters():
        """Durable-checkpoint counters (runtime/durability.py):
        process-wide saves/restores/corruptions/fallbacks/GC."""
        from ..runtime.durability import checkpoint_counters

        return checkpoint_counters()

    @staticmethod
    def _watchdog_counters():
        """Training-watchdog counters (elastic/watchdog.py): process-wide
        bad steps / skips / rollbacks."""
        from ..elastic.watchdog import watchdog_counters

        return watchdog_counters()

    def prometheus_text(self) -> str:
        """Prometheus exposition-format metrics (the Triton /metrics
        role). One renderer — `MetricsRegistry.render()` — over two
        registries: this server's per-model families plus the process-wide
        default registry, which carries `ff_plan_diagnostics_total`,
        `ff_checkpoint_*`,
        `ff_watchdog_*` and the batchers' `ff_serving_*` / `ff_kvpool_*`
        families without any per-family code here. Derived/mirrored
        series (avg-latency gauge, elastic event counts) are synced right
        before rendering so a scrape is point-in-time consistent."""
        avg = self.registry.gauge("ff_inference_avg_latency_ms",
                                  "Mean successful-request latency",
                                  labels=("model",))
        for n, m in sorted(self._metrics.items()):
            avg.set(m.stats()["avg_latency_ms"], model=n)
        if self._elastic_events is not None:
            c = self.registry.counter(
                "ff_elastic_events_total",
                "Elastic runtime events by kind", labels=("kind",))
            for kind, n in self._elastic_events.counts().items():
                c.set_total(n, kind=kind)
        if not self._fleets:
            return self.registry.render() + REGISTRY.render()
        # one exposition document over every source: this server's
        # registry, the process-wide one, each router's ff_fleet_*
        # families and every replica's registry under a `replica` label.
        # One render_labeled pass emits one TYPE header a family even
        # where the default registry carries the same families (a
        # non-fleet batcher in this process); concatenated renders would
        # repeat the headers, which scrapers and validate_exposition
        # refuse
        from ..obs.registry import render_labeled

        multi = len(self._fleets) > 1
        members = [((), self.registry), ((), REGISTRY)]
        for fname in sorted(self._fleets):
            router = self._fleets[fname]
            members.append(
                (((("fleet", fname),) if multi else ()), router.registry))
            for rname, reg in sorted(router.replica_registries().items()):
                pairs = (("fleet", fname), ("replica", rname)) if multi \
                    else (("replica", rname),)
                members.append((pairs, reg))
        return render_labeled(members)

    def shutdown(self):
        for name in (list(self._models) + list(self._generative)
                     + list(self._continuous) + list(self._fleets)):
            self.unregister(name)

    # -- optional HTTP endpoint ---------------------------------------
    def serve_http(self, host: str = "127.0.0.1", port: int = 8000,
                   block: bool = False):
        """Start a KServe-flavored HTTP endpoint. Returns the http.server
        instance (call .shutdown() to stop) unless block=True."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self._send_trace_headers()
                self.end_headers()
                self.wfile.write(body)

            def _send_trace_headers(self):
                """Echo the request id and (when a trace is active) the
                traceparent, so clients can join their logs to the
                server's timeline."""
                rid = getattr(self, "_request_id", None)
                if rid:
                    self.send_header("X-Request-Id", rid)
                ctx = getattr(self, "_trace_ctx", None)
                if ctx is not None:
                    self.send_header("traceparent", _format_traceparent(ctx))

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if self.path == "/v2/models":
                    self._reply(200, {"models": server_ref.models()})
                elif self.path == "/healthz":
                    # liveness + readiness in one: 200 with the serving
                    # inventory (Triton's /v2/health/ready role). With a
                    # fleet registered the status aggregates its
                    # replicas' health: "degraded" while any replica
                    # drains, is lost or failed to load (the
                    # ff_model_load_failures_total leg), "down" when a
                    # fleet has nothing ready
                    fleets = {n: r.health()
                              for n, r in sorted(server_ref._fleets.items())}
                    status = "ok"
                    if server_ref._load_failures or any(
                            f["status"] == "degraded"
                            for f in fleets.values()):
                        status = "degraded"
                    if any(f["status"] == "down" for f in fleets.values()):
                        status = "down"
                    payload = {
                        "status": status,
                        "models": server_ref.models(),
                        "generative": sorted(server_ref._generative),
                        "continuous": sorted(server_ref._continuous),
                        "load_failures": sorted(server_ref._load_failures),
                        "uptime_s": round(
                            time.time() - server_ref._start_time, 3),
                    }
                    if fleets:
                        payload["fleets"] = fleets
                    self._reply(200, payload)
                elif self.path == "/metrics":
                    body = server_ref.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif (len(parts) == 4 and parts[0] == "v2"
                        and parts[1] == "models" and parts[3] == "stats"):
                    try:
                        self._reply(200, server_ref.stats(parts[2]))
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                else:
                    self._reply(404, {"error": "not found"})

            def _stream_generate(self, name: str, prompt, req: dict):
                """"stream": true — per-token NDJSON over a close-delimited
                HTTP/1.0 response: one {"token": t} line per generated
                token as the scheduler emits it, then a {"done": ...}
                trailer with the full sequence."""
                gen = server_ref.generate_stream(
                    name, prompt, int(req.get("max_new_tokens", 16)),
                    eos_id=req.get("eos_id"), seed=int(req.get("seed") or 0))
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self._send_trace_headers()
                self.end_headers()
                toks = []
                try:
                    for tok in gen.stream(timeout=600.0):
                        toks.append(tok)
                        self.wfile.write(
                            (json.dumps({"token": tok}) + "\n").encode())
                        self.wfile.flush()
                    # cache_hit/prefix_tokens: the prefix-cache outcome
                    # (serving/sched/kvpool.py) — lets clients see why
                    # their TTFT was what it was. request_id/trace_id
                    # name the request in the server's trace.
                    trailer = {
                        "done": True, "tokens": toks,
                        "cache_hit": bool(gen.cache_hit),
                        "prefix_tokens": int(gen.prefix_tokens),
                        "ttft_ms": (round(gen.ttft_s * 1e3, 3)
                                    if gen.ttft_s is not None else None),
                        "request_id": self._request_id,
                        "trace_id": getattr(gen, "trace_id", None),
                    }
                except OSError:  # client disconnected mid-stream
                    return
                except Exception as e:  # headers already sent: error trailer
                    trailer = {"done": False, "tokens": toks,
                               "error": f"{type(e).__name__}: {e}",
                               "request_id": self._request_id}
                try:
                    self.wfile.write((json.dumps(trailer) + "\n").encode())
                except OSError:
                    # response is committed and the client is gone —
                    # nothing left to reply with (do_POST must NOT try a
                    # second status line)
                    pass

            def do_POST(self):
                from .sched.admission import AdmissionError

                # request-scoped trace context + request id: every span
                # below lands under the inbound traceparent (or a fresh
                # root), and the id is echoed in headers, rejection
                # bodies, and streaming trailers
                self._trace_ctx, self._request_id = _request_scope(
                    self.headers)
                parts = self.path.strip("/").split("/")
                if (len(parts) == 4 and parts[0] == "v2"
                        and parts[1] == "models"
                        and parts[3] == "generate"):
                    continuous = (parts[2] in server_ref._continuous
                                  or parts[2] in server_ref._fleets)
                    if not continuous and parts[2] not in server_ref._generative:
                        self._reply(
                            404, {"error": f"no generative session "
                                           f"{parts[2]!r}"})
                        return
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(length) or b"{}")
                        if "prompt" not in req:
                            self._reply(
                                400, {"error": "missing 'prompt' field"})
                            return
                        # continuous fans ragged rows out as independent
                        # requests; the lockstep session needs a rectangle
                        prompt = (req["prompt"] if continuous
                                  else np.asarray(req["prompt"],
                                                  dtype=np.int32))
                        with use_context(self._trace_ctx):
                            if continuous and req.get("stream"):
                                self._stream_generate(
                                    parts[2], np.asarray(prompt, np.int32),
                                    req)
                                return
                            toks = server_ref.generate(
                                parts[2], prompt,
                                int(req.get("max_new_tokens", 16)),
                                eos_id=req.get("eos_id"),
                                seed=int(req.get("seed") or 0),
                            )
                        toks = (toks.tolist()
                                if isinstance(toks, np.ndarray) else toks)
                        self._reply(200, {"tokens": toks})
                    except AdmissionError as e:
                        # typed backpressure: 429 for transient saturation
                        # (retry with backoff), 400 for can-never-fit;
                        # request_id lets a shed client quote exactly
                        # which attempt was rejected
                        self._reply(e.http_status,
                                    {"error": str(e), "reason": e.reason,
                                     "request_id": self._request_id})
                    except ValueError as e:  # malformed request shape
                        self._reply(400, {"error": str(e),
                                          "request_id": self._request_id})
                    except Exception as e:
                        self._reply(
                            500, {"error": f"{type(e).__name__}: {e}",
                                  "request_id": self._request_id})
                    return
                # v2/models/<name>/infer
                if (len(parts) != 4 or parts[0] != "v2"
                        or parts[1] != "models" or parts[3] != "infer"):
                    self._reply(404, {"error": "not found"})
                    return
                name = parts[2]
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    inputs = {
                        k: np.asarray(v, dtype=np.float32)
                        if not _is_int_list(v) else np.asarray(v, dtype=np.int32)
                        for k, v in req.get("inputs", {}).items()
                    }
                    with use_context(self._trace_ctx):
                        out = server_ref.infer(name, inputs, timeout=30.0)
                    self._reply(200, {"outputs": np.asarray(out).tolist()})
                except KeyError as e:
                    self._reply(404, {"error": str(e),
                                      "request_id": self._request_id})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}",
                                      "request_id": self._request_id})

        httpd = ThreadingHTTPServer((host, port), Handler)
        if block:
            httpd.serve_forever()
            return httpd
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd


def _is_int_list(v) -> bool:
    while isinstance(v, (list, tuple)) and v:
        v = v[0]
    return isinstance(v, int)


def _prompt_rows(prompt_ids):
    """Normalize a prompt payload into a list of (L,) int32 rows.
    Continuous batching fans rows out as independent requests, so RAGGED
    lists of lists are legal (the lockstep path needs a rectangle)."""
    if isinstance(prompt_ids, np.ndarray):
        return ([prompt_ids.astype(np.int32)] if prompt_ids.ndim == 1
                else [r.astype(np.int32) for r in prompt_ids])
    if isinstance(prompt_ids, (list, tuple)) and prompt_ids and \
            isinstance(prompt_ids[0], (list, tuple, np.ndarray)):
        return [np.asarray(r, np.int32) for r in prompt_ids]
    return [np.asarray(prompt_ids, np.int32)]
