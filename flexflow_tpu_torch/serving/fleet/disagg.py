"""Disaggregated prefill/decode serving: the priced KV-handoff plane.

Production serving splits prefill (compute-bound, batch-hungry) from
decode (bytes-bound, latency-critical) onto separate replica pools so
neither phase's batching regime poisons the other's tail latency
(docs/serving.md "Disaggregated serving"). The Router already sends
fresh traffic to `role="prefill"` replicas only; each such replica runs
chunked prefill to completion, emits the FIRST token, and PARKS the
request (RequestState.PARKED) with its finished KV pages resident. This
module is the control loop that moves a parked request to the decode
pool:

 1. `on_parked` (batcher scheduler thread) enqueues the request here —
    the handoff worker thread owns the rest, so the scheduler never
    blocks on its own ticket queue.
 2. EXPORT: `ContinuousBatcher.request_export` gathers the sequence's
    owned cache rows to host numpy plus the pool's geometry-checked page
    descriptor (`PagedKVPool.export_sequence`). The request STAYS
    parked — any later failure resumes it locally with nothing lost.
 3. PRICE + GATE: the shipment is modeled as the same per-array TRANSFER
    schedule a live mesh resize uses (`plan_slot_migration`), priced on
    the fleet's `HierarchicalMachineModel` — a decode pool on the other
    pod pays the DCN hop, not the innermost p2p link — and FFTA06x-gated
    through `check_redistribution` before a byte moves. Cross-tier
    shipments are chunked at `TRANSFER_TIER_CHUNK_BYTES` (64 MB), the
    same cap the resharding executor honors.
 4. IMPORT: the chosen decode replica (least pages-used READY
    `role="decode"` replica) installs the rows into a fresh slot and the
    request enters DECODE with ZERO recompute (`request_import`).
    Token parity with unified serving is structural: greedy/seeded
    decode is a pure function of cache rows, absolute positions and the
    request's own seed, all of which ship intact.
 5. COMMIT: the caller's `FleetRequest` rebinds to the decode
    continuation (`Router.rebind_handoff` — first token(s) become the
    stitched base, exactly like a failover rebind), THEN the prefill
    side frees its slot/pages/admission (`release_parked`).

Every failure mode — no decode replica, admission shed on import,
geometry mismatch, export/import ticket failure, coordinator stopped —
degrades to `resume_parked`: the prefill replica decodes the request
locally and the fleet stays ZERO-DROP. A prefill replica dying
mid-handoff is the router's failover path unchanged: the fence freezes the
emitted first token and the router replays prompt ‖ base on a sibling
(which parks and hands off again). A decode replica dying after commit
fails over from the DECODE pool's outstanding list.

Each committed handoff also appends its measured walls beside its price
to `log` (bytes, chunks, predicted_us, export_ms: the export's copy to
host on the prefill replica's scheduler thread, import_ms: the import
ticket's wait, wall_ms): on one card both pools share the device, so
the rows go device -> host -> device through one card's copy engines,
not over a link, and the walls measure that.

The whole handoff runs under the request's ORIGINAL trace
(`fleet.kv_handoff` span on the worker thread, `serve.kv_export` /
`serve.kv_import` on the two scheduler threads), so the merged Perfetto
timeline shows one request flowing prefill replica -> handoff plane ->
decode replica under one trace_id. The priced-transfer EWMA feeds
`Router.predicted_handoff_s`, so SLO admission charges prefill
candidates the handoff leg the request will actually pay.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...analysis.pipeline import check_redistribution
from ...obs.registry import MetricsRegistry
from ...obs.tracing import get_tracer, use_context
from ...resharding.cost import schedule_cost_us
from ...resharding.plan import TRANSFER_TIER_CHUNK_BYTES, plan_slot_migration
from .replica import Replica
from .router import Router

# EWMA smoothing for the learned priced-transfer model (us/byte and
# bytes/token): recent handoffs dominate, one outlier does not
_EWMA_ALPHA = 0.3


class HandoffFailed(RuntimeError):
    """A KV handoff could not commit (no decode replica, shed, geometry
    mismatch, ...). Internal to the coordinator: the request is resumed
    on its prefill replica, never dropped."""


class DisaggCoordinator:
    """The fleet's KV-handoff worker: one background thread draining a
    queue of parked requests, shipping each to the decode pool.

    `machine` + `device_ids` define how shipments are priced:
    `device_ids` are the global device positions the two pools span, so
    on a hierarchical machine the TRANSFER is priced at the OUTERMOST
    tier the pools cross (a decode pool on the other pod prices over
    DCN). With `machine=None` pricing degrades to byte counts and the
    FFTA06x gate still checks schedule shape.
    """

    def __init__(self, router: Router, machine=None,
                 device_ids=(0,), registry: Optional[MetricsRegistry] = None,
                 wait_s: float = 30.0, start: bool = True):
        self.router = router
        self.machine = machine
        self.device_ids = tuple(int(i) for i in device_ids)
        self.registry = router.registry if registry is None else registry
        self.wait_s = float(wait_s)
        self._cv = threading.Condition()
        self._q: "deque[Tuple[str, object]]" = deque()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # learned priced-transfer model feeding Router.predicted_handoff_s
        self._us_per_byte: Optional[float] = None
        self._bytes_per_token: Optional[float] = None
        self.committed = 0
        self.resumed = 0
        self.failed = 0
        self.last_error: Optional[str] = None
        self.last_predicted_us: Optional[float] = None
        # one record of measured walls beside the price a committed handoff
        self.log: List[Dict[str, object]] = []
        self._c_handoffs = self.registry.counter(
            "ff_disagg_handoffs_total",
            "KV handoffs by outcome (committed = decode replica took the"
            " request; resumed = failure fell back to local decode;"
            " failed = request no longer parked, failover owns it)",
            labels=("outcome",))
        self._c_bytes = self.registry.counter(
            "ff_disagg_handoff_bytes_total",
            "KV bytes shipped prefill -> decode (committed handoffs)")
        self._c_chunks = self.registry.counter(
            "ff_disagg_handoff_chunks_total",
            "Cross-tier 64 MB TRANSFER chunks shipped (1/handoff when the"
            " pools share the innermost tier)")
        self._h_ms = self.registry.histogram(
            "ff_disagg_handoff_ms",
            "Wall time of one committed handoff: export + price/gate +"
            " import + rebind")
        self._g_pred = self.registry.gauge(
            "ff_disagg_predicted_transfer_us",
            "Last FFTA06x-gated priced transfer time (schedule_cost_us on"
            " the fleet machine model)")
        self._g_queue = self.registry.gauge(
            "ff_disagg_queue_depth", "Parked requests awaiting handoff")
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="disagg-handoff", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the worker. Queued-but-unshipped requests resume locally
        on their prefill replicas — stopping the handoff plane degrades
        the fleet to unified serving, it never drops work."""
        with self._cv:
            self._running = False
            leftover = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        for name, req in leftover:
            try:
                self.router.replica(name).batcher.resume_parked(req)
                self._note("resumed")
            except Exception:
                self._note("failed")
        self._g_queue.set(0)

    # -- wiring ------------------------------------------------------------
    def wire(self, replica: Replica) -> None:
        """Point a prefill replica's `on_parked` at this coordinator.
        Factories the autoscaler respawns from should call this on every
        prefill replica they build."""
        if replica.role != "prefill":
            raise ValueError(
                f"replica {replica.name!r} has role={replica.role!r};"
                " only prefill replicas park requests")
        replica.batcher.on_parked = \
            lambda req, _n=replica.name: self.enqueue(_n, req)

    def attach(self, name: str) -> None:
        self.wire(self.router.replica(name))

    def attach_all(self) -> None:
        """Wire every registered prefill replica and install the
        predicted-handoff charge on the router's SLO gate."""
        for name in self.router.replica_names():
            rep = self.router.replica(name)
            if rep.role == "prefill":
                self.wire(rep)
        self.router.predicted_handoff_s = self.predicted_handoff_s

    def enqueue(self, replica_name: str, req) -> None:
        """on_parked entry point (batcher scheduler thread — must not
        block). Raising when stopped makes the batcher resume the
        request inline: the degrade-to-unified fallback is one hop."""
        with self._cv:
            if not self._running:
                raise RuntimeError("disagg coordinator is stopped")
            self._q.append((str(replica_name), req))
            self._g_queue.set(len(self._q))
            self._cv.notify_all()

    # -- routing signal ----------------------------------------------------
    def predicted_handoff_s(self, prompt_len: int) -> float:
        """Predicted handoff wall time for a prompt of this length, from
        the learned (us/byte, bytes/token) EWMAs — 0 until the first
        priced handoff calibrates them. Installed as
        `Router.predicted_handoff_s` by attach_all."""
        with self._cv:
            us_b, b_tok = self._us_per_byte, self._bytes_per_token
        if us_b is None or b_tok is None:
            return 0.0
        return (us_b * b_tok * max(1, int(prompt_len))) / 1e6

    # -- pricing -----------------------------------------------------------
    def price_transfer(self, src: Replica, dst: Replica, plen: int,
                       rows: Dict[str, np.ndarray]) -> Dict[str, object]:
        """Model the shipment as the resharding TRANSFER schedule a live
        resize would use — one move per cache array carrying the
        sequence's `plen` owned rows — priced on the fleet machine and
        FFTA06x-gated (check_redistribution raises PlanAnalysisError on
        an illegal schedule). Cross-tier shipments report the 64 MB
        chunk count the executor must honor (`plan_slot_migration`
        itself does not chunk)."""
        src_pool, dst_pool = src.batcher.pool, dst.batcher.pool
        kv_shapes: Dict[str, Tuple[Tuple[int, ...], int]] = {}
        for path, r in rows.items():
            arr = np.asarray(r)
            shape = (src_pool.num_slots, src_pool.max_len) \
                + tuple(int(d) for d in arr.shape[1:])
            kv_shapes[f"kv/{path}"] = (shape, int(arr.dtype.itemsize))
        schedule = plan_slot_migration(
            kv_shapes, src_pool.num_slots, dst_pool.num_slots,
            int(plen), device_ids=self.device_ids)
        check_redistribution(schedule, machine=self.machine)
        # with no machine model the schedule is still FFTA06x-gated but
        # unpriceable (step_cost_us needs link constants) — predict 0
        predicted_us = float(schedule_cost_us(schedule, self.machine)) \
            if self.machine is not None else 0.0
        total = int(sum(np.asarray(r).nbytes for r in rows.values()))
        cross = (self.machine is not None
                 and hasattr(self.machine, "crosses_tier_boundary")
                 and len(self.device_ids) > 1
                 and self.machine.crosses_tier_boundary(
                     len(self.device_ids)))
        cap = int(TRANSFER_TIER_CHUNK_BYTES)
        chunks = max(1, math.ceil(total / cap)) if cross else 1
        return {"schedule": schedule, "predicted_us": predicted_us,
                "bytes": total, "chunks": chunks,
                "cross_tier": bool(cross)}

    # -- worker ------------------------------------------------------------
    def _loop(self) -> None:
        tracer = get_tracer()
        tracer.set_thread_name("disagg-handoff")
        while True:
            with self._cv:
                while self._running and not self._q:
                    self._cv.wait(0.5)
                if not self._q:
                    if not self._running:
                        return
                    continue
                name, req = self._q.popleft()
                self._g_queue.set(len(self._q))
            try:
                self._handoff(name, req, tracer)
            except Exception as e:  # absolute backstop: plane never dies
                self.last_error = f"{type(e).__name__}: {e}"
                self._resume(name, req)

    def _pick_decode(self) -> Tuple[Optional[str], Optional[Replica]]:
        """Least pages-used READY decode replica (ties to load_score):
        the decode pool's saturation currency is KV pages, not queue."""
        cands = [(n, r) for n, r in self.router._ready()
                 if r.role == "decode"]
        if not cands:
            return None, None
        name, rep = min(
            cands, key=lambda nr: (nr[1].utilization(),
                                   nr[1].load_score(), nr[0]))
        return name, rep

    def _find_fleet_request(self, name: str, req):
        for fr in self.router.outstanding_for(name):
            inner, _ = fr._snapshot()
            if inner is req:
                return fr
        return None

    def _await_fleet_request(self, name: str, req, window_s: float = 0.25):
        """A fast prefill can park `req` between `Replica.submit`
        returning and the router binding the FleetRequest into its
        outstanding list — give the bind a beat before concluding the
        request was a direct (non-router) submit."""
        fr = self._find_fleet_request(name, req)
        deadline = time.monotonic() + window_s
        while fr is None and time.monotonic() < deadline:
            time.sleep(0.005)
            fr = self._find_fleet_request(name, req)
        return fr

    def _handoff(self, name: str, req, tracer) -> None:
        t0 = time.monotonic()
        try:
            rep = self.router.replica(name)
        except KeyError:
            # replica evicted while the request queued here: the
            # failover fence owns the request now
            self._note("failed")
            return
        fr = self._await_fleet_request(name, req)
        if fr is None:
            # a direct (non-router) submit parked here: there is no
            # fleet handle to rebind, so a handoff would orphan the
            # caller's stream — decode locally instead
            self._resume(name, req)
            return
        ctx = fr.trace_ctx
        try:
            with use_context(ctx):
                dec_name, dec = self._pick_decode()
                if dec is None:
                    raise HandoffFailed("no READY decode replica")
                exp = rep.batcher.request_export(req).wait(self.wait_s)
                priced = self.price_transfer(
                    rep, dec, int(exp["plen"]), exp["rows"])
                with tracer.span(
                        "fleet.kv_handoff", replica=name, to=dec_name,
                        request=req.id, bytes=priced["bytes"],
                        chunks=priced["chunks"],
                        predicted_us=round(priced["predicted_us"], 3)):
                    base = list(req.tokens)
                    base_times = list(req.token_times)
                    remaining = req.max_new_tokens - len(base)
                    t_imp = time.monotonic()
                    inner = dec.batcher.request_import(
                        exp["desc"], exp["rows"], req.prompt,
                        exp["last_tok"], remaining, eos_id=req.eos_id,
                        seed=req.seed, trace=req.trace).wait(self.wait_s)
                    import_ms = (time.monotonic() - t_imp) * 1e3
                    # rebind BEFORE release: release_parked finishes the
                    # old inner, and a consumer must never observe a
                    # finished stream with no continuation bound
                    self.router.rebind_handoff(
                        fr, dec_name, inner, base, base_times,
                        req.t_first_token)
                    rep.batcher.release_parked(req)
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {e}"
            self._resume(name, req)
            return
        self._note("committed")
        self._c_bytes.inc(priced["bytes"])
        self._c_chunks.inc(priced["chunks"])
        wall_ms = (time.monotonic() - t0) * 1e3
        self._h_ms.observe(wall_ms)
        self._calibrate(priced, int(exp["plen"]))
        self.log.append({
            "request": req.id, "from": name, "to": dec_name,
            "tokens": int(exp["plen"]), "bytes": priced["bytes"],
            "chunks": priced["chunks"],
            "predicted_us": priced["predicted_us"],
            "export_ms": float(exp.get("wall_ms", 0.0)),
            "import_ms": import_ms, "wall_ms": wall_ms})

    def _calibrate(self, priced: Dict[str, object], plen: int) -> None:
        us, nbytes = float(priced["predicted_us"]), int(priced["bytes"])
        self.last_predicted_us = us
        self._g_pred.set(us)
        if nbytes <= 0 or plen <= 0:
            return
        upb, bpt = us / nbytes, nbytes / plen
        with self._cv:
            self._us_per_byte = upb if self._us_per_byte is None else \
                (1 - _EWMA_ALPHA) * self._us_per_byte + _EWMA_ALPHA * upb
            self._bytes_per_token = bpt if self._bytes_per_token is None \
                else (1 - _EWMA_ALPHA) * self._bytes_per_token \
                + _EWMA_ALPHA * bpt

    def _resume(self, name: str, req) -> None:
        """Zero-drop fallback: put the request back to local decoding on
        its prefill replica. False (not parked any more) means the
        failover machinery already fenced it — nothing to do here."""
        try:
            ok = self.router.replica(name).batcher.resume_parked(req)
        except Exception:
            ok = False
        self._note("resumed" if ok else "failed")

    def _note(self, outcome: str) -> None:
        self._c_handoffs.inc(outcome=outcome)
        if outcome == "committed":
            self.committed += 1
        elif outcome == "resumed":
            self.resumed += 1
        else:
            self.failed += 1

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._cv:
            depth = len(self._q)
            us_b, b_tok = self._us_per_byte, self._bytes_per_token
        return {
            "running": self._running,
            "queue_depth": depth,
            "committed": self.committed,
            "resumed": self.resumed,
            "failed": self.failed,
            "last_error": self.last_error,
            "last_predicted_us": self.last_predicted_us,
            "us_per_byte": us_b,
            "bytes_per_token": b_tok,
        }
