"""One serving replica: a model instance behind its own ContinuousBatcher.

A fleet (docs/serving.md "Fleet") is N of these behind one Router. Each
replica owns

 - its own `ContinuousBatcher` — and with it a private PagedKVPool,
   PrefixCache, and AdmissionController (the per-replica capacity the
   router reasons about);
 - its own `MetricsRegistry`, so the `ff_serving_*` / `ff_kvpool_*` /
   `ff_prefix_cache_*` families of sibling replicas never clobber each
   other — the fleet's `/metrics` stamps each registry's samples with a
   `replica` label through `obs.render_merged`;
 - a lifecycle state the router routes by: READY takes traffic, DRAINING
   finishes what it has (queued work is handed off by the router) but
   accepts nothing new, STOPPED is fully shut down.

Replicas may SHARE one compiled FFModel: the batcher only reads
`model.params`/`model.state` and carries its own KV-cache arrays, so N
replicas of one model cost N KV pools, not N weight copies — on a real
fleet each replica's mesh holds its own weights, and the `model` handle
is per-replica anyway.
"""
from __future__ import annotations

import enum
import threading
from typing import Dict, Optional

from ...obs.registry import MetricsRegistry
from ..sched.continuous import ContinuousBatcher


class ReplicaState(enum.Enum):
    READY = "ready"
    DRAINING = "draining"
    STOPPED = "stopped"
    # declared dead by the HealthMonitor (crashed scheduler, hung
    # heartbeat): evicted from routing, in-flight work replayed on
    # survivors (router.fail_over), batcher aborted without a join
    DEAD = "dead"


class Replica:
    """ContinuousBatcher + private registry + lifecycle state.

    Every batcher keyword (`max_len`, `num_slots`, `page_size`,
    `prefill_chunk_tokens`, `prefix_cache_pages`, `max_queue`, ...)
    passes through; the registry is forced to this replica's own unless
    the caller provides one explicitly.
    """

    def __init__(self, name: str, model, registry: Optional[MetricsRegistry]
                 = None, start: bool = True, role: str = "unified",
                 **batcher_kw):
        self.name = str(name)
        self.registry = MetricsRegistry() if registry is None else registry
        self._lock = threading.Lock()
        self._state = ReplicaState.READY
        batcher_kw.setdefault("registry", self.registry)
        # the scheduler thread's track in trace exports carries the
        # replica name, so a merged post-mortem timeline shows one track
        # per replica (metric labels keep the pool's own label)
        batcher_kw.setdefault("trace_label", self.name)
        # disaggregated serving (docs/serving.md): 'prefill' replicas
        # park every request after its first token for the KV-handoff
        # plane, 'decode' replicas serve imported sequences, 'unified'
        # is the classic both-phases replica. The batcher enforces the
        # role's scheduling semantics; the Router routes by it.
        batcher_kw.setdefault("role", role)
        self.batcher = ContinuousBatcher(model, **batcher_kw)
        self.role = self.batcher.role
        if start:
            self.batcher.start()

    # -- lifecycle ---------------------------------------------------------
    @property
    def state(self) -> ReplicaState:
        with self._lock:
            return self._state

    def mark_draining(self) -> None:
        """No new routes land here; live + queued work keeps running
        (the router hands queued requests off to siblings)."""
        with self._lock:
            if self._state is ReplicaState.READY:
                self._state = ReplicaState.DRAINING

    def stop(self) -> None:
        """Stop the batcher (active requests decode to completion, queued
        ones fail with BatcherStopped — drain first for a zero-drop
        removal)."""
        with self._lock:
            self._state = ReplicaState.STOPPED
        self.batcher.stop()

    def mark_dead(self) -> None:
        """Record the monitor's DEAD verdict (terminal: a dead replica
        never takes traffic again — the autoscaler respawns a FRESH one
        from the factory)."""
        with self._lock:
            self._state = ReplicaState.DEAD

    def kill(self, err: BaseException) -> None:
        """DEAD + non-blocking batcher abort: every in-flight request is
        fenced with `err` (its emitted-token snapshot frozen for the
        router's token-exact replay) and the scheduler thread — possibly
        hung — is left to exit on its own (ContinuousBatcher.abort)."""
        self.mark_dead()
        self.batcher.abort(err)

    # -- traffic (router-facing) -------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, eos_id=None,
               seed: int = 0, prefill_only: bool = False):
        return self.batcher.submit(prompt_ids, max_new_tokens,
                                   eos_id=eos_id, seed=seed,
                                   prefill_only=prefill_only)

    def cancel(self, req) -> bool:
        return self.batcher.cancel(req)

    def request_resize(self, num_slots: Optional[int] = None, machine=None):
        return self.batcher.request_resize(num_slots=num_slots,
                                           machine=machine)

    # -- routing signals ---------------------------------------------------
    def prefix_probe(self, prompt_ids) -> int:
        """Prompt tokens this replica's prefix cache already owns — the
        affinity signal (ContinuousBatcher.prefix_probe)."""
        return self.batcher.prefix_probe(prompt_ids)

    def prefix_probe_chain(self, chain, prompt_len: int) -> int:
        """`prefix_probe` against a router-precomputed routing chain
        (ContinuousBatcher.prefix_probe_chain) — one prompt hashing per
        request fleet-wide instead of one per probed replica."""
        return self.batcher.prefix_probe_chain(chain, prompt_len)

    def predicted_ttft_s(self, prompt_len: int,
                         shared_tokens: int = 0) -> float:
        return self.batcher.predicted_ttft_s(prompt_len,
                                             shared_tokens=shared_tokens)

    def load_score(self) -> float:
        """Scalar least-loaded ordering key: queued requests dominate,
        then active slots relative to capacity, then page utilization —
        all cheap reads off the batcher's own accounting."""
        b = self.batcher
        queue = b.admission.queue_depth()
        pool = b.pool
        active = pool.live_sequences()
        return (queue * 1000.0
                + (active / max(1, pool.num_slots)) * 10.0
                + pool.utilization())

    # -- health signals (fleet/health.py HealthMonitor) --------------------
    def scheduler_alive(self) -> bool:
        return self.batcher.scheduler_alive()

    def heartbeat_age_s(self):
        return self.batcher.heartbeat_age_s()

    def step_latency_s(self):
        return self.batcher.step_latency_s()

    def reset_latency(self) -> None:
        """Forget the step-latency EWMA baseline after a respawn/resize
        (FailureDetector.reset_latency semantics) so recompile-slow
        first iterations don't re-flag a recovered replica."""
        self.batcher.reset_latency()

    def live_sequences(self) -> int:
        return self.batcher.pool.live_sequences()

    def queue_depth(self) -> int:
        return self.batcher.admission.queue_depth()

    def num_slots(self) -> int:
        return self.batcher.num_slots

    def utilization(self) -> float:
        return self.batcher.pool.utilization()

    def prefill_backlog_s(self) -> float:
        """Queued prefill work in seconds at the measured rate — the
        prefill pool's saturation signal (ContinuousBatcher
        .prefill_backlog_s)."""
        return self.batcher.prefill_backlog_s()

    def itl_window(self):
        """ff_serving_itl_ms Histogram.snapshot — the baseline the
        role-scoped autoscaler passes back to `itl_p99_ms(since=)` so
        the decode pool's latency signal covers a recent window."""
        fam = self.registry.get("ff_serving_itl_ms")
        return None if fam is None else fam.snapshot()

    def itl_p99_ms(self, since=None) -> float:
        """Observed p99 inter-token latency from this replica's own
        registry — the decode pool's saturation signal (pages-used is
        capacity; ITL is what the user feels when decode batches
        thicken)."""
        fam = self.registry.get("ff_serving_itl_ms")
        if fam is None:
            return 0.0
        return fam.quantile(0.99, since=since)

    def ttft_window(self) -> Dict[str, tuple]:
        """{cache label: Histogram.snapshot row} for ff_serving_ttft_ms —
        the baseline the autoscaler passes back to `ttft_p99_ms(since=)`
        so its latency signal covers a recent window, not process
        lifetime."""
        fam = self.registry.get("ff_serving_ttft_ms")
        if fam is None:
            return {}
        return {c: fam.snapshot(cache=c) for c in ("hit", "miss")}

    def ttft_p99_ms(self, since: Optional[Dict[str, tuple]] = None) -> float:
        """Observed p99 TTFT across prefix-cache outcomes, read from this
        replica's own registry (Histogram.quantile) — the autoscaler's
        latency signal. `since` (a `ttft_window()` snapshot) restricts
        the read to observations after the snapshot: the histogram
        buckets are lifetime-cumulative, so without a window one slow
        burst would read as overload forever."""
        fam = self.registry.get("ff_serving_ttft_ms")
        if fam is None:
            return 0.0
        since = since or {}
        return max((fam.quantile(0.99, since=since.get(c), cache=c)
                    for c in ("hit", "miss")), default=0.0)

    # -- reporting ---------------------------------------------------------
    def health(self) -> Dict[str, object]:
        b = self.batcher
        return {
            "state": self.state.value,
            "role": self.role,
            "num_slots": b.num_slots,
            "queue_depth": b.admission.queue_depth(),
            "live_sequences": b.pool.live_sequences(),
            "utilization": round(b.pool.utilization(), 4),
            "ttft_p99_ms": round(self.ttft_p99_ms(), 3),
        }

    def stats(self) -> Dict[str, object]:
        out = {"state": self.state.value}
        out.update(self.batcher.stats())
        return out
