"""ContinuousBatcher: iteration-level scheduling over the paged KV pool
(the core of flexflow_tpu/serving/sched/continuous.py).

Every decode iteration steps ALL decoding slots at their OWN positions
(the per-slot-position entry of ops/attention.py); a request that emits
EOS or reaches max_new_tokens frees its slot and pages that iteration,
and a queued request starts prefilling into the freed slot on the next
one while the others keep decoding. Prompts prefill in fixed-size chunks
(one KV page per scheduler iteration by default) through the chunk-offset
entry, interleaved with decode iterations; `prefill_chunk_tokens=0` runs
the one-shot prefill instead: one full-sequence walk over the padded
window that fills the slot's caches (the flash kernel, causal, on the
card), the prompt capped at the window.

Requests move through a small state machine::

    QUEUED --admit+slot--> PREFILL --first token--> DECODE --eos/max--> FINISHED
        \\                                             \\
         +------------------ FAILED <------------------+

and a prefill-only request (disaggregated serving, below) parks::

    PREFILL --first token--> PARKED --release_parked--> (the decode replica)
                                \\--resume_parked--> DECODE

Device state: the per-op K/V caches, (num_slots, max_len, heads, head_dim)
each, are allocated once and updated in place — the JAX batcher gets the
same effect by donating them to its jitted dispatches. A prefill chunk
writes straight into its slot's rows (a view of the pool caches); the JAX
batcher prefills into separate batch-1 caches and scatters them into the
slot at the end. Either way the rows a query can attend are the prompt's.

Compiled dispatches: on the card the decode iteration is ONE CUDA graph
(runtime/graphs.py; the counterpart of the JAX batcher's jitted
`decode_all`): the tokens, positions and sampling keys of every slot go
from pinned host memory into a static buffer by one copy, the graph
replays the walk and the pick (greedy's argmax, or the sampled pick)
into static outputs, and the tokens are read back. A prefill chunk is one
CUDA graph per slot (the slot's cache rows are fixed views; the JAX
batcher's `prefill_chunk` / `prefill_last_chunk`), its offset a 0-d
device buffer; all graphs share one memory pool and replay one at a time,
and the first token is picked from the chunk's static output. A graph is
captured at its first dispatch and again after the weights changed. The
one-shot prefill, the prefix install and insert run eagerly, once a
request. On the CPU every dispatch runs eagerly.

Speculative decoding (`draft_model=`, `spec_tokens=k`; the JAX batcher's
`spec_decode_all`): every decode iteration is then ONE dispatch, on the
card one CUDA graph over both models' caches — k unrolled greedy draft
steps, step j at positions pos + j over the draft's own slot-dense
caches, then the target scoring [last token, k proposals] at the
per-slot positions in one multi-query walk (C = k + 1, the decode
kernel's C >= 1 entry), the accept as the cumulative product of matches,
and `min(accepted + 1, k)` tokens a slot, all picked by `pick_tokens`'
argmax, as plain decode picks. Greedy output is token-identical to plain
greedy whatever the draft: every emitted token is the target's own
argmax. Emission is capped at k so the draft's cache stays exactly one
token behind the target's; rejected rows are never cleaned, the
positions just do not advance over them. The draft prefills the whole
prompt through its own per-slot chunk graphs (also on a prefix-cache
hit: the band holds target pages), and the target's last chunk waits
until the draft has caught up. Greedy-only, chunked-prefill-only.

Prefix reuse (kvpool.PrefixCache, on by default with chunked prefill:
two slots' worth of pages): cached prefix pages live in a band of
slot-shaped rows beside the decode caches, which decode never carries or
attends. A scheduled prompt's longest cached page-aligned prefix (at most
all but its last token) is copied into the slot's leading rows, one
indexed copy a cache, and only the suffix is prefilled; a finished
prefill copies its new full pages into the band. Admission credits the
expected sharing against its backlog budget.

The control surface (the JAX batcher's, for the fleet of ROADMAP A10):
`cancel` of a queued request, `abort` of the whole replica (fencing each
slotted request's emitted tokens), the health probes (`scheduler_alive`,
`heartbeat_age_s`, `step_latency_s`, `reset_latency`), the measured rate
model (`prefill_backlog_s`, `queued_prefill_tokens`, `predicted_ttft_s`)
and the metric families (obs/registry.py; the process-wide registry
unless one is passed).

Determinism: greedy decode (temperature <= 0) is a function of the prompt
alone, whatever shares the batch. Sampled decode adds Gumbel noise made
from the request's key (its seed) and the position (serving/generate.py
`pick_tokens`), so a request's tokens depend only on its own seed and
prompt, never on co-scheduled traffic. The numbers are not jax.random's,
so sampled tokens differ from the JAX batcher's.

Expert-affine admission (`expert_affinity=True`, `affinity_window=`;
sched/affinity.py): each request is signed at submit with the experts a
host-side probe of the first MoE gate routes it to, and a freed slot
takes, within the window, the queued request whose signature overlaps
the running batch's most. It orders admissions only: the MoE walks keep
no router state, and greedy tokens do not depend on the batch.

Tracing (obs/tracing.py; the JAX batcher's spans on the paths the port
has): `submit` opens `serve.admit` and captures the caller's context as
the `serve.submit` handoff, which the scheduler thread resumes for that
request's `serve.prefill` (one a chunk, or the one-shot walk),
`serve.prefix_install`, `serve.prefix_insert` and `serve.draft_prefill`
spans; each iteration is one `serve.decode` or `serve.spec_verify` span.
The scheduler thread's track is named `trace_label` (default: the pool's
label). While tracing is off each site costs one attribute check; the
spans read the host clock only, so a dispatch captured as a CUDA graph
inside one is captured as without it.

`num_slots=None` derives the slot count from the machine model's device
memory (kvpool.py derive_num_slots; `machine=` names the machine model,
else the config's: the H100 spec on the card), less the prefix band's
slots, and with a draft scaled by the target's share of the combined
per-token cache cost, as the JAX batcher does.

Live resize (`request_resize`, the JAX batcher's; ROADMAP A5.5): the
serving mesh grew or shrank, so the slot count changes between
iterations. A shrink waits until the live sequences fit the target and
holds admissions meanwhile; nothing is dropped. Before any device work
the migration is planned as a resharding schedule
(resharding/plan.py `plan_slot_migration`, the old and new arrays both
counted as scratch), gated by the FFTA06x analysis and priced with the
machine model (`schedule_cost_us`). New slot-dense caches are made and
only the rows the page tables own (`PagedKVPool.owned_view`) are copied
into them, the draft's caches with the target's. Every compiled
dispatch was captured over the old arrays and staging buffers, so all of
them are dropped and captured again over the new ones (a graph that
replayed over freed arrays would corrupt tokens silently). Each resize
is one `serve.resize` span, one `ff_serving_resizes_total` count and one
entry of `stats()["resizes"]`.

The JAX batcher serves unsharded models only: a model with a tensor
partitioned over a mesh axis is refused at construction with its
ValueError, before anything is allocated (sharded generation on ranks
is serving/generate.py `GenerativeSession`).

Disaggregated serving (`role=`, the JAX batcher's; serving/fleet/
disagg.py drives it): a "prefill" replica (or a `prefill_only` submit)
PARKS each request after its first token, slot and pages held, and
tells `on_parked`; the coordinator then asks `request_export`, ships
the rows, asks the decode replica's `request_import`, and commits with
`release_parked` (outcome "handed_off") or falls back to
`resume_parked` (local decode) on any failure. Both steps run on the
scheduler thread between iterations, as the resize does. The export
copies `cache[slot, :plen]` of every cache into pinned host memory and
waits on that copy's own event, not on the device; the import writes the
shipped rows into the EXISTING caches in place, one copy a cache, since
the captured decode and chunk graphs read those tensors (rows past plen
stay stale, never attended before decode rewrites them). The imported
request's sampling key comes from its seed as `submit` makes it, so its
continuation is the unified run's, greedy or sampled. Each step is one
`serve.kv_export` / `serve.kv_import` span. `fault_hook` (the fleet's
chaos engine) runs once an iteration with the batcher: a raise kills
the loop, a sleep stalls it.
"""
from __future__ import annotations

import contextlib
import enum
import itertools
import math
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...ffconst import OpType
from ...obs.tracing import _NULL_SPAN, get_tracer
from ...runtime.graphs import CapturedCall, Staging, graph_counts, \
    model_weights, new_pool
from ..batcher import BatcherStopped
from ..generate import key_bits, pick_tokens, sample_key
from .admission import AdmissionController
from .kvpool import KVGeometryMismatch, PagedKVPool, kv_cache_spec


class RequestCancelled(RuntimeError):
    """The caller cancelled a still-queued request (ContinuousBatcher
    .cancel) before it reached a slot."""


class ResizeTicket:
    """Handle for one requested resize (ContinuousBatcher.request_resize):
    the scheduler applies it between iterations, once the live sequences
    fit the target, and resolves it with the migration's record;
    `wait()` blocks until then."""

    def __init__(self, target_slots: int):
        self.target_slots = int(target_slots)
        self.result: Optional[Dict] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> Dict:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"resize to {self.target_slots} slots not applied within"
                f" {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, result: Dict) -> None:
        self.result = result
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self._done.set()


class HandoffTicket:
    """Handle for one step of the KV handoff on the scheduler thread: the
    EXPORT of a parked sequence's rows to host memory, or the IMPORT of
    shipped rows as a request entering decode. Applied between
    iterations, as a resize is; `wait()` blocks until then. Failures are
    typed (admission errors, `KVGeometryMismatch`) and land here, never
    in the loop."""

    def __init__(self):
        self.result = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"KV handoff step not applied within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, result) -> None:
        self.result = result
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self._done.set()


def _partitioned_tensor(model):
    """(name, spec) of the first tensor of `model` that a mesh partitions,
    in the JAX batcher's order (each op's outputs, then its weights), or
    None: an output cut over `data` on its batch (where the degree
    divides it) and a weight sharded over any axis (`Op.shards`)."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return None
    dp = mesh.size("data")
    for op in model.graph.ops.values():
        for t in op.outputs:
            spec = [None] * len(t.dims)
            if dp > 1 and t.dims and t.dims[0] % dp == 0 \
                    and not op.whole_batch:
                spec[0] = "data"
            if any(spec):
                return t.name, spec
        for t, ws in zip(op.weights, op.specs):
            pt = op.shards.get(ws.name)
            if pt is not None and pt.sharded_dims():
                return t.name, [d.axis if d.degree > 1 else None
                                for d in pt.dims]
    return None


def _spec_text(spec) -> str:
    """A partition spec as jax.sharding.PartitionSpec prints."""
    inner = ", ".join("None" if a is None else repr(a) for a in spec)
    return f"PartitionSpec({inner}{',' if len(spec) == 1 else ''})"


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    # a prefill-only request after its first token: its KV resident, slot
    # and pages held, not decoding, until the handoff commits
    # (release_parked) or falls back to local decode (resume_parked)
    PARKED = "parked"
    FINISHED = "finished"
    FAILED = "failed"


_DONE = object()


class GenRequest:
    """Handle for one submitted generation request."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
                 eos_id: Optional[int], seed: int):
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.seed = int(seed)
        self.state = RequestState.QUEUED
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self._stream: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self.t_submit = time.monotonic()
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.queue_wait_s: Optional[float] = None
        # emission time per token (inter-token latencies)
        self.token_times: List[float] = []
        # prefix-cache outcome, set when the scheduler takes the request:
        # cache_hit = at least one page of the prompt came from the cache
        self.cache_hit = False
        self.prefix_tokens = 0
        # failover fence (`_fence`): once fenced, the emitted tokens are
        # frozen, so a scheduler thread that resumes after an abort can
        # append nothing a replay elsewhere would duplicate
        self._emit_lock = threading.Lock()
        self._fenced = False
        # expert-affine admission (sched/affinity.py): the probe's expert
        # signature, and the picks this request was passed over in
        self.expert_sig: frozenset = frozenset()
        # the submitting thread's trace context, handed to the scheduler
        # thread (obs/tracing.py Handoff; None while tracing is off)
        self.trace = None
        self.affinity_skips = 0
        # disaggregated serving: park after the first token for the handoff
        self.prefill_only = False

    # -- consumer API ------------------------------------------------------
    def stream(self, timeout: Optional[float] = None):
        """Yield token ids in emission order; raises the request's error if
        it failed. Each next() waits at most `timeout` seconds."""
        while True:
            try:
                item = self._stream.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"request {self.id}: no token within {timeout}s")
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until finished; returns the (n,) int32 generated tokens."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"request {self.id} not finished within {timeout}s")
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    # -- scheduler side ----------------------------------------------------
    def _emit(self, tok: int) -> None:
        with self._emit_lock:
            if self._fenced:
                return
            self.tokens.append(int(tok))
            self.token_times.append(time.monotonic())
            self._stream.put(int(tok))

    def _finish(self) -> None:
        with self._emit_lock:
            if self._fenced or self._done.is_set():
                return
            self.state = RequestState.FINISHED
            self.t_done = time.monotonic()
            self._stream.put(_DONE)
            self._done.set()

    def _fail(self, err: BaseException) -> None:
        with self._emit_lock:
            if self._fenced or self._done.is_set():
                return
            self.state = RequestState.FAILED
            self.error = err
            self.t_done = time.monotonic()
            self._stream.put(err)
            self._done.set()

    def _fence(self, err: BaseException):
        """Freeze the request for failover: no token emitted after the
        fence is visible anywhere, so the returned (tokens, token_times)
        snapshot is exactly what the stream has shown or will show before
        the error. Returns None when the request already FINISHED;
        otherwise fails it with `err` (unless an error is already
        recorded: the consumer sees exactly one) and returns the
        snapshot."""
        with self._emit_lock:
            already = self._fenced
            self._fenced = True
            if self.state is RequestState.FINISHED:
                return None
            snap = (list(self.tokens), list(self.token_times))
            if not already and self.error is None:
                self.state = RequestState.FAILED
                self.error = err
                self.t_done = time.monotonic()
                self._stream.put(err)
                self._done.set()
            return snap


class _Slot:
    """One active sequence bound to a pool slot."""

    __slots__ = ("req", "slot", "pos", "emitted", "last_tok", "plen",
                 "filled", "shared", "key", "t_last_emit", "draft_filled")

    def __init__(self, req: GenRequest, slot: int):
        self.req = req
        self.slot = slot
        self.pos = 0          # cache row the NEXT decode writes at
        self.emitted = 0
        self.last_tok = 0
        self.plen = 0        # prompt length
        self.filled = 0       # prompt tokens already in the cache
        self.shared = 0       # prompt tokens installed from the prefix cache
        self.key = sample_key(req.seed)
        self.t_last_emit = time.monotonic()
        # prompt tokens in the DRAFT's cache (speculative decoding): always
        # from 0, even on a prefix-cache hit (the band holds target pages)
        self.draft_filled = 0


class ContinuousBatcher:
    """Continuous-batching scheduler over a compiled causal-transformer
    FFModel whose final tensor is a vocabulary distribution; the model's
    declared input length bounds the prefill chunk (and, one-shot, the
    prompt).

    temperature / top_k are batcher-level policy; a request's `seed` is
    per request. `num_slots=None` derives it from the machine model
    (`machine`, default the config's). prefix_cache_pages:
    band pages of the prefix cache; None gives two slots' worth with
    chunked prefill and none one-shot, 0 turns it off. draft_model /
    spec_tokens: speculative decoding (see the module docstring).
    expert_affinity / affinity_window: expert-affine admission (the
    module docstring); it needs a model with a fused EXPERTS op.
    registry: the metric families' registry (default the process-wide
    one, which a server renders; pass one only to isolate a test).
    trace_label: the scheduler thread's track name in exported traces
    (default: the pool's label).
    """

    def __init__(self, model, max_len: int, num_slots: Optional[int] = None,
                 page_size: int = 16, max_queue: int = 64,
                 queue_pages_budget: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 registry=None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_cache_pages: Optional[int] = None,
                 draft_model=None, spec_tokens: int = 3,
                 expert_affinity: bool = False, affinity_window: int = 4,
                 trace_label: Optional[str] = None, machine=None,
                 role: str = "unified"):
        found = _partitioned_tensor(model)
        if found is not None:
            # the JAX batcher's refusal and text (its sharding constraints
            # assume the compiled batch)
            name, spec = found
            raise ValueError(
                "ContinuousBatcher serves unsharded models;"
                f" tensor {name!r} is partitioned"
                f" ({_spec_text(spec)}) and its sharding"
                " constraint assumes the compiled batch")
        chunk = int(page_size) if prefill_chunk_tokens is None \
            else int(prefill_chunk_tokens)
        if chunk < 0:
            raise ValueError(
                f"prefill_chunk_tokens={prefill_chunk_tokens}: need >= 0")
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k={top_k}: must be >= 1")
        if float(temperature) < 0.0:
            raise ValueError(f"temperature={temperature}: must be >= 0")
        self.model = model
        self.device = model.device
        self.max_len = int(max_len)
        self.window = model.input_ops[0].outputs[0].dims[1]
        self.prefill_chunk_tokens = min(chunk, self.window)
        if self.prefill_chunk_tokens == 0 and self.max_len < self.window:
            # one-shot prefill fills a whole (1, window) pass into the
            # slot's rows; chunked prefill has no such floor
            raise ValueError(
                f"max_len={max_len} smaller than the prefill window"
                f" ({self.window})")
        self.temperature = float(temperature)
        self.top_k = top_k
        # disaggregated serving: "prefill" parks every request after its
        # first token for the handoff (and charges no decode leg in
        # predicted_ttft_s), "decode" serves imported sequences beside
        # its own traffic, "unified" does both phases
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role={role!r}: must be 'prefill', 'decode' or"
                " 'unified'")
        if role == "prefill" and draft_model is not None:
            raise ValueError(
                "role='prefill' cannot speculate: a parked request never"
                " decodes here, and the draft's caches do not ship in"
                " the KV handoff")
        self.role = role
        if not any(op.op_type == OpType.MULTIHEAD_ATTENTION
                   for op in model.graph.ops.values()):
            raise ValueError("generation needs multihead_attention ops")
        # ids must index the embedding table: on the card an out-of-range
        # gather is a device-side assert that takes the process down
        self._vocab = _embedding_entries(model)

        # speculative decoding: the JAX batcher's checks and texts
        self.draft_model = draft_model
        self.spec_tokens = int(spec_tokens) if draft_model is not None else 0
        if draft_model is not None:
            if self.spec_tokens < 2:
                # emission is capped at k (the draft stays one token
                # behind), so k = 1 can never beat plain decode
                raise ValueError(
                    f"spec_tokens={spec_tokens}: need >= 2 — emission is"
                    " capped at spec_tokens tokens/iteration, so k=1 can"
                    " never beat plain decode")
            if self.temperature > 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only (temperature 0):"
                    " sampled acceptance needs rejection sampling, which"
                    " this batcher does not implement")
            if self.prefill_chunk_tokens == 0:
                raise ValueError(
                    "speculative decoding requires chunked prefill"
                    " (prefill_chunk_tokens > 0): the draft model"
                    " prefills its own cache through the chunk entry")
            if self.spec_tokens + 1 > self.window:
                raise ValueError(
                    f"spec_tokens={self.spec_tokens}: the verify dispatch"
                    f" feeds {self.spec_tokens + 1} query tokens, more"
                    f" than the target's declared window ({self.window})")
            draft_window = draft_model.input_ops[0].outputs[0].dims[1]
            if draft_window < self.prefill_chunk_tokens:
                raise ValueError(
                    f"draft window ({draft_window}) smaller than the"
                    f" prefill chunk ({self.prefill_chunk_tokens}): the"
                    " draft prefills through the same chunk entry")
            if not any(op.op_type == OpType.MULTIHEAD_ATTENTION
                       for op in draft_model.graph.ops.values()):
                raise ValueError(
                    "draft model needs multihead_attention ops")
            tvocab = model.final_tensor.dims[-1]
            dvocab = draft_model.final_tensor.dims[-1]
            if tvocab != dvocab:
                raise ValueError(
                    f"draft vocab ({dvocab}) != target vocab ({tvocab}):"
                    " proposals must be scoreable by the target")
            if draft_model.device != self.device:
                raise ValueError(
                    f"draft model on {draft_model.device}, target on "
                    f"{self.device}: one dispatch runs both")
            dv = _embedding_entries(draft_model)
            if dv is not None:
                self._vocab = dv if self._vocab is None \
                    else min(self._vocab, dv)

        # expert-affine admission: the probe reads the embedding table and
        # the first gate to the host once, here
        self._affinity_probe = None
        self.affinity_window = max(1, int(affinity_window))
        if expert_affinity:
            from .affinity import ExpertAffinityProbe

            self._affinity_probe = ExpertAffinityProbe(model)

        # the prefix cache's budget (JAX continuous.py:515-533): two slots'
        # worth of band pages with chunked prefill, which the hit path
        # needs to prefill only the suffix
        if prefix_cache_pages is None:
            prefix_pages = (2 * math.ceil(self.max_len / int(page_size))
                            if self.prefill_chunk_tokens else 0)
        else:
            prefix_pages = int(prefix_cache_pages)
        if prefix_pages and not self.prefill_chunk_tokens:
            raise ValueError(
                "prefix caching requires chunked prefill"
                " (prefill_chunk_tokens > 0): installing a cached prefix"
                " leaves only the suffix to prefill, which needs the"
                " chunk-offset entry")
        if num_slots is None:
            num_slots = self._derive_slots(prefix_pages, int(page_size),
                                           machine)
        self.num_slots = int(num_slots)
        if registry is None:
            from ...obs.registry import REGISTRY as registry  # noqa: N813
        self.registry = registry
        self.pool = PagedKVPool(self.num_slots, self.max_len,
                                page_size=page_size, registry=registry,
                                prefix_cache_pages=prefix_pages)
        self.trace_label = str(trace_label) if trace_label \
            else self.pool.label
        self.admission = AdmissionController(
            self.pool,
            self.window if self.prefill_chunk_tokens == 0 else None,
            max_queue=max_queue, queue_pages_budget=queue_pages_budget,
            registry=registry)
        self._register_metrics(registry)

        self._caches = _zero_caches(model, self.num_slots, self.max_len)
        # the prefix cache's band: slot-shaped rows beside the decode
        # caches (JAX `_zero_band`), which decode never carries
        band_slots = self.pool.band_slots
        self._band = _zero_caches(model, band_slots, self.max_len) \
            if band_slots else None
        self._input_name = model.input_ops[0].name
        self._final_guid = model.final_tensor.guid
        self._draft_caches = None
        if draft_model is not None:
            # the draft's slot-dense caches mirror the target's slot for
            # slot (JAX `_zero_draft_caches`)
            self._draft_caches = _zero_caches(draft_model, self.num_slots,
                                              self.max_len)
            self._draft_input = draft_model.input_ops[0].name
            self._draft_final = draft_model.final_tensor.guid
        self.graphs = graph_counts()
        self._build_dispatches()

        self._rid = itertools.count()
        self._queue: List[GenRequest] = []
        self._slots: List[Optional[_Slot]] = [None] * self.num_slots
        self._cv = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._pending_resize: Optional[ResizeTicket] = None
        self._resizes: List[Dict] = []
        # the chaos hook (serving/fleet/chaos.py): called once an
        # iteration with the batcher; it reads `tokens_emitted`
        self.fault_hook = None
        # parked requests awaiting the handoff, the hook the coordinator
        # sets to hear of them, and the export / import steps queued for
        # the scheduler thread (the only thread that touches the caches)
        self._parked: Dict[int, _Slot] = {}
        self.on_parked = None
        self._pending_handoffs: List[tuple] = []
        self._completed = 0
        self._failed = 0
        self.tokens_emitted = 0
        self._decode_iters = 0
        self._decode_s = 0.0
        self._prefill_chunks = 0
        # health signals: a heartbeat stamped at the top of every loop
        # iteration (the idle wait wakes every 0.1 s, so a stale one means
        # a stuck dispatch) and an EWMA of the wall between consecutive
        # iterations that had work, stalls between dispatches included
        self._t_heartbeat: Optional[float] = None
        self._t_iter_prev: Optional[float] = None
        self._iter_had_work = False
        self._ewma_step_s: Optional[float] = None
        self._step_warmup = 0
        # the measured rate model of `predicted_ttft_s`: per-token prefill
        # cost (sampled at synced prefill dispatches: one-shot and the
        # final chunk, which block on the picked token), the draft's (its
        # final chunk, synced), and the decode iteration's wall
        self._ewma_prefill_s_per_tok: Optional[float] = None
        self._ewma_draft_prefill_s_per_tok: Optional[float] = None
        self._ewma_decode_iter_s: Optional[float] = None
        self._ewma_spec_accept: Optional[float] = None
        self._spec_proposed = 0
        self._spec_accepted = 0

    def _build_dispatches(self) -> None:
        """The compiled dispatches over the current caches: static inputs
        and outputs, one graph for the decode iteration (or the
        speculative one) and one per slot for a prefill chunk (and the
        draft's), all in one new graph pool; the caches' per-slot views
        the chunks write through. Built at construction and again after
        a resize, whose new arrays no old graph may replay over."""
        from ...ops.common import emit_dtype

        model = self.model
        vocab = model.final_tensor.dims[-1]
        pdt = emit_dtype(model.config, model.final_tensor.dtype)
        S, C = self.num_slots, self.prefill_chunk_tokens
        weights = model_weights(model)
        pool = new_pool(self.device)
        # per-slot views of the caches: a prefill chunk writes its slot's
        # rows in place through these
        self._slot_caches = _slot_views(self._caches, S)
        self._dec_in = Staging(3 * S, self.device)
        self._dec_probs = torch.zeros((S, vocab), dtype=pdt,
                                      device=self.device)
        self._dec_tok = torch.zeros((S,), dtype=torch.int32,
                                    device=self.device)
        self._decode_call = CapturedCall(self._decode_walk, self.device,
                                         weights, self.graphs, pool)
        if C:
            self._chunk_in = Staging(C + 1, self.device)
            self._chunk_probs = torch.zeros((1, C, vocab), dtype=pdt,
                                            device=self.device)
            self._chunk_calls = [
                CapturedCall(self._chunk_walk(i), self.device, weights,
                             self.graphs, pool) for i in range(S)]
        if self.draft_model is None:
            return
        # the draft's per-slot chunk views and graphs, in the same pool
        self._draft_slot_caches = _slot_views(self._draft_caches, S)
        dweights = model_weights(self.draft_model)
        k = self.spec_tokens
        self._draft_chunk_in = Staging(C + 1, self.device)
        self._draft_chunk_calls = [
            CapturedCall(self._draft_chunk_walk(i), self.device,
                         dweights, self.graphs, pool) for i in range(S)]
        # in: the tokens and positions of every slot; out: the verify
        # probabilities, and per slot the k target picks, the count to
        # emit and the raw accepted count, read back by one copy
        self._spec_in = Staging(2 * S, self.device)
        self._spec_probs = torch.zeros((S, k + 1, vocab), dtype=pdt,
                                       device=self.device)
        self._spec_out = torch.zeros((S, k + 2), dtype=torch.int32,
                                     device=self.device)
        self._spec_call = CapturedCall(self._spec_walk, self.device,
                                       weights + dweights, self.graphs,
                                       pool)

    def _register_metrics(self, registry) -> None:
        """The batcher's metric families (JAX continuous.py:566-674)."""
        label = self.pool.label
        self._g_active = registry.gauge(
            "ff_serving_slots_active", "Decode slots holding a live request",
            labels=("pool",))
        self._g_active.set(0, pool=label)
        self._h_ttft = registry.histogram(
            "ff_serving_ttft_ms",
            "Submit-to-first-token latency, split by prefix-cache outcome",
            labels=("cache",))
        self._h_itl = registry.histogram(
            "ff_serving_itl_ms", "Inter-token latency during decode")
        self._c_requests = registry.counter(
            "ff_serving_requests_total",
            "Continuous-batching requests by outcome", labels=("outcome",))
        self._c_tokens = registry.counter(
            "ff_serving_tokens_total", "Tokens generated")
        self._c_resizes = registry.counter(
            "ff_serving_resizes_total",
            "Applied serving mesh resizes", labels=("direction",))
        self._g_prefill_rate = registry.gauge(
            "ff_serving_prefill_tokens_per_s",
            "Measured prefill rate, EWMA over synced prefill dispatches",
            labels=("pool",))
        self._g_decode_iter = registry.gauge(
            "ff_serving_decode_iter_ms",
            "Measured decode-iteration wall, EWMA", labels=("pool",))
        if self.draft_model is not None:
            self._c_spec_proposed = registry.counter(
                "ff_spec_decode_proposed_total",
                "Draft tokens proposed for verification")
            self._c_spec_accepted = registry.counter(
                "ff_spec_decode_accepted_total",
                "Draft tokens accepted by the target's greedy verify")
            self._g_spec_accept = registry.gauge(
                "ff_spec_decode_acceptance",
                "EWMA draft-token acceptance rate (accepted/proposed)",
                labels=("pool",))
        self._ewma_affinity_overlap: Optional[float] = None
        if self._affinity_probe is not None:
            self._c_affinity = registry.counter(
                "ff_serving_affinity_picks_total",
                "Expert-affine admission picks by outcome",
                labels=("outcome",))
            self._g_affinity_overlap = registry.gauge(
                "ff_serving_affinity_overlap",
                "EWMA expert-signature overlap of admitted requests with"
                " the running batch", labels=("pool",))

    def _derive_slots(self, prefix_pages: int, page_size: int,
                      machine) -> int:
        """JAX continuous.py:534-548: the derived count less the band's
        slots (the band lives in device memory beside the decode slots),
        with a draft scaled by the combined per-token cache cost."""
        from .kvpool import derive_num_slots, kv_bytes_per_token

        full_pages_per_slot = self.max_len // page_size
        if full_pages_per_slot == 0:
            prefix_pages = 0  # no full page fits a slot: nothing cacheable
        band_slots = (math.ceil(prefix_pages / full_pages_per_slot)
                      if prefix_pages else 0)
        derived = derive_num_slots(self.model, self.max_len, machine=machine)
        if self.draft_model is not None:
            tb = kv_bytes_per_token(self.model)
            db = kv_bytes_per_token(self.draft_model)
            derived = max(1, int(derived * tb / max(1, tb + db)))
        return max(1, derived - band_slots)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError(
                    "previous scheduler thread is still draining; cannot"
                    " restart until it exits")
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop accepting work. ACTIVE requests decode to completion;
        QUEUED requests fail with BatcherStopped."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)
            if not t.is_alive():
                self._thread = None
        self._drain_queue(BatcherStopped("batcher stopped"))
        self._fail_pending_resize(BatcherStopped("batcher stopped"))
        self._fail_pending_handoffs(BatcherStopped("batcher stopped"))
        self._fail_parked(BatcherStopped("batcher stopped"))

    def abort(self, err: BaseException) -> None:
        """Non-blocking kill of a replica declared dead: fence every
        slotted request (freezing its emitted tokens for a replay
        elsewhere, `GenRequest._fence`), fail queued work with `err`, and
        release the pool and admission state. Unlike stop() this never
        joins the scheduler thread (it may hang inside a dispatch); the
        thread exits once it sees the batcher stopped, its late emissions
        are fenced no-ops, and start() refuses a second loop meanwhile."""
        with self._cv:
            self._running = False
            slots, self._slots = list(self._slots), [None] * self.num_slots
            self._parked.clear()
            self._cv.notify_all()
        for s in slots:
            if s is None:
                continue
            self.pool.free(s.req.id)
            self.admission.release(s.req.id)
            self._failed += 1
            self._c_requests.inc(outcome="failed")
            s.req._fence(err)
        self._drain_queue(err)
        self._fail_pending_resize(err)
        self._fail_pending_handoffs(err)
        self._g_active.set(0, pool=self.pool.label)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               eos_id: Optional[int] = None, seed: int = 0,
               prefill_only: bool = False) -> GenRequest:
        """Admit one request (prompt_ids: (L,) or (1, L) int tokens).
        Raises an AdmissionError subclass on rejection; otherwise returns
        a GenRequest whose stream()/result() deliver the tokens.

        prefill_only (implied by role='prefill'): the request prefills,
        emits its first token and PARKS for the KV handoff
        (`request_export`, `release_parked`, `resume_parked`)."""
        prefill_only = bool(prefill_only) or self.role == "prefill"
        if prefill_only and self.draft_model is not None:
            raise ValueError(
                "prefill_only cannot speculate: the draft's caches do"
                " not ship in the KV handoff")
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1:
            raise ValueError(
                "continuous batching takes ONE prompt per request —"
                f" expected shape (L,) or (1, L), got {prompt.shape}")
        if self._vocab is not None and prompt.size and (
                prompt.min() < 0 or prompt.max() >= self._vocab):
            raise ValueError(
                f"prompt token ids must lie in [0, {self._vocab})")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}: need >= 1")
        rid = next(self._rid)
        # expected prefix sharing, credited against the backlog budget (a
        # probe, not a pin: the match is made when the request is
        # scheduled)
        shared_pages = 0
        if self.pool.prefix is not None:
            matched, _ = self.pool.prefix.match(prompt)
            shared_pages = min(matched, prompt.size - 1) // self.pool.page_size
        # the expert signature outside the lock: one small host matmul
        sig = (self._affinity_probe.signature(prompt)
               if self._affinity_probe is not None else frozenset())
        tracer = get_tracer()
        with self._cv:
            if not self._running:
                raise BatcherStopped("batcher is not running")
            with tracer.span("serve.admit", request=rid):
                self.admission.admit(rid, prompt.size, max_new_tokens,
                                     shared_pages=shared_pages)
            req = GenRequest(rid, prompt, max_new_tokens, eos_id, seed)
            req.prefill_only = prefill_only
            # the caller's context as an explicit handoff, which the
            # scheduler thread resumes (None while tracing is off)
            req.trace = tracer.handoff("serve.submit")
            req.expert_sig = sig
            self._queue.append(req)
            self._cv.notify_all()
        return req

    def cancel(self, req: GenRequest) -> bool:
        """Best-effort cancel of a STILL-QUEUED request: removes it from
        the wait queue, releases its admission reservation and fails it
        with RequestCancelled. Returns False once the request reached a
        slot (or finished): scheduled work runs to completion."""
        with self._cv:
            try:
                self._queue.remove(req)
            except ValueError:
                return False
        self.admission.release(req.id)
        self._failed += 1
        self._c_requests.inc(outcome="cancelled")
        req._fail(RequestCancelled(f"request {req.id} cancelled"))
        return True

    def prefix_probe(self, prompt_ids) -> int:
        """Tokens of the prompt this batcher's prefix cache would install
        (a probe: no pin, no hit or miss counted; 0 with the cache off)."""
        if self.pool.prefix is None:
            return 0
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        matched, _ = self.pool.prefix.match(prompt)
        return int(min(matched, max(prompt.size - 1, 0)))

    def prefix_probe_chain(self, chain, prompt_len: int) -> int:
        """`prefix_probe` against a precomputed `prefix_route_chain`."""
        if self.pool.prefix is None or not chain:
            return 0
        matched = self.pool.prefix.match_chain(chain) * self.pool.page_size
        return int(min(matched, max(int(prompt_len) - 1, 0)))

    def request_resize(self, num_slots: Optional[int] = None,
                       machine=None) -> ResizeTicket:
        """Resize the serving mesh's capacity under load (JAX
        `request_resize`): an explicit slot target, or a machine model
        (the grown or shrunk mesh's) from which `derive_num_slots` makes
        it, less the prefix band's slots. The scheduler applies it
        between iterations (see the module docstring). Returns a
        ResizeTicket; `.wait()` blocks until it is applied."""
        if num_slots is None and machine is None:
            raise ValueError("give num_slots or a machine spec")
        if num_slots is None:
            from .kvpool import derive_num_slots

            num_slots = max(1, derive_num_slots(self.model, self.max_len,
                                                machine=machine)
                            - self.pool.band_slots)
        target = int(num_slots)
        if target < 1:
            raise ValueError(f"num_slots={target}: need >= 1")
        ticket = ResizeTicket(target)
        with self._cv:
            if not self._running:
                raise BatcherStopped("batcher is not running")
            if (self._pending_resize is not None
                    and not self._pending_resize.done()):
                raise RuntimeError("a resize is already pending")
            self._pending_resize = ticket
            self._cv.notify_all()
        return ticket

    # -- the disaggregated KV handoff (JAX continuous.py:1238-1460) ---------
    def parked_requests(self) -> List[GenRequest]:
        with self._cv:
            return [s.req for s in self._parked.values()]

    def request_export(self, req: GenRequest) -> HandoffTicket:
        """Queue the export of a PARKED request's rows to host memory. The
        ticket resolves with {"desc", "rows", "plen", "last_tok",
        "bytes", "wall_ms"}: `desc` is the pool's descriptor
        (`PagedKVPool.export_sequence`), `rows` maps "op/part" to the
        (plen, heads, dim) host array of the rows the page table owns
        (bf16 as its bits, int16). The request STAYS parked, so a failed
        ship can still resume_parked with nothing lost."""
        ticket = HandoffTicket()
        with self._cv:
            if not self._running:
                raise BatcherStopped("batcher is not running")
            self._pending_handoffs.append(("export", ticket, req))
            self._cv.notify_all()
        return ticket

    def request_import(self, desc: Dict, rows: Dict, prompt,
                       last_tok: int, max_new_tokens: int,
                       eos_id: Optional[int] = None, seed: int = 0,
                       trace=None) -> HandoffTicket:
        """Queue the import of a shipped sequence as a request entering
        DECODE with nothing recomputed: `max_new_tokens` is the REMAINING
        budget (the prefill side emitted the first token), `last_tok`
        feeds the first decode step. The ticket resolves with the new
        GenRequest, or fails typed: an AdmissionError where this replica
        sheds, `KVGeometryMismatch` where the exporter's geometry
        differs."""
        ticket = HandoffTicket()
        payload = {"desc": desc, "rows": rows,
                   "prompt": np.asarray(prompt, np.int32),
                   "last_tok": int(last_tok),
                   "max_new_tokens": int(max_new_tokens),
                   "eos_id": eos_id, "seed": int(seed), "trace": trace}
        with self._cv:
            if not self._running:
                raise BatcherStopped("batcher is not running")
            self._pending_handoffs.append(("import", ticket, payload))
            self._cv.notify_all()
        return ticket

    def resume_parked(self, req: GenRequest) -> bool:
        """The fall-back of every failed handoff: a PARKED request decodes
        here after all. False once it is no longer parked."""
        with self._cv:
            s = self._parked.pop(req.id, None)
            if s is None or req.state is not RequestState.PARKED:
                return False
            req.state = RequestState.DECODE
            self._cv.notify_all()
        return True

    def release_parked(self, req: GenRequest) -> bool:
        """The handoff committed on the decode side: free the parked
        request's slot, pages and reservation here and close its local
        handle with RequestCancelled (not a clean finish, which would read
        as a whole one-token answer; the fleet handle has rebound to the
        decode side and waits for it). False once it is no longer
        parked."""
        with self._cv:
            s = self._parked.pop(req.id, None)
            if s is None:
                return False
            self._slots[s.slot] = None
        self.pool.free(req.id)
        self.admission.release(req.id)
        self._completed += 1
        self._c_requests.inc(outcome="handed_off")
        self._sync_active_gauge()
        req._fail(RequestCancelled(
            f"request {req.id} handed off to a decode replica"))
        with self._cv:
            self._cv.notify_all()
        return True

    def _runnable_locked(self) -> bool:
        """Any slot that still schedules work (the caller holds _cv):
        PARKED slots hold pages but neither prefill nor decode."""
        return any(s is not None and s.req.state is not RequestState.PARKED
                   for s in self._slots)

    def _process_handoffs(self, tracer) -> None:
        """The queued export and import steps (scheduler thread). A failed
        step fails its own ticket."""
        with self._cv:
            work, self._pending_handoffs = self._pending_handoffs, []
        for kind, ticket, payload in work:
            try:
                if kind == "export":
                    ticket._finish(self._export_parked(payload, tracer))
                else:
                    ticket._finish(self._import_one(tracer, **payload))
            except Exception as e:
                ticket._fail(e)

    def _export_parked(self, req: GenRequest, tracer) -> Dict:
        """A parked request's owned rows, `cache[slot, :plen]` of every
        cache, copied into pinned host memory; waits on the copies' own
        event, not on the device."""
        with self._cv:
            s = self._parked.get(req.id)
        if s is None or req.state is not RequestState.PARKED:
            raise KeyError(f"request {req.id} is not parked")
        desc = self.pool.export_sequence(req.id)
        plen = int(s.plen)
        t0 = time.monotonic()
        with tracer.resume(req.trace), \
                tracer.span("serve.kv_export", request=req.id, tokens=plen):
            host = {}
            for name, pair in self._caches.items():
                for part, arr in pair.items():
                    src = arr[s.slot, :plen]
                    if self.device.type == "cuda":
                        dst = torch.empty(src.shape, dtype=src.dtype,
                                          pin_memory=True)
                        dst.copy_(src, non_blocking=True)
                    else:
                        dst = src.clone()
                    host[f"{name}/{part}"] = dst
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                done.synchronize()
            rows = {key: _host_array(t) for key, t in host.items()}
        return {"desc": desc, "rows": rows, "plen": plen,
                "last_tok": int(s.last_tok),
                "bytes": int(sum(r.nbytes for r in rows.values())),
                "wall_ms": (time.monotonic() - t0) * 1e3}

    def _import_one(self, tracer, desc, rows, prompt, last_tok,
                    max_new_tokens, eos_id, seed, trace) -> GenRequest:
        """A shipped sequence as a request entering DECODE (scheduler
        thread; see request_import)."""
        plen = int(desc["n_tokens"])
        for name, pair in self._caches.items():
            for part, arr in pair.items():
                src = rows.get(f"{name}/{part}")
                want = (plen,) + tuple(int(d) for d in arr.shape[2:])
                if src is None or tuple(src.shape) != want:
                    raise KVGeometryMismatch(
                        f"kv_rows[{name}/{part}]",
                        None if src is None else tuple(src.shape), want)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens}: an import with no"
                " remaining budget has nothing to decode")
        rid = next(self._rid)
        self.admission.admit(rid, plen, max_new_tokens)
        try:
            slot_idx = self.pool.import_sequence(desc, seq_id=rid)
        except BaseException:
            self.admission.release(rid)
            raise
        req = GenRequest(rid, np.asarray(prompt, np.int32), max_new_tokens,
                         eos_id, seed)
        req.trace = trace
        # the KV arrived whole: no prefill leg to charge it
        req.cache_hit = True
        req.prefix_tokens = plen
        req.queue_wait_s = self.admission.on_scheduled(rid)
        s = _Slot(req, slot_idx)  # the key from the seed, as submit's
        s.plen = s.filled = s.pos = plen
        s.last_tok = int(last_tok)
        with tracer.resume(trace), \
                tracer.span("serve.kv_import", request=rid, tokens=plen):
            # in place: the captured graphs read these very tensors
            for name, pair in self._caches.items():
                for part, arr in pair.items():
                    arr[slot_idx, :plen].copy_(_device_rows(
                        rows[f"{name}/{part}"], arr.dtype))
        req.state = RequestState.DECODE
        req.t_first_token = time.monotonic()
        with self._cv:
            self._slots[slot_idx] = s
            self._cv.notify_all()
        self._sync_active_gauge()
        return req

    def _fail_pending_handoffs(self, err: BaseException) -> None:
        with self._cv:
            work, self._pending_handoffs = self._pending_handoffs, []
        for _, ticket, _ in work:
            if not ticket.done():
                ticket._fail(err)

    def _fail_parked(self, err: BaseException) -> None:
        """Fail every request still parked (stop): fenced, so a fleet
        replay sees the frozen first token, its pool and admission state
        released."""
        with self._cv:
            parked, self._parked = dict(self._parked), {}
            for s in parked.values():
                if self._slots[s.slot] is s:
                    self._slots[s.slot] = None
        for s in parked.values():
            self.pool.free(s.req.id)
            self.admission.release(s.req.id)
            self._failed += 1
            self._c_requests.inc(outcome="failed")
            s.req._fence(err)
        if parked:
            self._sync_active_gauge()

    # -- the measured rate model and the health probes ---------------------
    # (JAX continuous.py:1475-1706): read-only, no device state touched
    _EWMA_ALPHA = 0.25
    _STEP_EWMA_ALPHA = 0.3
    _STEP_WARMUP = 2

    def _observe_prefill(self, n_tokens: int, dt: float) -> None:
        """One synced prefill dispatch covered `n_tokens` in `dt`
        seconds."""
        if n_tokens <= 0 or dt <= 0:
            return
        sample = dt / n_tokens
        old = self._ewma_prefill_s_per_tok
        self._ewma_prefill_s_per_tok = sample if old is None else \
            (1 - self._EWMA_ALPHA) * old + self._EWMA_ALPHA * sample
        self._g_prefill_rate.set(
            1.0 / self._ewma_prefill_s_per_tok, pool=self.pool.label)

    def _observe_draft_prefill(self, n_tokens: int, dt: float) -> None:
        """One synced DRAFT prefill chunk covered `n_tokens` in `dt`
        seconds: the cost speculation adds to every prompt token."""
        if n_tokens <= 0 or dt <= 0:
            return
        sample = dt / n_tokens
        old = self._ewma_draft_prefill_s_per_tok
        self._ewma_draft_prefill_s_per_tok = sample if old is None else \
            (1 - self._EWMA_ALPHA) * old + self._EWMA_ALPHA * sample

    def _observe_decode_iter(self, dt: float) -> None:
        """One decode iteration took `dt` seconds of wall. The EWMA is
        the raw wall a speculative iteration takes too: speculation
        enters `predicted_ttft_s` only as a cap on how many walls a
        prefill can collide with (`_decode_drain_iterations`)."""
        if dt <= 0:
            return
        old = self._ewma_decode_iter_s
        self._ewma_decode_iter_s = dt if old is None else \
            (1 - self._EWMA_ALPHA) * old + self._EWMA_ALPHA * dt
        self._g_decode_iter.set(self._ewma_decode_iter_s * 1e3,
                                pool=self.pool.label)

    def scheduler_alive(self) -> bool:
        """True while the scheduler thread exists and runs; False after a
        crash or a clean stop."""
        t = self._thread
        return t is not None and t.is_alive()

    def heartbeat_age_s(self) -> Optional[float]:
        """Seconds since the scheduler last passed the top of its loop
        (None before its first iteration). The idle wait wakes at least
        every 0.1 s, so an age of seconds means a hung dispatch or a
        stalled host thread, never an empty queue."""
        t = self._t_heartbeat
        return None if t is None else max(0.0, time.monotonic() - t)

    def step_latency_s(self) -> Optional[float]:
        """EWMA wall between consecutive busy scheduler iterations (None
        until warmed up): the straggler signal."""
        return self._ewma_step_s

    def reset_latency(self) -> None:
        """Forget the step-latency baseline and re-enter warm-up (after a
        respawn, whose first iterations capture graphs)."""
        self._ewma_step_s = None
        self._step_warmup = 0
        self._t_iter_prev = None

    def _observe_step_gap(self, dt: float) -> None:
        if dt <= 0:
            return
        if self._step_warmup < self._STEP_WARMUP:
            self._step_warmup += 1
            return
        old = self._ewma_step_s
        self._ewma_step_s = dt if old is None else \
            (1 - self._STEP_EWMA_ALPHA) * old + self._STEP_EWMA_ALPHA * dt

    def prefill_backlog_s(self) -> float:
        """Queued prefill work in seconds at the measured prefill rate
        (0.0 until the EWMA has a sample)."""
        per_tok = self._ewma_prefill_s_per_tok
        if per_tok is None:
            return 0.0
        return self.queued_prefill_tokens() * per_tok

    def queued_prefill_tokens(self) -> int:
        """Prompt tokens admitted but not yet prefilled: the whole queue
        plus the unfilled rest of every slot still prefilling."""
        with self._cv:
            backlog = sum(int(r.prompt.size) for r in self._queue)
            for s in self._slots:
                if s is not None and s.req.state is RequestState.PREFILL:
                    backlog += max(0, s.plen - s.filled)
        return backlog

    def predicted_ttft_s(self, prompt_len: int,
                         shared_tokens: int = 0) -> float:
        """Predicted time to first token of a NEW request of `prompt_len`
        tokens, from the measured rate model:

            (backlog + own) tokens x EWMA per-token prefill cost
          + ceil((backlog + own) / chunk) x EWMA decode-iteration wall

        own = prompt minus the `shared_tokens` the prefix cache would
        install. Chunked prefill runs one decode iteration between chunks
        while anything decodes, so each pending chunk costs a decode wall.
        With a draft, the prefill leg also charges every prompt token
        (own and backlog, no prefix credit: the draft prefills it all) at
        the draft's measured per-token cost (the target's until the
        draft has a sample), and the interleave leg charges no more walls
        than the decode drain horizon. A batcher with no samples predicts
        0. own = 0 (the KV is all installed, or imported) pays one decode
        wall; a role='prefill' replica charges no decode leg (nothing
        decodes there)."""
        own = max(0, int(prompt_len) - max(0, int(shared_tokens)))
        backlog = self.queued_prefill_tokens()
        total = own + backlog
        per_tok = self._ewma_prefill_s_per_tok
        t = total * per_tok if per_tok is not None else 0.0
        if self.draft_model is not None:
            draft_per_tok = self._ewma_draft_prefill_s_per_tok
            if draft_per_tok is None:
                draft_per_tok = per_tok
            if draft_per_tok is not None:
                t += (int(prompt_len) + backlog) * draft_per_tok
        chunk = self.prefill_chunk_tokens
        iter_s = self._ewma_decode_iter_s
        if own == 0 and iter_s is not None:
            t += iter_s
        if chunk and iter_s is not None and self.role != "prefill":
            with self._cv:
                interleaved = len(self._queue) > 0 or any(
                    s is not None and s.req.state is RequestState.DECODE
                    for s in self._slots)
            if interleaved:
                iters = math.ceil(total / chunk)
                if self.spec_tokens:
                    iters = min(iters, self._decode_drain_iterations())
                t += iters * iter_s
        return t

    def _decode_drain_iterations(self) -> int:
        """Decode iterations left before every live request's budget
        drains at the measured accepted-token rate (k_eff = 1 +
        acceptance x spec_tokens, at most spec_tokens): the longest
        budget over k_eff, or the total over the pool's slots x k_eff if
        larger (queued requests count at their full budget)."""
        k_eff = 1.0
        if self.spec_tokens:
            acc = self._ewma_spec_accept or 0.0
            k_eff = min(float(self.spec_tokens),
                        1.0 + acc * self.spec_tokens)
        k_eff = max(1.0, k_eff)
        with self._cv:
            budgets = [s.req.max_new_tokens - s.emitted
                       for s in self._slots if s is not None]
            budgets += [r.max_new_tokens for r in self._queue]
        budgets = [b for b in budgets if b > 0]
        if not budgets:
            return 0
        longest = math.ceil(max(budgets) / k_eff)
        pooled = math.ceil(sum(budgets) / (max(1, self.num_slots) * k_eff))
        return max(longest, pooled)

    def stats(self) -> Dict[str, object]:
        """The JAX batcher's `stats()` keys, and the port's dispatch
        counts:
        "graphs" holds the warm-ups, captures and replays, and the walks
        run outside any graph (on the card: the one-shot prefills)."""
        with self._cv:
            active = sum(1 for s in self._slots if s is not None)
            queued = len(self._queue)
            parked = len(self._parked)
        out = {
            "queue_depth": queued,
            "slots_active": active,
            "role": self.role,
            "parked": parked,
            "completed": self._completed,
            "failed": self._failed,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "num_slots": self.num_slots,
            "prefill_s_per_token": self._ewma_prefill_s_per_tok,
            "draft_prefill_s_per_token": self._ewma_draft_prefill_s_per_tok,
            "decode_iter_s": self._ewma_decode_iter_s,
            "step_latency_s": self._ewma_step_s,
            "tokens_emitted": self.tokens_emitted,
            "queued_prefill_tokens": self.queued_prefill_tokens(),
            "resizes": list(self._resizes),
            "pool": self.pool.stats(),
            "admission": self.admission.stats(),
            "prefill_chunks": self._prefill_chunks,
            "decode_iterations": self._decode_iters,
            "decode_iter_s_mean": (self._decode_s / self._decode_iters
                                   if self._decode_iters else None),
            "graphs": dict(self.graphs),
        }
        if self.draft_model is not None:
            out["spec"] = {
                "tokens": self.spec_tokens,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "acceptance": (self._spec_accepted / self._spec_proposed
                               if self._spec_proposed else 0.0),
                "acceptance_ewma": self._ewma_spec_accept,
            }
        if self._affinity_probe is not None:
            out["affinity"] = {
                "window": self.affinity_window,
                "overlap_ewma": self._ewma_affinity_overlap,
                "picks": {outcome: int(v) for (outcome,), v
                          in self._c_affinity.items()},
            }
        return out

    # -- device steps --------------------------------------------------------
    def _decode_walk(self) -> None:
        """The decode iteration from the static input (tokens, positions,
        key bits of every slot) into the static probabilities and picked
        tokens."""
        S = self.num_slots
        buf = self._dec_in.buf
        pos = buf[S:2 * S]
        probs = self.model.executor.forward_values(
            {self._input_name: buf[:S].view(S, 1)}, state=self._caches,
            decode_pos=pos)[self._final_guid][:, 0, :]
        self._dec_probs.copy_(probs)
        self._dec_tok.copy_(pick_tokens(probs, self.temperature, self.top_k,
                                        buf[2 * S:], pos))

    def _chunk_walk(self, slot: int):
        """Slot `slot`'s prefill chunk from the static input (C tokens,
        then the offset) into the static probabilities."""
        def walk() -> None:
            C = self.prefill_chunk_tokens
            buf = self._chunk_in.buf
            self._chunk_probs.copy_(self.model.executor.forward_values(
                {self._input_name: buf[:C].view(1, C)},
                state=self._slot_caches[slot],
                decode_pos=buf[C])[self._final_guid])
        return walk

    def _draft_chunk_walk(self, slot: int):
        """The draft's prefill chunk of slot `slot` from its static input
        (C tokens, then the offset); only its K/V rows matter."""
        def walk() -> None:
            C = self.prefill_chunk_tokens
            buf = self._draft_chunk_in.buf
            self.draft_model.executor.forward_values(
                {self._draft_input: buf[:C].view(1, C)},
                state=self._draft_slot_caches[slot], decode_pos=buf[C])
        return walk

    def _spec_walk(self) -> None:
        """The speculative iteration (JAX `spec_decode_all`) from the
        static input (tokens, positions of every slot): k greedy draft
        steps, step j at pos + j, then the target over [token, k
        proposals] at pos, the accept, into the static probabilities and
        (k target picks, count to emit, raw accepted count) a slot."""
        S, k = self.num_slots, self.spec_tokens
        buf = self._spec_in.buf
        toks, pos = buf[:S], buf[S:2 * S]
        draft = self.draft_model.executor
        cur, props = toks, []
        for j in range(k):
            probs = draft.forward_values(
                {self._draft_input: cur.view(S, 1)},
                state=self._draft_caches,
                decode_pos=pos + j)[self._draft_final]
            cur = pick_tokens(probs[:, 0, :], 0.0, None, None, None).to(
                torch.int32)
            props.append(cur)
        props = torch.stack(props, dim=1)                       # (S, k)
        probs = self.model.executor.forward_values(
            {self._input_name: torch.cat([toks.view(S, 1), props], dim=1)},
            state=self._caches, decode_pos=pos)[self._final_guid]
        self._spec_probs.copy_(probs)                           # (S, k+1, V)
        tgt = pick_tokens(probs.reshape(S * (k + 1), -1), 0.0, None, None,
                          None).view(S, k + 1)[:, :k]
        # proposal j survives while every proposal up to it matched the
        # target's own pick at that position
        n_acc = torch.cumprod((props == tgt).to(torch.int32), dim=1).sum(1)
        out = self._spec_out
        out[:, :k].copy_(tgt)
        out[:, k].copy_(torch.clamp(n_acc + 1, max=k))
        out[:, k + 1].copy_(n_acc)

    def _decode_dispatch(self, host: np.ndarray) -> np.ndarray:
        """One decode iteration: host (3 * num_slots,) int32 holds the
        tokens, positions and key bits; returns the picked tokens. The
        static probabilities hold until the next decode dispatch."""
        self._dec_in.put(host)
        self._decode_call()
        return self._dec_tok.cpu().numpy()  # syncs the device

    def _spec_dispatch(self, host: np.ndarray) -> np.ndarray:
        """One speculative iteration: host (2 * num_slots,) int32 holds
        the tokens and positions; returns (num_slots, k + 2) int32: the k
        target picks, the count to emit, the raw accepted count. The
        static probabilities hold until the next one."""
        self._spec_in.put(host)
        self._spec_call()
        return self._spec_out.cpu().numpy()  # syncs the device

    def _chunk_dispatch(self, slot: int, host: np.ndarray) -> None:
        """One prefill chunk of `slot`: host (C + 1,) int32, the chunk's
        tokens then its offset. The static probabilities hold until the
        next chunk dispatch."""
        self._chunk_in.put(host)
        self._chunk_calls[slot]()

    def _pick_row(self, row: torch.Tensor, s: _Slot, pos: int) -> int:
        """The token after position `pos` from one (V,) distribution."""
        keys = pos_t = None
        if self.temperature > 0.0:
            keys = torch.from_numpy(key_bits([s.key])).to(row.device)
            pos_t = torch.tensor([pos], dtype=torch.int32, device=row.device)
        return int(pick_tokens(row[None], self.temperature, self.top_k,
                               keys, pos_t)[0])

    # -- scheduler loop ----------------------------------------------------
    def _loop(self) -> None:
        get_tracer().set_thread_name(self.trace_label)
        try:
            with torch.no_grad(), (torch.cuda.device(self.device)
                                   if self.device.type == "cuda"
                                   else contextlib.nullcontext()):
                self._run()
        except BaseException as e:  # scheduler died: fail everything
            self._fail_all(e)
        finally:
            self._g_active.set(0, pool=self.pool.label)

    def _run(self) -> None:
        tracer = get_tracer()
        while True:
            with self._cv:
                # PARKED slots hold KV for the handoff but schedule
                # nothing: they neither keep the loop busy nor hold a stop
                while (self._running and not self._queue
                       and not self._runnable_locked()
                       and self._pending_resize is None
                       and not self._pending_handoffs):
                    # an idle loop is a healthy one: stamp the heartbeat
                    # on every wake
                    self._t_heartbeat = time.monotonic()
                    self._cv.wait(timeout=0.1)
                if not self._running and not self._runnable_locked():
                    break
                running = self._running

            # health: the heartbeat, and the gap since the last iteration
            # that had work (stalls between dispatches count)
            now = time.monotonic()
            self._t_heartbeat = now
            if self._iter_had_work and self._t_iter_prev is not None:
                self._observe_step_gap(now - self._t_iter_prev)
            self._t_iter_prev = now
            self._iter_had_work = bool(self._queue) or any(self._slots)
            hook = self.fault_hook
            if hook is not None:
                hook(self)

            # 0) a pending resize (a shrink waits until the live
            #    sequences fit; admissions are held meanwhile)
            if self._pending_resize is not None:
                self._maybe_resize(tracer)
            S = self.num_slots

            # 0b) queued handoff steps (export parked rows, import shipped
            #     ones)
            if self._pending_handoffs:
                self._process_handoffs(tracer)

            # 1) move queued requests into free slots (skipped once
            #    stopping: queued requests fail in stop()); one-shot mode
            #    prefills them here, chunked mode installs any cached
            #    prefix
            if running:
                self._admit_new()

            # 2) one prefill chunk per PREFILLING slot, interleaved with
            #    decode
            self._step_prefills()

            # 3) one decode iteration over all DECODING slots
            active = [s for s in self._slots if s is not None
                      and s.req.state is RequestState.DECODE]
            if not active:
                continue
            host = np.zeros(3 * S, np.int32)
            toks, pos, keys = host[:S], host[S:2 * S], host[2 * S:]
            for s in self._slots:
                if s is not None and s.req.state is not RequestState.DECODE:
                    # the decode dispatch writes K/V rows from `pos` on for
                    # EVERY slot (k + 1 of them speculating). A slot still
                    # prefilling must not take those dummy writes inside
                    # its prompt rows, in either model's cache: aim them
                    # past both models' filled rows, which later chunks or
                    # decode overwrite before any query attends them
                    pos[s.slot] = min(max(s.filled, s.draft_filled),
                                      self.max_len - 1)
            for s in active:
                if s.shared and s.pos < s.shared:
                    # copy-on-write break: a write inside pages the sequence
                    # still shares (unreachable with page-aligned matching,
                    # decode writes at pos >= plen > shared; enforced)
                    self.pool.prefix.cow_break(s.req.id, s.pos)
                    s.shared = (s.pos // self.pool.page_size
                                ) * self.pool.page_size
                toks[s.slot] = s.last_tok
                pos[s.slot] = s.pos
                keys[s.slot] = key_bits([s.key])[0]
            if self.spec_tokens:
                self._spec_iterate(active, host[:2 * S])
                continue
            with self._iteration_span(tracer, "serve.decode", active):
                t0 = time.monotonic()
                picked = self._decode_dispatch(host)
                dt = time.monotonic() - t0
            self._decode_s += dt
            self._decode_iters += 1
            self._observe_decode_iter(dt)
            now = time.monotonic()
            for s in active:
                self._h_itl.observe((now - s.t_last_emit) * 1e3)
                s.t_last_emit = now
                self.pool.extend(s.req.id, 1)
                s.pos += 1
                self._emit_token(s, int(picked[s.slot]))

    @staticmethod
    def _iteration_span(tracer, name: str, active: List[_Slot], **args):
        """An iteration's span over the slots it steps (one attribute
        check while tracing is off)."""
        if not tracer.enabled:
            return _NULL_SPAN
        return tracer.span(name, slots=len(active),
                           requests=[s.req.id for s in active], **args)

    def _spec_iterate(self, active: List[_Slot], host: np.ndarray) -> None:
        """One speculative iteration (JAX `_spec_iterate`): the fused
        draft-propose and verify dispatch, then each slot's accepted
        tokens emitted on the host. A slot's position advances only over
        what it emits; rejected rows are left for later writes."""
        k = self.spec_tokens
        with self._iteration_span(get_tracer(), "serve.spec_verify", active,
                                  k=k):
            t0 = time.monotonic()
            out = self._spec_dispatch(host)
            dt = time.monotonic() - t0
        self._decode_s += dt
        self._decode_iters += 1
        # acceptance counts raw verify matches (a perfect draft reads 1.0),
        # but only of proposals that could still matter: a slot with r
        # tokens of budget left can use at most r - 1 of them
        proposed = accepted = 0
        for s in active:
            useful = min(k, s.req.max_new_tokens - s.emitted - 1)
            if useful <= 0:
                continue
            proposed += useful
            accepted += min(int(out[s.slot, k + 1]), useful)
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._c_spec_proposed.inc(proposed)
        self._c_spec_accepted.inc(accepted)
        if proposed:
            rate = accepted / proposed
            old = self._ewma_spec_accept
            self._ewma_spec_accept = rate if old is None else \
                (1 - self._EWMA_ALPHA) * old + self._EWMA_ALPHA * rate
            self._g_spec_accept.set(self._ewma_spec_accept,
                                    pool=self.pool.label)
        self._observe_decode_iter(dt)
        now = time.monotonic()
        for s in active:
            for i in range(int(out[s.slot, k])):
                self._h_itl.observe((now - s.t_last_emit) * 1e3)
                s.t_last_emit = now
                self.pool.extend(s.req.id, 1)
                s.pos += 1
                self._emit_token(s, int(out[s.slot, i]))
                if s.req.state is not RequestState.DECODE:
                    break  # retired (EOS or budget): the rest is past the end

    def _maybe_resize(self, tracer) -> None:
        """Apply the pending resize (scheduler thread only; JAX
        `_maybe_resize`): gated and priced before any device work, then
        the owned rows into new arrays, the dispatches rebuilt over them
        (see the module docstring)."""
        ticket = self._pending_resize
        if ticket is None:  # failed by stop() or abort() meanwhile
            return
        target = ticket.target_slots
        if target == self.num_slots:
            with self._cv:
                self._pending_resize = None
            ticket._finish({"from": target, "to": target,
                            "direction": "noop", "migrated_rows": 0,
                            "in_flight": 0, "predicted_us": 0.0,
                            "wall_ms": 0.0, "noop": True})
            return
        if self.pool.live_sequences() > target:
            return  # a shrink waits until enough sequences finish
        direction = "shrink" if target < self.num_slots else "grow"
        t0 = time.monotonic()
        with tracer.span("serve.resize", slots_from=self.num_slots,
                         slots_to=target) as sp:
            from ...analysis import PlanAnalysisError, check_redistribution
            from ...resharding import (leaf_itemsize, plan_slot_migration,
                                       schedule_cost_us)
            from ...search.machine_model import make_machine_model
            from .kvpool import PoolExhausted

            # the draft's caches ride the same migration: the same slot
            # map and owned rows (draft row p mirrors target row p)
            cache_sets = [("kv", self._caches)]
            if self._draft_caches is not None:
                cache_sets.append(("draft_kv", self._draft_caches))
            kv_shapes = {
                f"{tag}/{name}/{part}": (tuple(arr.shape),
                                         leaf_itemsize(arr.dtype))
                for tag, caches in cache_sets
                for name, pair in caches.items()
                for part, arr in pair.items()}
            live = [s for s in self._slots if s is not None]
            n_rows = sum(hi - lo for s in live
                         for _, lo, hi in self.pool.owned_view(s.req.id))
            machine = make_machine_model(
                self.model.config, max(1, self.model.config.total_devices))
            schedule = plan_slot_migration(kv_shapes, self.num_slots,
                                           target, n_rows)
            try:
                check_redistribution(schedule, machine=machine)
            except PlanAnalysisError as err:
                with self._cv:
                    self._pending_resize = None
                ticket._fail(err)
                return
            predicted_us = schedule_cost_us(schedule, machine)
            try:
                moves = self.pool.resize(target)
            except PoolExhausted:
                return  # a request landed since the check: wait again
            # row coordinates, made ONLY from what the page tables own
            src_sl, dst_sl, rows = [], [], []
            slot_map: Dict[object, int] = {}
            for seq_id, old_slot, new_slot, n_pages in moves:
                slot_map[seq_id] = new_slot
                owned = 0
                for slot, lo, hi in self.pool.owned_view(seq_id):
                    # every copied row lies in a page the sequence owns
                    assert slot == new_slot and hi <= self.max_len, \
                        (seq_id, slot, new_slot, lo, hi)
                    src_sl += [old_slot] * (hi - lo)
                    dst_sl += [new_slot] * (hi - lo)
                    rows += range(lo, hi)
                    owned += hi - lo
                assert owned <= n_pages * self.pool.page_size, \
                    (seq_id, owned, n_pages)
            copied = len(rows)
            idx = [torch.tensor(a, dtype=torch.long, device=self.device)
                   for a in (src_sl, rows, dst_sl)]

            def migrate(old_caches):
                new_caches: Dict[str, Dict[str, torch.Tensor]] = {}
                for name, pair in old_caches.items():
                    new_caches[name] = {}
                    for part, arr in pair.items():
                        buf = torch.zeros((target,) + tuple(arr.shape[1:]),
                                          dtype=arr.dtype, device=arr.device)
                        if copied:
                            buf[idx[2], idx[1]] = arr[idx[0], idx[1]]
                        new_caches[name][part] = buf
                return new_caches

            new_caches = migrate(self._caches)
            new_draft = (migrate(self._draft_caches)
                         if self._draft_caches is not None else None)
            moved = copied * sum(
                arr[0, 0].numel() * arr.element_size()
                for _, caches in cache_sets for pair in caches.values()
                for arr in pair.values())
            with self._cv:
                self._caches = new_caches
                self._draft_caches = new_draft
                new_slots: List[Optional[_Slot]] = [None] * target
                for s in live:
                    s.slot = slot_map[s.req.id]
                    new_slots[s.slot] = s
                self._slots = new_slots
                prev = self.num_slots
                self.num_slots = target
                # every graph was captured over the old arrays
                self._build_dispatches()
                self._pending_resize = None
            result = {
                "from": prev, "to": target, "direction": direction,
                "migrated_rows": copied, "in_flight": len(moves),
                "predicted_us": round(float(predicted_us), 2),
                "bytes_moved": int(moved),
                "wall_ms": round((time.monotonic() - t0) * 1e3, 3),
            }
            self._resizes.append(result)
            self._c_resizes.inc(direction=direction)
            sp.set(**result)
        ticket._finish(result)
        with self._cv:
            self._cv.notify_all()

    def _fail_pending_resize(self, err: BaseException) -> None:
        with self._cv:
            ticket, self._pending_resize = self._pending_resize, None
        if ticket is not None and not ticket.done():
            ticket._fail(err)

    def _pop_next_locked(self) -> GenRequest:
        """The next request off the queue (the caller holds self._cv):
        FIFO, or with expert-affine admission the best signature-overlap
        pick within the window (affinity.py), counted by outcome, the
        winner's overlap folded into the EWMA gauge (JAX
        `_pop_next_locked`)."""
        if self._affinity_probe is None or len(self._queue) < 2:
            return self._queue.pop(0)
        from .affinity import pick_affine

        active = [s.req.expert_sig for s in self._slots
                  if s is not None and s.req.expert_sig]
        idx, outcome, frac = pick_affine(self._queue, active,
                                         self.affinity_window)
        for passed in self._queue[:idx]:
            passed.affinity_skips += 1
        req = self._queue.pop(idx)
        self._c_affinity.inc(outcome=outcome)
        old = self._ewma_affinity_overlap
        self._ewma_affinity_overlap = frac if old is None else \
            (1 - self._EWMA_ALPHA) * old + self._EWMA_ALPHA * frac
        self._g_affinity_overlap.set(self._ewma_affinity_overlap,
                                     pool=self.pool.label)
        return req

    def _admit_new(self) -> None:
        while True:
            with self._cv:
                if self._pending_resize is not None:
                    # a pending shrink waits for live sequences to drain:
                    # filling freed slots would starve it
                    return
                if not self._queue or self.pool.free_slot_count() == 0:
                    return
                req = self._pop_next_locked()
            req.state = RequestState.PREFILL
            req.queue_wait_s = self.admission.on_scheduled(req.id)
            plen = req.prompt.size
            slot_idx = self.pool.alloc(req.id, plen)
            s = _Slot(req, slot_idx)
            s.plen = plen
            self._slots[slot_idx] = s
            self._sync_active_gauge()
            if self.prefill_chunk_tokens == 0:
                tracer = get_tracer()
                with tracer.resume(req.trace), tracer.span(
                        "serve.prefill", request=req.id, tokens=plen):
                    self._prefill_one(s)
                continue
            prefix = self.pool.prefix
            if prefix is not None:
                # leave >= 1 suffix token: the first output token's
                # distribution comes from the last prompt position. The
                # draft (s.draft_filled = 0) prefills the whole prompt
                matched, entries = prefix.acquire(
                    req.id, req.prompt,
                    max_pages=(plen - 1) // self.pool.page_size)
                if entries:
                    tracer = get_tracer()
                    with tracer.resume(req.trace), tracer.span(
                            "serve.prefix_install", request=req.id,
                            tokens=matched):
                        self._install_prefix(slot_idx, entries, matched)
                    s.filled = s.shared = matched
                    req.prefix_tokens = matched
                    req.cache_hit = True

    def _prefill_one(self, s: _Slot) -> None:
        """One-shot prefill (JAX `prefill_one`): the padded (1, window)
        prompt through one full-sequence walk that fills the slot's
        caches, then the first token."""
        t0 = time.monotonic()
        padded = np.zeros((1, self.window), np.int32)
        padded[0, :s.plen] = s.req.prompt
        probs = self.model.executor.forward_values(
            {self._input_name: torch.from_numpy(padded).to(self.device)},
            state=self._slot_caches[s.slot],
            fill_kv_cache=True)[self._final_guid]
        self.graphs["eager_walks"] += 1
        tok = self._pick_row(probs[0, s.plen - 1], s, s.plen - 1)
        self._observe_prefill(s.plen, time.monotonic() - t0)
        s.filled = s.pos = s.plen
        s.last_tok = tok
        self._first_token(s, tok)

    def _step_prefills(self) -> None:
        """One prefill chunk for every slot in the PREFILL state (and, with
        a draft, one draft chunk before it); a slot whose prompt
        completes emits its first token, inserts its full prompt pages
        into the prefix cache and joins this iteration's decode."""
        chunk = self.prefill_chunk_tokens
        for s in [x for x in self._slots
                  if x is not None and x.req.state is RequestState.PREFILL]:
            if self.draft_model is not None and s.draft_filled < s.plen:
                self._step_draft_prefill(s)
            off = s.filled
            n = min(chunk, s.plen - off)
            if (off + n >= s.plen and self.draft_model is not None
                    and s.draft_filled < s.plen):
                # hold the target's last chunk (which emits the first token
                # and arms decode) until the draft's cache holds the whole
                # prompt: the next speculative iteration needs both
                continue
            host = np.zeros(chunk + 1, np.int32)
            host[:n] = s.req.prompt[off:off + n]
            host[chunk] = off
            # the padded tail of the last chunk writes rows >= plen: they
            # are rewritten by decode before any query attends them
            tracer = get_tracer()
            with tracer.resume(s.req.trace), tracer.span(
                    "serve.prefill", request=s.req.id, offset=off, tokens=n):
                t0 = time.monotonic()
                self._chunk_dispatch(s.slot, host)
                self._prefill_chunks += 1
                s.filled = off + n
                if s.filled < s.plen:
                    continue
                tok = self._pick_row(self._chunk_probs[0, s.plen - 1 - off],
                                     s, s.plen - 1)
                self._observe_prefill(n, time.monotonic() - t0)
            s.pos = s.plen
            s.last_tok = tok
            self._insert_prefix(s)
            self._first_token(s, tok)

    def _step_draft_prefill(self, s: _Slot) -> None:
        """One DRAFT prefill chunk of a speculative slot (JAX
        `_step_draft_prefill`): the target's chunk stream, into the
        draft's caches; its last chunk is synced and timed for the
        draft's per-token prefill cost."""
        chunk = self.prefill_chunk_tokens
        off = s.draft_filled
        n = min(chunk, s.plen - off)
        host = np.zeros(chunk + 1, np.int32)
        host[:n] = s.req.prompt[off:off + n]
        host[chunk] = off
        tracer = get_tracer()
        with tracer.resume(s.req.trace), tracer.span(
                "serve.draft_prefill", request=s.req.id, offset=off,
                tokens=n):
            t0 = time.monotonic()
            self._draft_chunk_in.put(host)
            self._draft_chunk_calls[s.slot]()
            s.draft_filled = off + n
            if s.draft_filled >= s.plen:
                if self.device.type == "cuda":
                    torch.cuda.current_stream(self.device).synchronize()
                self._observe_draft_prefill(n, time.monotonic() - t0)

    def _band_rows(self, pages) -> np.ndarray:
        """Flat (band slot * max_len + row) indices of band pages' rows."""
        ps = self.pool.page_size
        out = []
        for page in pages:
            bslot, roff = self.pool.band_coords(page)
            out.append(bslot * self.max_len + roff + np.arange(ps))
        return np.concatenate(out)

    def _install_prefix(self, slot: int, entries, matched: int) -> None:
        """Prefix-cache hit (JAX `install_prefix`): the matched band pages'
        rows into the slot's leading rows, one indexed copy a cache."""
        idx = torch.from_numpy(self._band_rows(
            [e.page for e in entries])).to(self.device)
        for name, c in self._caches.items():
            for var, t in c.items():
                band = self._band[name][var]
                torch.index_select(band.view(-1, *band.shape[2:]), 0, idx,
                                   out=t[slot, :matched])

    def _insert_prefix(self, s: _Slot) -> None:
        """A finished prefill registers its new full prompt pages in the
        prefix cache (JAX `insert_pages`): the slot's rows of every new
        page into its band page, one indexed copy a cache."""
        prefix = self.pool.prefix
        if prefix is None:
            return
        ps = self.pool.page_size

        def copy_pages(pairs) -> None:
            src = torch.from_numpy(np.concatenate(
                [b * ps + np.arange(ps) for b, _ in pairs])).to(self.device)
            dst = torch.from_numpy(self._band_rows(
                [page for _, page in pairs])).to(self.device)
            for name, c in self._caches.items():
                for var, t in c.items():
                    band = self._band[name][var]
                    band.view(-1, *band.shape[2:]).index_copy_(
                        0, dst, t[s.slot].index_select(0, src))

        tracer = get_tracer()
        with tracer.resume(s.req.trace), tracer.span("serve.prefix_insert",
                                                     request=s.req.id):
            prefix.insert(s.req.prompt, s.plen, copy_pages)

    def _first_token(self, s: _Slot, tok: int) -> None:
        """Prefill complete: the request starts decoding and its TTFT is
        recorded, split by prefix-cache outcome. A prefill-only request
        PARKS instead and `on_parked` is told; if the hook fails, the
        request decodes here (a broken coordinator strands nothing)."""
        req = s.req
        req.state = RequestState.DECODE
        req.t_first_token = time.monotonic()
        self._h_ttft.observe((req.t_first_token - req.t_submit) * 1e3,
                             exemplar=req.trace_id,
                             cache="hit" if req.cache_hit else "miss")
        self._emit_token(s, tok)
        if req.prefill_only and req.state is RequestState.DECODE:
            with self._cv:
                req.state = RequestState.PARKED
                self._parked[req.id] = s
            cb = self.on_parked
            if cb is not None:
                try:
                    cb(req)
                except Exception:
                    self.resume_parked(req)

    def _emit_token(self, s: _Slot, tok: int) -> None:
        """Deliver one token; retire the request on EOS or its budget,
        freeing the slot and pages for the next iteration."""
        req = s.req
        req._emit(tok)
        s.last_tok = tok
        s.emitted += 1
        self.tokens_emitted += 1
        self._c_tokens.inc()
        if ((req.eos_id is not None and tok == req.eos_id)
                or s.emitted >= req.max_new_tokens):
            self._retire(s)

    def _retire(self, s: _Slot) -> None:
        self._slots[s.slot] = None
        with self._cv:
            self._parked.pop(s.req.id, None)
        self.pool.free(s.req.id)
        self.admission.release(s.req.id)
        self._completed += 1
        self._c_requests.inc(outcome="completed")
        self._sync_active_gauge()
        s.req._finish()
        with self._cv:
            self._cv.notify_all()

    def _sync_active_gauge(self) -> None:
        self._g_active.set(sum(1 for s in self._slots if s is not None),
                           pool=self.pool.label)

    def _drain_queue(self, err: BaseException) -> None:
        with self._cv:
            pending, self._queue = self._queue, []
        for req in pending:
            self.admission.release(req.id)
            self._failed += 1
            self._c_requests.inc(outcome="failed")
            req._fail(err)

    def _fail_all(self, err: BaseException) -> None:
        with self._cv:
            self._running = False
            slots, self._slots = list(self._slots), [None] * self.num_slots
            self._parked.clear()
        for s in slots:
            if s is None:
                continue
            self.pool.free(s.req.id)
            self.admission.release(s.req.id)
            self._failed += 1
            self._c_requests.inc(outcome="failed")
            s.req._fail(err)
        self._drain_queue(err)
        self._fail_pending_resize(err)
        self._fail_pending_handoffs(err)


def _embedding_entries(model) -> Optional[int]:
    """Rows of the embedding table the model's token input indexes."""
    return min((op.params["num_entries"] for op in model.graph.ops.values()
                if op.op_type == OpType.EMBEDDING
                and op.inputs[0] is model.input_ops[0].outputs[0]),
               default=None)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16, which numpy lacks, as its bits."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _device_rows(rows: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Shipped rows (`_host_array`'s) as a host tensor of `dtype`."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if dtype == torch.bfloat16 and t.dtype == torch.int16:
        return t.view(dtype)
    return t.to(dtype)


def _zero_caches(model, slots: int, max_len: int):
    """Zeroed (slots, max_len, heads, head_dim) K and V caches of every
    attention op of `model` (kvpool.kv_cache_spec's geometry)."""
    return {
        name: {
            "k_cache": torch.zeros((slots, max_len, heads, kdim), dtype=cdt,
                                   device=model.device),
            "v_cache": torch.zeros((slots, max_len, heads, vdim), dtype=cdt,
                                   device=model.device),
        }
        for name, heads, kdim, vdim, cdt in kv_cache_spec(model)
    }


def _slot_views(caches, slots: int):
    """Per-slot (1, max_len, heads, head_dim) views of slot-dense caches."""
    return [{name: {var: t[i:i + 1] for var, t in c.items()}
             for name, c in caches.items()} for i in range(slots)]
