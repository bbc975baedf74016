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

Prefix reuse (kvpool.PrefixCache, on by default with chunked prefill:
two slots' worth of pages): cached prefix pages live in a band of
slot-shaped rows beside the decode caches, which decode never carries or
attends. A scheduled prompt's longest cached page-aligned prefix (at most
all but its last token) is copied into the slot's leading rows, one
indexed copy a cache, and only the suffix is prefilled; a finished
prefill copies its new full pages into the band. Admission credits the
expected sharing against its backlog budget.

Determinism: greedy decode (temperature <= 0) is a function of the prompt
alone, whatever shares the batch. Sampled decode adds Gumbel noise made
from the request's key (its seed) and the position (serving/generate.py
`pick_tokens`), so a request's tokens depend only on its own seed and
prompt, never on co-scheduled traffic. The numbers are not jax.random's,
so sampled tokens differ from the JAX batcher's.

Not ported yet, each raising a clear error: speculative decoding with a
draft model, request_resize and the disaggregated park / handoff calls
(ROADMAP A5), deriving num_slots from the machine model (ROADMAP A7),
expert-affine admission (with the MoE ops, ROADMAP A6), metrics and
tracing (ROADMAP A9).
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
from ...runtime.graphs import CapturedCall, Staging, graph_counts, \
    model_weights, new_pool
from ..generate import key_bits, pick_tokens, sample_key
from .admission import AdmissionController
from .kvpool import PagedKVPool, kv_cache_spec


class BatcherStopped(RuntimeError):
    """The batcher is not running (typed shutdown)."""


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flexflow_tpu_torch yet ({item} in "
        "ROADMAP.md); use flexflow_tpu's ContinuousBatcher for it")


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
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

    # -- scheduler side ----------------------------------------------------
    def _emit(self, tok: int) -> None:
        self.tokens.append(int(tok))
        self.token_times.append(time.monotonic())
        self._stream.put(int(tok))

    def _finish(self) -> None:
        self.state = RequestState.FINISHED
        self.t_done = time.monotonic()
        self._stream.put(_DONE)
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        if self._done.is_set():
            return
        self.state = RequestState.FAILED
        self.error = err
        self.t_done = time.monotonic()
        self._stream.put(err)
        self._done.set()


class _Slot:
    """One active sequence bound to a pool slot."""

    __slots__ = ("req", "slot", "pos", "emitted", "last_tok", "plen",
                 "filled", "shared", "key")

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


class ContinuousBatcher:
    """Continuous-batching scheduler over a compiled causal-transformer
    FFModel whose final tensor is a vocabulary distribution; the model's
    declared input length bounds the prefill chunk (and, one-shot, the
    prompt).

    temperature / top_k are batcher-level policy; a request's `seed` is
    per request. `num_slots` is required for now. prefix_cache_pages:
    band pages of the prefix cache; None gives two slots' worth with
    chunked prefill and none one-shot, 0 turns it off.
    """

    def __init__(self, model, max_len: int, num_slots: Optional[int] = None,
                 page_size: int = 16, max_queue: int = 64,
                 queue_pages_budget: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_cache_pages: Optional[int] = None,
                 draft_model=None):
        if num_slots is None:
            raise ValueError(
                "num_slots is required: deriving it from device memory "
                "(derive_num_slots) needs the machine model, ROADMAP A7")
        if draft_model is not None:
            raise _not_ported("speculative decoding (draft_model)", "A5")
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
        if not any(op.op_type == OpType.MULTIHEAD_ATTENTION
                   for op in model.graph.ops.values()):
            raise ValueError("generation needs multihead_attention ops")
        # ids must index the embedding table: on the card an out-of-range
        # gather is a device-side assert that takes the process down
        self._vocab = min((op.params["num_entries"]
                           for op in model.graph.ops.values()
                           if op.op_type == OpType.EMBEDDING
                           and op.inputs[0] is model.input_ops[0].outputs[0]),
                          default=None)
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
        self.num_slots = int(num_slots)
        self.pool = PagedKVPool(self.num_slots, self.max_len,
                                page_size=page_size,
                                prefix_cache_pages=prefix_pages)
        self.admission = AdmissionController(
            self.pool,
            self.window if self.prefill_chunk_tokens == 0 else None,
            max_queue=max_queue, queue_pages_budget=queue_pages_budget)

        spec = kv_cache_spec(model)
        self._caches = {
            name: {
                "k_cache": torch.zeros(
                    (self.num_slots, self.max_len, heads, kdim), dtype=cdt,
                    device=self.device),
                "v_cache": torch.zeros(
                    (self.num_slots, self.max_len, heads, vdim), dtype=cdt,
                    device=self.device),
            }
            for name, heads, kdim, vdim, cdt in spec
        }
        # per-slot views of the caches: a prefill chunk writes its slot's
        # rows in place through these
        self._slot_caches = [
            {name: {var: t[i:i + 1] for var, t in c.items()}
             for name, c in self._caches.items()}
            for i in range(self.num_slots)]
        # the prefix cache's band: slot-shaped rows beside the decode
        # caches (JAX `_zero_band`), which decode never carries
        band_slots = self.pool.band_slots
        self._band = {
            name: {
                "k_cache": torch.zeros((band_slots, self.max_len, heads,
                                        kdim), dtype=cdt, device=self.device),
                "v_cache": torch.zeros((band_slots, self.max_len, heads,
                                        vdim), dtype=cdt, device=self.device),
            }
            for name, heads, kdim, vdim, cdt in spec
        } if band_slots else None
        self._input_name = model.input_ops[0].name
        self._final_guid = model.final_tensor.guid

        # the compiled dispatches: static inputs and outputs, one graph
        # for the decode iteration and one per slot for a prefill chunk
        from ...ops.common import emit_dtype

        vocab = model.final_tensor.dims[-1]
        pdt = emit_dtype(model.config, model.final_tensor.dtype)
        S, C = self.num_slots, self.prefill_chunk_tokens
        self.graphs = graph_counts()
        weights = model_weights(model)
        pool = new_pool(self.device)
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

        self._rid = itertools.count()
        self._queue: List[GenRequest] = []
        self._slots: List[Optional[_Slot]] = [None] * self.num_slots
        self._cv = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._completed = 0
        self._failed = 0
        self.tokens_emitted = 0
        self._decode_iters = 0
        self._decode_s = 0.0
        self._prefill_chunks = 0

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
        a GenRequest whose stream()/result() deliver the tokens."""
        if prefill_only:
            raise _not_ported("prefill_only (disaggregated serving)", "A5")
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
        with self._cv:
            if not self._running:
                raise BatcherStopped("batcher is not running")
            self.admission.admit(rid, prompt.size, max_new_tokens,
                                 shared_pages=shared_pages)
            req = GenRequest(rid, prompt, max_new_tokens, eos_id, seed)
            self._queue.append(req)
            self._cv.notify_all()
        return req

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

    def request_resize(self, *args, **kwargs):
        raise _not_ported("request_resize", "A5")

    def request_export(self, *args, **kwargs):
        raise _not_ported("the KV handoff (request_export)", "A5")

    def request_import(self, *args, **kwargs):
        raise _not_ported("the KV handoff (request_import)", "A5")

    def resume_parked(self, *args, **kwargs):
        raise _not_ported("parked requests (resume_parked)", "A5")

    def release_parked(self, *args, **kwargs):
        raise _not_ported("parked requests (release_parked)", "A5")

    def stats(self) -> Dict[str, object]:
        """The counters; "graphs" holds the dispatches' warm-ups, captures
        and replays, and the walks run outside any graph (on the card:
        the one-shot prefills)."""
        with self._cv:
            active = sum(1 for s in self._slots if s is not None)
            queued = len(self._queue)
        return {
            "queue_depth": queued,
            "slots_active": active,
            "completed": self._completed,
            "failed": self._failed,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "num_slots": self.num_slots,
            "tokens_emitted": self.tokens_emitted,
            "prefill_chunks": self._prefill_chunks,
            "decode_iterations": self._decode_iters,
            "decode_iter_s": (self._decode_s / self._decode_iters
                              if self._decode_iters else None),
            "graphs": dict(self.graphs),
            "pool": self.pool.stats(),
            "admission": self.admission.stats(),
        }

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

    def _decode_dispatch(self, host: np.ndarray) -> np.ndarray:
        """One decode iteration: host (3 * num_slots,) int32 holds the
        tokens, positions and key bits; returns the picked tokens. The
        static probabilities hold until the next decode dispatch."""
        self._dec_in.put(host)
        self._decode_call()
        return self._dec_tok.cpu().numpy()  # syncs the device

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
        try:
            with torch.no_grad(), (torch.cuda.device(self.device)
                                   if self.device.type == "cuda"
                                   else contextlib.nullcontext()):
                self._run()
        except BaseException as e:  # scheduler died: fail everything
            self._fail_all(e)

    def _run(self) -> None:
        S = self.num_slots
        while True:
            with self._cv:
                while (self._running and not self._queue
                       and not any(self._slots)):
                    self._cv.wait(timeout=0.1)
                if not self._running and not any(self._slots):
                    break
                running = self._running

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
                    # the decode dispatch writes one K/V row at `pos` for
                    # EVERY slot. A slot still prefilling must not take that
                    # dummy write inside its prompt rows: aim it at its next
                    # chunk's first row, which that chunk overwrites
                    pos[s.slot] = min(s.filled, self.max_len - 1)
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
            t0 = time.monotonic()
            picked = self._decode_dispatch(host)
            self._decode_s += time.monotonic() - t0
            self._decode_iters += 1
            for s in active:
                self.pool.extend(s.req.id, 1)
                s.pos += 1
                self._emit_token(s, int(picked[s.slot]))

    def _admit_new(self) -> None:
        while True:
            with self._cv:
                if not self._queue or self.pool.free_slot_count() == 0:
                    return
                req = self._queue.pop(0)
            req.state = RequestState.PREFILL
            req.queue_wait_s = self.admission.on_scheduled(req.id)
            plen = req.prompt.size
            slot_idx = self.pool.alloc(req.id, plen)
            s = _Slot(req, slot_idx)
            s.plen = plen
            self._slots[slot_idx] = s
            if self.prefill_chunk_tokens == 0:
                self._prefill_one(s)
                continue
            prefix = self.pool.prefix
            if prefix is not None:
                # leave >= 1 suffix token: the first output token's
                # distribution comes from the last prompt position
                matched, entries = prefix.acquire(
                    req.id, req.prompt,
                    max_pages=(plen - 1) // self.pool.page_size)
                if entries:
                    self._install_prefix(slot_idx, entries, matched)
                    s.filled = s.shared = matched
                    req.prefix_tokens = matched
                    req.cache_hit = True

    def _prefill_one(self, s: _Slot) -> None:
        """One-shot prefill (JAX `prefill_one`): the padded (1, window)
        prompt through one full-sequence walk that fills the slot's
        caches, then the first token."""
        padded = np.zeros((1, self.window), np.int32)
        padded[0, :s.plen] = s.req.prompt
        probs = self.model.executor.forward_values(
            {self._input_name: torch.from_numpy(padded).to(self.device)},
            state=self._slot_caches[s.slot],
            fill_kv_cache=True)[self._final_guid]
        self.graphs["eager_walks"] += 1
        tok = self._pick_row(probs[0, s.plen - 1], s, s.plen - 1)
        s.filled = s.pos = s.plen
        s.last_tok = tok
        self._first_token(s, tok)

    def _step_prefills(self) -> None:
        """One prefill chunk for every slot in the PREFILL state; a slot
        whose prompt completes emits its first token, inserts its full
        prompt pages into the prefix cache and joins this iteration's
        decode."""
        chunk = self.prefill_chunk_tokens
        for s in [x for x in self._slots
                  if x is not None and x.req.state is RequestState.PREFILL]:
            off = s.filled
            n = min(chunk, s.plen - off)
            host = np.zeros(chunk + 1, np.int32)
            host[:n] = s.req.prompt[off:off + n]
            host[chunk] = off
            # the padded tail of the last chunk writes rows >= plen: they
            # are rewritten by decode before any query attends them
            self._chunk_dispatch(s.slot, host)
            self._prefill_chunks += 1
            s.filled = off + n
            if s.filled < s.plen:
                continue
            tok = self._pick_row(self._chunk_probs[0, s.plen - 1 - off], s,
                                 s.plen - 1)
            s.pos = s.plen
            s.last_tok = tok
            self._insert_prefix(s)
            self._first_token(s, tok)

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

        prefix.insert(s.req.prompt, s.plen, copy_pages)

    def _first_token(self, s: _Slot, tok: int) -> None:
        req = s.req
        req.state = RequestState.DECODE
        req.t_first_token = time.monotonic()
        self._emit_token(s, tok)

    def _emit_token(self, s: _Slot, tok: int) -> None:
        """Deliver one token; retire the request on EOS or its budget,
        freeing the slot and pages for the next iteration."""
        req = s.req
        req._emit(tok)
        s.last_tok = tok
        s.emitted += 1
        self.tokens_emitted += 1
        if ((req.eos_id is not None and tok == req.eos_id)
                or s.emitted >= req.max_new_tokens):
            self._retire(s)

    def _retire(self, s: _Slot) -> None:
        self._slots[s.slot] = None
        self.pool.free(s.req.id)
        self.admission.release(s.req.id)
        self._completed += 1
        s.req._finish()
        with self._cv:
            self._cv.notify_all()

    def _drain_queue(self, err: BaseException) -> None:
        with self._cv:
            pending, self._queue = self._queue, []
        for req in pending:
            self.admission.release(req.id)
            self._failed += 1
            req._fail(err)

    def _fail_all(self, err: BaseException) -> None:
        with self._cv:
            self._running = False
            slots, self._slots = list(self._slots), [None] * self.num_slots
        for s in slots:
            if s is None:
                continue
            self.pool.free(s.req.id)
            self.admission.release(s.req.id)
            self._failed += 1
            s.req._fail(err)
        self._drain_queue(err)
