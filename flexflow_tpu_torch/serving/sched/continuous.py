"""ContinuousBatcher: iteration-level scheduling over the paged KV pool
(the core of flexflow_tpu/serving/sched/continuous.py).

Every decode iteration steps ALL decoding slots at their OWN positions
(the per-slot-position entry of ops/attention.py); a request that emits
EOS or reaches max_new_tokens frees its slot and pages that iteration,
and a queued request starts prefilling into the freed slot on the next
one while the others keep decoding. Prompts prefill in fixed-size chunks
(one KV page per scheduler iteration by default) through the chunk-offset
entry, interleaved with decode iterations.

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

Determinism: greedy decode (temperature <= 0) is a function of the prompt
alone, whatever shares the batch. Sampled decode draws each token from a
generator seeded by the request's (seed, position), so a request's tokens
depend only on its own seed and prompt, never on co-scheduled traffic.
The numbers are not jax.random's, so sampled tokens differ from the JAX
batcher's.

Not ported yet, each raising a clear error: one-shot prefill
(prefill_chunk_tokens=0, needs the flash-attention slice, ROADMAP B1), the
prefix cache, speculative decoding with a draft model, request_resize and
the disaggregated park / handoff calls (ROADMAP A5), deriving num_slots
from the machine model (ROADMAP A7), expert-affine admission (with the
MoE ops, ROADMAP A6), metrics and tracing (ROADMAP A9).
"""
from __future__ import annotations

import contextlib
import enum
import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ffconst import OpType
from ..generate import sampling_logits
from .admission import AdmissionController
from .kvpool import PagedKVPool, kv_cache_spec

_MASK64 = (1 << 64) - 1


class BatcherStopped(RuntimeError):
    """The batcher is not running (typed shutdown)."""


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flexflow_tpu_torch yet ({item} in "
        "ROADMAP.md); use flexflow_tpu's ContinuousBatcher for it")


def sample_seed(seed: int, pos: int) -> int:
    """Generator seed for the token a request samples after position
    `pos` (a splitmix64 mix of (seed, pos), 63 bits)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(pos)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


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
                 "filled")

    def __init__(self, req: GenRequest, slot: int):
        self.req = req
        self.slot = slot
        self.pos = 0          # cache row the NEXT decode writes at
        self.emitted = 0
        self.last_tok = 0
        self.plen = 0        # prompt length
        self.filled = 0       # prompt tokens already in the cache


class ContinuousBatcher:
    """Continuous-batching scheduler over a compiled causal-transformer
    FFModel whose final tensor is a vocabulary distribution; the model's
    declared input length bounds the prefill chunk.

    temperature / top_k are batcher-level policy; a request's `seed` is
    per request. `num_slots` is required for now.
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
        if prefix_cache_pages:
            raise _not_ported("the prefix cache (prefix_cache_pages)", "A5")
        chunk = int(page_size) if prefill_chunk_tokens is None \
            else int(prefill_chunk_tokens)
        if chunk < 0:
            raise ValueError(
                f"prefill_chunk_tokens={prefill_chunk_tokens}: need >= 0")
        if chunk == 0:
            raise _not_ported("one-shot prefill (prefill_chunk_tokens=0)",
                              "the flash-attention kernel, queue B1")
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k={top_k}: must be >= 1")
        if float(temperature) < 0.0:
            raise ValueError(f"temperature={temperature}: must be >= 0")
        self.model = model
        self.device = model.device
        self.max_len = int(max_len)
        self.window = model.input_ops[0].outputs[0].dims[1]
        self.prefill_chunk_tokens = min(chunk, self.window)
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
        self.num_slots = int(num_slots)
        self.pool = PagedKVPool(self.num_slots, self.max_len,
                                page_size=page_size)
        self.admission = AdmissionController(
            self.pool, None, max_queue=max_queue,
            queue_pages_budget=queue_pages_budget)

        self._caches = {
            name: {
                "k_cache": torch.zeros(
                    (self.num_slots, self.max_len, heads, kdim), dtype=cdt,
                    device=self.device),
                "v_cache": torch.zeros(
                    (self.num_slots, self.max_len, heads, vdim), dtype=cdt,
                    device=self.device),
            }
            for name, heads, kdim, vdim, cdt in kv_cache_spec(model)
        }
        # per-slot views of the caches: a prefill chunk writes its slot's
        # rows in place through these
        self._slot_caches = [
            {name: {var: t[i:i + 1] for var, t in c.items()}
             for name, c in self._caches.items()}
            for i in range(self.num_slots)]
        self._input_name = model.input_ops[0].name
        self._final_guid = model.final_tensor.guid
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
        with self._cv:
            if not self._running:
                raise BatcherStopped("batcher is not running")
            self.admission.admit(rid, prompt.size, max_new_tokens)
            req = GenRequest(rid, prompt, max_new_tokens, eos_id, seed)
            self._queue.append(req)
            self._cv.notify_all()
        return req

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
            "pool": self.pool.stats(),
            "admission": self.admission.stats(),
        }

    # -- device steps --------------------------------------------------------
    def _forward(self, tokens: np.ndarray, state, pos):
        """One executor walk: tokens (B, C) at `pos` against `state`'s
        caches; returns the final tensor (B, C, V)."""
        values = self.model.executor.forward_values(
            {self._input_name: torch.from_numpy(tokens).to(self.device)},
            state=state, decode_pos=pos)
        return values[self._final_guid]

    def _pick(self, probs: torch.Tensor,
              rows: Sequence[Tuple[int, int, int]]) -> Dict[int, int]:
        """Next token per row of probs (R, V): rows lists (row, seed, pos).
        Greedy takes the first maximum (as jnp.argmax); sampling adds
        Gumbel noise from a generator seeded by (seed, pos)."""
        if self.temperature <= 0.0:
            toks = torch.argmax(probs, dim=-1).cpu().numpy()
            return {r: int(toks[r]) for r, _, _ in rows}
        logits = sampling_logits(probs, self.temperature, self.top_k)
        picked = []
        for r, seed, pos in rows:
            g = torch.Generator(device=probs.device)
            g.manual_seed(sample_seed(seed, pos))
            u = torch.rand(logits.shape[-1], generator=g,
                           device=probs.device).clamp_min(1e-20)
            picked.append(torch.argmax(logits[r] - torch.log(-torch.log(u))))
        toks = torch.stack(picked).cpu().numpy()
        return {r: int(t) for (r, _, _), t in zip(rows, toks)}

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
        while True:
            with self._cv:
                while (self._running and not self._queue
                       and not any(self._slots)):
                    self._cv.wait(timeout=0.1)
                if not self._running and not any(self._slots):
                    break
                running = self._running

            # 1) move queued requests into free slots (skipped once
            #    stopping: queued requests fail in stop())
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
            toks = np.zeros((self.num_slots, 1), np.int32)
            pos = np.zeros(self.num_slots, np.int32)
            for s in self._slots:
                if s is not None and s.req.state is not RequestState.DECODE:
                    # the decode dispatch writes one K/V row at `pos` for
                    # EVERY slot. A slot still prefilling must not take that
                    # dummy write inside its prompt rows: aim it at its next
                    # chunk's first row, which that chunk overwrites
                    pos[s.slot] = min(s.filled, self.max_len - 1)
            for s in active:
                toks[s.slot, 0] = s.last_tok
                pos[s.slot] = s.pos
            t0 = time.monotonic()
            probs = self._forward(toks, self._caches,
                                  torch.from_numpy(pos).to(self.device))
            picked = self._pick(probs[:, 0, :],
                                [(s.slot, s.req.seed, s.pos)
                                 for s in active])  # syncs the device
            self._decode_s += time.monotonic() - t0
            self._decode_iters += 1
            for s in active:
                self.pool.extend(s.req.id, 1)
                s.pos += 1
                self._emit_token(s, picked[s.slot])

    def _admit_new(self) -> None:
        while True:
            with self._cv:
                if not self._queue or self.pool.free_slot_count() == 0:
                    return
                req = self._queue.pop(0)
            req.state = RequestState.PREFILL
            req.queue_wait_s = self.admission.on_scheduled(req.id)
            slot_idx = self.pool.alloc(req.id, req.prompt.size)
            s = _Slot(req, slot_idx)
            s.plen = req.prompt.size
            self._slots[slot_idx] = s

    def _step_prefills(self) -> None:
        """One prefill chunk for every slot in the PREFILL state; a slot
        whose prompt completes emits its first token and joins this
        iteration's decode."""
        chunk = self.prefill_chunk_tokens
        for s in [x for x in self._slots
                  if x is not None and x.req.state is RequestState.PREFILL]:
            off = s.filled
            n = min(chunk, s.plen - off)
            tokens = np.zeros((1, chunk), np.int32)
            tokens[0, :n] = s.req.prompt[off:off + n]
            # the padded tail of the last chunk writes rows >= plen: they
            # are rewritten by decode before any query attends them
            probs = self._forward(tokens, self._slot_caches[s.slot], off)
            self._prefill_chunks += 1
            s.filled = off + n
            if s.filled < s.plen:
                continue
            tok = self._pick(probs[:, s.plen - 1 - off, :],
                             [(0, s.req.seed, s.plen - 1)])[0]
            s.pos = s.plen
            s.last_tok = tok
            self._first_token(s, tok)

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
