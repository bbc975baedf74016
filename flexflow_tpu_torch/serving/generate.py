"""Autoregressive generation with KV caches (counterpart of
flexflow_tpu/serving/generate.py): the sampling policy core shared with the
continuous batcher, and `GenerativeSession`, the lockstep path. A session
prefills the whole padded batch in one full-sequence walk that fills the
caches (`fill_kv_cache`: the flash kernel, causal, on the card), then
decodes every row at one shared position, K steps a dispatch: on the card
one CUDA graph of K steps (runtime/graphs.py), the counterpart of JAX's
`lax.scan`; on the CPU the K steps run eagerly.

On a data x model mesh of ranks (compile(parallel_axes=...), the JAX
entry's leg 9) every rank calls `generate` with the same prompts. Each
rank prefills and decodes its own rows (b/dp where `data` divides the
batch) over its own heads, picks tokens with the keys of the GLOBAL row
indices, and gathers the tokens over `data` before it reads them, so
every rank returns the whole array and decides an eos stop on the same
rows. There the K decode steps of a dispatch run eagerly in one host
dispatch (runtime/distributed.py `graph_capture`: gloo's host-staged
collectives cannot be captured); `stats()` says so and why.

Sampling: a token is argmax(log-probs / temperature + Gumbel noise), the
noise of every vocabulary id computed on the device by integer hashing of
(the row's 32-bit key, the position, the id), so a pick runs inside a
graph, and a row's tokens depend only on its key and its positions, never
on how many steps a dispatch holds. The numbers are not jax.random's:
sampled tokens differ from the JAX package's, greedy ones do not.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ffconst import OpType
from ..runtime.collectives import gather_shards
from ..runtime.distributed import graph_capture
from ..runtime.graphs import CapturedCall, graph_counts, model_weights, \
    new_pool

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def sampling_logits(probs: torch.Tensor, temperature: float, top_k):
    """Log-probs at `temperature`, optionally truncated to the top_k most
    likely tokens via a kth-largest threshold. Works on (V,) rows and
    (b, V) batches alike."""
    logits = torch.log(probs.float() + 1e-9) / temperature
    if top_k is not None:
        kk = int(top_k)
        if kk < 1:
            raise ValueError(f"top_k={top_k}: must be >= 1")
        kk = min(kk, logits.shape[-1])
        kth = torch.topk(logits, kk, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full_like(logits, float("-inf")))
    return logits


def sample_key(seed: int, stream: int = 0) -> int:
    """The 32-bit sampling key of (seed, stream), a splitmix64 mix: a
    batcher request uses stream 0, a session row its row index."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(stream)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & _MASK32


def key_bits(keys) -> np.ndarray:
    """32-bit keys as the int32 bit patterns a device buffer holds."""
    return np.asarray(keys, np.uint32).view(np.int32)


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 lanes holding [0, 2^32): every
    multiplier is below 2^31, so no product leaves int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _MASK32
    return h ^ (h >> 16)


def gumbel_noise(keys: torch.Tensor, pos: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(R, vocab) f32 Gumbel noise of rows with int32-bit keys (R,) at
    positions pos (R,): a function of (key, position, id) alone."""
    k = keys.long() & _MASK32
    base = _mix32(k ^ _mix32((pos.long() * 0x9E3779B1) & _MASK32))
    ids = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    h = _mix32((base[:, None] + ids[None, :] * 0x2545F491) & _MASK32)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))   # (0, 1), exact
    return -torch.log(-torch.log(u))


def pick_tokens(probs: torch.Tensor, temperature: float, top_k,
                keys: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Next token of each row of probs (R, V): greedy takes the first
    maximum (as jnp.argmax) at temperature <= 0; else argmax of the
    sampling logits plus the rows' Gumbel noise at their positions."""
    if temperature <= 0.0:
        return torch.argmax(probs, dim=-1)
    logits = sampling_logits(probs, temperature, top_k)
    return torch.argmax(
        logits + gumbel_noise(keys, pos, logits.shape[-1]), dim=-1)


class GenerativeSession:
    """Incremental decoding session over a compiled causal-transformer
    FFModel whose final tensor is a distribution over the vocabulary.

    max_len: cache capacity (max prompt + generated tokens). The model's
    declared input length is the PREFILL window; prompts are padded to it
    (cache rows past the prompt are overwritten as decoding proceeds)."""

    def __init__(self, model, max_len: int):
        if model.executor is None:
            raise RuntimeError(model.outside_mesh
                               or "GenerativeSession needs a compiled model")
        self.model = model
        self.max_len = int(max_len)
        window = model.input_ops[0].outputs[0].dims[1]
        if self.max_len < window:
            raise ValueError(
                f"max_len={self.max_len} smaller than the model's prefill "
                f"window ({window}); the cache must hold at least one "
                "full prefill")
        if not any(op.op_type == OpType.MULTIHEAD_ATTENTION
                   for op in model.graph.ops.values()):
            raise ValueError("generation needs multihead_attention ops")
        from .sched.kvpool import local_kv_cache_spec, local_rows

        self.device = model.device
        self.mesh = model.mesh
        if self.mesh is not None and set(self.mesh.shape) - {"data",
                                                             "model"}:
            raise NotImplementedError(
                f"generation on the mesh {dict(self.mesh.shape)}: a "
                "session runs on the data and model axes (ROADMAP A8)")
        # this rank's rows of the session batch: [row0, row0 + b)
        b = self.rows = local_rows(model, model.config.batch_size)
        self._row0 = (self.mesh.index("data") * b
                      if b < model.config.batch_size else 0)
        self._caches = {
            name: {
                "k_cache": torch.zeros((b, self.max_len, heads, kdim),
                                       dtype=cdt, device=self.device),
                "v_cache": torch.zeros((b, self.max_len, heads, vdim),
                                       dtype=cdt, device=self.device),
            }
            for name, heads, kdim, vdim, cdt in local_kv_cache_spec(model)
        }
        # the decode carry: the next token and its write position of every
        # row, and the rows' sampling keys (int32 bit patterns)
        self._tok = torch.zeros((b, 1), dtype=torch.int32, device=self.device)
        self._pos = torch.zeros((b,), dtype=torch.int32, device=self.device)
        self._keys = torch.zeros((b,), dtype=torch.int32, device=self.device)
        self._input_name = model.input_ops[0].name
        self._final_guid = model.final_tensor.guid
        self._weights = model_weights(model)
        self._pool = new_pool(self.device)
        # (k, temperature, top_k) -> (dispatch, its (k, b) token output)
        self._decode_scans: Dict[tuple, Tuple[CapturedCall,
                                              torch.Tensor]] = {}
        self.counts = graph_counts()
        self.capture, self.capture_reason = graph_capture(self.device,
                                                          self.mesh)

    def stats(self) -> Dict[str, object]:
        """The dispatch counts (warm-ups, captures, replays, eager walks),
        whether a K-step dispatch is a captured graph and why not, and
        the rows this rank walks."""
        return {"graphs": dict(self.counts), "graph_capture": self.capture,
                "reason": self.capture_reason, "rows": self.rows,
                "row0": self._row0}

    def _walk(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        """The final tensor's value of one walk over this rank's rows
        (cut over `data` when they are a part of the batch)."""
        ex = self.model.executor
        ex.batch_cut = self.rows < self.model.config.batch_size
        return ex.forward_values({self._input_name: tokens},
                                 state=self._caches, **kw)[self._final_guid]

    def _decode_scan(self, k: int, temperature: float,
                     top_k: Optional[int]):
        """k decode steps a dispatch, cached per (k, temperature, top_k):
        each step decodes every row at the carried position, picks the
        next token, writes it into row i of the output and the carry, and
        advances the position."""
        cache_key = (k, float(temperature), top_k)
        hit = self._decode_scans.get(cache_key)
        if hit is not None:
            return hit
        b = self._tok.shape[0]
        out = torch.zeros((k, b), dtype=torch.int32, device=self.device)

        def steps():
            for i in range(k):
                probs = self._walk(self._tok, decode_pos=self._pos)
                tok = pick_tokens(probs[:, 0, :], temperature, top_k,
                                  self._keys, self._pos)
                out[i].copy_(tok)
                self._tok.copy_(tok[:, None])
                self._pos.add_(1)

        hit = (CapturedCall(steps, self.device, self._weights, self.counts,
                            self._pool, capture=self.capture), out)
        self._decode_scans[cache_key] = hit
        return hit

    def _fetch(self, t: torch.Tensor):
        """Start copying a device result (k, rows) to the host; returns a
        callable that waits for the copy and gives the numpy array. On a
        mesh whose `data` axis cut the rows, every rank gathers the whole
        (k, batch) first, here, in the same order on every rank."""
        if self.rows < self.model.config.batch_size:
            t = gather_shards(t, 1, self.mesh.group("data"),
                              self.mesh.size("data"))
        if self.device.type != "cuda":
            host = t.clone()
            return host.numpy
        host = t.to("cpu", non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))

        def wait():
            event.synchronize()
            return host.numpy()
        return wait

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 tokens_per_dispatch: int = 1,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        """Decoding. prompt_ids: (batch, prompt_len) int tokens. Returns
        (batch, generated) token ids. temperature=0 (default) is greedy
        argmax; temperature>0 samples (optionally truncated to top_k) with
        noise from each row's key and position, so the same seed yields
        the same tokens at any tokens_per_dispatch.

        Every dispatch holds K = tokens_per_dispatch decode steps, the
        next dispatch queued before the previous one's tokens are read
        (the carry stays on the device). With an eos_id the stop happens
        on the same step as at K = 1, at the cost of up to one dispatch of
        discarded work. On a mesh every rank calls it with the same
        arguments and returns the same array."""
        model = self.model
        b = model.config.batch_size
        window = model.input_ops[0].outputs[0].dims[1]
        prompt_ids = np.asarray(prompt_ids)
        if prompt_ids.ndim != 2 or prompt_ids.shape[0] < 1:
            raise ValueError(
                "prompt_ids must be a non-empty (n_prompts, prompt_len) "
                f"array of token ids; got shape {prompt_ids.shape}")
        n_real = prompt_ids.shape[0]
        if n_real > b:
            raise ValueError(
                f"{n_real} prompts exceed the session batch size {b}")
        if n_real < b:
            # pad partial batches by tiling the last real prompt: rows
            # decode independently, and the padded rows are finished from
            # step 0 below, so an eos stop never waits on them
            prompt_ids = np.concatenate(
                [prompt_ids, np.tile(prompt_ids[-1:], (b - n_real, 1))],
                axis=0)
        prompt_len = prompt_ids.shape[1]
        if prompt_len > window:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the prefill window "
                f"({window})")
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the cache capacity "
                f"({self.max_len})")
        if max_new_tokens <= 0:
            return np.zeros((n_real, 0), dtype=np.int32)

        padded = np.zeros((b, window), dtype=np.int32)
        padded[:, :prompt_len] = prompt_ids
        with torch.no_grad():
            return self._generate(padded, prompt_len, n_real,
                                  max_new_tokens, eos_id,
                                  max(1, int(tokens_per_dispatch)),
                                  float(temperature), top_k, int(seed))

    def _generate(self, padded, prompt_len, n_real, max_new_tokens, eos_id,
                  K, temperature, top_k, seed) -> np.ndarray:
        b = padded.shape[0]
        lo, n = self._row0, self.rows
        probs = self._walk(torch.from_numpy(padded[lo:lo + n]).to(
            self.device), fill_kv_cache=True)
        self.counts["eager_walks"] += 1
        # the keys of the global rows: a mesh picks what one device picks
        self._keys.copy_(torch.from_numpy(key_bits(
            [sample_key(seed, r) for r in range(lo, lo + n)])))
        self._pos.fill_(prompt_len - 1)
        # the next token from the last REAL prompt position
        tok = pick_tokens(probs[:, prompt_len - 1, :], temperature, top_k,
                          self._keys, self._pos)
        self._tok.copy_(tok[:, None])
        self._pos.fill_(prompt_len)
        pending = self._fetch(self._tok.t())

        out = []
        finished = np.zeros(b, dtype=bool)
        finished[n_real:] = True

        def absorb(rows) -> bool:
            """Append a dispatch's rows; True = stop decoding."""
            for row in rows:
                out.append(row)
                if eos_id is not None:
                    finished[:] |= row == eos_id
                    if finished.all():
                        return True
                if len(out) >= max_new_tokens:
                    return True
            return False

        dispatched = 1  # the prefill's token
        while dispatched < max_new_tokens:
            k = min(K, max_new_tokens - dispatched)
            call, toks = self._decode_scan(k, temperature, top_k)
            call()
            dispatched += k
            if absorb(pending()):  # overlaps the dispatch just queued
                return np.stack(out, axis=1)[:n_real]
            pending = self._fetch(toks)
        absorb(pending())
        return np.stack(out, axis=1)[:n_real]
