"""serve-bench: the load generator that measures continuous batching
(counterpart of flexflow_tpu/serving/sched/bench.py).

``python -m flexflow_tpu_torch serve-bench`` builds a causal transformer
LM (`build_tiny_lm`; `--hidden`, `--heads`, `--layers`, `--vocab` give
its widths, f32 as in the JAX package) on `--device cuda|cpu` (default
cuda) and drives one workload (``--workload``):

 - ``mixed`` (default): mixed prompt and output lengths through the
   continuous batcher and the lockstep ``GenerativeSession`` baseline;
   tokens/s, TTFT and latency percentiles, and the speedup;
 - ``shared-prefix``: N requests over K system prompts; one leader a
   group prefills cold, the followers hit the prefix cache. Asserts
   greedy tokens identical to a cache-cold lockstep reference and hit
   TTFT ``--ttft-ratio`` x lower than miss TTFT;
 - ``long-prefill``: in-flight decoders against one long prompt, chunked
   and one-shot. Asserts the long request's tokens identical in both and
   the one-shot stall ``--itl-ratio`` x the chunked p99 inter-token gap;
 - ``mesh-resize``: the batcher's slots shrink to ``--shrink-to``
   mid-decode and grow back; zero drops, tokens identical to a run
   without the resize;
 - ``fleet``, ``chaos``, ``disagg``: the fleet's runs
   (serving/fleet/bench.py `run_fleet_cli`, `run_chaos_cli`,
   `run_disagg_cli`);
 - ``speculative``: plain greedy against draft-verify decoding; tokens
   identical, nonzero acceptance, ``--spec-speedup``, a short rerun with
   the decode kernels forced, and the CostModel pricing the
   ``attention_decode_mq`` family;
 - ``moe``: the MoE LM under expert-affine admission; tokens identical
   to the lockstep session, zero router drops.

Hard checks for every workload (exit 1, a ``FAIL:`` line each): every
request finishes with exactly its requested tokens; no admission wait
past ``--deadline``; the run's metrics render through the exposition
validator with the required ``ff_*`` families. ``--assert-speedup X``
fails the mixed run below X continuous / lockstep tokens/s. The wall
clock ratios (``--ttft-ratio``, ``--itl-ratio``, ``--spec-speedup``,
``--affine-margin``, ``--disagg-margin``) keep JAX's defaults.

The module also holds the builders and passes the chip checks call
directly: `build_tiny_lm`, `build_tiny_moe_lm`, `make_workload`,
`make_shared_prefix_workload`, `run_speculative_once`, `run_moe`,
`session_refs` and `_moe_router_check`.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...config import FFConfig, require_device
from ...ffconst import ActiMode, AggrMode, CompMode, DataType
from ...model import FFModel


def build_tiny_lm(batch: int, window: int, vocab: int = 64,
                  hidden: int = 32, heads: int = 4, layers: int = 2,
                  mixed_precision: bool = False, device: str = "cuda",
                  generator: Optional[torch.Generator] = None) -> FFModel:
    """A causal transformer LM, the same graph and op names as the JAX
    builder: embedding, then per layer attention + add + layer_norm and a
    GELU FFN of 2 x hidden + add + layer_norm, then lm_head and the
    vocabulary softmax. Compiled for `batch` slots on `device`, weights
    drawn from `generator`."""
    config = FFConfig()
    config.batch_size = batch
    config.allow_mixed_precision = mixed_precision
    config.device = device
    model = FFModel(config)
    tokens = model.create_tensor([batch, window], DataType.DT_INT32)
    t = model.embedding(tokens, vocab, hidden, AggrMode.AGGR_MODE_NONE,
                        name="emb")
    for i in range(layers):
        attn = model.multihead_attention(t, t, t, hidden, heads,
                                         causal=True, name=f"l{i}_attn")
        t = model.layer_norm(model.add(t, attn), [-1], name=f"l{i}_ln1")
        h = model.dense(t, hidden * 2, ActiMode.AC_MODE_GELU,
                        name=f"l{i}_ff1")
        h = model.dense(h, hidden, name=f"l{i}_ff2")
        t = model.layer_norm(model.add(t, h), [-1], name=f"l{i}_ln2")
    model.softmax(model.dense(t, vocab, name="lm_head"))
    model.compile(comp_mode=CompMode.COMP_MODE_INFERENCE,
                  generator=generator)
    return model


def build_tiny_moe_lm(batch: int, window: int, vocab: int = 64,
                      hidden: int = 32, heads: int = 4, layers: int = 2,
                      experts: int = 4, moe_top_k: int = 2,
                      mixed_precision: bool = False, device: str = "cuda",
                      generator: Optional[torch.Generator] = None
                      ) -> FFModel:
    """The MoE bench model: the zoo's switch / top-k causal LM
    (models/moe.py build_moe_lm) with the JAX builder's graph and op
    names. capacity_factor is the expert count, so capacity = top_k x
    tokens and the router can never drop an assignment: a request's
    greedy tokens do not depend on its batch. Compiled for `batch` slots
    on `device`, weights drawn from `generator`."""
    from ...models import MoeTransformerConfig, build_moe_lm

    config = FFConfig()
    config.batch_size = batch
    config.allow_mixed_precision = mixed_precision
    config.device = device
    model = FFModel(config)
    tokens = model.create_tensor([batch, window], DataType.DT_INT32)
    cfg = MoeTransformerConfig(
        hidden_size=hidden, num_heads=heads, num_layers=layers,
        num_experts=experts, top_k=moe_top_k,
        capacity_factor=float(experts), lambda_bal=0.0, vocab_size=vocab)
    build_moe_lm(model, tokens, cfg)
    model.compile(comp_mode=CompMode.COMP_MODE_INFERENCE,
                  generator=generator)
    return model


def make_workload(n: int, prompt_min: int, prompt_max: int, out_min: int,
                  out_max: int, vocab: int, seed: int) -> List[Dict]:
    """N requests of independent random prompts (JAX `make_workload`):
    lengths uniform in [prompt_min, prompt_max], budgets in [out_min,
    out_max], from one RandomState(seed) stream."""
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        plen = int(rng.randint(prompt_min, prompt_max + 1))
        olen = int(rng.randint(out_min, out_max + 1))
        reqs.append({
            "prompt": rng.randint(1, vocab, size=(plen,)).astype(np.int32),
            "max_new": olen,
        })
    return reqs


def make_shared_prefix_workload(n: int, groups: int, prefix_len: int,
                                suffix_min: int, suffix_max: int,
                                out_min: int, out_max: int, vocab: int,
                                seed: int) -> List[Dict]:
    """N requests over `groups` distinct system prompts: request i carries
    prefix (i % groups) plus a unique suffix. The first request of each
    group is the LEADER (a cold prefill that fills the prefix cache); the
    rest should hit. The JAX serve-bench defaults: 4 groups, a 128-token
    prefix, 2-8 suffix tokens."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(1, vocab, size=(prefix_len,)).astype(np.int32)
                for _ in range(groups)]
    reqs = []
    for i in range(n):
        g = i % groups
        slen = int(rng.randint(suffix_min, suffix_max + 1))
        reqs.append({
            "prompt": np.concatenate(
                [prefixes[g],
                 rng.randint(1, vocab, size=(slen,)).astype(np.int32)]),
            "max_new": int(rng.randint(out_min, out_max + 1)),
            "group": g,
            "leader": i < groups,
        })
    return reqs


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _submit_with_backpressure(batcher, workload, deadline_s: float,
                              t0: float):
    """Submit the workload as a well-behaved client: queue and pool
    saturation (HTTP 429) retry with backoff, giving up only past
    `deadline_s` after `t0`. Returns (handles, backpressure retries)."""
    from .admission import PoolSaturated, QueueFull

    handles = []
    backpressured = 0
    for w in workload:
        while True:
            try:
                handles.append(batcher.submit(w["prompt"], w["max_new"]))
                break
            except (QueueFull, PoolSaturated):
                backpressured += 1
                if time.monotonic() - t0 > deadline_s:
                    raise
                time.sleep(0.02)
    return handles, backpressured


def run_continuous(model, workload, max_len: int, slots: int,
                   page_size: int, deadline_s: float,
                   prefill_chunk=None) -> Dict:
    from .continuous import ContinuousBatcher

    batcher = ContinuousBatcher(
        model, max_len=max_len, num_slots=slots, page_size=page_size,
        prefill_chunk_tokens=prefill_chunk,
        prefix_cache_pages=0 if prefill_chunk == 0 else None,
        max_queue=max(len(workload), 1))
    with batcher:
        # warmup OUTSIDE the timed window: the first prefill and decode
        # dispatches build the kernels and capture the graphs; both
        # paths get the same treatment, so the comparison is scheduling.
        # Two multi-chunk all-zero submits cover every chunked-prefill
        # path (chunk, fused last chunk, insert, and — second time —
        # install); zeros never collide with real prompts
        # the warmup prompt must itself be admissible: cap it to the
        # cache span (2 new tokens) and the one-shot window
        warm_len = min(page_size * 2 + 1, max_len - 2)
        if batcher.prefill_chunk_tokens == 0:
            warm_len = min(2, warm_len)  # single prefill compile
        warm = np.zeros(max(1, warm_len), np.int32)
        batcher.submit(warm, 2).result(timeout=600.0)
        batcher.submit(warm, 2).result(timeout=600.0)
        t0 = time.monotonic()
        handles, backpressured = _submit_with_backpressure(
            batcher, workload, deadline_s, t0)
        results = [h.result(timeout=600.0) for h in handles]
    wall = time.monotonic() - t0
    tokens = sum(len(r) for r in results)
    dropped = sum(1 for h, w in zip(handles, workload)
                  if h.error is not None or len(h.tokens) != w["max_new"])
    ttfts = [h.ttft_s * 1e3 for h in handles if h.ttft_s is not None]
    # split by prefix-cache outcome: the ff_serving_ttft_ms histogram has
    # carried the `cache` label since the PrefixCache landed, but the
    # summary used to collapse it — the hit/miss p99 split is what makes
    # an affine-routing (or cache-sizing) win visible in one BENCH line
    hit_ttfts = [h.ttft_s * 1e3 for h in handles
                 if h.cache_hit and h.ttft_s is not None]
    miss_ttfts = [h.ttft_s * 1e3 for h in handles
                  if not h.cache_hit and h.ttft_s is not None]
    lats = [(h.t_done - h.t_submit) * 1e3 for h in handles
            if h.t_done is not None]
    waits = [h.queue_wait_s or 0.0 for h in handles]
    return {
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "tokens_per_s": round(tokens / wall, 2) if wall > 0 else 0.0,
        "dropped": dropped,
        "ttft_ms_p50": round(_pct(ttfts, 50), 2),
        "ttft_ms_p95": round(_pct(ttfts, 95), 2),
        "ttft_ms_p99": round(_pct(ttfts, 99), 2),
        "ttft_hit_ms_p99": round(_pct(hit_ttfts, 99), 2),
        "ttft_miss_ms_p99": round(_pct(miss_ttfts, 99), 2),
        "cache_hits": len(hit_ttfts),
        "cache_misses": len(miss_ttfts),
        "latency_ms_p50": round(_pct(lats, 50), 2),
        "latency_ms_p95": round(_pct(lats, 95), 2),
        "max_queue_wait_s": round(max(waits), 3) if waits else 0.0,
        "starved": sum(1 for w in waits if w > deadline_s),
        "backpressure_retries": backpressured,
        "stats": batcher.stats(),
    }


def run_lockstep(model, workload, max_len: int) -> Dict:
    """The baseline: fixed batches through GenerativeSession — prompts
    zero-padded to the longest in each batch, every batch decoding until
    its LONGEST output finishes. Each request is still only credited the
    tokens it asked for (goodput, not padded throughput)."""
    from ..generate import GenerativeSession

    b = model.config.batch_size
    session = GenerativeSession(model, max_len=max_len)
    # warmup: compile the prefill + decode dispatches outside the timing
    session.generate(np.ones((1, 2), np.int32), 2)
    t0 = time.monotonic()
    tokens = 0
    for lo in range(0, len(workload), b):
        group = workload[lo:lo + b]
        plen = max(w["prompt"].size for w in group)
        prompts = np.zeros((len(group), plen), np.int32)
        for i, w in enumerate(group):
            prompts[i, :w["prompt"].size] = w["prompt"]
        n_new = max(w["max_new"] for w in group)
        out = session.generate(prompts, n_new)
        assert out.shape == (len(group), n_new), out.shape
        tokens += sum(w["max_new"] for w in group)  # goodput credit
    wall = time.monotonic() - t0
    return {
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "tokens_per_s": round(tokens / wall, 2) if wall > 0 else 0.0,
    }


def run_shared_prefix(model, workload, max_len: int, slots: int,
                      page_size: int, prefix_cache_pages: int,
                      deadline_s: float) -> Dict:
    """Drive the shared-prefix workload: leaders first (cold prefills that
    populate the cache), then followers in waves of `slots` so queue wait
    never pollutes the TTFT comparison. Every request's tokens are checked
    against a cache-cold lockstep reference — the greedy-parity acceptance
    bound."""
    from ..generate import GenerativeSession
    from .continuous import ContinuousBatcher

    session = GenerativeSession(model, max_len=max_len)
    refs = [session.generate(w["prompt"][None, :], w["max_new"])[0]
            for w in workload]

    batcher = ContinuousBatcher(
        model, max_len=max_len, num_slots=slots, page_size=page_size,
        prefix_cache_pages=prefix_cache_pages,
        max_queue=max(len(workload), 1))
    leaders = [(i, w) for i, w in enumerate(workload) if w["leader"]]
    followers = [(i, w) for i, w in enumerate(workload) if not w["leader"]]
    handles: List = [None] * len(workload)
    with batcher:
        # warmup outside the timed window: the first (cold) run compiles
        # chunk / fused-last-chunk / insert, the second (hitting its own
        # insert) compiles the install path. All-zero tokens can never
        # collide with real prompts (make_*_workload draws from
        # [1, vocab))
        warm = np.zeros(
            max(1, min(batcher.pool.page_size * 2 + 1, max_len - 2)),
            np.int32)
        batcher.submit(warm, 2).result(timeout=600.0)
        batcher.submit(warm, 2).result(timeout=600.0)
        t0 = time.monotonic()
        for i, w in leaders:
            handles[i] = batcher.submit(w["prompt"], w["max_new"])
        for i, _ in leaders:
            handles[i].result(timeout=600.0)
        # followers in waves of `slots`: every follower gets a slot
        # immediately, so its TTFT measures prefill cost, not queueing
        for lo in range(0, len(followers), slots):
            wave = followers[lo:lo + slots]
            for i, w in wave:
                handles[i] = batcher.submit(w["prompt"], w["max_new"])
            for i, _ in wave:
                handles[i].result(timeout=600.0)
        wall = time.monotonic() - t0
        stats = batcher.stats()
    tokens = sum(len(h.tokens) for h in handles)
    dropped = sum(1 for h, w in zip(handles, workload)
                  if h.error is not None or len(h.tokens) != w["max_new"])
    parity_bad = sum(
        1 for h, ref in zip(handles, refs)
        if not np.array_equal(np.asarray(h.tokens, np.int32),
                              np.asarray(ref)))
    hit_ttfts = [h.ttft_s * 1e3 for h in handles
                 if h.cache_hit and h.ttft_s is not None]
    miss_ttfts = [h.ttft_s * 1e3 for h in handles
                  if not h.cache_hit and h.ttft_s is not None]
    waits = [h.queue_wait_s or 0.0 for h in handles]
    prefix_stats = stats["pool"].get("prefix", {})
    return {
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "tokens_per_s": round(tokens / wall, 2) if wall > 0 else 0.0,
        "dropped": dropped,
        "parity_mismatches": parity_bad,
        "requests": len(workload),
        "hits": len(hit_ttfts),
        "misses": len(miss_ttfts),
        "ttft_hit_ms_p50": round(_pct(hit_ttfts, 50), 2),
        "ttft_hit_ms_p95": round(_pct(hit_ttfts, 95), 2),
        "ttft_hit_ms_p99": round(_pct(hit_ttfts, 99), 2),
        "ttft_miss_ms_p50": round(_pct(miss_ttfts, 50), 2),
        "ttft_miss_ms_p95": round(_pct(miss_ttfts, 95), 2),
        "ttft_miss_ms_p99": round(_pct(miss_ttfts, 99), 2),
        "ttft_miss_over_hit_p50": round(
            _pct(miss_ttfts, 50) / _pct(hit_ttfts, 50), 2)
        if hit_ttfts and _pct(hit_ttfts, 50) > 0 else 0.0,
        "pages_saved": prefix_stats.get("pages_saved", 0),
        "prefix": prefix_stats,
        "max_queue_wait_s": round(max(waits), 3) if waits else 0.0,
        "starved": sum(1 for w in waits if w > deadline_s),
        "stats": stats,
    }


def _itl_during(handles, t_start: float, t_end: float) -> List[float]:
    """Inter-token gaps (ms) of the given requests that OVERLAP
    [t_start, t_end] — the in-flight decoders' latency while the long
    prefill was running. Overlap, not containment: the one-shot stall is
    a single gap that starts before the prefill and ends after it, and it
    must be counted."""
    gaps = []
    for h in handles:
        ts = h.token_times
        for a, b in zip(ts, ts[1:]):
            if a <= t_end and b >= t_start:
                gaps.append((b - a) * 1e3)
    return gaps


def run_long_prefill(model, max_len: int, slots: int, page_size: int,
                     long_len: int, long_out: int, decoder_out: int,
                     chunk: int, vocab: int, seed: int) -> Dict:
    """One run of the long-prefill scenario: slots-1 short-prompt decoders
    start decoding, then one `long_len`-token prompt arrives. chunk=0 is
    the one-shot baseline (the full-prompt stall); chunk>0 interleaves.
    Returns per-run ITL stats + the long request's tokens (for the
    chunked-vs-one-shot parity assert)."""
    from .continuous import ContinuousBatcher

    rng = np.random.RandomState(seed)
    dec_prompts = [rng.randint(1, vocab, size=(8,)).astype(np.int32)
                   for _ in range(max(1, slots - 1))]
    long_prompt = rng.randint(1, vocab, size=(long_len,)).astype(np.int32)
    batcher = ContinuousBatcher(
        model, max_len=max_len, num_slots=slots, page_size=page_size,
        prefill_chunk_tokens=chunk,
        # cache off: both runs must be cache-cold for a fair stall
        # comparison (and one-shot cannot use it anyway)
        prefix_cache_pages=0,
        max_queue=slots + 4)
    with batcher:
        # warmup covers both the multi-chunk and fused-final-chunk paths
        batcher.submit(
            np.zeros(max(1, min(2 * page_size + 1, max_len - 2)), np.int32),
            2).result(timeout=600.0)
        decoders = [batcher.submit(p, decoder_out) for p in dec_prompts]
        # wait until every decoder is actually decoding
        deadline = time.monotonic() + 600.0
        for d in decoders:
            while not d.token_times:
                if d.error is not None or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"decoder {d.id} never produced a token"
                        f" (error={d.error})")
                time.sleep(0.005)
        t_submit = time.monotonic()
        long_req = batcher.submit(long_prompt, long_out)
        long_toks = long_req.result(timeout=600.0)
        t_first = long_req.t_first_token
        for d in decoders:
            d.result(timeout=600.0)
    stall = _itl_during(decoders, t_submit, t_first)
    all_gaps = [g for h in decoders
                for g in np.diff(np.asarray(h.token_times)) * 1e3]
    return {
        "chunk": chunk,
        "long_prompt_tokens": int(long_len),
        "ttft_long_ms": round((t_first - t_submit) * 1e3, 2),
        "decode_itl_ms_median": round(_pct(all_gaps, 50), 2),
        "stall_itl_ms_p99": round(_pct(stall, 99), 2),
        "stall_itl_ms_max": round(max(stall), 2) if stall else 0.0,
        "stall_samples": len(stall),
        "long_tokens": [int(t) for t in long_toks],
        "decoder_tokens": [[int(t) for t in d.tokens] for d in decoders],
    }


def run_mesh_resize(model, workload, max_len: int, slots: int,
                    page_size: int, shrink_to: int,
                    deadline_s: float) -> Dict:
    """Drive the mesh-resize scenario: submit the workload, and once
    tokens are flowing shrink the mesh to `shrink_to` slots (the resize
    defers until live sequences fit — nothing is dropped), then grow it
    back. Every request's tokens are compared against a no-resize
    reference run of the SAME workload — greedy decode must be
    token-identical across a topology change."""
    from .continuous import ContinuousBatcher

    def drive(batcher, resize: bool) -> Dict:
        resizes = []
        with batcher:
            warm = np.zeros(
                max(1, min(batcher.pool.page_size * 2 + 1, max_len - 2)),
                np.int32)
            batcher.submit(warm, 2).result(timeout=600.0)
            t0 = time.monotonic()
            handles, _ = _submit_with_backpressure(
                batcher, workload, deadline_s, t0)
            if resize:
                # wait until decode is genuinely in flight, then resize
                # under load: shrink (defers until live fits), grow back
                deadline = time.monotonic() + deadline_s
                while not any(h.tokens for h in handles):
                    if time.monotonic() > deadline:
                        raise RuntimeError("no tokens before resize")
                    time.sleep(0.005)
                resizes.append(
                    batcher.request_resize(shrink_to).wait(
                        timeout=deadline_s))
                resizes.append(
                    batcher.request_resize(slots).wait(
                        timeout=deadline_s))
            results = [h.result(timeout=600.0) for h in handles]
            wall = time.monotonic() - t0
        tokens = sum(len(r) for r in results)
        return {
            "wall_s": round(wall, 3),
            "tokens": tokens,
            "tokens_per_s": round(tokens / wall, 2) if wall > 0 else 0.0,
            "dropped": sum(
                1 for h, w in zip(handles, workload)
                if h.error is not None or len(h.tokens) != w["max_new"]),
            "token_lists": [[int(t) for t in h.tokens] for h in handles],
            "resizes": resizes,
        }

    def make_batcher():
        return ContinuousBatcher(
            model, max_len=max_len, num_slots=slots, page_size=page_size,
            prefix_cache_pages=0, max_queue=max(len(workload), 1))

    ref = drive(make_batcher(), resize=False)
    res = drive(make_batcher(), resize=True)
    parity_bad = sum(1 for a, b in zip(res["token_lists"],
                                       ref["token_lists"]) if a != b)
    out = {k: v for k, v in res.items() if k != "token_lists"}
    out.update({
        "requests": len(workload),
        "parity_mismatches": parity_bad,
        "reference_tokens_per_s": ref["tokens_per_s"],
        "reference_dropped": ref["dropped"],
        "migrated_in_flight": min(
            (r.get("in_flight", 0) for r in res["resizes"]), default=0),
        "predicted_resize_us": [r.get("predicted_us")
                                for r in res["resizes"]],
    })
    return out


def run_speculative_once(model, draft, workload, max_len: int, slots: int,
                         page_size: int, spec_tokens: int,
                         deadline_s: float) -> Dict:
    """One timed pass of the workload ([{"prompt", "max_new"}, ...]):
    plain greedy when `draft` is None, draft-verify speculative
    otherwise. Two warm-up requests run outside the timed window (they
    capture the chunk graphs of the slots they take, both models', and
    the decode or speculative graph). Returns tokens/s, the token lists
    and the batcher's spec stats."""
    from .continuous import ContinuousBatcher

    batcher = ContinuousBatcher(
        model, max_len=max_len, num_slots=slots, page_size=page_size,
        prefix_cache_pages=0, max_queue=max(len(workload), 1),
        draft_model=draft, spec_tokens=spec_tokens)
    with batcher:
        warm = np.zeros(
            max(1, min(page_size * 2 + 1, max_len - 4)), np.int32)
        batcher.submit(warm, 3).result(timeout=600.0)
        batcher.submit(warm, 3).result(timeout=600.0)
        t0 = time.monotonic()
        handles, backpressured = _submit_with_backpressure(
            batcher, workload, deadline_s, t0)
        results = [h.result(timeout=600.0) for h in handles]
        wall = time.monotonic() - t0
        stats = batcher.stats()
    tokens = sum(len(r) for r in results)
    return {
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "tokens_per_s": round(tokens / wall, 2) if wall > 0 else 0.0,
        "dropped": sum(
            1 for h, w in zip(handles, workload)
            if h.error is not None or len(h.tokens) != w["max_new"]),
        "backpressure_retries": backpressured,
        "token_lists": [[int(t) for t in h.tokens] for h in handles],
        "spec": stats.get("spec"),
        "decode_iter_s": stats.get("decode_iter_s"),
    }


def session_refs(model, workload, max_len: int) -> List[np.ndarray]:
    """Each request's greedy tokens from a lockstep GenerativeSession: the
    reference `run_moe` holds the batcher's tokens against."""
    from ..generate import GenerativeSession

    session = GenerativeSession(model, max_len=max_len)
    return [session.generate(w["prompt"][None, :], w["max_new"])[0]
            for w in workload]


def run_moe(model, workload, max_len: int, slots: int, page_size: int,
            deadline_s: float, affinity_window: int,
            expert_affinity: bool = True,
            refs: Optional[List[np.ndarray]] = None) -> Dict:
    """The MoE workload ([{"prompt", "max_new"}, ...]) through the
    continuous batcher with expert-affine admission (on unless
    `expert_affinity` is False), each request's greedy tokens checked
    against `refs`, by default `session_refs`: affinity may reorder
    admissions, never change tokens. One warm-up request a slot,
    submitted together (each captures its slot's chunk graph), runs
    outside the timed window. Returns tokens/s, parity mismatches, the
    token lists, TTFTs, queue waits, the warm-up's graph counts and the
    batcher's stats (with its "affinity" picks)."""
    from .continuous import ContinuousBatcher

    if refs is None:
        refs = session_refs(model, workload, max_len)
    batcher = ContinuousBatcher(
        model, max_len=max_len, num_slots=slots, page_size=page_size,
        prefix_cache_pages=0, max_queue=max(len(workload), 1),
        expert_affinity=expert_affinity, affinity_window=affinity_window)
    with batcher:
        warm = np.zeros(
            max(1, min(page_size * 2 + 1, max_len - 2)), np.int32)
        for r in [batcher.submit(warm, 2) for _ in range(slots)]:
            r.result(timeout=600.0)
        warm_graphs = dict(batcher.stats()["graphs"])
        t0 = time.monotonic()
        handles, backpressured = _submit_with_backpressure(
            batcher, workload, deadline_s, t0)
        results = [h.result(timeout=600.0) for h in handles]
        wall = time.monotonic() - t0
        stats = batcher.stats()
    tokens = sum(len(r) for r in results)
    parity_bad = sum(
        1 for h, ref in zip(handles, refs)
        if not np.array_equal(np.asarray(h.tokens, np.int32),
                              np.asarray(ref)))
    waits = [h.queue_wait_s or 0.0 for h in handles]
    ttft = [h.ttft_s for h in handles if h.ttft_s is not None]
    return {
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "tokens_per_s": round(tokens / wall, 2) if wall > 0 else 0.0,
        "dropped": sum(
            1 for h, w in zip(handles, workload)
            if h.error is not None or len(h.tokens) != w["max_new"]),
        "parity_mismatches": parity_bad,
        "requests": len(workload),
        "max_queue_wait_s": round(max(waits), 3) if waits else 0.0,
        "starved": sum(1 for w in waits if w > deadline_s),
        "backpressure_retries": backpressured,
        "token_lists": [[int(t) for t in h.tokens] for h in handles],
        "ttft_s": ttft,
        "affinity": stats.get("affinity") or {},
        "graphs_warmup": warm_graphs,
        "stats": stats,
    }


def _moe_router_check(model, workload, window: int) -> Dict:
    """One inference walk over the workload's prompts handed the model's
    own state, so the fused ExpertsOps count their capacity-overflow drops
    and per-expert load there; then published into the obs registry (the
    ff_moe_* families). Returns {op: {dropped, load}}."""
    from ...obs.moe import publish_moe_metrics

    b = model.config.batch_size
    batch = np.zeros((b, window), np.int32)
    for i, w in enumerate(workload[:b]):
        p = w["prompt"][:window]
        batch[i, :p.size] = p
    feeds = {model.input_ops[0].name:
             torch.from_numpy(batch).to(model.device)}
    with torch.no_grad():
        model.executor.forward_values(feeds, state=model.state)
    return publish_moe_metrics(model)


def _spec_pricing(model, spec_tokens: int, max_len: int,
                  slots: int) -> Dict:
    """The CostModel's view of the two hot dispatches: one plain decode
    step vs one C = k+1 multi-query verify, with and without the fused
    tier selected — the predicted side of the speculative win."""
    from ...ffconst import OpType
    from ...kernels.registry import KERNELS, PALLAS_COST_GAIN
    from ...search.machine_model import make_machine_model
    from ...search.simulator import CostModel

    attn = next(op for op in model.graph.ops.values()
                if op.op_type == OpType.MULTIHEAD_ATTENTION)
    machine = make_machine_model(model.config,
                                 max(1, model.config.total_devices))
    cost = CostModel(machine, model.config)
    c = spec_tokens + 1
    ref_plain = cost.decode_step_time_us(attn, slots, max_len, 1)
    ref_mq = cost.decode_step_time_us(attn, slots, max_len, c)
    with KERNELS.override("attention_decode", "pallas"), \
            KERNELS.override("attention_decode_mq", "pallas"):
        fused_plain = cost.decode_step_time_us(attn, slots, max_len, 1)
        fused_mq = cost.decode_step_time_us(attn, slots, max_len, c)
    return {
        "decode_us_reference": round(ref_plain, 3),
        "decode_us_fused": round(fused_plain, 3),
        "verify_us_reference": round(ref_mq, 3),
        "verify_us_fused": round(fused_mq, 3),
        "mq_gain_priced": round(fused_mq / ref_mq, 4) if ref_mq else 0.0,
        "mq_gain_expected": PALLAS_COST_GAIN["attention_decode_mq"],
    }


def _run_speculative_cli(args) -> int:
    """Speculative against plain greedy decode: tokens identical, nonzero
    acceptance, >= --spec-speedup tokens/s per chip, a rerun with the
    decode kernels forced still identical, and the CostModel pricing the
    multi-query family."""
    from ...kernels.registry import KERNELS, PALLAS_COST_GAIN

    window = args.prompt_max
    max_len = args.prompt_max + args.out_max
    draft_layers = args.draft_layers or args.layers
    draft_hidden = args.draft_hidden or args.hidden
    tied = (not args.no_draft_tied and draft_layers == args.layers
            and draft_hidden == args.hidden)
    print(f"[serve-bench] speculative: {args.requests} requests,"
          f" k={args.spec_tokens} draft tokens/iteration, draft"
          f" layers={draft_layers} hidden={draft_hidden}"
          f" ({'tied weights' if tied else 'independent weights'})")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    draft = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=draft_hidden, heads=args.heads,
                          layers=draft_layers, device=args.device)
    if tied:
        # a draft of the target's weights: acceptance ~1.0 by
        # construction, so the run measures the scheduling and dispatch
        # win alone
        draft.load_params(model.params)
    workload = make_workload(args.requests, args.prompt_min,
                             args.prompt_max, args.out_min, args.out_max,
                             args.vocab, args.seed)

    # best-of-N both sides: shared-runner outlier armor (same contract
    # as the fleet bench's --repeats)
    plain = spec = None
    for _ in range(max(1, args.repeats)):
        p = run_speculative_once(model, None, workload, max_len,
                                 args.slots, args.page_size,
                                 args.spec_tokens, args.deadline)
        s = run_speculative_once(model, draft, workload, max_len,
                                 args.slots, args.page_size,
                                 args.spec_tokens, args.deadline)
        if plain is None or p["tokens_per_s"] > plain["tokens_per_s"]:
            plain = p
        if spec is None or s["tokens_per_s"] > spec["tokens_per_s"]:
            spec = s
    speedup = (spec["tokens_per_s"] / plain["tokens_per_s"]
               if plain["tokens_per_s"] else 0.0)
    parity_bad = sum(1 for a, b in zip(spec["token_lists"],
                                       plain["token_lists"]) if a != b)
    acc = spec["spec"] or {}
    print(f"[serve-bench] plain: {plain['tokens']} tokens in"
          f" {plain['wall_s']}s = {plain['tokens_per_s']} tok/s |"
          f" speculative: {spec['tokens']} tokens in {spec['wall_s']}s ="
          f" {spec['tokens_per_s']} tok/s | speedup {speedup:.2f}x"
          f" (require >= {args.spec_speedup}x)")
    print(f"[serve-bench] acceptance: {acc.get('accepted', 0)}/"
          f"{acc.get('proposed', 0)} = {acc.get('acceptance', 0.0):.3f} |"
          f" parity mismatches {parity_bad} | dropped"
          f" spec={spec['dropped']} plain={plain['dropped']}")

    # the forced-kernel leg: a short rerun with the decode kernels
    # FORCED (their plain versions on CPU tensors) must stay identical,
    # end to end: the multi-query kernel computes what the einsum does
    fused_workload = workload[:min(6, len(workload))]
    fused_workload = [dict(w, max_new=min(8, w["max_new"]))
                      for w in fused_workload]
    fused_ref = run_speculative_once(model, None, fused_workload,
                                     max_len, args.slots, args.page_size,
                                     args.spec_tokens, args.deadline)
    with KERNELS.override("attention_decode", "pallas"), \
            KERNELS.override("attention_decode_mq", "pallas"):
        fused = run_speculative_once(model, draft, fused_workload,
                                     max_len, args.slots,
                                     args.page_size, args.spec_tokens,
                                     args.deadline)
    fused_parity_bad = sum(
        1 for a, b in zip(fused["token_lists"], fused_ref["token_lists"])
        if a != b)
    pricing = _spec_pricing(model, args.spec_tokens, max_len, args.slots)
    print(f"[serve-bench] fused mq leg: parity mismatches"
          f" {fused_parity_bad} ({len(fused_workload)} requests,"
          " kernels forced) | CostModel mq gain"
          f" {pricing['mq_gain_priced']} (expected"
          f" {pricing['mq_gain_expected']})")

    failures = []
    if plain["dropped"] or spec["dropped"]:
        failures.append(
            f"dropped/short requests: spec {spec['dropped']}, plain"
            f" {plain['dropped']}")
    if parity_bad:
        failures.append(
            f"{parity_bad} requests' greedy tokens differ between"
            " speculative and plain decode")
    if not acc.get("accepted"):
        failures.append("draft acceptance stayed zero")
    if speedup < args.spec_speedup:
        failures.append(
            f"speculative speedup {speedup:.2f}x below required"
            f" {args.spec_speedup}x")
    if fused["dropped"] or fused_parity_bad:
        failures.append(
            f"fused multi-query leg: {fused_parity_bad} parity"
            f" mismatches, {fused['dropped']} dropped")
    if abs(pricing["mq_gain_priced"]
           - PALLAS_COST_GAIN["attention_decode_mq"]) > 1e-6:
        failures.append(
            "CostModel does not price the attention_decode_mq family:"
            f" gain {pricing['mq_gain_priced']}, expected"
            f" {pricing['mq_gain_expected']}")
    _check_exposition(failures, extra_required=(
        "ff_spec_decode_proposed_total", "ff_spec_decode_accepted_total",
        "ff_spec_decode_acceptance"))
    report = {
        "config": vars(args),
        "speculative": {
            "tokens_per_s_per_chip": spec["tokens_per_s"],
            "plain_tokens_per_s_per_chip": plain["tokens_per_s"],
            "speedup": round(speedup, 3),
            "acceptance": round(acc.get("acceptance", 0.0), 4),
            "proposed": acc.get("proposed", 0),
            "accepted": acc.get("accepted", 0),
            "spec_tokens": args.spec_tokens,
            "draft_tied": tied,
            "parity_mismatches": parity_bad,
            "fused_parity_mismatches": fused_parity_bad,
            "dropped": spec["dropped"] + plain["dropped"],
            "pricing": pricing,
        },
    }
    return _finish(args, report, failures)


# run_moe's keys that the report leaves out: the batcher's stats, the
# token lists and the warm-up's graph counts (chip checks read them)
_MOE_RUN_ONLY = ("stats", "token_lists", "ttft_s", "graphs_warmup")


def _run_moe_cli(args) -> int:
    """The MoE serving leg: tokens identical to the lockstep reference and
    zero router drops under expert-affine continuous batching."""
    window = args.prompt_max
    max_len = args.prompt_max + args.out_max
    print(f"[serve-bench] moe: {args.requests} requests through a"
          f" {args.experts}-expert top-{args.moe_top_k} MoE LM"
          f" (hidden={args.hidden} layers={args.layers}), expert-affine"
          f" admission window {args.affinity_window}")
    model = build_tiny_moe_lm(args.slots, window, vocab=args.vocab,
                              hidden=args.hidden, heads=args.heads,
                              layers=args.layers, experts=args.experts,
                              moe_top_k=args.moe_top_k, device=args.device)
    workload = make_workload(args.requests, args.prompt_min,
                             args.prompt_max, args.out_min, args.out_max,
                             args.vocab, args.seed)
    res = run_moe(model, workload, max_len, args.slots, args.page_size,
                  args.deadline, args.affinity_window)
    router = _moe_router_check(model, workload, window)
    router_dropped = sum(v["dropped"] for v in router.values())
    aff = res["affinity"]
    picks = aff.get("picks", {})
    print(f"[serve-bench] {res['tokens']} tokens in {res['wall_s']}s ="
          f" {res['tokens_per_s']} tok/s | dropped {res['dropped']} |"
          f" parity mismatches {res['parity_mismatches']}")
    print(f"[serve-bench] affinity picks: {picks} | overlap ewma"
          f" {round(aff.get('overlap_ewma') or 0.0, 3)} | router drops"
          f" {router_dropped} across {len(router)} experts ops")

    failures = []
    if res["dropped"]:
        failures.append(f"{res['dropped']} requests dropped/short")
    if res["starved"]:
        failures.append(f"{res['starved']} requests starved past"
                        f" {args.deadline}s")
    if res["parity_mismatches"]:
        failures.append(
            f"{res['parity_mismatches']} requests' greedy tokens differ"
            " from the lockstep reference under expert-affine admission")
    if router_dropped > 0:
        failures.append(
            f"router dropped {router_dropped} token-assignments despite"
            f" capacity_factor == num_experts")
    if not router:
        failures.append("no EXPERTS op state found — the router check"
                        " never ran")
    if not picks or sum(picks.values()) == 0:
        failures.append(
            "expert-affine admission never made a pick (queue never"
            " held 2+ requests — raise --requests)")
    _check_exposition(failures, extra_required=(
        "ff_moe_router_dropped_tokens_total", "ff_moe_expert_load",
        "ff_moe_expert_load_imbalance", "ff_serving_affinity_picks_total",
        "ff_serving_affinity_overlap"))
    report = {"config": vars(args), "moe": {
        **{k: v for k, v in res.items() if k not in _MOE_RUN_ONLY},
        "router_dropped_tokens": router_dropped,
        "router": router,
    }}
    return _finish(args, report, failures)


def run_bench(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flexflow_tpu_torch serve-bench",
        description="continuous-batching vs lockstep serving load test")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the LMs run (default: the card)")
    ap.add_argument("--workload", default="mixed",
                    choices=("mixed", "shared-prefix", "long-prefill",
                             "mesh-resize", "fleet", "chaos", "disagg",
                             "speculative", "moe"))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=64)
    ap.add_argument("--out-min", type=int, default=8)
    ap.add_argument("--out-max", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots = lockstep batch width")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk tokens for the mixed workload"
                         " (default: batcher default; 0 = one-shot)")
    ap.add_argument("--deadline", type=float, default=120.0,
                    help="max tolerated admission-queue wait, seconds")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the lockstep run (continuous only)")
    ap.add_argument("--assert-speedup", type=float, default=None,
                    help="fail unless continuous/lockstep tokens/s >= X")
    ap.add_argument("--report", default=None,
                    help="write the result JSON here")
    # shared-prefix workload
    ap.add_argument("--prefix-groups", type=int, default=4,
                    help="distinct system prompts (shared-prefix)")
    ap.add_argument("--prefix-len", type=int, default=128,
                    help="system-prompt length in tokens (shared-prefix)")
    ap.add_argument("--suffix-min", type=int, default=2)
    ap.add_argument("--suffix-max", type=int, default=8)
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    help="band page budget (default: batcher default)")
    ap.add_argument("--ttft-ratio", type=float, default=3.0,
                    help="require miss/hit TTFT p50 >= this"
                         " (shared-prefix)")
    # long-prefill workload
    ap.add_argument("--long-prompt", type=int, default=4096,
                    help="long request's prompt length (long-prefill)")
    ap.add_argument("--long-out", type=int, default=4)
    ap.add_argument("--decoder-out", type=int, default=96,
                    help="tokens each in-flight decoder generates")
    ap.add_argument("--itl-ratio", type=float, default=3.0,
                    help="require one-shot stall max / chunked stall p99"
                         " >= this (long-prefill)")
    # mesh-resize workload
    ap.add_argument("--shrink-to", type=int, default=None,
                    help="mid-decode shrink target in slots"
                         " (mesh-resize; default slots // 2)")
    # fleet workload (serving/fleet/bench.py): N replicas behind the
    # prefix-affine router, shared-prefix tenant mix, diurnal swing with
    # the autoscaler live; --requests is the session count and
    # --prefix-groups the tenant count
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet replica count (fleet)")
    ap.add_argument("--min-slots", type=int, default=None,
                    help="autoscaler floor per replica"
                         " (fleet; default slots // 2)")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="autoscaler ceiling per replica"
                         " (fleet; default 2 * slots)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="SLO admission budget in ms: shed when every"
                         " replica's PREDICTED TTFT exceeds it (fleet;"
                         " default: no SLO shedding)")
    ap.add_argument("--affine-margin", type=float, default=1.2,
                    help="require round-robin p99 TTFT / affine p99 TTFT"
                         " >= this (fleet)")
    # chaos workload (serving/fleet/chaos.py): crash a loaded
    # replica mid-decode, assert zero lost requests + token parity +
    # detect/evict/respawn within the heartbeat window
    ap.add_argument("--chaos-seed", type=int, default=18,
                    help="seed for the FleetFaultPlan determinism check"
                         " (chaos)")
    ap.add_argument("--chaos-crash-after", type=int, default=12,
                    help="crash the victim this many generated tokens"
                         " after the chaos engine is armed (chaos)")
    ap.add_argument("--chaos-suspect", type=float, default=2.0,
                    help="heartbeat age that turns a replica SUSPECT"
                         " (chaos; generous — cold-dispatch compiles"
                         " look exactly like hangs)")
    ap.add_argument("--chaos-dead", type=float, default=10.0,
                    help="heartbeat age that turns a replica DEAD;"
                         " the DEAD-detect latency is asserted against"
                         " this window (chaos)")
    ap.add_argument("--chaos-interval", type=float, default=0.1,
                    help="HealthMonitor / Autoscaler poll interval"
                         " (chaos)")
    ap.add_argument("--artifacts", default=None,
                    help="directory for the chaos drill's observability"
                         " artifacts: request trace, EventLog dump,"
                         " flight-recorder post-mortem bundle, and the"
                         " merged Perfetto timeline; also arms the"
                         " failover trace-continuity assert (chaos)")
    # disagg workload (serving/fleet/disagg.py): the same
    # prefill-heavy stream through a unified fleet and a prefill/decode
    # split at equal chips; the split must protect the decode tail while
    # every request's KV ships through one priced, traced handoff
    ap.add_argument("--disagg-margin", type=float, default=1.2,
                    help="require unified p99 ITL / disagg p99 ITL >="
                         " this (disagg)")
    ap.add_argument("--machine-spec", default=None,
                    help="hierarchical machine JSON pricing the KV"
                         " handoff (disagg; default: a built-in 2x8"
                         " two-pod spec mirroring"
                         " examples/machines/multipod_2x8.json)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="static routing runs per policy; the best"
                         " steady-state p99 of each is compared (fleet —"
                         " outlier armor for shared runners; speculative"
                         " reuses it as best-of-N per decode mode)")
    # speculative workload (draft-verify decoding)
    ap.add_argument("--spec-tokens", type=int, default=3,
                    help="draft proposals per slot per iteration"
                         " (speculative)")
    ap.add_argument("--spec-speedup", type=float, default=1.3,
                    help="require speculative/plain tokens/s >= this"
                         " (speculative)")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="draft model layers (speculative; default ="
                         " target's)")
    ap.add_argument("--draft-hidden", type=int, default=None,
                    help="draft model hidden dim (speculative; default ="
                         " target's)")
    ap.add_argument("--no-draft-tied", action="store_true",
                    help="keep the draft's own random weights instead of"
                         " tying them to the target (speculative;"
                         " acceptance is then whatever the draft earns)")
    # moe workload (expert-affine serving)
    ap.add_argument("--experts", type=int, default=4,
                    help="expert count of the MoE bench model (moe)")
    ap.add_argument("--moe-top-k", type=int, default=2,
                    help="router top-k of the MoE bench model (moe)")
    ap.add_argument("--affinity-window", type=int, default=4,
                    help="expert-affine admission fairness window:"
                         " queued requests considered per pick, and the"
                         " max times any request may be passed over"
                         " (moe)")
    args = ap.parse_args(argv)
    require_device(args.device)

    if args.workload == "shared-prefix":
        return _run_shared_prefix_cli(args)
    if args.workload == "long-prefill":
        return _run_long_prefill_cli(args)
    if args.workload == "mesh-resize":
        return _run_mesh_resize_cli(args)
    if args.workload == "speculative":
        return _run_speculative_cli(args)
    if args.workload == "moe":
        return _run_moe_cli(args)
    if args.workload == "fleet":
        from ..fleet.bench import run_fleet_cli

        return run_fleet_cli(args)
    if args.workload == "chaos":
        from ..fleet.bench import run_chaos_cli

        return run_chaos_cli(args)
    if args.workload == "disagg":
        from ..fleet.bench import run_disagg_cli

        return run_disagg_cli(args)

    window = args.prompt_max
    max_len = args.prompt_max + args.out_max
    print(f"[serve-bench] model: hidden={args.hidden} layers={args.layers}"
          f" heads={args.heads} vocab={args.vocab} window={window}"
          f" max_len={max_len}")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    workload = make_workload(args.requests, args.prompt_min,
                             args.prompt_max, args.out_min, args.out_max,
                             args.vocab, args.seed)
    total_requested = sum(w["max_new"] for w in workload)
    print(f"[serve-bench] workload: {len(workload)} requests,"
          f" prompts {args.prompt_min}-{args.prompt_max},"
          f" outputs {args.out_min}-{args.out_max}"
          f" ({total_requested} tokens requested)")

    cont = run_continuous(model, workload, max_len, args.slots,
                          args.page_size, args.deadline,
                          prefill_chunk=args.prefill_chunk)
    print(f"[serve-bench] continuous: {cont['tokens']} tokens in"
          f" {cont['wall_s']}s = {cont['tokens_per_s']} tok/s |"
          f" ttft p50/p95 {cont['ttft_ms_p50']}/{cont['ttft_ms_p95']} ms |"
          f" ttft p99 hit/miss {cont['ttft_hit_ms_p99']}/"
          f"{cont['ttft_miss_ms_p99']} ms"
          f" ({cont['cache_hits']}h/{cont['cache_misses']}m) |"
          f" latency p50/p95 {cont['latency_ms_p50']}/"
          f"{cont['latency_ms_p95']} ms | dropped={cont['dropped']}"
          f" starved={cont['starved']}")

    report = {"config": vars(args), "continuous": cont}
    failures = []
    if cont["dropped"]:
        failures.append(f"{cont['dropped']} requests dropped/short")
    if cont["tokens"] != total_requested:
        failures.append(
            f"token count mismatch: emitted {cont['tokens']},"
            f" requested {total_requested}")
    if cont["starved"]:
        failures.append(
            f"{cont['starved']} requests starved past the"
            f" {args.deadline}s admission deadline")

    if not args.no_baseline:
        base = run_lockstep(model, workload, max_len)
        report["lockstep"] = base
        speedup = (cont["tokens_per_s"] / base["tokens_per_s"]
                   if base["tokens_per_s"] else float("inf"))
        report["speedup"] = round(speedup, 3)
        print(f"[serve-bench] lockstep:   {base['tokens']} tokens in"
              f" {base['wall_s']}s = {base['tokens_per_s']} tok/s")
        print(f"[serve-bench] speedup: {report['speedup']}x"
              " (continuous / lockstep aggregate tokens/s)")
        if args.assert_speedup is not None and speedup < args.assert_speedup:
            failures.append(
                f"speedup {speedup:.2f}x below required"
                f" {args.assert_speedup}x")

    _check_exposition(failures)
    return _finish(args, report, failures)


def _check_exposition(failures: List[str], extra_required=()) -> None:
    """The run's own metrics must render through the one exposition
    renderer and parse back — the check a scrape of /metrics makes."""
    from ...obs import validate_exposition
    from ...obs.registry import REGISTRY

    text = REGISTRY.render()
    validate_exposition(text)
    for required in (("ff_kvpool_pages_total", "ff_serving_slots_active",
                      "ff_serving_ttft_ms", "ff_serving_itl_ms",
                      "ff_serving_queue_depth") + tuple(extra_required)):
        if required not in text:
            failures.append(f"metric {required} missing from exposition")
    print("[serve-bench] metrics exposition: valid"
          f" ({len(text.splitlines())} lines)")


def _finish(args, report: Dict, failures: List[str]) -> int:
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[serve-bench] report -> {args.report}")

    if failures:
        for f in failures:
            print(f"[serve-bench] FAIL: {f}")
        return 1
    print("[serve-bench] OK")
    return 0


def _run_mesh_resize_cli(args) -> int:
    """The slot resize under load: the batcher shrinks and grows back
    mid-decode with zero dropped requests and tokens identical to a run
    without the resize."""
    shrink_to = args.shrink_to if args.shrink_to is not None \
        else max(1, args.slots // 2)
    if not 1 <= shrink_to < args.slots:
        raise SystemExit(
            f"--shrink-to {shrink_to} must be in [1, --slots {args.slots})")
    window = args.prompt_max
    max_len = args.prompt_max + args.out_max
    print(f"[serve-bench] mesh-resize: {args.requests} requests on"
          f" {args.slots} slots, shrink to {shrink_to} mid-decode and"
          f" grow back (outputs {args.out_min}-{args.out_max})")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    workload = make_workload(args.requests, args.prompt_min,
                             args.prompt_max, args.out_min, args.out_max,
                             args.vocab, args.seed)
    res = run_mesh_resize(model, workload, max_len, args.slots,
                          args.page_size, shrink_to, args.deadline)
    print(f"[serve-bench] {res['tokens']} tokens in {res['wall_s']}s ="
          f" {res['tokens_per_s']} tok/s (no-resize reference"
          f" {res['reference_tokens_per_s']} tok/s) | dropped"
          f" {res['dropped']} | parity mismatches"
          f" {res['parity_mismatches']}")
    for r in res["resizes"]:
        print(f"[serve-bench] resize {r['from']}->{r['to']}"
              f" ({r['direction']}): migrated {r['migrated_rows']} rows,"
              f" {r['in_flight']} in-flight, predicted"
              f" {r['predicted_us']} us, wall {r['wall_ms']} ms")

    failures = []
    if res["dropped"] or res["reference_dropped"]:
        failures.append(
            f"dropped/short requests: resize run {res['dropped']},"
            f" reference {res['reference_dropped']}")
    if res["parity_mismatches"]:
        failures.append(
            f"{res['parity_mismatches']} requests' greedy tokens changed"
            " across the resize")
    if len(res["resizes"]) != 2:
        failures.append(
            f"expected shrink + grow, applied {len(res['resizes'])}")
    elif res["resizes"][0]["to"] != shrink_to:
        failures.append(
            f"shrink landed on {res['resizes'][0]['to']} slots, wanted"
            f" {shrink_to}")
    if res["migrated_in_flight"] < 1:
        failures.append(
            "no in-flight sequence was migrated — the resize never"
            " happened under load (raise --out-max)")
    _check_exposition(failures,
                      extra_required=("ff_serving_resizes_total",))
    return _finish(args, {"config": vars(args), "mesh_resize": res},
                   failures)


def _run_shared_prefix_cli(args) -> int:
    """N requests over K distinct system prompts, the multi-tenant KV
    reuse: hit TTFT >= --ttft-ratio lower than miss TTFT, nonzero pages
    saved, greedy tokens identical to the cache-cold lockstep path."""
    window = args.prefix_len + args.suffix_max
    max_len = window + args.out_max
    print(f"[serve-bench] shared-prefix: {args.requests} requests over"
          f" {args.prefix_groups} system prompts of {args.prefix_len}"
          f" tokens, suffixes {args.suffix_min}-{args.suffix_max},"
          f" outputs {args.out_min}-{args.out_max}")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    workload = make_shared_prefix_workload(
        args.requests, args.prefix_groups, args.prefix_len,
        args.suffix_min, args.suffix_max, args.out_min, args.out_max,
        args.vocab, args.seed)
    # every follower must be able to hit: budget >= the resident groups
    # (+2 pages for the warmup request's own insert)
    pages = args.prefix_cache_pages
    if pages is None:
        pages = 2 + args.prefix_groups * math.ceil(
            (args.prefix_len + args.suffix_max) / args.page_size)
    res = run_shared_prefix(model, workload, max_len, args.slots,
                            args.page_size, pages, args.deadline)
    print(f"[serve-bench] {res['tokens']} tokens in {res['wall_s']}s ="
          f" {res['tokens_per_s']} tok/s | hits {res['hits']} misses"
          f" {res['misses']} | pages_saved {res['pages_saved']}")
    print(f"[serve-bench] ttft p50 hit/miss:"
          f" {res['ttft_hit_ms_p50']}/{res['ttft_miss_ms_p50']} ms"
          f" (miss/hit = {res['ttft_miss_over_hit_p50']}x, require >="
          f" {args.ttft_ratio}x) | p95 hit/miss:"
          f" {res['ttft_hit_ms_p95']}/{res['ttft_miss_ms_p95']} ms")

    failures = []
    if res["dropped"]:
        failures.append(f"{res['dropped']} requests dropped/short")
    if res["starved"]:
        failures.append(f"{res['starved']} requests starved past"
                        f" {args.deadline}s")
    if res["parity_mismatches"]:
        failures.append(
            f"{res['parity_mismatches']} requests' greedy tokens differ"
            " from the cache-cold lockstep reference")
    if res["misses"] != args.prefix_groups:
        failures.append(
            f"expected exactly {args.prefix_groups} cold leaders, got"
            f" {res['misses']} misses")
    if res["hits"] != args.requests - args.prefix_groups:
        failures.append(
            f"expected every follower to hit, got {res['hits']}/"
            f"{args.requests - args.prefix_groups}")
    if res["pages_saved"] <= 0:
        failures.append("ff_kvpool_pages_saved stayed zero")
    if res["ttft_miss_over_hit_p50"] < args.ttft_ratio:
        failures.append(
            f"hit TTFT only {res['ttft_miss_over_hit_p50']}x lower than"
            f" miss (required {args.ttft_ratio}x)")
    _check_exposition(failures, extra_required=(
        "ff_kvpool_pages_saved", "ff_prefix_cache_hits_total",
        "ff_prefix_cache_misses_total", "ff_prefix_cache_pages"))
    return _finish(args, {"config": vars(args), "shared_prefix": res},
                   failures)


def _run_long_prefill_cli(args) -> int:
    """One long-prompt request against in-flight decoders, chunked then
    one-shot: in-flight ITL bounded during the long prefill, tokens
    identical to the one-shot path."""
    window = args.long_prompt  # the one-shot baseline pads to the window
    max_len = args.long_prompt + max(args.long_out, args.decoder_out) + 8
    print(f"[serve-bench] long-prefill: {args.long_prompt}-token prompt"
          f" against {max(1, args.slots - 1)} in-flight decoders"
          f" ({args.decoder_out} tokens each), chunk {args.page_size}"
          " vs one-shot")
    model = build_tiny_lm(args.slots, window, vocab=args.vocab,
                          hidden=args.hidden, heads=args.heads,
                          layers=args.layers, device=args.device)
    chunked = run_long_prefill(
        model, max_len, args.slots, args.page_size, args.long_prompt,
        args.long_out, args.decoder_out, args.page_size, args.vocab,
        args.seed)
    oneshot = run_long_prefill(
        model, max_len, args.slots, args.page_size, args.long_prompt,
        args.long_out, args.decoder_out, 0, args.vocab, args.seed)
    print(f"[serve-bench] chunked:  long TTFT {chunked['ttft_long_ms']} ms"
          f" | in-flight ITL during prefill p99/max"
          f" {chunked['stall_itl_ms_p99']}/{chunked['stall_itl_ms_max']} ms"
          f" ({chunked['stall_samples']} samples, decode median"
          f" {chunked['decode_itl_ms_median']} ms)")
    print(f"[serve-bench] one-shot: long TTFT {oneshot['ttft_long_ms']} ms"
          f" | in-flight ITL during prefill max"
          f" {oneshot['stall_itl_ms_max']} ms"
          f" ({oneshot['stall_samples']} samples)")

    failures = []
    if chunked["long_tokens"] != oneshot["long_tokens"]:
        failures.append(
            "long request's greedy tokens differ between chunked and"
            " one-shot prefill")
    if chunked["decoder_tokens"] != oneshot["decoder_tokens"]:
        failures.append("in-flight decoders' tokens differ between runs")
    if chunked["stall_samples"] == 0:
        failures.append(
            "no in-flight decode tokens landed during the chunked"
            " prefill — raise --decoder-out")
    # the acceptance bound: chunking keeps in-flight ITL bounded where
    # one-shot stalls every decoder for the whole prompt
    stall_ratio = (oneshot["stall_itl_ms_max"]
                   / max(chunked["stall_itl_ms_p99"], 1e-9))
    print(f"[serve-bench] stall ratio (one-shot max / chunked p99):"
          f" {stall_ratio:.1f}x (require >= {args.itl_ratio}x)")
    if stall_ratio < args.itl_ratio:
        failures.append(
            f"chunked prefill only bounded in-flight ITL {stall_ratio:.1f}x"
            f" below the one-shot stall (required {args.itl_ratio}x)")
    _check_exposition(failures)
    report = {"config": vars(args), "long_prefill": {
        "chunked": {k: v for k, v in chunked.items()
                    if k not in ("long_tokens", "decoder_tokens")},
        "one_shot": {k: v for k, v in oneshot.items()
                     if k not in ("long_tokens", "decoder_tokens")},
        "stall_ratio": round(stall_ratio, 2),
    }}
    return _finish(args, report, failures)
