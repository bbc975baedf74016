"""The serve-bench LMs, the random and shared-prefix workloads, the
speculative pass and the MoE pass (counterparts of
flexflow_tpu/serving/sched/bench.py `build_tiny_lm`, `build_tiny_moe_lm`,
`make_workload`, `make_shared_prefix_workload`,
`run_speculative_once`, `run_moe` and `_moe_router_check`). The
serve-bench CLI itself comes with a later slice."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...config import FFConfig
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
