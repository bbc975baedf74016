"""Readings that several metric readers (`metrics/*.py`) share. Each
returns None where the run has nothing to read."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from benchmark import flops
from benchmark.stats import percentile

ATTN_BWD = json.loads((Path(__file__).resolve().parent
                       / "kernels.json").read_text())["attn_bwd"]


def idle_pct(obs) -> Optional[float]:
    """The device's idle share of the traced slice, in %."""
    share = obs.device.idle_share() if obs.device is not None else None
    return None if share is None else 100.0 * share


def decode_spans(obs) -> list:
    return sorted(obs.spans_named("serve.decode"), key=lambda e: e["ts"])


def decode_iter_ms(obs) -> Optional[float]:
    spans = decode_spans(obs)
    if not spans:
        return None
    return sum(e["dur"] for e in spans) / len(spans) / 1e3


def decode_flops(obs) -> float:
    """Model operations of every decode iteration in the window: each
    request a span steps feeds one token at its next position, which is
    its prompt length plus the iterations that stepped it before."""
    plen = {r.rid: r.prompt_len for r in obs.requests if r.rid >= 0}
    seen: dict = {}
    total = 0.0
    for e in decode_spans(obs):
        for rid in e["args"].get("requests", []):
            if rid not in plen:
                continue
            pos = plen[rid] + seen.get(rid, 0)
            seen[rid] = seen.get(rid, 0) + 1
            total += flops.forward_flops(obs.dims, pos, 1)
    return total


def prefill_flops(obs) -> float:
    """Model operations of every prefill span in the window."""
    return sum(flops.forward_flops(obs.dims, e["args"].get("offset", 0),
                                   e["args"]["tokens"])
               for e in obs.spans_named("serve.prefill"))


def peak_share_pct(operations: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or operations <= 0:
        return None
    return 100.0 * operations / seconds / flops.PEAKS["bf16_flops_per_s"]


def p95_ms(values) -> Optional[float]:
    p = percentile(values, 95)
    return None if p is None else 1e3 * p


def train_tokens_per_s(obs) -> Optional[float]:
    """Tokens of the optimizer steps completed in the window over the
    window's length (host clock, the window closed by a synchronize)."""
    if not obs.steps or obs.window_s <= 0:
        return None
    return obs.steps * obs.traffic["batch"] * obs.traffic["seq"] \
        / obs.window_s


def train_mfu_pct(obs) -> Optional[float]:
    """The training step's share of the card's bf16 peak over the traced
    slice: flops.py's count of a step's model operations (no
    recomputation) times the steps inside the slice, over its length."""
    if obs.device is None or not obs.trace_steps:
        return None
    mix = obs.traffic
    step = flops.train_step_flops(obs.dims, mix["batch"], mix["seq"])
    return peak_share_pct(step * obs.trace_steps, obs.device.window_s)


def attn_bwd_roofline_pct(obs) -> Optional[float]:
    """Attention backward's share of its roofline in the traced slice:
    the least time of its calls (flops.py attn_bwd_cost at the cell's
    shapes over the peaks, one call a launch of kernels.json's `per_call`
    kernel) over the device time of the kernels kernels.json names."""
    if obs.device is None:
        return None
    busy, _ = obs.device.time_of(ATTN_BWD["match"])
    _, calls = obs.device.time_of([ATTN_BWD["per_call"]])
    if not calls or busy <= 0:
        return None
    d, mix = obs.dims, obs.traffic
    f, nbytes = flops.attn_bwd_cost(mix["batch"], d["heads"], mix["seq"],
                                    d["hidden"] // d["heads"])
    return 100.0 * calls * flops.least_time_s(f, nbytes) / busy
