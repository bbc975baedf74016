"""Expert-affine admission for MoE serving (counterpart of
flexflow_tpu/serving/sched/affinity.py).

Expert-parallel MoE serving pays an all-to-all per decode iteration
whose cost grows with the number of distinct experts the batch touches,
so co-scheduling requests that route to overlapping expert sets keeps
the fan-out narrow. The routing is known only inside the walk, so
admission works from a host-side approximation:

 - `ExpertAffinityProbe` copies the embedding table and the first MoE
   layer's gate weights to the host once, at batcher construction, and
   scores a request as ``mean(embed(prompt)) @ gate_kernel + bias``, the
   router's view of the prompt's average token; the top-k expert ids are
   the request's SIGNATURE (a heuristic: the gate reads post-attention
   states; it only has to correlate);
 - `pick_affine` admits, among the first ``window`` queued requests, the
   one whose signature overlaps the active slots' most (FIFO breaks
   ties); a request passed over ``window`` times goes next, so affinity
   never starves the head of the queue.

Greedy tokens do not depend on the batch (the MoE serving model's
capacity holds every assignment), so affinity reorders admissions and
changes no token.
"""
from __future__ import annotations

from typing import FrozenSet, List, Sequence

import numpy as np

from ...ffconst import OpType


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class ExpertAffinityProbe:
    """Host-side router approximation for one compiled MoE model."""

    def __init__(self, model):
        ops = model.graph.ops.values()
        experts = [op for op in ops if op.op_type == OpType.EXPERTS]
        if not experts:
            raise ValueError(
                "expert_affinity=True needs a model with a fused EXPERTS"
                " op (model.moe(..., fused=True))")
        first = min(experts, key=lambda op: op.guid)
        self.num_experts = int(first.params["n"])
        # top-k from the assignment input's trailing dim
        self.top_k = int(first.inputs[2].dims[-1])
        emb = next((op for op in ops if op.op_type == OpType.EMBEDDING),
                   None)
        if emb is None:
            raise ValueError(
                "expert_affinity=True needs a token-embedding model: the"
                " probe scores mean(embed(prompt)) through the gate")
        self._table = _host(model.params[emb.name]["weight"])
        gate = self._find_gate(model, first)
        gw = model.params[gate.name]
        self._gate_kernel = _host(gw["kernel"])
        self._gate_bias = (_host(gw["bias"]) if "bias" in gw
                           else np.zeros(self.num_experts, np.float32))
        if self._gate_kernel.shape[0] != self._table.shape[1]:
            raise ValueError(
                f"gate in-features ({self._gate_kernel.shape[0]}) do not"
                f" match the embedding width ({self._table.shape[1]}):"
                " the affinity probe needs the gate to consume the"
                " embedded hidden size")

    @staticmethod
    def _find_gate(model, experts_op):
        """The gate dense: up from the fused op's top-k scores input to the
        op that owns the (H, n) kernel."""
        graph = model.graph
        t = experts_op.inputs[1]
        for _ in range(4):  # top_k -> softmax -> dense, and one spare
            op = getattr(t, "owner_op", None)
            if op is None or op.guid not in graph.ops:
                break
            if op.specs and op.specs[0].dims[-1] == experts_op.params["n"]:
                return op
            if not op.inputs:
                break
            t = op.inputs[0]
        raise ValueError(
            f"could not locate the gate dense feeding {experts_op.name!r}"
            " (expected top_k <- softmax <- dense with an (H, n) kernel)")

    def signature(self, prompt_ids) -> FrozenSet[int]:
        """Top-k expert ids for the prompt's mean embedding."""
        ids = np.clip(np.asarray(prompt_ids, np.int64).ravel(),
                      0, self._table.shape[0] - 1)
        if ids.size == 0:
            return frozenset()
        mean = self._table[ids].mean(axis=0)
        logits = mean @ self._gate_kernel + self._gate_bias
        k = min(self.top_k, logits.size)
        top = np.argpartition(logits, -k)[-k:]
        return frozenset(int(e) for e in top)


def overlap_fraction(sig: FrozenSet[int],
                     active: Sequence[FrozenSet[int]]) -> float:
    """|sig ∩ union(active)| / |sig|: 1.0 when every expert the request
    routes to is already in the running batch."""
    if not sig:
        return 0.0
    union = frozenset().union(*active) if active else frozenset()
    return len(sig & union) / len(sig)


def pick_affine(queue: List, active: Sequence[FrozenSet[int]],
                window: int) -> tuple:
    """Index into `queue` to admit next, the outcome ('affine' | 'fifo' |
    'forced') and the winner's overlap fraction. Only the first `window`
    entries compete; an entry already passed over `window` times wins
    outright (the oldest such first). Callers bump `affinity_skips` on
    the entries the pick jumped over."""
    window = max(1, int(window))
    horizon = queue[:window]
    for i, req in enumerate(horizon):
        if getattr(req, "affinity_skips", 0) >= window:
            return i, "forced", overlap_fraction(
                getattr(req, "expert_sig", frozenset()), active)
    best_i, best_frac = 0, -1.0
    for i, req in enumerate(horizon):
        frac = overlap_fraction(
            getattr(req, "expert_sig", frozenset()), active)
        if frac > best_frac:
            best_i, best_frac = i, frac
    return best_i, ("fifo" if best_i == 0 else "affine"), max(best_frac,
                                                              0.0)
