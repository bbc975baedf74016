"""The numbers that decide `correct`, each the program's reading against
the plain reference's (limits in `limits/<workload>.json`; PERF.md gives
the readings each limit was set from).

Training, over the first two dispatches of the window's own call (K
steps each), on rows that all differ:
 - loss_gap: the largest |program - reference| / reference of a
   dispatch's mean loss;
 - grad_gap: the gradient as the optimizer got it, read from Adam's first
   moment after the first dispatch: the worst leaf's |norm(program) -
   norm(reference)| over the larger of the reference leaf's norm and the
   median leaf's;
 - change_gap: the same of each leaf's change over the two dispatches,
   leaving out the leaves whose first reference gradient is under a
   thousandth of the median leaf's (moved by round-off alone).
Serving:
 - logit_gap: the widest gap by which a served token's logit lies below
   the reference's best, at its position, over the sampled requests.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Set, Tuple

import torch

STILL_SHARE = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Set[str]] = None) -> Tuple[float, str]:
    """(gap, leaf) of the worst leaf by the norms' gap over max(the
    reference leaf's norm, the median reference leaf's)."""
    med = statistics.median(ref.values())
    worst, which = 0.0, ""
    for leaf, r in ref.items():
        if keep is not None and leaf not in keep:
            continue
        gap = abs(prog[leaf] - r) / max(r, med)
        if gap >= worst:
            worst, which = gap, leaf
    return worst, which


def moved(grad_norms: Dict[str, float]) -> Set[str]:
    """The leaves whose gradient is at least STILL_SHARE of the median
    leaf's."""
    med = statistics.median(grad_norms.values())
    return {k for k, g in grad_norms.items() if g >= STILL_SHARE * med}


def train_numbers(prog: dict, ref: dict) -> Tuple[dict, dict]:
    """The three numbers, and notes naming the worst leaves and counting
    the leaves left out of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    grad, grad_leaf = worst_leaf(prog["moment"], ref["moment"])
    keep = moved(ref["grad"])
    change, change_leaf = worst_leaf(prog["change"], ref["change"], keep)
    notes = {"grad_worst_leaf": grad_leaf, "change_worst_leaf": change_leaf,
             "still_leaves": len(set(ref["grad"]) - keep),
             "program_losses": prog["loss"], "reference_losses": ref["loss"]}
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}, notes


def widest_gap(logits: Iterable[torch.Tensor],
               tokens: Iterable[torch.Tensor]) -> float:
    """The largest max(logits) - logits[token] over every position; each
    logits (n, V) f32 with its tokens (n,)."""
    worst = 0.0
    for z, t in zip(logits, tokens):
        gap = z.max(dim=-1).values - z.gather(-1, t.view(-1, 1)).view(-1)
        worst = max(worst, float(gap.max()))
    return worst


def checks(numbers: Dict[str, float],
           limits: Dict[str, float]) -> Dict[str, Tuple[float, float]]:
    """{name: (number, limit)} for every number that has a limit."""
    return {k: (numbers[k], float(limits[k])) for k in limits}
