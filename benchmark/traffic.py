"""The one traffic generator: it reads a mix's parameters from
`traffic/<mix>.json` and makes its inputs from the seed.

Every seed gets the same work in the same bursts: requests come in
blocks of `block`, each block holds the quantiles of the mix's
distributions on a fixed grid, and the seed only orders them within the
block (and draws the tokens). Kinds:
 - "train": a pool of distinct (batch, seq) token batches, and targets a
   fixed function of each token that the model can learn;
 - "open_loop": requests due on a schedule whether or not earlier ones
   finished (independent users); each block of arrivals spans block /
   rate seconds, so a window of whole blocks asks the same work of every
   seed, and a longer window only adds blocks after it;
 - "closed_loop": a long queue of requests that clients take one at a
   time, each sending its next when its last one finished.
Distributions: {"dist": "uniform", "min", "max"} (integers, both ends
included), {"dist": "lognormal", "median", "sigma", "min", "max"};
arrivals {"process": "poisson", "rate"}.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream `stream` of the seed (any size)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         int(stream)]))


def grid(spec: dict, n: int) -> np.ndarray:
    """n integers: the (i + 1/2) / n quantiles of the distribution."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "uniform":
        lo, hi = int(spec["min"]), int(spec["max"])
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown distribution {kind!r}")


@dataclass
class Request:
    prompt: np.ndarray    # (L,) int32 token ids
    max_new: int          # tokens to generate
    due: float = 0.0      # seconds after the window opens (open loop)


def train_pool(mix: dict, vocab: int, seed: int):
    """(x, y): `pool_batches` distinct batches of uniform token ids,
    (P, batch, seq) int32, and their targets (P, batch, seq, 1) int32, a
    permutation of the vocabulary drawn from the seed applied to each
    token."""
    rng = rng_for(seed, 1)
    shape = (int(mix["pool_batches"]), int(mix["batch"]), int(mix["seq"]))
    x = rng.integers(0, vocab, size=shape, dtype=np.int32)
    perm = rng.permutation(vocab).astype(np.int32)
    return x, perm[x][..., None]


def _prompt(rng, length: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=int(length), dtype=np.int32)


def open_loop(mix: dict, vocab: int, seed: int,
              seconds: float) -> List[Request]:
    """The requests due in [0, seconds), made block by block: a block
    holds the quantile grids of the prompt and output lengths and of the
    Poisson gaps, each in an order drawn from the seed, the gaps scaled
    so that the block spans exactly block / rate seconds."""
    arr = mix["arrivals"]
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    block = int(mix["block"])
    span = block / float(arr["rate"])
    u = (np.arange(block) + 0.5) / block
    gap_grid = -np.log1p(-u)
    gap_grid *= span / gap_grid.sum()
    rng = rng_for(seed, 2)
    out: List[Request] = []
    b = 0
    while b * span < seconds:
        start, b = b * span, b + 1
        plen = rng.permutation(grid(mix["prompt"], block))
        olen = rng.permutation(grid(mix["output"], block))
        gaps = rng.permutation(gap_grid)
        due = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        out += [Request(_prompt(rng, p, vocab), int(o), float(d))
                for p, o, d in zip(plen, olen, due) if d < seconds]
    return out


def closed_loop(mix: dict, vocab: int, seed: int) -> List[Request]:
    """`pool` requests in blocks of `block`: each block holds the quantile
    grid of both length distributions, in an order drawn from the seed,
    so every whole number of blocks asks the same work."""
    rng = rng_for(seed, 3)
    block, n = int(mix["block"]), int(mix["pool"])
    out: List[Request] = []
    while len(out) < n:
        plen = rng.permutation(grid(mix["prompt"], block))
        olen = rng.permutation(grid(mix["output"], block))
        out += [Request(_prompt(rng, p, vocab), int(o))
                for p, o in zip(plen, olen)]
    return out[:n]


def warmup_prompts(count: int, length: int, vocab: int) -> List[np.ndarray]:
    """Fixed prompts for the warm-up, the same in every run: ids drawn
    from a stream no seed's traffic uses, each prompt distinct."""
    rng = np.random.default_rng(np.random.SeedSequence([0, 99]))
    return [_prompt(rng, length, vocab) for _ in range(count)]
