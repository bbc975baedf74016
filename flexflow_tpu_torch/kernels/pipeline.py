"""GPipe over a `stage` mesh axis (counterpart of
flexflow_tpu/kernels/pipeline.py).

Each rank of the axis holds one stage: a slice of the pipelined region
of homogeneous blocks (runtime/executor.py, parallel/pipeline_plan.py,
or models/pipeline_transformer.py's stacked layers), and only that
stage's weights. The batch is cut into M microbatches; T = M + S - 1
ticks run on every stage. At tick t stage s computes microbatch t - s
(garbage outside 0 <= t - s < M, as in the JAX schedule): stage 0 reads
the microbatch queue, the others the activation the previous stage sent
at the tick before (runtime/collectives.py `ppermute`, one hop a tick).
The last stage's outputs for microbatches 0 .. M-1 (ticks S-1 .. T-1)
go to every stage (`broadcast_from`). The bubble is (S-1)/T.

The backward is autograd's through the schedule: each hop's backward is
the opposite hop, the broadcast's keeps the gradient on the last stage,
and the region input enters through `enter_tp`, which hands stage 0's
gradient of it to every stage. Every stage builds the same graph (the
JAX `where(s == 0, queue, buffer)` select included), so every rank runs
the same collectives in the backward, in the same order.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..runtime.collectives import broadcast_from, enter_tp, ppermute


def gpipe(stage_fn: Callable, x: torch.Tensor, mesh, axis: str = "stage",
          microbatches: int = 4) -> torch.Tensor:
    """(B, ...) outputs of the S stages applied in turn to x (B, ...),
    replicated over the axis; `stage_fn(x_micro)` applies this rank's
    stage to one (B / M, ...) microbatch."""
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(
            f"pipeline microbatches ({microbatches}) must divide the batch "
            f"({b}) — set config.pipeline_microbatches accordingly")
    n_stages, s = mesh.size(axis), mesh.index(axis)
    m = microbatches
    xm = enter_tp(x, mesh.group(axis)).reshape((m, b // m) + x.shape[1:])
    first = torch.tensor(s == 0, device=x.device)
    buf = torch.zeros_like(xm[0])
    outs = []
    ticks = m + n_stages - 1
    for t in range(ticks):
        y = stage_fn(torch.where(first, xm[min(t, m - 1)], buf))
        outs.append(y)
        if t < ticks - 1:
            buf = ppermute(y, mesh, axis, 1)
    out = broadcast_from(torch.stack(outs[n_stages - 1:]), mesh, axis,
                         n_stages - 1)
    return out.reshape((b,) + out.shape[2:])
