"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python -m flexflow_tpu_torch.tools.train_profile [--steps N] [--tier]
        [--steps-per-execution K]

Builds bench.py's flagship BERT encoder at full width (batch 8, seq 512,
hidden 1024, 16 heads, 12 layers, FFN 4096, vocab 30522; bf16 mixed
precision, Adam alpha 1e-4 with bf16 moments; random weights from a fixed
generator, tokens and labels from np.random.RandomState(0)), runs a few
warm-up steps through FFModel.fit, then `steps` steps under torch.profiler
with CUDA activity, and prints one JSON line: host wall per step, device
busy time per step (the sum of kernel times), the device's idle share,
kernel launches and elementwise launches (and their device time) per
step, and device time by kernel, largest first.
`--steps-per-execution K` runs every fit with K steps a dispatch (a CUDA
graph of K captured steps; the warm-up dispatches capture it); `steps`
is rounded up to a multiple of K. `--tier` does the same for the
JAX package's kernel-tier graph (`build_tier_model`, bf16, the kernels
forced; one batch from np.random.RandomState(8)): the only full-width
path of RMSNorm forward and backward. Needs CUDA; exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .serve_profile import _kernel_table, trace_device


# bench.py's flagship training configuration (bench.py:79-84)
BATCH, SEQ = 8, 512


def build_bench_model(device: str = "cuda", layers: int = 12,
                      mixed: bool = True, seed: int = 0,
                      kernel_impl: str = "auto"):
    """bench.py's flagship BERT encoder (`TransformerConfig()` widths, cut
    to `layers`), compiled for training with bench.py's optimizer (Adam,
    alpha 1e-4, bf16 moments) and accuracy, weights drawn from
    `torch.Generator().manual_seed(seed)`, ops selected by `kernel_impl`
    (FFConfig.kernel_impl)."""
    import torch

    from .. import (AdamOptimizer, DataType, FFConfig, FFModel, LossType,
                    MetricsType)
    from ..models import TransformerConfig, build_bert_encoder

    model = FFModel(FFConfig(batch_size=BATCH, allow_mixed_precision=mixed,
                             device=device, kernel_impl=kernel_impl))
    tokens = model.create_tensor([BATCH, SEQ], DataType.DT_INT32)
    build_bert_encoder(model, tokens, TransformerConfig(num_layers=layers))
    model.compile(
        optimizer=AdamOptimizer(model, alpha=1e-4,
                                moments_dtype=torch.bfloat16),
        loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.METRICS_ACCURACY],
        generator=torch.Generator().manual_seed(seed))
    return model


def build_tier_model(device: str = "cuda", mixed: bool = True,
                     kernel_impl: str = "pallas", seed: int = 0):
    """The JAX package's kernel-tier graph (tests/test_pallas_kernels.py
    `_tiny_model`) at the flagship's norm shape: (8, 512, 1024) ->
    layer_norm -> rms_norm -> dense(10) -> softmax; sparse CE, accuracy,
    SGD lr 0.05; weights from torch.Generator().manual_seed(seed)."""
    import torch

    from .. import FFConfig, FFModel, LossType, MetricsType, SGDOptimizer

    m = FFModel(FFConfig(batch_size=BATCH, allow_mixed_precision=mixed,
                         device=device, kernel_impl=kernel_impl))
    t = m.create_tensor([BATCH, SEQ, 1024])
    t = m.layer_norm(t, [-1], name="ln")
    t = m.rms_norm(t, [-1], name="rms")
    m.softmax(m.dense(t, 10, name="cls"))
    m.compile(optimizer=SGDOptimizer(m, lr=0.05),
              loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[MetricsType.METRICS_ACCURACY],
              generator=torch.Generator().manual_seed(seed))
    return m


def profile_fit(model, x, y, batch: int, steps: int, k: int = 1,
                warmup: int = 3) -> dict:
    """Time `model.fit` over `steps` optimizer steps of the batch (x, y),
    `k` steps a dispatch, after `warmup` warm-up steps (dispatches): host
    wall per step with and without the profiler (and the median of the
    unprofiled run's `step_ms`), device busy per step (the sum of kernel
    times under torch.profiler), launches a step and the device time by
    kernel."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    steps = -(-steps // k) * k

    def run(n):
        model.fit(np.concatenate([x] * n), np.concatenate([y] * n),
                  batch_size=batch, epochs=1, steps_per_execution=k)
        torch.cuda.synchronize()

    run(warmup * k)
    with trace_device() as prof:
        t0 = time.perf_counter()
        run(steps)
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    busy_ms, table = _kernel_table(prof, steps)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    elementwise = [e for e in kernels if "elementwise" in e.name]
    t0 = time.perf_counter()
    run(steps)
    bare_ms = (time.perf_counter() - t0) / steps * 1e3
    return {
        "steps": steps, "steps_per_execution": k,
        "wall_ms_per_step": bare_ms, "wall_ms_per_step_profiled": wall_ms,
        # the unprofiled run's records: a step, or a dispatch over its K
        "ms_per_step_median": float(np.median(
            [r["step_ms"] for r in model.step_stats.records()])),
        "device_busy_ms_per_step": busy_ms,
        # the profiler slows the host, not the device, so the same busy
        # time over the unprofiled wall is the idle share a user's step sees
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "device_idle_share_unprofiled": (1 - busy_ms / bare_ms)
        if busy_ms else None,
        "device_launches_per_step": len(kernels) / steps,
        "elementwise_launches_per_step": len(elementwise) / steps,
        "elementwise_ms_per_step": sum(e.time_range.elapsed_us()
                                       for e in elementwise) / steps / 1e3,
        "kernels": table}


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps-per-execution", type=int, default=1,
                    help="optimizer steps a dispatch (K > 1: a CUDA graph)")
    ap.add_argument("--tier", action="store_true",
                    help="profile the kernel-tier graph's step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device visible", file=sys.stderr)
        return 2
    batch, seq, vocab = BATCH, SEQ, 30522
    if args.tier:
        model = build_tier_model()
        rng = np.random.RandomState(8)
        x = rng.randn(batch, seq, 1024).astype(np.float32)
        y = rng.randint(0, 10, size=(batch, seq, 1)).astype(np.int32)
    else:
        model = build_bench_model()
        rng = np.random.RandomState(0)
        x = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
        y = rng.randint(0, 2, size=(batch, seq, 1)).astype(np.int32)
    out = profile_fit(model, x, y, batch, args.steps,
                      args.steps_per_execution, args.warmup)
    print(json.dumps({"phase": "tier" if args.tier else "train",
                      "device": torch.cuda.get_device_name(0), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
