"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python -m flexflow_tpu_torch.tools.train_profile [--steps N] [--tier]

Builds bench.py's flagship BERT encoder at full width (batch 8, seq 512,
hidden 1024, 16 heads, 12 layers, FFN 4096, vocab 30522; bf16 mixed
precision, Adam alpha 1e-4 with bf16 moments; random weights from a fixed
generator, tokens and labels from np.random.RandomState(0)), runs a few
warm-up steps through FFModel.fit, then `steps` steps under torch.profiler
with CUDA activity, and prints one JSON line: host wall per step, device
busy time per step (the sum of kernel times), the device's idle share,
and device time by kernel, largest first. `--tier` does the same for the
JAX package's kernel-tier graph (`build_tier_model`, bf16, the kernels
forced; one batch from np.random.RandomState(8)): the only full-width
path of RMSNorm forward and backward. Needs CUDA; exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .serve_profile import _kernel_table


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


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
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
    model.fit(x, y, batch_size=batch, epochs=args.warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        # each step ends when its loss reaches the host
        model.fit(x, y, batch_size=batch, epochs=args.steps)
        wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
    busy_ms, table = _kernel_table(prof, args.steps)
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=batch, epochs=args.steps)
    bare_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(json.dumps({
        "phase": "tier" if args.tier else "train",
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps, "wall_ms_per_step": bare_ms,
        "wall_ms_per_step_profiled": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        # the profiled window, as serve_profile reports it; the profiler
        # slows the host, not the device, so the same busy time over the
        # unprofiled wall is the idle share a user's step sees
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "device_idle_share_unprofiled": (1 - busy_ms / bare_ms)
        if busy_ms else None,
        "kernels": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
