"""The model zoo at its examples' widths, trained on one NVIDIA GPU.

    python -m flexflow_tpu_torch.tools.zoo_train [--model NAME ...]
        [--steps N] [--steps-per-execution K] [--profile]

Each entry of `ZOO` is one builder of `flexflow_tpu_torch.models` at the
widths of its example in `examples/python/native/` (the batch, the image
size, the vocabulary, the tables), with random weights from
`torch.Generator().manual_seed(seed)` and a random batch from
`np.random.RandomState(seed)`: bf16 mixed precision and Adam (alpha
1e-4, bf16 moments, as bench.py; `build(..., mixed=False)` makes the f32
model). `train` runs `steps`
fit steps, `k` a dispatch (a CUDA graph of k steps when k > 1): the
losses, peak memory and kernel launches; `time_steps` runs them again,
warm (at k > 1 replays only): host ms a step, samples/s and MFU (3 x the
ops' forward FLOPs, `Op.flops`, an MoE block's expert FFN alone, over
989 TFLOP/s); `profile_steps`
(`--profile`) runs them under torch.profiler: device busy, idle share,
launches. Prints one JSON line a model. Needs CUDA; exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet


def _image(builder: str, batch: int, chans: int, size: int, classes: int,
           source: str, **kw):
    def build(m, pt):
        t = m.create_tensor([batch, chans, size, size])
        getattr(pt.models, builder)(m, t, **kw)

    def data(rng, n):
        return [rng.randn(n, chans, size, size).astype(np.float32)], \
            rng.randint(0, classes, size=(n, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch, source=source)


def _nmt(layers: int = 2, batch: int = 32, seq: int = 24):
    def build(m, pt):
        src = m.create_tensor([batch, seq], pt.DataType.DT_INT32)
        tgt = m.create_tensor([batch, seq], pt.DataType.DT_INT32)
        pt.models.build_lstm_nmt(m, src, tgt, num_layers=layers)

    def data(rng, n):
        return [rng.randint(0, 32000, size=(n, seq)).astype(np.int32)
                for _ in range(2)], \
            rng.randint(0, 32000, size=(n, seq, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch,
                source="build_lstm_nmt defaults; examples/python/native/"
                       "nmt_lstm.py batch 32, seq 24")


def _dlrm(bag: int, batch: int = 64):
    def build(m, pt):
        cfg = pt.models.DLRMConfig(embedding_bag_size=bag)
        dense = m.create_tensor([batch, cfg.mlp_bot[0]])
        sparse = [m.create_tensor([batch, bag], pt.DataType.DT_INT32)
                  for _ in cfg.embedding_size]
        pt.models.build_dlrm(m, dense, sparse, cfg)

    def data(rng, n):
        return [rng.randn(n, 4).astype(np.float32)] + [
            rng.randint(0, 1000000, size=(n, bag)).astype(np.int32)
            for _ in range(4)], rng.randint(0, 2, size=(n, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch,
                source=f"DLRMConfig() defaults, bag {bag}; "
                       "examples/python/native/dlrm.py batch 64")


def _xdl(batch: int = 64):
    tables = [100000] * 4

    def build(m, pt):
        cfg = pt.models.XDLConfig(embedding_size=tables)
        sparse = [m.create_tensor([batch, 1], pt.DataType.DT_INT32)
                  for _ in tables]
        pt.models.build_xdl(m, sparse, cfg)

    def data(rng, n):
        return [rng.randint(0, v, size=(n, 1)).astype(np.int32)
                for v in tables], rng.randint(0, 2, size=(n, 1)).astype(
            np.int32)

    return dict(build=build, data=data, batch=batch,
                source="examples/python/native/xdl.py")


def _candle_uno(batch: int = 32):
    feats = {"dose1": 1, "dose2": 1, "cell.rnaseq": 942,
             "drug1.descriptors": 5270, "drug1.fingerprints": 2048}

    def build(m, pt):
        cfg = pt.models.CandleUnoConfig(dense_layers=[512] * 2,
                                        dense_feature_layers=[512] * 2)
        pt.models.build_candle_uno(
            m, {k: m.create_tensor([batch, d]) for k, d in feats.items()},
            cfg)

    def data(rng, n):
        return [rng.randn(n, d).astype(np.float32) for d in feats.values()], \
            rng.randn(n, 1).astype(np.float32)

    return dict(build=build, data=data, batch=batch, regression=True,
                source="examples/python/native/candle_uno.py")


def _mlp_unify(batch: int = 64):
    def build(m, pt):
        a, b = (m.create_tensor([batch, 1024]) for _ in range(2))
        pt.models.build_mlp_unify(m, a, b, hidden_dims=(4096, 4096, 4096,
                                                        10))

    def data(rng, n):
        return [rng.randn(n, 1024).astype(np.float32) for _ in range(2)], \
            rng.randint(0, 10, size=(n, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch,
                source="examples/python/native/mlp_unify.py")


def _mnist_mlp(batch: int = 64):
    def build(m, pt):
        pt.models.build_mnist_mlp(m, m.create_tensor([batch, 784]))

    def data(rng, n):
        return [rng.randn(n, 784).astype(np.float32)], \
            rng.randint(0, 10, size=(n, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch,
                source="examples/python/native/mnist_mlp.py")


def _transformer(batch: int = 8):
    def build(m, pt):
        cfg = pt.models.TransformerConfig()
        pt.models.build_transformer(
            m, m.create_tensor([batch, cfg.sequence_length,
                                cfg.hidden_size]), cfg)

    def data(rng, n):
        return [rng.randn(n, 512, 1024).astype(np.float32)], \
            rng.randint(0, 2, size=(n, 512, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch,
                source="TransformerConfig() defaults "
                       "(examples/cpp/Transformer/transformer.cc), batch 8")


def _bert(dropout: float, batch: int = 8, seq: int = 512):
    """bench.py's flagship BERT encoder (build_bert_encoder); at dropout
    > 0 the same graph and op names, its attention probabilities dropped
    out in training."""
    def build(m, pt):
        from flexflow_tpu_torch.models.transformer import _encoder_layer

        tokens = m.create_tensor([batch, seq], pt.DataType.DT_INT32)
        cfg = pt.models.TransformerConfig()
        if not dropout:
            pt.models.build_bert_encoder(m, tokens, cfg)
            return
        t = m.embedding(tokens, cfg.vocab_size, cfg.hidden_size,
                        pt.AggrMode.AGGR_MODE_NONE, name="tok_emb")
        for i in range(cfg.num_layers):
            t = _encoder_layer(m, t, cfg, f"layer{i}", dropout=dropout)
        m.softmax(m.dense(t, 2, name="cls"))

    def data(rng, n):
        return [rng.randint(0, 30522, size=(n, seq)).astype(np.int32)], \
            rng.randint(0, 2, size=(n, seq, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch,
                source=f"bench.py's flagship BERT, attention dropout "
                       f"{dropout}")


def _moe_transformer(batch: int, seq: int, source: str, **cfg):
    """build_moe_transformer (2 classes a token) on random token ids."""
    def build(m, pt):
        tokens = m.create_tensor([batch, seq], pt.DataType.DT_INT32)
        pt.models.build_moe_transformer(
            m, tokens, pt.models.MoeTransformerConfig(**cfg))

    def data(rng, n):
        vocab = cfg["vocab_size"]
        return [rng.randint(0, vocab, size=(n, seq)).astype(np.int32)], \
            rng.randint(0, 2, size=(n, seq, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch, source=source)


def _moe_encoder(batch: int = 32, seq: int = 16):
    """examples/python/native/moe.py: MoeConfig()'s encoder (the unfused
    group_by / dense / aggregate path), a mean pool and a 10-way head."""
    def build(m, pt):
        cfg = pt.models.MoeConfig()
        t = m.create_tensor([batch, seq, cfg.hidden_size])
        out = pt.models.build_moe_encoder(m, t, cfg)
        m.softmax(m.dense(m.mean(out, [1]), 10, name="head"))

    def data(rng, n):
        return [rng.randn(n, seq, 64).astype(np.float32)], \
            rng.randint(0, 10, size=(n, 1)).astype(np.int32)

    return dict(build=build, data=data, batch=batch,
                source="examples/python/native/moe.py: MoeConfig(), batch "
                       "32, seq 16")


# the switch shape the JAX package's MoE dry-run prices
# (__graft_entry__.py:1362-1364) on its [batch, 128] tokens
MOE_SWITCH = dict(hidden_size=1024, num_heads=16, num_layers=2,
                  num_experts=256, top_k=2, capacity_factor=2.0,
                  lambda_bal=0.01, vocab_size=8192)

ZOO: Dict[str, dict] = {
    "resnet50": _image("build_resnet50", 16, 3, 224, 10,
                       "examples/python/native/resnet.py"),
    "resnet_small": _image("build_resnet", 16, 3, 64, 10,
                           "build_resnet(stages=(1, 1)) at 64 px",
                           stages=(1, 1)),
    "nmt": _nmt(),
    "nmt_1layer": _nmt(layers=1),
    "dlrm": _dlrm(1),
    "dlrm_bag8": _dlrm(8),
    "bert_dropout": _bert(0.1),
    "bert": _bert(0.0),
    "alexnet": _image("build_alexnet", 64, 3, 229, 10,
                      "examples/python/native/alexnet.py"),
    "mnist_mlp": _mnist_mlp(),
    "mnist_cnn": _image("build_mnist_cnn", 64, 1, 28, 10,
                        "examples/python/native/mnist_cnn.py"),
    "cifar10_cnn": _image("build_cifar10_cnn", 64, 3, 32, 10,
                          "examples/python/native/cifar10_cnn.py"),
    "resnext50": _image("build_resnext50", 16, 3, 224, 1000,
                        "build_resnext50 defaults at resnet.py's batch 16, "
                        "224 px"),
    "inception_v3": _image("build_inception_v3", 8, 3, 299, 10,
                           "examples/python/native/inception.py"),
    "xdl": _xdl(),
    "candle_uno": _candle_uno(),
    "mlp_unify": _mlp_unify(),
    "transformer": _transformer(),
    "moe_switch": _moe_transformer(
        8, 128, "__graft_entry__.py:1362-1364 switch shape (256 experts, "
        "top-2, hidden 1024, 2 layers, vocab 8192), batch 8, seq 128",
        **MOE_SWITCH),
    # phase 27's f32 witness: the switch config cut to 1 layer, 16 experts,
    # hidden 128
    "moe_switch_small": _moe_transformer(
        8, 128, "the switch shape cut to 1 layer, 16 experts, hidden 128",
        **dict(MOE_SWITCH, hidden_size=128, num_layers=1, num_experts=16)),
    "moe": _moe_transformer(
        8, 64, "python -m flexflow_tpu profile --model moe -b 8 defaults "
        "(flexflow_tpu/__main__.py:83-95)", hidden_size=512, num_heads=8,
        num_layers=2, num_experts=8, top_k=2, vocab_size=1024),
    "moe_encoder": _moe_encoder(),
}


def build(name: str, device: str = "cuda", mixed: bool = True,
          seed: int = 0):
    """ZOO[name] compiled for training on `device`: weights from
    torch.Generator().manual_seed(seed), Adam (bf16 moments under mixed
    precision, alpha 1e-4), sparse categorical cross-entropy and accuracy
    (mean squared error for a regression)."""
    import torch

    import flexflow_tpu_torch as pt
    import flexflow_tpu_torch.models  # noqa: F401

    spec = ZOO[name]
    m = pt.FFModel(pt.FFConfig(batch_size=spec["batch"],
                               allow_mixed_precision=mixed, device=device,
                               seed=seed))
    spec["build"](m, pt)
    reg = spec.get("regression", False)
    m.compile(
        optimizer=pt.AdamOptimizer(m, alpha=1e-4, moments_dtype=(
            torch.bfloat16 if mixed else torch.float32)),
        loss_type=(pt.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE if reg
                   else pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY),
        metrics=[pt.MetricsType.METRICS_MEAN_SQUARED_ERROR if reg
                 else pt.MetricsType.METRICS_ACCURACY],
        generator=torch.Generator().manual_seed(seed))
    return m


def batches(name: str, steps: int, seed: int = 0
            ) -> Tuple[List[np.ndarray], np.ndarray]:
    """`steps` batches of ZOO[name] from np.random.RandomState(seed)."""
    spec = ZOO[name]
    return spec["data"](np.random.RandomState(seed), steps * spec["batch"])


def step_flops(model) -> float:
    """3 x the forward FLOPs the port performs (forward and backward): the
    ops' `flops()`, but an EXPERTS op's batched FFN alone (`ffn_flops`:
    its dispatch and combine are gathers, counted as zero; its `flops()`
    also counts the JAX package's one-hot contractions)."""
    from flexflow_tpu_torch.ffconst import OpType

    return 3.0 * sum(op.ffn_flops() if op.op_type == OpType.EXPERTS
                     else op.flops() for op in model.ops)


def n_params(model) -> int:
    return sum(t.numel() for ws in model.params.values() for t in ws.values())


def train(model, xs, y, steps: int, k: int = 1) -> dict:
    """fit over `steps` steps, k a dispatch, on the card, the launch
    counters set to 0 before it: losses, host wall, peak memory and the
    kernel launches (and calls by route)."""
    import torch

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    model.fit(xs, y, batch_size=model.config.batch_size, epochs=1,
              steps_per_execution=k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    losses = [v for r in model.step_records
              for v in r.get("losses", [r["loss"]])]
    return {"steps": len(losses), "steps_per_execution": k,
            "losses": losses, "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": {n: c for n, c in launches.items()
                         if c and "/" not in n},
            "routes": {n: c for n, c in launches.items() if c and "/" in n}}


def time_steps(model, xs, y, steps: int, k: int = 1) -> dict:
    """The same `steps` fit steps again, after `train` (every kernel and
    cuDNN plan warm, the k-step graph captured, so k > 1 only replays):
    host wall a step from one synchronize to the next, samples/s and MFU
    (3 x the ops' forward FLOPs over the bf16 peak)."""
    import torch

    batch = model.config.batch_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(xs, y, batch_size=batch, epochs=1, steps_per_execution=k)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    flops = step_flops(model)
    return {"ms_per_step": ms, "samples_per_s": batch / ms * 1e3,
            "flops_per_step": flops,
            "mfu_bf16_peak": flops / (ms / 1e3) / PEAK_BF16_FLOPS,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def profile_steps(model, xs, y, steps: int, k: int = 1) -> dict:
    """`steps` more fit steps under torch.profiler (CUDA activity), after
    `train`: device busy a step (the sum of kernel times), the device's
    idle share against the profiled host wall, device kernel launches a
    step, and the five kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType

    from .serve_profile import _kernel_table, trace_device

    with trace_device() as prof:
        t0 = time.perf_counter()
        model.fit(xs, y, batch_size=model.config.batch_size, epochs=1,
                  steps_per_execution=k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    busy_ms, table = _kernel_table(prof, steps)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"profiled_wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "device_launches_per_step": len(kernels) / steps,
            "top_kernels": table[:5]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", nargs="*", default=sorted(ZOO),
                    choices=sorted(ZOO))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--steps-per-execution", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="also profile the steps (device busy, idle)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("zoo_train: no CUDA device visible", file=sys.stderr)
        return 2
    for name in args.model:
        m = build(name, "cuda")
        xs, y = batches(name, args.steps)
        out = train(m, xs, y, args.steps, args.steps_per_execution)
        out.update(time_steps(m, xs, y, args.steps,
                              args.steps_per_execution))
        if args.profile:
            out.update(profile_steps(m, xs, y, args.steps,
                                     args.steps_per_execution))
        print(json.dumps({"model": name, "source": ZOO[name]["source"],
                          "params": n_params(m),
                          "device": torch.cuda.get_device_name(0), **out}),
              flush=True)
        del m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
