"""The command line: `python -m flexflow_tpu_torch [--model NAME]
[--device cuda|cpu] [flags...]` (counterpart of flexflow_tpu/__main__.py).

One entry point that takes the standard FFConfig flags, builds a named
model from the zoo on synthetic data and trains it; `--from-c-spec FILE`
trains a model exported by the C API instead. The subcommands:

    elastic-drill      scripted chip-loss and recovery (elastic/drill.py)
    analyze            static plan analysis (analysis/cli.py)
    profile            traced training, calibration, BENCH point (obs/cli.py)
    timeline           merge trace, events and flight bundle (obs/timeline.py)
    collective-bench   the collective sweep (obs/collective_bench.py)
    serve-bench        the serving load test (serving/sched/bench.py)

Every path runs on the card unless `--device cpu` says otherwise; a
CUDA request where no card is visible exits with an error. Run a user
script instead with `python -m flexflow_tpu_torch script.py [flags...]`
(the script sees the remaining argv, `--device` included).
"""
from __future__ import annotations

import os
import runpy
import sys
import time

import numpy as np

ZOO = ("alexnet", "resnet50", "inception", "resnext50", "cifar10_cnn",
       "mnist_cnn", "mnist_mlp", "bert", "mlp_unify", "moe")


def _synthetic(model_name, config):
    """Build (model, inputs, label) for a zoo model on synthetic data: the
    JAX CLI's builders, widths, `FF_BERT_*` / `FF_MOE_*` knobs and
    RandomState(0) draws."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch import models as zoo

    b = config.batch_size
    rng = np.random.RandomState(0)
    m = ff.FFModel(config)

    if model_name in ("alexnet", "resnet50", "inception", "resnext50",
                      "cifar10_cnn", "mnist_cnn"):
        size = {"alexnet": 229, "resnet50": 224, "inception": 299,
                "resnext50": 224, "cifar10_cnn": 32, "mnist_cnn": 28}[model_name]
        chans = 1 if model_name == "mnist_cnn" else 3
        build = {"alexnet": zoo.build_alexnet, "resnet50": zoo.build_resnet50,
                 "inception": zoo.build_inception_v3,
                 "resnext50": zoo.build_resnext50,
                 "cifar10_cnn": zoo.build_cifar10_cnn,
                 "mnist_cnn": zoo.build_mnist_cnn}[model_name]
        inp = m.create_tensor([b, chans, size, size])
        build(m, inp)
        x = rng.randn(b * 4, chans, size, size).astype(np.float32)
        y = rng.randint(0, 10, size=(b * 4, 1)).astype(np.int32)
        return m, [x], y
    if model_name == "mnist_mlp":
        inp = m.create_tensor([b, 784])
        zoo.build_mnist_mlp(m, inp)
        x = rng.randn(b * 4, 784).astype(np.float32)
        y = rng.randint(0, 10, size=(b * 4, 1)).astype(np.int32)
        return m, [x], y
    if model_name == "bert":
        # FF_BERT_* shrink the flagship for CPU runs; unset = the full
        # widths (1024 / 16 / 12 / 512 / 30522)
        cfg = zoo.TransformerConfig(
            hidden_size=int(os.environ.get("FF_BERT_HIDDEN", 1024)),
            embedding_size=int(os.environ.get("FF_BERT_HIDDEN", 1024)),
            num_heads=int(os.environ.get("FF_BERT_HEADS", 16)),
            num_layers=int(os.environ.get("FF_BERT_LAYERS", 12)),
            sequence_length=int(os.environ.get("FF_BERT_SEQ", 512)),
            vocab_size=int(os.environ.get("FF_BERT_VOCAB", 30522)),
        )
        tokens = m.create_tensor([b, cfg.sequence_length],
                                 ff.DataType.DT_INT32)
        zoo.build_bert_encoder(m, tokens, cfg)
        x = rng.randint(0, cfg.vocab_size,
                        size=(b * 2, cfg.sequence_length)).astype(np.int32)
        y = rng.randint(0, 2, size=(b * 2, cfg.sequence_length, 1)).astype(np.int32)
        return m, [x], y
    if model_name == "mlp_unify":
        in1 = m.create_tensor([b, 4096])
        in2 = m.create_tensor([b, 4096])
        zoo.build_mlp_unify(m, in1, in2)
        xs = [rng.randn(b * 4, 4096).astype(np.float32) for _ in range(2)]
        y = rng.randint(0, 10, size=(b * 4, 1)).astype(np.int32)
        return m, xs, y
    if model_name == "moe":
        # FF_MOE_* as FF_BERT_*: the defaults are the switch-transformer
        # shape of the JAX package's multipod dry run
        cfg = zoo.MoeTransformerConfig(
            hidden_size=int(os.environ.get("FF_MOE_HIDDEN", 512)),
            num_heads=int(os.environ.get("FF_MOE_HEADS", 8)),
            num_layers=int(os.environ.get("FF_MOE_LAYERS", 2)),
            num_experts=int(os.environ.get("FF_MOE_EXPERTS", 8)),
            top_k=int(os.environ.get("FF_MOE_TOPK", 2)),
            vocab_size=int(os.environ.get("FF_MOE_VOCAB", 1024)),
        )
        seq = int(os.environ.get("FF_MOE_SEQ", 64))
        tokens = m.create_tensor([b, seq], ff.DataType.DT_INT32)
        zoo.build_moe_transformer(m, tokens, cfg)
        x = rng.randint(0, cfg.vocab_size,
                        size=(b * 2, seq)).astype(np.int32)
        y = rng.randint(0, 2, size=(b * 2, seq, 1)).astype(np.int32)
        return m, [x], y
    raise SystemExit(
        f"unknown --model {model_name!r}; choices: {' '.join(ZOO)}, or "
        f"pass a script path")


def _c_spec_data(model):
    """Synthetic inputs and labels for a model built from a C-API spec:
    ids in the smallest embedding's vocabulary, classes of the last op's
    width, from RandomState(0)."""
    from .ffconst import OpType

    rng = np.random.RandomState(0)
    b = model.config.batch_size
    vocab = min((op.params["num_entries"] for op in model.ops
                 if op.op_type == OpType.EMBEDDING), default=100)
    xs = []
    for op in model.input_ops:
        dims = (b * 4,) + tuple(op.outputs[0].dims[1:])
        if op.outputs[0].dtype.value.startswith("int"):
            xs.append(rng.randint(0, vocab, size=dims).astype(np.int32))
        else:
            xs.append(rng.randn(*dims).astype(np.float32))
    out_dim = model.ops[-1].outputs[0].dims[-1]
    y = rng.randint(0, out_dim, size=(b * 4, 1)).astype(np.int32)
    return xs, y


SUBCOMMANDS = {
    # scripted chip loss and recovery on ranks (elastic/drill.py)
    "elastic-drill": ("elastic.drill", "run_drill"),
    # the plan sanitizer's report over a zoo model and a strategy file
    "analyze": ("analysis.cli", "run_analyze"),
    # traced training: trace, calibration, metrics, BENCH point
    "profile": ("obs.cli", "run_profile"),
    # tracer export + EventLog + flight bundle -> one Perfetto trace
    "timeline": ("obs.timeline", "run_timeline"),
    # the reduction-strategy lowerings x message sizes on ranks
    "collective-bench": ("obs.collective_bench", "run_collective_bench"),
    # the serving load test: continuous batching against lockstep
    "serve-bench": ("serving.sched.bench", "run_bench"),
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        import importlib

        module, fn = SUBCOMMANDS[argv[0]]
        run = getattr(importlib.import_module(f"{__package__}.{module}"), fn)
        raise SystemExit(run(argv[1:]))
    # script mode: first non-flag arg ending in .py
    script = next((a for a in argv if a.endswith(".py")), None)
    if script is not None:
        sys.argv = [script] + [a for a in argv if a != script]
        runpy.run_path(script, run_name="__main__")
        return

    from .config import FFConfig, take_device

    device = take_device(argv)
    model_name = "mnist_mlp"
    if "--model" in argv:
        i = argv.index("--model")
        model_name = argv[i + 1]
        del argv[i:i + 2]
    c_spec = None
    if "--from-c-spec" in argv:  # train a model exported by the C API
        i = argv.index("--from-c-spec")
        if i + 1 >= len(argv):
            raise SystemExit("missing value for --from-c-spec")
        c_spec = argv[i + 1]
        del argv[i:i + 2]

    import flexflow_tpu_torch as ff

    config = FFConfig(device=device)
    rest = config.parse_args(argv)
    if rest:
        print(f"warning: unrecognized flags {rest}", file=sys.stderr)

    if c_spec is not None:
        from .native.c_model import model_from_spec

        # an explicit command-line batch size wins over the spec's
        cli_batch = (config.batch_size
                     if "-b" in argv or "--batch-size" in argv else None)
        model = model_from_spec(c_spec, config=config, batch_size=cli_batch)
        model_name = c_spec
        xs, y = _c_spec_data(model)
    else:
        model, xs, y = _synthetic(model_name, config)
    model.compile(
        optimizer=ff.SGDOptimizer(model, lr=config.learning_rate),
        loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[ff.MetricsType.METRICS_ACCURACY],
    )
    n = y.shape[0]
    t0 = time.time()
    hist = model.fit(xs, y, batch_size=config.batch_size,
                     epochs=config.epochs,
                     steps_per_execution=config.steps_per_execution)
    dt = time.time() - t0
    thru = n * config.epochs / max(dt, 1e-9)
    print(f"[{model_name}] {config.epochs} epoch(s) in {dt:.2f}s "
          f"({thru:.1f} samples/s), final metrics: "
          + ", ".join(f"{k}={v:.4f}" for k, v in hist[-1].items()
                      if isinstance(v, float)))


if __name__ == "__main__":
    main()
