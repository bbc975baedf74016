"""Train the flagship BERT encoder on a data x model mesh of ranks.

    python -m flexflow_tpu_torch.tools.tp_train --model 2 [--data 1]
        [--layers 12] [--steps 5] [--device cuda]

Starts one process per mesh position on this machine
(runtime/distributed.py `spawn`; NCCL when each rank has a card of its
own, gloo otherwise, as `initialize` decides), and each rank trains
bench.py's encoder (batch 8, seq 512, hidden 1024, 16 heads, FFN 4096,
vocab 30522; bf16 mixed precision, Adam alpha 1e-4 with bf16 moments;
weights from torch.Generator().manual_seed(0), tokens and labels from
np.random.RandomState(0)) through FFModel.compile(parallel_axes=...)
and fit. Prints one JSON line per rank: losses, ms per step, launches
per step by kernel, peak memory, backend and host staging.

`run_rank` is the rank's body, also what chip_smoke.py and
tests/test_torch_tp.py, test_torch_axes.py, test_torch_pipeline.py and
test_torch_serving_mesh.py spawn: a list of jobs, each a dict (see `JOB`), run one after another in
one process group. A job's `model` names its graph (`MODELS`: the BERT
encoder, the small graphs of the JAX package's multi-device entry, a
`tools/zoo_train.py` model), its `axes` any mesh of the data, model,
expert, attr, seq and stage axes. A job with `axes` None
compiles with no axes, so the model's plan comes from its config
(`config`: the strategy search, an imported strategy file, or the
`{"data": world}` default); each rank then reports the plan it holds,
and a rank past the plan's mesh trains nothing: it reports the error
its `fit` raises. A job with a `serve` spec serves its model on the
mesh instead of training it (`serve_job`): a GenerativeSession, an
InferenceModel with the leader-driven DynamicBatcher, or a
ContinuousBatcher's construction. A job with an `elastic` spec (see
`ELASTIC`) trains under the elastic coordinator instead
(`elastic_job`): its fault plan may take ranks away, so after such a job
every rank, the lost ones too, joins a fresh process group before the
next job (`run_rank`); with `exit_in_allreduce` a rank exits mid
all-reduce, as a crashed peer does. A `collective_timeout` job makes
rank 0's all-reduce time out and retries it on the same group
(`collective_timeout`).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

# a job's keys and their defaults
JOB: Dict[str, Any] = {
    # the graph: a key of MODELS ("encoder" reads `widths` as
    # TransformerConfig fields, the others as their builder's keywords)
    "model": "encoder",
    # ("adam", alpha, moments dtype name or None) or ("sgd", lr); None:
    # `adam` below
    "optimizer": None,
    # fit(steps_per_execution=)
    "steps_per_execution": 1,
    # compile a one-device copy of the same graph from the same seed and
    # adopt its weights (FFModel.adopt_params_from)
    "adopt_sequential": False,
    # a JAX model's params (numpy, a `__pipeline__` tree unstacked),
    # loaded through params_from_jax
    "jax_params": None,
    # every attention op's sequence_parallel_mode ("ring", "ulysses")
    "sp_mode": None,
    # the mesh axes; None: the plan compile chooses from `config`
    "axes": {"model": 2},
    # further FFConfig fields (the strategy search's: search_budget,
    # measure_op_costs, import_strategy_file, ...)
    "config": {},
    # TransformerConfig fields; the default is bench.py's encoder
    "widths": {},
    "batch": 8,
    "mixed": True,
    # Adam: (alpha, moments dtype name or None)
    "adam": (1e-4, "bfloat16"),
    "seed": 0,
    "use_flash": None,
    # whole weights to load (op -> weight -> array), else the seed's draw,
    # and a whole optimizer state to load (FFModel.load_opt_state's form)
    "params": None,
    "opt_state": None,
    # tokens (batch, seq) int32 and labels (batch, seq, 1) int32
    "x": None,
    "y": None,
    # fit steps, one batch each; the last `count_steps` are counted and
    # timed
    "steps": 3,
    "count_steps": 0,
    # when > 0: that many steps of loss and gradient norms of these
    # weights, one optimizer update between steps, instead of fit
    "grad_steps": 0,
    "grad_norms_of": (),
    # return the gathered weights (numpy) and the per-rank shard shapes
    "return_params": False,
    # FFModel.eval on (x, y) after training
    "eval": False,
    # FFModel.predict on x after training, at this batch size (0: none)
    "predict_batch": 0,
    # on rank 0, after compile: the analytic search (no measured costs)
    # of a fresh build of the same graph, twice (the second a plan-cache
    # hit); each result's plan, cache mode and wall
    "analytic_twice": False,
    # a directory: after training, save a checkpoint there
    # (runtime/durability.py), restore it into a model drawn from another
    # seed and predict with it (needs predict_batch); the restored
    # weights and optimizer state are compared with the saved ones
    "checkpoint_dir": None,
    # a checkpoint file restored into the model after compile, before
    # training (runtime/checkpoint.py restore_checkpoint)
    "restore_path": None,
    # mesh axes: after training, redistribute the live weights and Adam
    # moments (resharding/) onto a model compiled on these axes, with
    # `reshard_peak` bytes of round scratch, check every shard against
    # the gathered whole, train 2 more steps there, and move back
    "reshard_to": None,
    "reshard_peak": 64 << 20,
    # > 0: the tokens repartitioned over dim 0 to this degree and combined
    # back before the encoder (explicit parallel ops,
    # parallel/parallel_ops.py)
    "parallel_chain": 0,
    # report each whole weight's change over the training as its norm
    # (float64, "op/weight" -> norm): under SGD the sync's gradient scale
    "update_norms": False,
    # compile() mode: "training" or "inference"
    "comp_mode": "training",
}


def _build_encoder(lib, model, job, **widths):
    """bench.py's BERT encoder at `widths` (TransformerConfig fields)."""
    cfg = lib.models.TransformerConfig(**widths)
    tokens = model.create_tensor([job["batch"], cfg.sequence_length],
                                 lib.DataType.DT_INT32)
    if job.get("parallel_chain"):
        tokens = model.combine(model.repartition(
            tokens, 0, job["parallel_chain"]), 0)
    lib.models.build_bert_encoder(model, tokens, cfg,
                                  use_flash=job["use_flash"])


def _build_sp_attn(lib, model, job, seq: int = 16, hidden: int = 32,
                   heads: int = 4, mode: str = "ring",
                   causal: bool = False, layers: int = 1,
                   ffn: bool = False):
    """The JAX entry's sequence-parallel leg (`__graft_entry__.py:
    134-186`): attention over (B, seq, hidden), residual, LayerNorm (and
    with `ffn` a GELU FFN of 2 x hidden, residual, LayerNorm), `layers`
    times, then a 2-way classifier a position."""
    t = x = model.create_tensor([job["batch"], seq, hidden])
    for i in range(layers):
        attn = model.multihead_attention(
            t, t, t, hidden, heads, causal=causal, sequence_parallel=True,
            sequence_parallel_mode=mode, name=f"sp_attn{i}")
        t = model.layer_norm(model.add(t, attn), [-1], name=f"sp_ln{i}")
        if ffn:
            h = model.dense(t, 2 * hidden, lib.ActiMode.AC_MODE_GELU,
                            name=f"sp_ff{i}a")
            h = model.dense(h, hidden, name=f"sp_ff{i}b")
            t = model.layer_norm(model.add(t, h), [-1], name=f"sp_lnf{i}")
    del x
    model.softmax(model.dense(t, 2, name="sp_cls"))


def _build_moe(lib, model, job, features: int = 16, experts: int = 8,
               select: int = 2, hidden: int = 16, lambda_bal: float = 0.05,
               fused: bool = True):
    """The JAX entry's expert leg (`:218-245`): a fused MoE block and a
    3-way classifier."""
    x = model.create_tensor([job["batch"], features])
    out = model.moe(x, num_exp=experts, num_select=select,
                    expert_hidden_size=hidden, alpha=float(experts),
                    lambda_bal=lambda_bal, fused=fused, name="moe")
    model.softmax(model.dense(out, 3, name="moe_cls"))


def _build_row_mlp(lib, model, job):
    """The JAX entry's row-parallel leg (`:255-321`): rp_fc1 (64, relu),
    rp_fc2 (32), rp_cls (4)."""
    x = model.create_tensor([job["batch"], 32])
    t = model.dense(x, 64, lib.ActiMode.AC_MODE_RELU, name="rp_fc1")
    t = model.dense(t, 32, name="rp_fc2")
    model.softmax(model.dense(t, 4, name="rp_cls"))


def _build_conv(lib, model, job, size: int = 8, batch_norm: bool = False,
                convs: int = 1):
    """The JAX entry's attribute leg (`:323-372`): `convs` 3x3 convs (8,
    relu, each followed by a batch norm with `batch_norm`), max pool 2x2,
    flat, a 4-way classifier."""
    t = model.create_tensor([job["batch"], 3, size, size])
    for i in range(convs):
        t = model.conv2d(t, 8, 3, 3, 1, 1, 1, 1,
                         activation=lib.ActiMode.AC_MODE_RELU,
                         name=f"ap_c{i + 1}")
        if batch_norm:
            t = model.batch_norm(t, relu=False, name=f"ap_bn{i + 1}")
    t = model.pool2d(t, 2, 2, 2, 2, 0, 0, name="ap_p1")
    t = model.flat(t, name="ap_flat")
    model.softmax(model.dense(t, 4, name="ap_cls"))


def _build_sp_search(lib, model, job, seq: int = 128, hidden: int = 64,
                     heads: int = 4):
    """tests/test_sequence_parallel_search.py's transformer (one encoder
    layer over 100 token ids, a 4-way classifier a position), a graph
    whose plan the Unity search cuts over `seq`."""
    tokens = model.create_tensor([job["batch"], seq], lib.DataType.DT_INT32)
    t = model.embedding(tokens, 100, hidden, lib.AggrMode.AGGR_MODE_NONE,
                        name="emb")
    attn = model.multihead_attention(t, t, t, hidden, heads, name="attn")
    t = model.layer_norm(model.add(t, attn), [-1], name="ln1")
    h = model.dense(t, hidden * 4, lib.ActiMode.AC_MODE_GELU, name="ff1")
    h = model.dense(h, hidden, name="ff2")
    t = model.layer_norm(model.add(t, h), [-1], name="ln2")
    model.softmax(model.dense(t, 4, name="cls"))


def _build_lm9(lib, model, job, vocab: int = 50, hidden: int = 32,
               heads: int = 4, window: int = 8):
    """The JAX entry's sharded-serving leg (`__graft_entry__.py:432-451`):
    embedding, causal attention, add, LayerNorm, the vocabulary head and
    its softmax."""
    t = model.embedding(
        model.create_tensor([job["batch"], window], lib.DataType.DT_INT32),
        vocab, hidden, lib.AggrMode.AGGR_MODE_NONE, name="g_emb")
    attn = model.multihead_attention(t, t, t, hidden, heads, causal=True,
                                     name="g_attn")
    t = model.layer_norm(model.add(t, attn), [-1], name="g_ln")
    model.softmax(model.dense(t, vocab, name="g_head"))


def _build_serve_lm(lib, model, job, vocab: int = 64, hidden: int = 32,
                    heads: int = 4, layers: int = 2, window: int = 16):
    """The serve LM (serving/sched/bench.py `build_tiny_lm`'s graph and
    op names)."""
    t = model.embedding(
        model.create_tensor([job["batch"], window], lib.DataType.DT_INT32),
        vocab, hidden, lib.AggrMode.AGGR_MODE_NONE, name="emb")
    for i in range(layers):
        attn = model.multihead_attention(t, t, t, hidden, heads,
                                         causal=True, name=f"l{i}_attn")
        t = model.layer_norm(model.add(t, attn), [-1], name=f"l{i}_ln1")
        h = model.dense(t, hidden * 2, lib.ActiMode.AC_MODE_GELU,
                        name=f"l{i}_ff1")
        h = model.dense(h, hidden, name=f"l{i}_ff2")
        t = model.layer_norm(model.add(t, h), [-1], name=f"l{i}_ln2")
    model.softmax(model.dense(t, vocab, name="lm_head"))


def _build_serve_mlp(lib, model, job, dim: int = 8, classes: int = 4):
    """tests/test_serving.py's serving model: dense 16 (relu), dense,
    softmax."""
    t = model.dense(model.create_tensor([job["batch"], dim]), 16,
                    lib.ActiMode.AC_MODE_RELU, name="sv_fc1")
    model.softmax(model.dense(t, classes, name="sv_fc2"))


def _build_zoo(lib, model, job, name: str = "moe_switch"):
    """A tools/zoo_train.py model's graph (its widths and batch)."""
    from . import zoo_train

    zoo_train.ZOO[name]["build"](model, lib)


def _build_elastic_mlp(lib, model, job, din: int = 32,
                       hidden: int = 64, classes: int = 10):
    """The JAX package's elastic tests' MLP (tests/test_elastic.py
    `builder`): dense `hidden` (relu), dense `classes`, softmax; no
    hidden layer with hidden 0. Unnamed ops, so both packages name them
    alike."""
    t = model.create_tensor([job["batch"], din])
    if hidden:
        t = model.dense(t, hidden, lib.ActiMode.AC_MODE_RELU)
    model.softmax(model.dense(t, classes))


# job["model"] -> builder(lib, model, job, **job["widths"]), `lib` the
# package whose FFModel `model` is (flexflow_tpu_torch here; the tests
# build the same graph in the JAX package)
MODELS = {"encoder": _build_encoder, "sp_attn": _build_sp_attn,
          "moe": _build_moe, "row_mlp": _build_row_mlp,
          "conv": _build_conv, "sp_search": _build_sp_search,
          "zoo": _build_zoo, "lm9": _build_lm9,
          "serve_lm": _build_serve_lm, "serve_mlp": _build_serve_mlp,
          "elastic_mlp": _build_elastic_mlp}


def _encoder_graph(job: Dict[str, Any], device: str, **config):
    """The job's graph (`MODELS`), built and not compiled."""
    from .. import FFConfig, FFModel

    model = FFModel(FFConfig(batch_size=job["batch"],
                             allow_mixed_precision=job["mixed"],
                             device=device, seed=job["seed"],
                             **{**job["config"], **config}))
    import flexflow_tpu_torch as lib
    import flexflow_tpu_torch.models  # noqa: F401

    MODELS[job["model"]](lib, model, job, **job["widths"])
    if job["sp_mode"]:
        for op in model.ops:
            if op.op_type.value == "multihead_attention":
                op.params["sequence_parallel_mode"] = job["sp_mode"]
    return model


def _compile(model, job: Dict[str, Any], axes) -> None:
    import torch

    from .. import (AdamOptimizer, CompMode, LossType, MetricsType,
                    SGDOptimizer)

    if job["comp_mode"] == "inference":
        model.compile(loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                      comp_mode=CompMode.COMP_MODE_INFERENCE,
                      parallel_axes=axes,
                      generator=torch.Generator().manual_seed(job["seed"]))
        return
    spec = job["optimizer"] or ("adam",) + tuple(job["adam"])
    if spec[0] == "sgd":
        opt = SGDOptimizer(model, lr=spec[1])
    else:
        opt = AdamOptimizer(model, alpha=spec[1], moments_dtype=getattr(
            torch, spec[2]) if spec[2] else None)
    model.compile(optimizer=opt,
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[MetricsType.METRICS_ACCURACY],
                  parallel_axes=axes,
                  generator=torch.Generator().manual_seed(job["seed"]))


def build_encoder(job: Dict[str, Any], device: str):
    """The job's model (JOB's keys, defaults filled in), compiled for
    training on its mesh."""
    from ..model import params_from_jax

    job = dict(JOB, **job)
    model = _encoder_graph(job, device)
    _compile(model, job, job["axes"])
    if model.outside_mesh:
        return model  # a rank past the plan's mesh holds no weights
    if job["adopt_sequential"]:
        seq = _encoder_graph(job, device)
        _compile(seq, job, {})
        model.adopt_params_from(seq)
        try:  # a pipeline-parallel source is refused
            seq.adopt_params_from(model)
            model.adopt_error = None
        except ValueError as exc:
            model.adopt_error = str(exc)
        del seq
    if job["jax_params"] is not None:
        params_from_jax(model, job["jax_params"])
    if job["params"] is not None:
        model.load_params(job["params"])
    if job["opt_state"] is not None:
        model.load_opt_state(job["opt_state"])
    if job["restore_path"]:
        from ..runtime.checkpoint import restore_checkpoint

        restore_checkpoint(job["restore_path"], model)
    return model


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def grad_steps(model, x, y, steps: int, names) -> List[Dict[str, Any]]:
    """Loss and the whole gradient's norm of each (op, weight) in `names`
    for `steps` steps on one batch, one optimizer update between steps."""
    import torch

    gstep = model.executor.build_grad_metrics_step(
        model.loss.fn, model.metrics, model.final_tensor)
    inputs, label = model._batch([x], y, 0, x.shape[0])
    out = []
    for step in range(1, steps + 1):
        grads, mvals = gstep(inputs, label)
        whole = model.gather_params(grads)
        out.append({"step": step, "loss": float(mvals["loss"]),
                    "grad_norms": {f"{op}/{w}": float(
                        whole[op][w].float().norm()) for op, w in names}})
        if step < steps:
            model.optimizer.update(model.executor.parameters(), grads,
                                   model.opt_state)
        del grads, whole
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return out


def plan_of(model) -> Dict[str, Any]:
    """The plan a compiled model holds: its mesh axes and each op's
    (dp, tp) by name (the mesh-wide degrees for an op the plan does not
    name), and what its search did, when it searched."""
    strategies = model._op_strategies or {}
    axes = dict(model.parallel_axes)
    ops = {}
    for op in model.graph.topo_order():
        s = strategies.get(op.guid)
        ops[op.name] = ([s.dp, s.tp] if s is not None
                        else [axes.get("data", 1), axes.get("model", 1)])
    degrees = {}
    for op in model.graph.topo_order():
        s = strategies.get(op.guid)
        degrees[op.name] = ([s.dp, s.tp, s.ep, s.ap, s.sp] if s is not None
                            else [axes.get(a, 1) for a in
                                  ("data", "model", "expert", "attr",
                                   "seq")])
    out: Dict[str, Any] = {"axes": axes, "ops": ops, "degrees": degrees,
                           "parallel_ops": {
                               op.name: op.op_type.value
                               for op in model.graph.topo_order()
                               if hasattr(op, "reshard")},
                           "xfer_ops": sorted(
                               op.name for op in model.graph.topo_order()
                               if getattr(op, "xfer_created", False))}
    low = getattr(model, "_grad_sync", None)
    if low is not None:
        out["grad_sync"] = {
            "mode": low.mode, "executed": low.executed_plan(),
            "priced": {k: v["strategy"]
                       for k, v in (model._reduction_plan or {}).items()},
            "decomposed": sum(len(e["sizes"]) > 1
                              for e in low.entries.values()),
            "buckets": len(low.bucket_map())}
    sr = model.search_result
    if sr is not None:
        out["search"] = {
            "cache_mode": sr.cache_mode, "wall_ms": sr.search_wall_ms,
            "predicted_step_us": sr.predicted_step_us,
            "cost_us": sr.cost_us, "memory_bytes": sr.memory_bytes,
            "candidates_simulated": sr.candidates_simulated,
            "candidates_pruned": sr.candidates_pruned,
            "applied_rewrites": [list(r) for r in sr.applied_rewrites]}
    report = getattr(model, "_analysis_report", None)
    if report is not None:
        codes: Dict[str, int] = {}
        for d in report.diagnostics:
            key = f"{d.code}/{d.severity.value}"
            codes[key] = codes.get(key, 0) + 1
        out["diagnostics"] = codes
    return out


def roles_of(model) -> Dict[str, Any]:
    """What a rank of the mesh runs of the plan: the ops on its positions
    (`seq`) or H rows (`attr`), the row-parallel linears and the
    column-parallel ones whose output stays sharded (the Megatron pair),
    and the pipelined region."""
    out: Dict[str, Any] = {
        "seq_local": sorted(op.name for op in model.ops if op.seq_local),
        "attr_local": sorted(op.name for op in model.ops if op.attr_local),
        "row_parallel": sorted(op.name for op in model.ops
                               if op.row_parallel),
        "unsharded_outputs": sorted(
            op.name for op in model.ops
            if op.op_type.value == "linear" and not op.gather_out)}
    plan = model.executor.pipeline_plan
    if plan is not None:
        out["pipeline"] = {"stages": plan.n_stages,
                           "segs_per_stage": plan.segs_per_stage,
                           "region_ops": len(plan.region_guids)}
    return out


def analytic_twice(job: Dict[str, Any], device: str, n_dev: int,
                   optimizer_state_factor: float) -> List[Dict[str, Any]]:
    """The analytic Unity search (measure_op_costs off) of fresh builds of
    the job's graph on `n_dev` devices, twice: the second run is the
    process-wide plan cache's to answer. Each run's plan (axes and (dp,
    tp) by op name), cache mode and wall."""
    from ..core.graph import Graph
    from ..search.machine_model import make_machine_model
    from ..search.unity import result_to_dict, unity_optimize

    out = []
    for _ in range(2):
        model = _encoder_graph(job, device, measure_op_costs=False)
        model.config.optimizer_state_factor = optimizer_state_factor
        graph = Graph(model.ops)
        t0 = time.perf_counter()
        res = unity_optimize(graph, model.config,
                             make_machine_model(model.config, n_dev),
                             model.config.batch_size, n_dev)
        wall = time.perf_counter() - t0
        plan = result_to_dict(res, graph)
        out.append({"axes": plan["mesh_axes"],
                    "ops": {k: [v["dp"], v["tp"]]
                            for k, v in plan["ops"].items()},
                    "cache_mode": res.cache_mode, "wall_s": wall,
                    "backend": ("cache" if res.cache_mode == "hit" else
                                "native" if res.log[:1] == [
                                    "native ffcore search"] else "python"),
                    "predicted_step_us": res.predicted_step_us,
                    "candidates_simulated": res.candidates_simulated,
                    "candidates_pruned": res.candidates_pruned})
    return out


def attention_blocks(job: Dict[str, Any], device: str) -> Dict[str, Any]:
    """`ring_attention` or `ulysses_attention` alone on a `seq` axis of
    every rank: job["attention"] holds "fn", "causal" and the whole f32
    "q", "k", "v" and output gradient "dout" (B, L, H, D); returns this
    rank's blocks of the output and of the gradients of q, k and v."""
    import torch

    from ..core.machine import make_mesh
    from ..kernels.ring_attention import ring_attention
    from ..kernels.ulysses_attention import ulysses_attention
    import torch.distributed as dist

    spec = job["attention"]
    mesh = make_mesh({"seq": dist.get_world_size()})
    n, i = mesh.size("seq"), mesh.index("seq")

    def block(a):
        a = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        m = a.shape[1] // n
        return a[:, i * m:(i + 1) * m].contiguous()

    q, k, v = (block(spec[x]).requires_grad_(True) for x in "qkv")
    fn = ring_attention if spec["fn"] == "ring" else ulysses_attention
    out = fn(q, k, v, mesh, "seq", causal=spec["causal"])
    grads = torch.autograd.grad(out, (q, k, v), block(spec["dout"]))
    return {"out": out.detach().cpu().numpy(),
            **{f"d{x}": g.cpu().numpy() for x, g in zip("qkv", grads)}}


def pipeline_transformer_steps(job: Dict[str, Any], device: str
                               ) -> Dict[str, Any]:
    """models/pipeline_transformer.py's train step on a `stage` axis of
    every rank: job["pipeline_transformer"] holds the whole stacked
    "params", "emb", "head", "tokens", "labels", "microbatches", "lr" and
    "steps"; returns the losses and this rank's final stage slice."""
    import torch
    import torch.distributed as dist

    from ..core.machine import make_mesh
    from ..models import pipeline_transformer as ptx

    spec = job["pipeline_transformer"]
    mesh = make_mesh({"stage": dist.get_world_size()})

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    params = ptx.stage_slice({k: dev(v) for k, v in spec["params"].items()},
                             mesh)
    emb, head = dev(spec["emb"]), dev(spec["head"])
    step = ptx.make_train_step(mesh, spec["microbatches"], spec["lr"])
    losses = []
    for _ in range(spec["steps"]):
        params, emb, head, loss = step(params, emb, head,
                                       dev(spec["tokens"]),
                                       dev(spec["labels"]))
        losses.append(float(loss))
    return {"losses": losses, "stage": mesh.index("stage"),
            "params": {k: v.cpu().numpy() for k, v in params.items()},
            "emb": emb.cpu().numpy(), "head": head.cpu().numpy()}


def collective_sweep(spec: Dict[str, Any], device: str) -> Dict[str, Any]:
    """obs/collective_bench.py's sweep on this world's ranks as one data
    axis: `spec` has the machine spec file (`machine`), the sizes in MB,
    the strategies, warm-up and repeats. Rows as dicts."""
    from ..config import FFConfig
    from ..obs.collective_bench import sweep_collectives
    from ..runtime import collectives

    config = FFConfig(device=device, machine_model_file=spec["machine"])
    collectives.reset_staged()
    t0 = time.perf_counter()
    res = sweep_collectives(
        config, [int(mb * 1e6) for mb in spec["sizes_mb"]],
        list(spec["strategies"]), warmup=spec.get("warmup", 1),
        repeats=spec.get("repeats", 3))
    res["rows"] = [r.to_dict() for r in res["rows"]]
    res["wall_s"] = time.perf_counter() - t0
    res["staged"] = dict(collectives.STAGED)
    return res


def _synced(device):
    """A no-argument wait for the rank's card (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def _session(model, spec: Dict[str, Any], device: str) -> Dict[str, Any]:
    """GenerativeSession runs on the mesh: spec["runs"], each generate's
    keywords (`new`, `eos_id`, `k`, `temperature`, `top_k`, `seed`), over
    spec["prompts"]; with spec["launches"] the kernel launches of one
    prefill and of one decode step on this rank; with
    spec["last_probs"] the prefill's last-prompt-position probabilities
    (gathered over `data`)."""
    import torch

    from ..kernels import launch_counts, reset_launch_counts
    from ..runtime import collectives
    from ..serving.generate import GenerativeSession

    sync = _synced(device)
    prompts = np.asarray(spec["prompts"], np.int32)
    sess = GenerativeSession(model, max_len=spec["max_len"])
    runs = []
    collectives.reset_staged()
    for r in spec["runs"]:
        sync()
        t0 = time.perf_counter()
        toks = sess.generate(prompts, max_new_tokens=r["new"],
                             eos_id=r.get("eos_id"),
                             tokens_per_dispatch=r.get("k", 1),
                             temperature=r.get("temperature", 0.0),
                             top_k=r.get("top_k"), seed=r.get("seed", 0))
        sync()
        runs.append({"tokens": toks, "s": time.perf_counter() - t0})
    out: Dict[str, Any] = {"runs": runs, "stats": sess.stats(),
                           "staged": dict(collectives.STAGED)}
    if spec.get("launches"):
        reset_launch_counts()
        sess.generate(prompts, max_new_tokens=1)
        prefill = launch_counts()
        reset_launch_counts()
        sess.generate(prompts, max_new_tokens=2)
        both = launch_counts()
        out["launches"] = {
            "prefill": {k: v for k, v in prefill.items() if v},
            "decode_step": {k: both[k] - prefill.get(k, 0) for k in both
                            if both[k] - prefill.get(k, 0)}}
    if spec.get("last_probs"):
        b, plen = model.config.batch_size, prompts.shape[1]
        window = model.input_ops[0].outputs[0].dims[1]
        padded = np.zeros((b, window), np.int32)
        padded[:, :plen] = prompts[-1]
        padded[:prompts.shape[0], :plen] = prompts
        lo, n = sess._row0, sess.rows
        ex = model.executor
        ex.batch_cut = n < b
        with torch.no_grad():
            probs = ex.forward_values({model.input_ops[0].name:
                                       torch.from_numpy(padded[lo:lo + n]
                                                        ).to(model.device)})
            probs = probs[model.final_tensor.guid][:, plen - 1].float()
            if n < b:
                probs = collectives.gather_shards(
                    probs, 0, model.mesh.group("data"),
                    model.mesh.size("data"))
        out["last_probs"] = probs.cpu().numpy()[:prompts.shape[0]]
    return out


def _infer(model, spec: Dict[str, Any], device: str) -> Dict[str, Any]:
    """An InferenceModel over spec["buckets"] on the mesh: predict of
    spec["x"] (every rank the same rows), with spec["launches"] the kernel
    launches of one walk of the largest bucket, then spec["batcher_rows"]
    single-row requests through the DynamicBatcher, which rank 0 leads
    and the others follow."""
    from ..kernels import launch_counts, reset_launch_counts
    from ..serving import DynamicBatcher, InferenceModel

    sync = _synced(device)
    im = InferenceModel(model, batch_buckets=spec["buckets"])
    name = im.input_names[0]
    x = np.asarray(spec["x"])
    sync()
    t0 = time.perf_counter()
    out: Dict[str, Any] = {"predict": im.predict({name: x})}
    sync()
    out["predict_s"] = time.perf_counter() - t0
    if spec.get("launches"):
        reset_launch_counts()
        im.predict({name: x[:max(spec["buckets"])]})
        out["launches"] = {k: v for k, v in launch_counts().items() if v}
    batcher = DynamicBatcher(im, max_batch_size=spec.get("max_batch", 8),
                             max_delay_ms=spec.get("delay_ms", 5.0))
    rows = spec.get("batcher_rows", 0)
    if batcher.leader:
        with batcher:
            futs = [batcher.submit({name: x[i:i + 1]}) for i in range(rows)]
            got = [f.result(timeout=600) for f in futs]
        out["batcher"] = np.concatenate(got) if got else None
    else:
        try:
            batcher.submit({name: x[:1]})
            out["follower_submit"] = None
        except RuntimeError as exc:
            out["follower_submit"] = str(exc)
        with batcher:
            pass  # follows the leader's batches until it stops
        out["followed"] = batcher.followed
    out["stats"] = im.stats()
    return out


def serve_job(job: Dict[str, Any], device: str) -> Dict[str, Any]:
    """A job's model built and compiled on its mesh (JOB's keys), then
    served by job["serve"]["kind"]: "session" (`_session`), "infer"
    (`_infer`), or "refusal" (the ValueError of a ContinuousBatcher over
    it). Reports whether compile built a train step and an optimizer
    state, and the error `fit` raises in inference mode."""
    spec = job["serve"]
    job = dict(JOB, **{k: v for k, v in job.items() if k != "serve"})
    t0 = time.perf_counter()
    model = build_encoder(job, device)
    out: Dict[str, Any] = {"mesh_coords": dict(model.mesh.coords)
                           if model.mesh else {},
                           "build_s": time.perf_counter() - t0,
                           "train_step": hasattr(model, "_train_step"),
                           "opt_state": model.opt_state is not None}
    if model.outside_mesh:
        out["outside_mesh"] = model.outside_mesh
        return out
    if job["comp_mode"] == "inference" and job["x"] is not None:
        try:
            model.fit(job["x"], job["y"], batch_size=job["batch"])
            out["fit_error"] = None
        except RuntimeError as exc:
            out["fit_error"] = str(exc)
    kind = spec["kind"]
    if kind == "session":
        out.update(_session(model, spec, device))
    elif kind == "infer":
        out.update(_infer(model, spec, device))
    elif kind == "refusal":
        from ..serving.sched import ContinuousBatcher

        try:
            ContinuousBatcher(model, max_len=spec["max_len"], num_slots=2)
            out["refusal"] = None
        except ValueError as exc:
            out["refusal"] = str(exc)
    else:
        raise ValueError(f"unknown serve kind {kind!r}")
    return out


# an `elastic` job's spec keys and their defaults
ELASTIC: Dict[str, Any] = {
    # the graph (a key of MODELS, its keywords), batch, seed, precision
    "model": "elastic_mlp",
    "widths": {},
    "batch": 12,
    "seed": 0,
    "mixed": False,
    "use_flash": None,
    # ("sgd", lr) or ("adam", alpha, moments dtype name or None)
    "optimizer": ("sgd", 0.05),
    # compile with the accuracy metric
    "accuracy": False,
    # further FFConfig fields (search_budget, measure_op_costs, ...)
    "config": {},
    # the ranks (config.device_ids); None: the world
    "device_ids": None,
    # whole initial weights (a JAX model's, numpy) every build loads
    "jax_params": None,
    # the FaultPlan: (kind, at_step, chips, times) each
    "faults": (),
    # ElasticCoordinator keywords (checkpoint_every, live_resharding,
    # max_rollbacks, preplan, ...) and its checkpoint directory
    "coordinator": {},
    "checkpoint_dir": None,
    # RetryPolicy keywords; WatchdogPolicy keywords (None: "auto")
    "retry": {"max_retries": 3, "base_delay_s": 0.0},
    "watchdog": None,
    # wait for the constructor's background plans before fit
    "preplan_join": False,
    # a DriftDetector's keywords, and "refit": whether the drift re-plan
    # refits the machine model (obs/refit.py refit) first
    "drift": None,
    # tokens or features x and labels y (numpy), and fit's steps
    "x": None,
    "y": None,
    "steps": 6,
    # "fit", or "recover_unidentified": a checkpoint, then _recover of a
    # topology loss naming no rank
    "call": "fit",
    # record the trace's spans (obs.enable_tracing) over the run; the
    # rank that leads at the end exports it to `trace_out` when given
    "trace": False,
    "trace_out": None,
    # check that every watchdog SKIP left the weights, the optimizer
    # state and the step count bit-identical, and record the kernel
    # launches at every step's verdict (`StepProbe`)
    "skip_witness": False,
    "step_launches": False,
    # (rank, step): that rank exits (os._exit) inside its first
    # torch.distributed.all_reduce from that step on, as a crashed peer
    # does mid-collective; spawn it with the rank among `leavers`
    "exit_in_allreduce": None,
}

# the exit code of a rank that `exit_in_allreduce` takes away
EXIT_IN_ALLREDUCE = 17


def _exit_in_allreduce(step_of, at_step: int) -> None:
    """Make this process exit inside its first torch.distributed
    all_reduce once step_of() >= at_step (the peers' matching call then
    sees the connection close)."""
    import torch.distributed as dist

    real = dist.all_reduce

    def all_reduce(*args, **kwargs):
        if step_of() >= at_step:
            os._exit(EXIT_IN_ALLREDUCE)
        return real(*args, **kwargs)

    dist.all_reduce = all_reduce


def collective_timeout(spec: Dict[str, Any], device: str) -> Dict[str, Any]:
    """A collective that only rank 0 joins: every rank makes a group over
    the world with a `timeout_s` limit; rank 0 dispatches an all-reduce
    on it through the elastic FailureDetector (its retry policy, no
    delay), the others never join. Rank 0 reports the first error (the
    timeout) and its elastic/faults.py class, the error of the retry on
    the same group and its class, what the dispatch raised, and the
    detector's events. The ranks then meet at a barrier of the default
    group."""
    import datetime

    import torch
    import torch.distributed as dist

    from ..elastic.detector import FailureDetector
    from ..elastic.faults import classify_error
    from ..elastic.retry import RetryPolicy

    group = dist.new_group(list(range(dist.get_world_size())),
                           timeout=datetime.timedelta(
                               seconds=spec["timeout_s"]))
    out: Dict[str, Any] = {"rank": dist.get_rank(), "errors": [],
                           "classes": [], "waits_s": [], "raised": None,
                           "events": []}
    if dist.get_rank() == 0:
        det = FailureDetector(retry_policy=RetryPolicy(base_delay_s=0.0))

        def all_reduce():
            try:
                dist.all_reduce(torch.ones(4, device=device), group=group)
            except Exception as exc:
                out["errors"].append(f"{type(exc).__name__}: {exc}")
                out["classes"].append(classify_error(exc))
                out["waits_s"].append(time.perf_counter() - t0)
                raise

        t0 = time.perf_counter()
        try:
            det.dispatch(all_reduce)
        except Exception as exc:  # noqa: BLE001 — the error is the result
            out["raised"] = f"{type(exc).__name__}: {exc}"
        out["events"] = [[e.kind, e.step, _jsonable(e.details)]
                         for e in det.events.events()]
    dist.barrier()
    return out


class StepProbe:
    """A TrainingWatchdog's verdicts, watched. With `skips`: the check
    that a SKIP changed nothing — at the verdict after a SKIP (the next
    step's, before any update of it) this rank's weights, optimizer state
    and step count equal, to the bit, their copies taken at the SKIP
    (`same`, one bool per SKIP so checked). With `launches`: the kernel
    launch counts at each verdict (`counts`, (step, counts) pairs); two
    consecutive verdicts' difference is one step's launches (the update
    of the first step and the walk of the second)."""

    def __init__(self, watchdog, model_of, skips: bool, launches: bool):
        self.inner = watchdog
        self.model_of = model_of
        self.skips, self.launches = skips, launches
        self.same: List[bool] = []
        self.counts: List[Any] = []
        self._copy = None

    def _state(self):
        m = self.model_of()
        leaves = [t for ws in m.params.values() for t in ws.values()]
        for v in m.opt_state.values():
            leaves += ([t for ws in v.values() for t in ws.values()]
                       if isinstance(v, dict) else [v])
        return leaves, m._step_count

    def check(self, step, loss):
        import torch

        from ..kernels import launch_counts

        if self.launches:
            self.counts.append((step, dict(launch_counts())))
        if self._copy is not None:
            (before, count), self._copy = self._copy, None
            now, now_count = self._state()
            self.same.append(count == now_count and all(
                torch.equal(a, b) for a, b in zip(before, now)))
        verdict = self.inner.check(step, loss)
        if verdict == "skip" and self.skips:
            leaves, count = self._state()
            self._copy = ([t.detach().clone() for t in leaves], count)
        return verdict

    def note_rollback(self, restored_step):
        self._copy = None
        self.inner.note_rollback(restored_step)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def elastic_job(spec: Dict[str, Any], device: str) -> Dict[str, Any]:
    """One rank's elastic run (`ELASTIC`'s keys): build the coordinator
    over the spec's ranks, fit under its fault plan, and report what
    this rank saw: whether it left (`departed`), its rank list and plan
    at the end, the committed history, the event log, the restore and
    checkpoint counters' moves, the checkpoints it wrote, the searching
    rank, the live reshard, the kernels launched, the spans. The run
    starts from an empty plan cache."""
    import torch
    import torch.distributed as dist

    import flexflow_tpu_torch as lib
    import flexflow_tpu_torch.models  # noqa: F401
    from .. import (AdamOptimizer, FFConfig, FFModel, LossType,
                    MetricsType, SGDOptimizer)
    from ..elastic import (ElasticCoordinator, EventLog, Fault, FaultPlan,
                           RecoveryFailed, RetryPolicy, TopologyLoss,
                           TrainingWatchdog, WatchdogPolicy)
    from ..kernels import launch_counts, reset_launch_counts
    from ..model import params_from_jax
    from ..obs.registry import REGISTRY
    from ..runtime.durability import checkpoint_counters
    from ..search.plan_cache import reset_plan_cache

    spec = dict(ELASTIC, **spec)
    reset_plan_cache()
    if device == "cpu":
        # ranks that share the host's cores: one intra-op thread each
        torch.set_num_threads(1)

    def builder(cfg):
        model = FFModel(cfg)
        MODELS[spec["model"]](lib, model, spec, **spec["widths"])
        opt = spec["optimizer"]
        if opt[0] == "sgd":
            optimizer = SGDOptimizer(model, lr=opt[1])
        else:
            optimizer = AdamOptimizer(model, alpha=opt[1],
                                      moments_dtype=getattr(torch, opt[2])
                                      if opt[2] else None)
        model.compile(
            optimizer=optimizer,
            loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
            metrics=[MetricsType.METRICS_ACCURACY]
            if spec["accuracy"] else [],
            generator=torch.Generator().manual_seed(spec["seed"]))
        if spec["jax_params"] is not None:
            params_from_jax(model, spec["jax_params"])
        return model

    config = FFConfig(batch_size=spec["batch"], seed=spec["seed"],
                      allow_mixed_precision=spec["mixed"], device=device,
                      device_ids=spec["device_ids"], **spec["config"])
    plan = FaultPlan([Fault(kind, at, chips=tuple(chips), times=times)
                      for kind, at, chips, times in spec["faults"]])
    events = EventLog()
    wd = "auto" if spec["watchdog"] is None else TrainingWatchdog(
        WatchdogPolicy(**spec["watchdog"]), events=events)
    restores = REGISTRY.counter("ff_recovery_restore_total", "",
                                labels=("source",))
    before = ({s: restores.value(source=s) for s in ("live", "disk")},
              checkpoint_counters(),
              REGISTRY.counter("ff_replan_total", "").value())
    tracer = None
    if spec["trace"]:
        from ..obs import enable_tracing

        tracer = enable_tracing()
        tracer.clear()
    coord = ElasticCoordinator(
        builder, config, fault_plan=plan, events=events,
        checkpoint_dir=spec["checkpoint_dir"], watchdog=wd,
        retry_policy=RetryPolicy(**spec["retry"]), **spec["coordinator"])
    if spec["preplan_join"]:
        coord.preplan_join(timeout=120)
    witness = None
    if spec["skip_witness"] or spec["step_launches"]:
        witness = StepProbe(coord.watchdog, lambda: coord.model,
                            spec["skip_witness"], spec["step_launches"])
        coord.watchdog = witness
    det = None
    if spec["drift"] is not None:
        from ..obs.refit import DriftDetector, refit

        drift = dict(spec["drift"])
        do_refit = drift.pop("refit", False)
        det = DriftDetector(**drift)
        coord.drift_detector = det
        if do_refit:
            def refit_hook(model, measured_us):
                prof, hist = refit(model, measured_us, [], rounds=3,
                                   tol=0.15)
                out["refit_ratio"] = hist[-1].ratio
                return prof.save(os.path.join(
                    coord.checkpoint_dir, f"fitted_{me}.json"))

            coord.drift_refit = refit_hook
    me = dist.get_rank() if dist.is_initialized() else 0
    if spec["exit_in_allreduce"] is not None and \
            me == spec["exit_in_allreduce"][0]:
        _exit_in_allreduce(lambda: coord.detector.current_step,
                           spec["exit_in_allreduce"][1])
    out: Dict[str, Any] = {"rank": me, "raised": None}
    dev = coord.model.device
    reset_launch_counts()
    t0 = time.perf_counter()
    history = []
    try:
        if spec["call"] == "recover_unidentified":
            coord._save(0)
            coord._recover(TopologyLoss([]))
        else:
            history = coord.fit(spec["x"], spec["y"], steps=spec["steps"])
    except RecoveryFailed as exc:
        out["raised"] = f"RecoveryFailed: {exc}"
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["fit_s"] = time.perf_counter() - t0
    out["launches"] = {k: n for k, n in launch_counts().items() if n}
    if tracer is not None:
        from ..obs import disable_tracing

        names = tracer.span_names()
        nested = None
        if tracer.events("elastic.recover"):
            rec = tracer.events("elastic.recover")[0]
            nested = all(
                rec["ts"] <= ev["ts"]
                and ev["ts"] + ev["dur"] <= rec["ts"] + rec["dur"] + 1e-3
                for child in ("elastic.replan", "elastic.restore")
                for ev in tracer.events(child)[:1])
        out["spans"] = sorted(set(names))
        # each span's durations (the trace's microseconds)
        out["span_us"] = {n: [ev["dur"] for ev in tracer.events(n)
                              if "dur" in ev] for n in set(names)}
        out["recover_nested"] = nested
        if spec["trace_out"] and not coord.departed and \
                me == coord.device_ids[0]:
            out["trace"] = tracer.export_chrome_trace(spec["trace_out"])
        disable_tracing()
    model = coord.model
    ckpt_after = checkpoint_counters()
    from ..serving.server import InferenceServer

    srv = InferenceServer()
    srv.attach_elastic_events(events)
    out.update({
        "departed": coord.departed,
        "device_ids": list(coord.device_ids),
        "axes": dict(model.parallel_axes),
        "mesh": model.mesh is not None,
        "mesh_ranks": model.mesh.mesh_ranks if model.mesh else None,
        "total_devices": model.config.total_devices,
        "history": history,
        "events": [[e.kind, e.step, _jsonable(e.details)]
                   for e in events.events()],
        "events_json": events.to_json(),
        # the ff_watchdog_* / ff_checkpoint_* lines this rank's serving
        # /metrics endpoint exports
        "metrics": [ln for ln in srv.prometheus_text().splitlines()
                    if ("watchdog" in ln or "checkpoint" in ln)
                    and not ln.startswith("#")],
        "restores": {s: restores.value(source=s) - before[0][s]
                     for s in ("live", "disk")},
        "checkpoint_counts": {k: v - before[1].get(k, 0)
                              for k, v in ckpt_after.items()},
        "replans": REGISTRY.counter("ff_replan_total", "").value()
        - before[2],
        "written": list(coord._ckpt.written),
        "search_leader": model.search_leader,
        "planner": coord.planner is not None,
        "reshard": coord.last_reshard,
        "model_device": str(dev),
        "param_devices": sorted({str(t.device)
                                 for ws in model.params.values()
                                 for t in ws.values()}),
        "fitted_profile": model.config.fitted_profile_file,
        "skips_identical": witness.same if witness and witness.skips
        else None,
        "step_launches": witness.counts if witness else None,
    })
    if det is not None:
        from ..obs.calibration import predicted_step_us

        out["drift"] = {"predicted_step_us": det.predicted_step_us,
                        "replans": det.replans,
                        "measured_step_us": det.measured_step_us,
                        "model_predicted_step_us": predicted_step_us(
                            model) if not coord.departed else None}
    del coord, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_job(job: Dict[str, Any], device: str) -> Dict[str, Any]:
    import torch

    if "serve" in job:
        return serve_job(job, device)
    if "attention" in job:
        return attention_blocks(job, device)
    if "pipeline_transformer" in job:
        return pipeline_transformer_steps(job, device)
    if "collective_sweep" in job:
        return collective_sweep(job["collective_sweep"], device)
    if "elastic" in job:
        return elastic_job(job["elastic"], device)
    if "collective_timeout" in job:
        return collective_timeout(job["collective_timeout"], device)

    from ..kernels import launch_counts, reset_launch_counts
    from ..runtime import collectives
    from ..search.simulator import get_op_cost_cache

    job = dict(JOB, **job)
    t0 = time.perf_counter()
    model = build_encoder(job, device)
    build_s = time.perf_counter() - t0
    out: Dict[str, Any] = {"mesh_coords": dict(model.mesh.coords)
                           if model.mesh else {}, "build_s": build_s,
                           "plan": plan_of(model),
                           "adopt_error": getattr(model, "adopt_error",
                                                  None)}
    if model.search_result is not None:
        cache = get_op_cost_cache(model.config)
        out["op_cost_cache"] = {"hits": cache.hits, "misses": cache.misses,
                                "failures": dict(cache.failures)}
    import torch.distributed as dist

    if job["analytic_twice"] and dist.get_rank() == 0:
        out["analytic"] = analytic_twice(
            job, device, model.config.total_devices,
            model.config.optimizer_state_factor)
    x, y = job["x"], job["y"]
    if model.outside_mesh:
        out["outside_mesh"] = model.outside_mesh
        try:
            model.fit(x, y, batch_size=job["batch"], epochs=1)
            out["fit_error"] = None
        except RuntimeError as exc:
            out["fit_error"] = str(exc)
        return out
    dev = model.device
    out["roles"] = roles_of(model)
    before = ({op: {w: t.detach().clone() for w, t in ws.items()}
               for op, ws in model.gather_params().items()}
              if job["update_norms"] else None)
    if job["grad_steps"]:
        out["steps"] = grad_steps(model, x, y, job["grad_steps"],
                                  job["grad_norms_of"])
    else:
        warm = job["steps"] - job["count_steps"]
        k = job["steps_per_execution"]
        # fit's StepStats records, one a step or K-step dispatch (its
        # history has one summary per epoch)
        steps = []
        if warm:
            model.fit(x, y, batch_size=job["batch"], epochs=warm,
                      steps_per_execution=k)
            steps += model.step_stats.records()
        n_warm = len(steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        collectives.reset_staged()
        counted = job["count_steps"]
        if counted:
            model.fit(x, y, batch_size=job["batch"], epochs=counted,
                      steps_per_execution=k)
            steps += model.step_stats.records()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            launches = launch_counts()
            out["launches_per_step"] = {k: n / counted
                                        for k, n in launches.items()}
            out["ms_per_step"] = [r["step_ms"] for r in steps[n_warm:]]
            out["staged_per_step"] = {k: v / counted for k, v in
                                      collectives.STAGED.items()}
            out["peak_mem_gib"] = (torch.cuda.max_memory_allocated(dev)
                                   / 2 ** 30 if dev.type == "cuda" else None)
        # a record's loss: a step's, or a K-step dispatch's mean
        out["losses"] = out["record_losses"] = [r["loss"] for r in steps]
        if k > 1:
            out["multi_step"] = model._multi_step(k).stats()
        if dev.type == "cuda":
            out["params_gib"] = sum(
                t.numel() * t.element_size() for ws in model.params.values()
                for t in ws.values()) / 2 ** 30
        if job["eval"]:
            out["eval"] = model.eval(x, y, batch_size=job["batch"])
        if job["predict_batch"]:
            out["predict"] = model.predict(x, batch_size=job["predict_batch"])
        if before is not None:
            out["update_norms"] = {
                f"{op}/{w}": float((t.double() - before[op][w].double())
                                   .norm())
                for op, ws in model.gather_params().items()
                for w, t in ws.items()}
            del before
        if job["checkpoint_dir"]:
            out.update(_checkpoint_round_trip(model, job, device))
        if job["reshard_to"]:
            out.update(_reshard(model, job, device))
    # the weights every rank holds whole must agree to the bit
    ex = model.executor
    out["replicated_digest"] = _digest(
        t for op in model.ops for ws in op.specs
        if ws.name not in op.shards and ex.stage_of(op) is None
        for t in [op.w(ws.name)])
    if job["return_params"]:
        out["shard_shapes"] = {op: {w: tuple(t.shape) for w, t in ws.items()}
                               for op, ws in model.params.items()}
        out["params"] = {op: {w: t.float().cpu().numpy()
                              for w, t in ws.items()}
                         for op, ws in model.gather_params().items()}
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _checkpoint_round_trip(model, job: Dict[str, Any],
                           device: str) -> Dict[str, Any]:
    """Save `model` into the job's checkpoint directory (every rank calls
    it, rank 0 writes), restore it into a model drawn from another seed,
    and predict with that one."""
    from ..runtime.durability import DurableCheckpointer

    import torch.distributed as dist

    ckpt = DurableCheckpointer(job["checkpoint_dir"])
    t0 = time.perf_counter()
    path = ckpt.save(model, step=model._step_count)
    save_s = time.perf_counter() - t0
    fresh = build_encoder(dict(job, seed=job["seed"] + 1, params=None,
                               opt_state=None, jax_params=None,
                               restore_path=None), device)
    t0 = time.perf_counter()
    step, restored = ckpt.restore_latest(fresh)
    restore_s = time.perf_counter() - t0

    def whole(m):
        trees = {"params": m.gather_params()}
        for k, v in m.opt_state.items():
            trees[k] = m.gather_params(v) if isinstance(v, dict) else {
                "": {"": v}}
        return _digest(t for tree in trees.values() for ws in tree.values()
                       for t in ws.values())

    keys = (sorted(np.load(path).files) if dist.get_rank() == 0 else None)
    return {"checkpoint": path, "restored_step": step,
            "checkpoint_keys": keys, "save_s": save_s,
            "restore_s": restore_s,
            "restored_state_equal": whole(model) == whole(fresh),
            "restored_predict": fresh.predict(
                job["x"], batch_size=job["predict_batch"])}


def _reshard(model, job: Dict[str, Any], device: str) -> Dict[str, Any]:
    """Redistribute `model`'s live weights and optimizer moments onto a
    model compiled on `job["reshard_to"]` (resharding/, the FFTA06x gate
    on), check every leaf of this rank against the slice of the gathered
    whole, adopt them and train 2 steps there; then move
    that model's state back onto a model on the first axes and check it
    the same way (a gather of the `model` shards)."""
    there, rec = _move(model, job["reshard_to"], job, device)
    there.fit(job["x"], job["y"], batch_size=job["batch"], epochs=2)
    rec["losses_after"] = [r["loss"] for r in there.step_stats.records()]
    _, back = _move(there, model.parallel_axes, job, device)
    rec["back"] = back
    return {"reshard": rec}


def _move(model, axes, job: Dict[str, Any], device: str):
    """(a model compiled on `axes` holding `model`'s live state moved by
    `redistribute`, the move's record)."""
    import torch
    import torch.distributed as dist

    from ..resharding import (flatten_tree, live_tree, load_live_tree,
                              plan_of, redistribute)
    from ..resharding.executor import shard_box
    from ..runtime import collectives
    from ..search.machine_model import make_machine_model

    old_plan = plan_of(model)
    tree = live_tree(model)
    whole = {"params": model.gather_params()}
    if "opt_state" in tree:
        whole["opt_state"] = {k: model.gather_params(v)
                              for k, v in tree["opt_state"].items()}
    new = build_encoder(dict(job, axes=axes, seed=job["seed"] + 1,
                             params=None, opt_state=None, jax_params=None,
                             restore_path=None), device)
    new_plan = plan_of(new)
    machine = make_machine_model(model.config, dist.get_world_size())
    collectives.reset_staged()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    res = redistribute(tree, old_plan, new_plan,
                       peak_bytes=job["reshard_peak"], machine=machine,
                       check=True, mesh=model.mesh)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    staged = dict(collectives.STAGED)
    me = dist.get_rank()
    flat_whole = flatten_tree(whole)
    moves = {m.path: m for m in res.schedule.moves}
    mismatched = []
    for path, got in flatten_tree(res.tree).items():
        move = moves[path]
        box = shard_box(move.new, res.schedule.new_mesh, me, move.shape)
        want = flat_whole[path]
        for d, (lo, hi) in enumerate(box):
            want = want.narrow(d, lo, hi - lo)
        if not torch.equal(got.cpu(), want.to(got.dtype).cpu()):
            mismatched.append(path)
    load_live_tree(new, res.tree)
    with torch.no_grad():
        for k in ("step", "lr"):
            new.opt_state[k].copy_(model.opt_state[k])
    new._step_count = model._step_count
    summary = res.schedule.summary()
    return new, {
        "old_axes": dict(old_plan.mesh.axes),
        "new_axes": dict(new_plan.mesh.axes),
        "arrays": summary["arrays"], "noop": summary["noop"],
        "rounds": summary["rounds"],
        "planned_scratch_bytes": summary["peak_scratch_bytes"],
        "peak_bytes_bound": summary["peak_bytes_bound"],
        "observed_peak_bytes": res.observed_peak_bytes,
        "bytes_moved": res.bytes_moved, "wall_s": res.wall_s,
        "transfer_rounds": res.transfer_rounds,
        "allgather_rounds": res.allgather_rounds,
        "staged": staged, "mismatched": mismatched}


def run_rank(rank: int, world: int, init_method: str, device: str,
             jobs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One rank's body: join the process group, run `jobs` in order,
    leave. Returns {"host": host_info, "jobs": [result, ...]}, each result
    with its wall `job_s`; rank 0 prints a line a finished job to
    stderr."""
    from ..runtime import distributed

    info = distributed.initialize(init_method, world_size=world, rank=rank,
                                  device=device)
    try:
        results = []
        for i, job in enumerate(jobs):
            t0 = time.perf_counter()
            res = run_job(job, device)
            res["job_s"] = time.perf_counter() - t0
            results.append(res)
            if "elastic" in job and i + 1 < len(jobs):
                # ranks may have left: every rank joins a fresh group
                # (runtime/distributed.py group_of's naming rule)
                distributed.shutdown()
                distributed.initialize(f"{init_method}.{i + 1}",
                                       world_size=world, rank=rank,
                                       device=device)
            if rank == 0:
                print(f"tp_train: job {i + 1} of {len(jobs)} "
                      f"({job.get('model', 'encoder')}, axes "
                      f"{job.get('axes')}) done in {res['job_s']:.1f} s",
                      file=sys.stderr, flush=True)
        return {"host": info, "jobs": results}
    finally:
        distributed.shutdown()


def spawn_jobs(world: int, device: str, jobs: List[Dict[str, Any]],
               timeout_s: float = 900.0, workdir: Optional[str] = None,
               leavers=()) -> List[Dict[str, Any]]:
    """Run `jobs` on `world` spawned ranks (a file:// rendezvous in
    `workdir`, default a fresh temporary directory); results by rank,
    None for a rank of `leavers` that exited (`exit_in_allreduce`)."""
    from ..runtime.distributed import spawn

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        return spawn(run_rank, world, (world, init, device, jobs),
                     timeout_s=timeout_s, leavers=leavers)


def bench_batch(batch: int = 8, seq: int = 512, vocab: int = 30522):
    """bench.py `_run`'s batch: tokens and labels from RandomState(0)."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
    y = rng.randint(0, 2, size=(batch, seq, 1)).astype(np.int32)
    return x, y


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("tp_train: no CUDA device visible (--device cpu runs the "
                  "ranks on the CPU)", file=sys.stderr)
            return 2
        from ..kernels import _build

        _build.library()  # once, before the ranks start
    x, y = bench_batch()
    job = {"axes": {"data": args.data, "model": args.model},
           "widths": {"num_layers": args.layers}, "x": x, "y": y,
           "steps": args.steps, "count_steps": max(1, args.steps - 2)}
    for rank, res in enumerate(spawn_jobs(args.data * args.model,
                                          args.device, [job])):
        print(json.dumps({"rank": rank, "host": res["host"],
                          **res["jobs"][0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
