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
tests/test_torch_tp.py spawn: a list of jobs, each a dict (see `JOB`),
run one after another in one process group. A job with `axes` None
compiles with no axes, so the model's plan comes from its config
(`config`: the strategy search, an imported strategy file, or the
`{"data": world}` default); each rank then reports the plan it holds,
and a rank past the plan's mesh trains nothing: it reports the error
its `fit` raises.
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
    # seed and predict with it (needs predict_batch)
    "checkpoint_dir": None,
}


def _encoder_graph(job: Dict[str, Any], device: str, **config):
    """The job's BERT encoder, built and not compiled."""
    from .. import DataType, FFConfig, FFModel
    from ..models import TransformerConfig, build_bert_encoder

    cfg = TransformerConfig(**job["widths"])
    batch = job["batch"]
    model = FFModel(FFConfig(batch_size=batch,
                             allow_mixed_precision=job["mixed"],
                             device=device, **{**job["config"], **config}))
    tokens = model.create_tensor([batch, cfg.sequence_length],
                                 DataType.DT_INT32)
    build_bert_encoder(model, tokens, cfg, use_flash=job["use_flash"])
    return model


def build_encoder(job: Dict[str, Any], device: str):
    """The job's BERT encoder (JOB's keys, defaults filled in), compiled
    for training on its mesh."""
    import torch

    from .. import AdamOptimizer, LossType, MetricsType

    job = dict(JOB, **job)
    model = _encoder_graph(job, device)
    alpha, moments = job["adam"]
    opt = AdamOptimizer(model, alpha=alpha, moments_dtype=getattr(
        torch, moments) if moments else None)
    model.compile(optimizer=opt,
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[MetricsType.METRICS_ACCURACY],
                  parallel_axes=job["axes"],
                  generator=torch.Generator().manual_seed(job["seed"]))
    if model.outside_mesh:
        return model  # a rank past the plan's mesh holds no weights
    if job["params"] is not None:
        model.load_params(job["params"])
    if job["opt_state"] is not None:
        model.load_opt_state(job["opt_state"])
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
    out: Dict[str, Any] = {"axes": axes, "ops": ops}
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
                    "predicted_step_us": res.predicted_step_us,
                    "candidates_simulated": res.candidates_simulated,
                    "candidates_pruned": res.candidates_pruned})
    return out


def run_job(job: Dict[str, Any], device: str) -> Dict[str, Any]:
    import torch

    from ..kernels import launch_counts, reset_launch_counts
    from ..runtime import collectives
    from ..search.simulator import get_op_cost_cache

    job = dict(JOB, **job)
    t0 = time.perf_counter()
    model = build_encoder(job, device)
    build_s = time.perf_counter() - t0
    out: Dict[str, Any] = {"mesh_coords": dict(model.mesh.coords)
                           if model.mesh else {}, "build_s": build_s,
                           "plan": plan_of(model)}
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
    if job["grad_steps"]:
        out["steps"] = grad_steps(model, x, y, job["grad_steps"],
                                  job["grad_norms_of"])
    else:
        warm = job["steps"] - job["count_steps"]
        # fit's per-step records (its history has one summary per epoch)
        steps = []
        if warm:
            model.fit(x, y, batch_size=job["batch"], epochs=warm)
            steps += model.step_records
        n_warm = len(steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        collectives.reset_staged()
        counted = job["count_steps"]
        if counted:
            model.fit(x, y, batch_size=job["batch"], epochs=counted)
            steps += model.step_records
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
        out["losses"] = [r["loss"] for r in steps]
        out["accuracy"] = [r["accuracy"] for r in steps]
        if job["eval"]:
            out["eval"] = model.eval(x, y, batch_size=job["batch"])
        if job["predict_batch"]:
            out["predict"] = model.predict(x, batch_size=job["predict_batch"])
        if job["checkpoint_dir"]:
            out.update(_checkpoint_round_trip(model, job, device))
    # the weights every rank holds whole must agree to the bit
    out["replicated_digest"] = _digest(
        t for op in model.ops for ws in op.specs if ws.name not in op.shards
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

    ckpt = DurableCheckpointer(job["checkpoint_dir"])
    path = ckpt.save(model, step=model._step_count)
    fresh = build_encoder(dict(job, seed=job["seed"] + 1, params=None,
                               opt_state=None), device)
    step, restored = ckpt.restore_latest(fresh)
    return {"checkpoint": path, "restored_step": step,
            "restored_predict": fresh.predict(
                job["x"], batch_size=job["predict_batch"])}


def run_rank(rank: int, world: int, init_method: str, device: str,
             jobs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One rank's body: join the process group, run `jobs` in order,
    leave. Returns {"host": host_info, "jobs": [result, ...]}."""
    from ..runtime import distributed

    info = distributed.initialize(init_method, world_size=world, rank=rank,
                                  device=device)
    try:
        return {"host": info, "jobs": [run_job(j, device) for j in jobs]}
    finally:
        distributed.shutdown()


def spawn_jobs(world: int, device: str, jobs: List[Dict[str, Any]],
               timeout_s: float = 900.0,
               workdir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Run `jobs` on `world` spawned ranks (a file:// rendezvous in
    `workdir`, default a fresh temporary directory); results by rank."""
    from ..runtime.distributed import spawn

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        return spawn(run_rank, world, (world, init, device, jobs),
                     timeout_s=timeout_s)


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
