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
run one after another in one process group.
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
    "axes": {"model": 2},
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
}


def build_encoder(job: Dict[str, Any], device: str):
    """The job's BERT encoder (JOB's keys, defaults filled in), compiled
    for training on its mesh."""
    import torch

    from .. import (AdamOptimizer, DataType, FFConfig, FFModel, LossType,
                    MetricsType)
    from ..models import TransformerConfig, build_bert_encoder

    job = dict(JOB, **job)
    cfg = TransformerConfig(**job["widths"])
    batch = job["batch"]
    model = FFModel(FFConfig(batch_size=batch,
                             allow_mixed_precision=job["mixed"],
                             device=device))
    tokens = model.create_tensor([batch, cfg.sequence_length],
                                 DataType.DT_INT32)
    build_bert_encoder(model, tokens, cfg, use_flash=job["use_flash"])
    alpha, moments = job["adam"]
    opt = AdamOptimizer(model, alpha=alpha, moments_dtype=getattr(
        torch, moments) if moments else None)
    model.compile(optimizer=opt,
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[MetricsType.METRICS_ACCURACY],
                  parallel_axes=job["axes"],
                  generator=torch.Generator().manual_seed(job["seed"]))
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


def run_job(job: Dict[str, Any], device: str) -> Dict[str, Any]:
    import torch

    from ..kernels import launch_counts, reset_launch_counts
    from ..runtime import collectives

    job = dict(JOB, **job)
    t0 = time.perf_counter()
    model = build_encoder(job, device)
    build_s = time.perf_counter() - t0
    dev = model.device
    out: Dict[str, Any] = {"mesh_coords": dict(model.mesh.coords)
                           if model.mesh else {}, "build_s": build_s}
    x, y = job["x"], job["y"]
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
