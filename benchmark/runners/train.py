"""The training runner (traffic kind "train"): FFModel.fit, the port's
training entry, at the mix's batch and sequence length with K =
`steps_per_execution` steps a dispatch (one CUDA graph of K steps on the
card).

Set-up builds the model (configs/<config>.py), loads the seed's weights
(reference/<config>.py make_weights) and runs the first two dispatches
through the window's own call on the pool's first 2K batches, all
different: the first runs its K steps eagerly and captures the graph,
the second replays it, so every shape is warm and the graph built before
the window. Their readings (each dispatch's mean loss, Adam's first
moment after the first, each leaf's change after both) are what the
reference checks after the window. The window calls fit on
`dispatches_per_call` dispatches at a time (some seconds of steps, as a
user's fit over a dataset, so that the host's work at each call is
spread over many steps), cycling through the pool, until `seconds` have
passed; a rate is all the steps over all the time of those calls.

With --trace 1, torch.profiler is started once the window has closed
(which takes seconds and turns CUPTI on, so the window runs without it)
and traces one more call of the same size, from PAD_S before it to
PAD_S after it; its marker spans the call.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import judge
from benchmark import traffic as gen
from benchmark.observe import Observations, Outcome
from benchmark.trace import PAD_S, Slice


def _fit(model, x, y, k: int) -> float:
    """One fit call over the batches x[i], y[i]; returns the mean loss
    of its last dispatch."""
    model.fit(x.reshape(-1, *x.shape[2:]), y.reshape(-1, *y.shape[2:]),
              batch_size=x.shape[1], epochs=1, steps_per_execution=k)
    return float(model.step_stats.records()[-1]["loss"])


def _norms(tree: dict, minus: dict = None) -> dict:
    with torch.no_grad():
        return {f"{op}/{k}": float((t.float() - (minus[op][k] if minus
                                                  else 0)).norm())
                for op, ws in tree.items() for k, t in ws.items()}


def setup(cell, seed: int, device: str):
    """The model after its first two dispatches, the traffic pool, and
    the program's readings of those dispatches."""
    cfg, mix = cell.config, cell.traffic
    ref = cell.reference()
    x, y = gen.train_pool(mix, ref.dims(cfg)["vocab"], seed)
    k = int(mix["steps_per_execution"])
    if len(x) < 2 * k:
        raise ValueError(f"pool_batches {len(x)} < two dispatches ({2 * k})")
    t = [time.monotonic()]
    model = cell.model_file().build_train(cfg, mix, device)
    t.append(time.monotonic())
    model.load_params(ref.make_weights(cfg, seed, device))
    t.append(time.monotonic())
    losses = [_fit(model, x[:k], y[:k], k)]
    moment = _norms(model.opt_state["m"])
    losses.append(_fit(model, x[k:2 * k], y[k:2 * k], k))
    t.append(time.monotonic())
    change = _norms(model.params, ref.make_weights(cfg, seed, device))
    parts = dict(zip(("setup_build_s", "setup_weights_s",
                      "setup_first_dispatches_s"), np.diff(t).tolist()))
    return model, (x, y), {"loss": losses, "moment": moment,
                           "change": change, "parts": parts}


def reference_readings(cell, seed: int, device: str, x, y,
                       precision: str = "f32", half_batch: bool = False):
    k = int(cell.traffic["steps_per_execution"])
    return cell.reference().train_readings(
        cell.config, x[:2 * k], y[:2 * k], k, device, seed,
        precision=precision, half_batch=half_batch)


def _device_info(device: str, chips: int) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float = None) -> Outcome:
    t_start = time.monotonic() if t_start is None else t_start
    mix = cell.traffic
    model, (x, y), prog = setup(cell, seed, device)
    k = int(mix["steps_per_execution"])
    per_call = k * int(mix["dispatches_per_call"])
    obs = Observations(cell.config, mix, cell.reference().dims(cell.config),
                       seed, seconds)
    i = 2 * k

    def call() -> None:
        nonlocal i
        idx = [(i + j) % len(x) for j in range(per_call)]
        i += per_call
        _fit(model, x[idx], y[idx], k)   # reads its losses: waits

    _sync(device)
    t0 = time.monotonic()
    obs.setup_s = t0 - t_start
    while time.monotonic() - t0 < seconds:
        call()
        obs.steps += per_call
    _sync(device)
    obs.window = (t0, time.monotonic())
    sl = Slice()
    if trace:
        sl.open()
        sl.record()
        time.sleep(PAD_S)
        sl.begin()
        call()
        _sync(device)
        sl.end()
        obs.trace_steps = per_call
        time.sleep(PAD_S)
        sl.close()
    obs.device = sl.result()
    info = _device_info(device, cell.chips)
    notes_trace = {f"profiler_{k}_s": v for k, v in sl.seconds.items()}
    del model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, device, x, y)
    numbers, notes = judge.train_numbers(prog, ref)
    problems = [f"non-finite program loss {v}" for v in prog["loss"]
                if not np.isfinite(v)]
    notes.update(numbers, **notes_trace, **prog["parts"])
    return Outcome(obs, judge.checks(numbers, cell.limits), problems,
                   attempted=obs.steps, failed=0, device=info, notes=notes)
