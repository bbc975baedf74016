"""Where the time of the port's serving path goes, on one NVIDIA GPU.

    python -m flexflow_tpu_torch.tools.serve_profile

Builds the full-width serve-bench LM that chip_smoke.py serves (hidden
1024, 16 heads, 12 layers, vocab 30522, bf16 mixed precision, random
weights from a fixed generator), then times, each under torch.profiler
with CUDA activity:
 - decode: `iters` decode iterations of the executor over 8 slots at
   ragged positions (what one ContinuousBatcher decode iteration runs);
 - prefill: `iters` 16-token chunks of one slot (one prefill chunk);
and prints one JSON line per phase: host wall per iteration, device busy
time per iteration (the sum of kernel times), the device's idle share,
and device time by kernel, largest first. Needs CUDA; exits 2 without.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict


def _kernel_table(prof, n_iters):
    from torch.autograd import DeviceType

    per = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name][0] += 1
            per[e.name][1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in per.values())
    rows = sorted(per.items(), key=lambda kv: -kv[1][1])
    return busy_us / n_iters / 1e3, [
        {"kernel": name[:90], "calls_per_iter": calls / n_iters,
         "ms_per_iter": us / n_iters / 1e3,
         "share": us / busy_us if busy_us else None}
        for name, (calls, us) in rows[:15]]


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device visible", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
    from flexflow_tpu_torch.serving.sched.kvpool import kv_cache_spec

    slots, window, max_len, chunk = 8, 512, 1024, 16
    lm = build_tiny_lm(slots, window, vocab=30522, hidden=1024, heads=16,
                       layers=12, mixed_precision=True, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    dev = lm.device
    caches = {name: {var: torch.zeros((slots, max_len, h, d), dtype=cdt,
                                      device=dev)
                     for var in ("k_cache", "v_cache")}
              for name, h, d, _, cdt in kv_cache_spec(lm)}
    one_slot = {name: {var: t[:1] for var, t in c.items()}
                for name, c in caches.items()}
    rng = np.random.RandomState(0)
    inp = lm.input_ops[0].name
    pos = torch.tensor([40, 97, 255, 300, 511, 700, 880, 1000],
                       dtype=torch.int32, device=dev)

    def decode():
        toks = torch.from_numpy(
            rng.randint(0, 30522, size=(slots, 1)).astype(np.int32)).to(dev)
        probs = lm.executor.forward_values({inp: toks}, state=caches,
                                           decode_pos=pos)
        return probs[lm.final_tensor.guid].argmax(-1).cpu()

    def prefill():
        toks = torch.from_numpy(
            rng.randint(0, 30522, size=(1, chunk)).astype(np.int32)).to(dev)
        probs = lm.executor.forward_values({inp: toks}, state=one_slot,
                                           decode_pos=480)
        return probs[lm.final_tensor.guid][0, -1].argmax().cpu()

    card = torch.cuda.get_device_name(0)
    for phase, fn in (("decode", decode), ("prefill", prefill)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()  # ends in a host copy: synchronises every iteration
            wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
        busy_ms, table = _kernel_table(prof, args.iters)
        # the same loop again without the profiler, for its overhead
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        bare_ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(json.dumps({
            "phase": phase, "device": card, "iters": args.iters,
            "wall_ms_per_iter": bare_ms,
            "wall_ms_per_iter_profiled": wall_ms,
            "device_busy_ms_per_iter": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernels": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
