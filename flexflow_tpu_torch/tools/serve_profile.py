"""Where the time of the port's serving path goes, on one NVIDIA GPU.

    python -m flexflow_tpu_torch.tools.serve_profile [--iters N] [--moe]

Builds the full-width serve-bench LM that chip_smoke.py serves (hidden
1024, 16 heads, 12 layers, vocab 30522, bf16 mixed precision, random
weights from a fixed generator) and the default ContinuousBatcher(
num_slots=8, max_len=1024, page_size=16) over it, then, each under
torch.profiler with CUDA activity:
 - decode: `iters` decode iterations of 8 slots at ragged positions, as
   the batcher dispatches them (a replay of its decode graph), each
   ending in the tokens' read back;
 - prefill: `iters` 16-token chunks of one slot at offset 480, the same
   way (a replay of the slot's chunk graph), each ending in the chunk's
   last-row argmax read back;
 - spec_tied, spec_untied: `iters` speculative iterations (spec_tokens
   3: three draft steps and the C = 4 verify, one graph replay) at the
   decode line's positions, as a ContinuousBatcher(draft_model=...)
   dispatches them, each ending in its picks and counts read back; the
   tied draft is the LM itself (its architecture and weights), the
   untied one the same widths cut to 2 layers from its own generator;
and prints one JSON line per phase: host wall per dispatch (also without
the profiler), device busy time per dispatch (the sum of kernel times),
the device's idle share (1 - busy / the profiled wall, as the tool has
always printed it; also against the unprofiled wall), device operations
(kernels and copies) per dispatch seen by the profiler, graph replays and
captures, and device time by kernel, largest first. chip_smoke.py's serve
line gives the serve mix's tokens/s and TTFT. `--moe` profiles the
decode and prefill dispatches of the MoE serve-bench LM at the same
widths instead (serving/sched/bench.py build_tiny_moe_lm: 4 experts,
top-2, no drops; chip_smoke.py phase 26). Needs CUDA; exits 2 without.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import defaultdict


def _device_ops(prof) -> int:
    """Device operations (kernels and copies) the profiler saw."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


# torch.profiler (CUPTI) drops some device records of a session whose
# body starts or ends right at its edges: eager walks and CUDA graph
# replays alike lose from one record to several hundred in a few percent
# of sessions (tools/trace_edges.py measures how often, with and without
# this padding)
TRACE_PAD_S = 0.05


@contextlib.contextmanager
def trace_device(cpu=True):
    """torch.profiler over the body, with the device idle and TRACE_PAD_S
    of host time on each side of it, so that no device record of the body
    falls at the session's edges (where the profiler drops records).
    Time the body inside it: the padding is outside what it measures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


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

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--moe", action="store_true",
                    help="the MoE LM (4 experts, top-2): decode, prefill")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device visible", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import (build_tiny_lm,
                                                        build_tiny_moe_lm)

    slots, window, max_len, chunk, vocab = 8, 512, 1024, 16, 30522
    builder = build_tiny_moe_lm if args.moe else build_tiny_lm
    lm = builder(slots, window, vocab=vocab, hidden=1024, heads=16,
                 layers=12, mixed_precision=True, device="cuda",
                 generator=torch.Generator().manual_seed(0))
    cb = ContinuousBatcher(lm, max_len=max_len, num_slots=slots,
                           page_size=chunk)
    drafts = {}

    def spec_batcher(which):
        if which not in drafts:
            draft = lm if which == "tied" else build_tiny_lm(
                slots, window, vocab=vocab, hidden=1024, heads=16, layers=2,
                mixed_precision=True, device="cuda",
                generator=torch.Generator().manual_seed(1))
            drafts[which] = ContinuousBatcher(
                lm, max_len=max_len, num_slots=slots, page_size=chunk,
                draft_model=draft, spec_tokens=3)
        return drafts[which]

    rng = np.random.RandomState(0)
    pos = np.array([40, 97, 255, 300, 511, 700, 880, 1000], np.int32)

    def decode():
        toks = rng.randint(0, vocab, size=slots).astype(np.int32)
        return cb._decode_dispatch(np.concatenate(
            [toks, pos, np.zeros(slots, np.int32)]))

    def prefill():
        toks = rng.randint(0, vocab, size=chunk).astype(np.int32)
        cb._chunk_dispatch(0, np.append(toks, np.int32(480)))
        return cb._chunk_probs[0, -1].argmax().cpu()

    def spec(which):
        def run():
            toks = rng.randint(0, vocab, size=slots).astype(np.int32)
            return spec_batcher(which)._spec_dispatch(
                np.concatenate([toks, pos]))
        return run

    card = torch.cuda.get_device_name(0)
    phases = [("decode", decode), ("prefill", prefill)]
    if not args.moe:
        phases += [("spec_tied", spec("tied")), ("spec_untied",
                                                 spec("untied"))]
    with torch.no_grad():
        for phase, fn in phases:
            graphs = (spec_batcher(phase[5:]) if phase.startswith("spec")
                      else cb).graphs
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            before = dict(graphs)
            with trace_device() as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    fn()  # ends in a host copy: synchronises every dispatch
                wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
            busy_ms, table = _kernel_table(prof, args.iters)
            ops = _device_ops(prof) / args.iters
            during = {k: v - before[k] for k, v in graphs.items()}
            # the same loop again without the profiler, for its overhead
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()
            bare_ms = (time.perf_counter() - t0) / args.iters * 1e3
            print(json.dumps({
                "phase": phase, "model": "moe" if args.moe else "dense",
                "device": card, "iters": args.iters,
                "wall_ms_per_iter": bare_ms,
                "wall_ms_per_iter_profiled": wall_ms,
                "device_busy_ms_per_iter": busy_ms,
                "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
                else None,
                "device_idle_share_unprofiled": (1 - busy_ms / bare_ms)
                if busy_ms else None,
                "device_ops_per_iter": ops,
                "graphs_during_profile": during,
                "kernels": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
