"""How often torch.profiler loses device records at the edges of a session.

    python -m flexflow_tpu_torch.tools.trace_edges [--sessions N]

A chain of 300 elementwise kernels (200 adds, 100 multiplies on 4 Mi f32
elements) runs 3 times a session, as eager walks and as replays of one
CUDA graph of the chain, in N sessions each: unpadded (the body right at
the session's start and end, as `profile()` around a loop puts it), and
through `serve_profile.trace_device` (idle padding on both sides). Each
session should see 900 kernels. Prints one JSON line: for each variant the
sessions that saw fewer, the fewest seen, and the card's name and power
limit. Exits 1 if a padded session lost a record (the padding no longer
covers the loss), else 0. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from .serve_profile import trace_device

CHAIN, REPS = 300, 3


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=150)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_edges: no CUDA device visible", file=sys.stderr)
        return 2
    x = torch.zeros(1 << 22, device="cuda")

    def chain():
        for i in range(CHAIN):
            if i % 3:
                x.add_(1.0)
            else:
                x.mul_(1.0001)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()

    def unpadded():
        torch.cuda.synchronize()
        return profile(activities=[ProfilerActivity.CUDA])

    def seen(fn, session):
        with session() as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset")))

    out = {"kernels_a_session": CHAIN * REPS, "sessions": args.sessions,
           "card": _card()}
    for name, fn, session in (
            ("walk_unpadded", chain, unpadded),
            ("replay_unpadded", graph.replay, unpadded),
            ("walk_padded", chain, lambda: trace_device(cpu=False)),
            ("replay_padded", graph.replay, lambda: trace_device(cpu=False))):
        counts = [seen(fn, session) for _ in range(args.sessions)]
        short = [n for n in counts if n < CHAIN * REPS]
        out[name] = {"sessions_short": len(short),
                     "fewest_seen": min(counts),
                     "most_seen": max(counts)}
    print(json.dumps(out))
    lost = any(out[v]["sessions_short"]
               for v in ("walk_padded", "replay_padded"))
    return 1 if lost else 0


if __name__ == "__main__":
    sys.exit(main())
