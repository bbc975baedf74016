"""The knee of an open-loop traffic mix: the highest offered rate at
which the backlog does not grow over the window, found once, on the card
(PERF.md keeps the sweep; a cell's traffic file keeps a rate below it):

    python3 benchmark/sweep.py --config gpt2-medium \
        --traffic chat-poisson --rates 10,20,30,40 --seconds 15 --seed 1

The mix need not be a cell of BENCHMARK.json yet. One model and batcher
serve every rate in turn, each after the last one's requests finished.
A line a rate: requests, refusals, tokens/s, TTFT and ITL percentiles,
and `backlog_slope`, the least-squares slope of the requests outstanding
(sent, not yet finished) over the second half of the window, in requests
a second.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark import traffic as gen  # noqa: E402
from benchmark.stats import percentile  # noqa: E402


def _slope(records, t0: float, seconds: float) -> float:
    ts = np.linspace(t0 + seconds / 2, t0 + seconds, 41)
    out = [sum(1 for r in records if r.due <= t and not (
        r.token_times and r.token_times[-1] <= t) and r.error is None)
        for t in ts]
    return float(np.polyfit(ts - t0, out, 1)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    name = f"{args.config}.{args.traffic}"
    spec = harness.read_json(harness.ROOT / "BENCHMARK.json")
    if all(w["name"] != name for w in spec["workloads"]):
        spec["workloads"].append({"name": name, "config": args.config,
                                  "traffic": args.traffic, "chips": 1,
                                  "why": "sweep"})
    cell = harness.load_cell(name, spec)
    drv = cell.runner()
    dims = cell.reference().dims(cell.config)
    model, batcher, _ = drv.build(cell, args.seed, "cuda")
    try:
        drv.warm(batcher, dims["vocab"])
        for rate in (float(r) for r in args.rates.split(",")):
            mix = dict(cell.traffic, arrivals={"process": "poisson",
                                               "rate": rate})
            reqs = gen.open_loop(mix, dims["vocab"], args.seed, args.seconds)
            t0 = time.monotonic()
            records, handles = [], []
            extra = drv._open_loop(
                batcher, reqs, t0,
                lambda: time.monotonic() - t0 >= args.seconds,
                records, handles)
            for rec, h in handles:
                h.result(timeout=300.0)
                drv._fill(rec, h)
            done = [r for r in records if r.finished]
            ttft = [r.first - r.due for r in done]
            itl = [b - a for r in done
                   for a, b in zip(r.token_times, r.token_times[1:])]
            toks = sum(1 for r in records for t in r.token_times
                       if t < t0 + args.seconds)
            print(json.dumps({
                "rate": rate, "requests": len(records),
                "refused": sum(1 for r in records if r.rid < 0),
                "tokens_per_s": toks / args.seconds,
                "ttft_p50_ms": 1e3 * percentile(ttft, 50),
                "ttft_p95_ms": 1e3 * percentile(ttft, 95),
                "itl_p95_ms": 1e3 * percentile(itl, 95),
                "backlog_slope": _slope(records, t0, args.seconds),
                "drain_s": time.monotonic() - t0 - args.seconds,
                **extra}), flush=True)
    finally:
        batcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
