"""Readings that the correctness limits are set from, on the card, at a
cell's own size (one JSON line a seed; PERF.md keeps them):

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 6]

Training cells: for every seed the program's first two dispatches
against the float32 reference (the numbers a run compares); for the
control seeds also the reference computed on fp8 operands (the control)
and the reference with half of each batch left out (a planted fault),
each against the float32 reference. A state left unchanged reads 1 on
`change_gap` by its definition and needs no run.

Serving cells: for every seed a run of `--seconds` at the cell's load,
its sampled requests' widest logit gap; for the control seeds also the
widest gap of the tokens the fp8 reference puts first at the same
positions.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, judge  # noqa: E402


def _free():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def train_seed(cell, seed: int, control: bool) -> dict:
    drv = cell.runner()
    t = time.monotonic()
    model, (x, y), prog = drv.setup(cell, seed, "cuda")
    del model
    _free()
    t_prog = time.monotonic() - t
    ref = drv.reference_readings(cell, seed, "cuda", x, y)
    t_ref = time.monotonic() - t - t_prog
    out = {"seed": seed, "program": judge.train_numbers(prog, ref)[0],
           "setup_s": t_prog, "reference_s": t_ref}
    if control:
        for name, kw in (("control", {"precision": "fp8"}),
                         ("half_batch", {"half_batch": True})):
            other = drv.reference_readings(cell, seed, "cuda", x, y, **kw)
            out[name] = judge.train_numbers(other, ref)[0]
            _free()
    return out


def serve_seed(cell, seed: int, seconds: float, control: bool) -> dict:
    drv = cell.runner()
    out = drv.run(cell, seed, seconds, False, "cuda")
    _free()
    sample = drv.sample([r for r in out.obs.requests if r.finished], seed,
                        int(cell.traffic["check_requests"]))
    gap, ctrl = drv.logit_gaps(cell, seed, "cuda", sample, control=True) \
        if control else (drv.logit_gaps(cell, seed, "cuda", sample), None)
    return {"seed": seed, "program": {"logit_gap": gap},
            **({"control": {"logit_gap": ctrl}} if control else {}),
            "checked_tokens": sum(len(r.tokens) for r in sample),
            "attempted": out.attempted, "failed": out.failed,
            "problems": out.problems}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["kind"] == "train":
            line = train_seed(cell, s, s in controls)
        else:
            line = serve_seed(cell, s, args.seconds, s in controls)
        print(json.dumps(dict(workload=cell.name, **line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
