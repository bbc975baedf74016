"""Run one cell of the benchmark once, on the card of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (building the model, drawing the
weights from the seed, warming every shape the cell uses) counts as
`setup_s`; then the cell's traffic runs for `--seconds`; then the plain
reference checks what the timed path produced. The last line of standard
output is the result (`correct`, `attempted`, `failed`, `metrics`,
`device`; with `--trace 1` the per-layer metrics and `breakdown`), and
the last lines of standard error give each compared number beside its
limit. Exits non-zero, printing no result, without a card (or with fewer
than the cell asks for) and when JAX or the JAX package is loaded once
the window has closed.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
# libraries the port may use must not bring JAX in on their own
for _var in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ.setdefault(_var, "0")

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print("run.py: modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
