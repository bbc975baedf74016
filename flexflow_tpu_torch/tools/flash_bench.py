"""Time the packed flash-attention kernels on one NVIDIA GPU.

    python flexflow_tpu_torch/tools/flash_bench.py [--repeat N]

Builds the kernel library and prints what ptxas reported for each flash
kernel (registers, spills), then times `flash_fwd` and `flash_bwd` on
packed q, k, v at bench.py's training shape (batch 8, seq 512, 16 heads
of 64, bf16, not causal) with CUDA events: `repeat` rounds of 50
launches after a warm-up, each round's mean. One JSON line. It uses
only the packed wrappers and absolute imports, so run as a file with an
older checkout's root first on PYTHONPATH it times that checkout's
kernels, for a comparison within one machine.
"""
from __future__ import annotations

import argparse
import json
import sys


def _round_ms(torch, fn, n=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device visible", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.kernels import _build
    from flexflow_tpu_torch.kernels import flash_attention as fa

    _build.library()
    ptxas = [line.strip() for log in _build.BUILD_INFO.get(
        "ptxas", {}).values() for line in log.splitlines()
        if "flash" in line or "spill" in line or "registers" in line]
    keep, prev = [], ""
    for line in ptxas:  # each kernel's name line and the lines after it
        if "flash" in line or "flash" in prev:
            keep.append(line)
        prev = line if "Compiling" in line or "properties" in line else prev
    b, l, h, d = 8, 512, 16, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((b, l, h * d), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, h, scale=d ** -0.5)
    fwd = [_round_ms(torch, lambda: fa.flash_fwd(q, k, v, h, scale=0.125))
           for _ in range(args.repeat)]
    bwd = [_round_ms(torch, lambda: fa.flash_bwd(q, k, v, o, lse, do, h,
                                                 scale=0.125))
           for _ in range(args.repeat)]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "package": fa.__file__, "shape": [b, l, h, d],
                      "flash_fwd_ms": fwd, "flash_bwd_ms": bwd,
                      "ptxas": keep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
