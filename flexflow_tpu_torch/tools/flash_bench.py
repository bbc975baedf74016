"""Time the flash-attention kernels on one NVIDIA GPU.

    python flexflow_tpu_torch/tools/flash_bench.py [--repeat N]

Builds the kernel library, prints what ptxas reported for the flash
kernels (registers, stack, spills; with the bf16 tensor-core kernels'
dynamic shared memory where the package reports it), then times the
forward and backward wrappers in bf16, not causal, at two shapes:
bench.py's training shape, packed (batch 8, seq 512, 16 heads of 64;
`flash_fwd`, `flash_bwd`), and a tensor-parallel rank's, blhd (batch 8,
seq 512, 8 heads of 64; `flash_fwd_heads`, `flash_bwd_heads`). Device
time from CUDA events around each call, with the host's calls queued
behind a sleep kernel so that host overhead is not counted: `repeat`
rounds of 50 calls after a warm-up, each round's mean. The backward
includes delta = sum(dO * O), computed in torch by the wrapper. Prints
the launches per route (tc: bf16 tensor cores, cc: f32 CUDA cores)
where the package counts them, so a run shows which kernels it timed,
and one JSON line.

It uses only the wrappers and absolute imports, so run as a file with an
older checkout's root first on PYTHONPATH it times that checkout's
kernels: the way to compare a parent with a change within one call
(parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import sys


def _device_ms(torch, fn, n=50):
    """Mean device ms of fn() over n calls, each between its own pair of
    CUDA events, queued while the device sleeps (so that the events time
    device work, not the host's launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(4):
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        pairs = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        ran_dry = slept.query()
        torch.cuda.synchronize()
        if not ran_dry:
            return sum(a.elapsed_time(b) for a, b in pairs) / n
        cycles *= 4
    raise RuntimeError("could not queue the timed calls ahead of the device")


def _ptxas(_build, fa):
    """The flash kernels' ptxas lines: the package's own report where it
    has one, else the raw lines of the flash source's log."""
    if hasattr(fa, "tc_kernel_report"):
        return fa.tc_kernel_report() + _build.ptxas_report(
            "flash_attention.cu")
    log = _build.BUILD_INFO.get("ptxas", {}).get("flash_attention.cu", "")
    return [line.strip() for line in log.splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]


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
    g = torch.Generator(device="cuda").manual_seed(0)
    scale = 0.125
    out = {"device": torch.cuda.get_device_name(0), "package": fa.__file__,
           "ptxas": _ptxas(_build, fa)}
    routes = getattr(fa, "ROUTES", None)
    for name, (b, l, h, d) in (("packed", (8, 512, 16, 64)),
                               ("blhd", (8, 512, 8, 64))):
        shape = (b, l, h * d) if name == "packed" else (b, l, h, d)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        if name == "packed":
            def fwd():
                return fa.flash_fwd(q, k, v, h, scale=scale)
            o, lse = fwd()

            def bwd():
                return fa.flash_bwd(q, k, v, o, lse, do, h, scale=scale)
        else:
            def fwd():
                return fa.flash_fwd_heads(q, k, v, scale=scale)
            o, lse = fwd()

            def bwd():
                return fa.flash_bwd_heads(q, k, v, o, lse, do, scale=scale)
        if routes is not None:
            for key in routes:
                routes[key] = 0
        out[name] = {
            "shape": [b, l, h, d],
            "fwd_ms": [_device_ms(torch, fwd) for _ in range(args.repeat)],
            "bwd_ms": [_device_ms(torch, bwd) for _ in range(args.repeat)]}
        if routes is not None:
            out[name]["routes"] = {k_: n for k_, n in routes.items() if n}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
