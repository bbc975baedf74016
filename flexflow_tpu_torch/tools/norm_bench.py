"""Time the norm, softmax and scalar reduction kernels on one NVIDIA GPU.

    python flexflow_tpu_torch/tools/norm_bench.py [--repeat N] [--sweep]
                                                  [--profile]

Builds the kernel library, prints what ptxas reported for the softmax,
RMSNorm and LayerNorm forward kernels, the LayerNorm and RMSNorm backward
kernels (csrc/norm.cu) and the reduction kernels (csrc/reduction.cu):
registers, stack, spills. Then it times in bf16 at every shape the paths
give them:
 - `softmax_fwd` at (8, 30522) (a decode iteration's LM head), (16,
   30522) (a prefill chunk's), (128, 30522) (the kernel table's), (4096,
   2) (the training step's classifier) and (4096, 10) (the kernel-tier
   graph's dense(10));
 - `rmsnorm_fwd` at (4096, 1024) with gamma (the tier's rms_norm);
 - `layernorm_fwd` at (4096, 1024) (24 launches a training step; also
   in f32, the train-witness's), (8, 1024) (a decode iteration), (16,
   1024) (a prefill chunk) and (128, 1024) (the kernel table's), with
   gamma and beta;
 - `layernorm_bwd` at (4096, 1024) with gamma, in bf16 (24 launches a
   training step) and f32 (the train-witness's);
 - `rmsnorm_bwd` at (4096, 1024) with gamma, in bf16 (the tier's) and
   f32;
 - `reduce` over 4096 f32 elements, mean (the loss's and the accuracy's
   terms, 2 launches a step), and over 2^26 f32, sum and max;
 - `softmax_bwd` at (4096, 2) and (4096, 10) in bf16 and f32 (the
   training, tp and tier steps; "rows"), (8, 30522) and (16, 30522)
   ("cluster"), (128, 30522), (2048, 32000) (the NMT projection at
   `models/rnn.py` widths) and (4096, 1024) ("block"), y the softmax of
   x and dy random;
 - `cumsum` at (4096, 1024) f32 and bf16 ("row"), (3, 1000003) f32
   forward and reverse, (1, 2^24) f32 and (1, 1000003) bf16 ("split");
each beside one library call on the same inputs (`torch.softmax`,
`F.rms_norm` and `F.layer_norm` with weights in x's dtype,
`aten.native_layer_norm_backward` likewise, `F.rms_norm`'s backward
through autograd, `torch.sum` and `torch.amax`,
`torch._softmax_backward_data`, `torch.cumsum` (forward for the reverse
scan too: the same work)) and the least time the card could take (bytes
over 3.35 TB/s or operations over 989 (bf16) or 67 (f32) TFLOP/s, the
larger). Device time from CUDA events around each call, the host's
calls queued behind a sleep kernel, no L2 flush (the activations arrive
hot from the op before, as on the paths): `repeat` rounds of 50 calls
after a warm-up, each round's mean. Each shape also gives the largest
difference from the plain version, and the calls per route where the
package counts them. Two yardsticks of the same timing go beside them:
an empty kernel (what any call pays) and a copy (`clone`) of a
(4096, 1024) and a (128, 30522) bf16 tensor (one read and one write of
the bytes). Prints one JSON line.

`--profile` adds each shape's device time per call by kernel (from
torch.profiler, the device synchronised between calls): LayerNorm's and
RMSNorm's backward row kernel beside its column sums, the split scan's
totals beside its chunk scan.

`--sweep` (a checkout with `layernorm_fwd_plan`) times the plans'
alternatives: every cluster size at the wide softmax shapes
(norm.FILL_CTAS set to rows x size; size 1 is the "block" route), the
"rows" route against "block" at N = 256-1024 (norm.ROWS_MAX_N 1024
against 128), the RMSNorm warp route's grid (norm.RMS_BLOCKS_PER_SM),
the LayerNorm forward warp route's grid (norm.LN_FWD_BLOCKS_PER_SM) and,
at the serving shapes, its warps a CTA (the plan's one warp a row an SM
against CTAs of 2-8 warps), the LayerNorm and RMSNorm backward warp
routes' grid (norm.LN_BWD_BLOCKS_PER_SM, one kernel) and the
reduction's "cta" route against "grid" at 4096-65536 f32
elements and 65536-131072 bf16 (reduction.REDUCE_CTA_MAX_BYTES), and (a
checkout with `softmax_bwd_plan`) the softmax backward's lanes a row at
N = 10, 33, 256 and 512 (norm.SOFTMAX_BWD_LANE_VALUES), its rows
route's CTAs
an SM (norm.SOFTMAX_BWD_ROWS_BLOCKS_PER_SM), its rows route against
"block" at N = 64-1024 (norm.SOFTMAX_BWD_ROWS_MAX_N), its cluster sizes
(norm.SOFTMAX_BWD_FILL_CTAS) and the split scan's chunk size and count
(reduction.CUMSUM_CTAS_PER_SM, reduction.CUMSUM_MIN_CHUNK): how the
constants in kernels/norm.py and
kernels/reduction.py were chosen.

It uses only the wrappers and absolute imports, so run as a file with an
older checkout's root first on PYTHONPATH it times that checkout's
kernels: the way to compare a parent with a change within one call
(parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import re
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
SOFTMAX_SHAPES = ((8, 30522), (16, 30522), (128, 30522), (4096, 2),
                  (4096, 10))
NORM_SHAPES = (("rmsnorm_fwd", 4096, 1024), ("layernorm_fwd", 4096, 1024),
               ("layernorm_fwd", 8, 1024), ("layernorm_fwd", 16, 1024),
               ("layernorm_fwd", 128, 1024))
LN_SERVE_ROWS = (8, 16, 128)
SWEEP_WIDE = ((8, 30522), (16, 30522), (64, 30522), (128, 30522))
SWEEP_NARROW = ((4096, 256), (4096, 512), (4096, 1000), (4096, 1024),
                (128, 1024))
SOFTMAX_BWD_SHAPES = (((4096, 2), "bfloat16"), ((4096, 2), "float32"),
                      ((4096, 10), "bfloat16"), ((4096, 10), "float32"),
                      ((8, 30522), "bfloat16"), ((16, 30522), "bfloat16"),
                      ((128, 30522), "bfloat16"),
                      ((2048, 32000), "bfloat16"),
                      ((4096, 1024), "bfloat16"))
CUMSUM_SHAPES = (((4096, 1024), "float32", False),
                 ((4096, 1024), "bfloat16", False),
                 ((3, 1000003), "float32", False),
                 ((3, 1000003), "float32", True),
                 ((1, 2 ** 24), "float32", False),
                 ((1, 1000003), "bfloat16", False))


def _bound_ms(nbytes, ops, ops_per_s=BF16_OPS_PER_S):
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s) * 1e3


def _cases(torch, F, norm, reduction, g):
    """{name: (kernel call, library call, bound ms, max |kernel - plain|)}
    on fresh bf16 inputs."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    out = {}
    for rows, n in SOFTMAX_SHAPES:
        x = (torch.randn((rows, n), generator=g, device=dev) * 4).to(bf16)
        err = (norm.softmax_fwd(x).float()
               - norm.softmax_fwd_plain(x).float()).abs().max()
        out[f"softmax_fwd {rows}x{n}"] = (
            lambda x=x: norm.softmax_fwd(x),
            lambda x=x: torch.softmax(x, dim=-1),
            _bound_ms(2 * x.numel() * 2, 5 * x.numel()), float(err))
    for name, rows, n in NORM_SHAPES:
        x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(
            bf16)
        gamma = torch.rand((n,), generator=g, device=dev) + 0.5
        g16 = gamma.to(bf16)
        if name == "rmsnorm_fwd":
            y = norm.rmsnorm_fwd(x, gamma)[0]
            ref = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)[0]
            kernel = lambda x=x, gamma=gamma: norm.rmsnorm_fwd(  # noqa: E731
                x, gamma)
            lib = lambda x=x, g16=g16, n=n: F.rms_norm(  # noqa: E731
                x, (n,), g16, 1e-6)
            bound = _bound_ms(2 * x.numel() * 2 + n * 4 + rows * 4,
                              4 * x.numel())
        else:
            beta = torch.randn((n,), generator=g, device=dev)
            b16 = beta.to(bf16)
            y = norm.layernorm_fwd(x, gamma, beta)[0]
            ref = norm.layernorm_fwd_plain(x, gamma, beta, 1e-5)[0]
            kernel = lambda x=x, gamma=gamma, beta=beta: (  # noqa: E731
                norm.layernorm_fwd(x, gamma, beta))
            lib = lambda x=x, g16=g16, b16=b16, n=n: F.layer_norm(  # noqa
                x, (n,), g16, b16, 1e-5)
            bound = _bound_ms(2 * x.numel() * 2 + 2 * n * 4 + 2 * rows * 4,
                              8 * x.numel())
        err = (y.float() - ref.float()).abs().max()
        out[f"{name} {rows}x{n}"] = (kernel, lib, bound, float(err))
    rows, n = 4096, 1024
    x = torch.randn((rows, n), generator=g, device=dev) * 2 + 1
    gamma = torch.rand((n,), generator=g, device=dev) + 0.5
    beta = torch.randn((n,), generator=g, device=dev)
    err = max(float((a - b).abs().max()) for a, b in zip(
        norm.layernorm_fwd(x, gamma, beta),
        norm.layernorm_fwd_plain(x, gamma, beta, 1e-5)))
    out[f"layernorm_fwd {rows}x{n} float32"] = (
        lambda x=x, gamma=gamma, beta=beta: norm.layernorm_fwd(x, gamma,
                                                               beta),
        lambda x=x, gamma=gamma, beta=beta, n=n: F.layer_norm(
            x, (n,), gamma, beta, 1e-5),
        _bound_ms(2 * x.numel() * 4 + 2 * n * 4 + 2 * rows * 4,
                  8 * x.numel(), F32_OPS_PER_S), err)
    for dtype in (bf16, torch.float32):
        x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(
            dtype)
        dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
        gamma = torch.rand((n,), generator=g, device=dev) + 0.5
        beta = torch.randn((n,), generator=g, device=dev)
        _, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
        got = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        ref = norm.layernorm_bwd_plain(x, gamma, mean, rstd, dy)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        wx, bx = gamma.to(dtype), beta.to(dtype)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [n], wx, bx,
                                                           1e-5)
        esz = x.element_size()
        out[f"layernorm_bwd {rows}x{n} {str(dtype)[6:]}"] = (
            lambda x=x, gamma=gamma, mean=mean, rstd=rstd, dy=dy: (
                norm.layernorm_bwd(x, gamma, mean, rstd, dy)),
            lambda x=x, dy=dy, lm=lmean, lr=lrstd, wx=wx, bx=bx, n=n: (
                torch.ops.aten.native_layer_norm_backward(
                    dy, x, [n], lm, lr, wx, bx, [True, True, True])),
            _bound_ms(3 * rows * n * esz + 2 * rows * 4 + 3 * n * 4,
                      10 * rows * n,
                      BF16_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S),
            err)
        # RMSNorm backward on the same x and dy
        _, rrstd = norm.rmsnorm_fwd(x, gamma)
        got = norm.rmsnorm_bwd(x, gamma, rrstd, dy)
        ref = norm.rmsnorm_bwd_plain(x, gamma, rrstd, dy)
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, ref))
        xg = x.detach().requires_grad_()
        wg = gamma.to(dtype).detach().requires_grad_()
        lib_out = F.rms_norm(xg, (n,), wg, 1e-6)
        out[f"rmsnorm_bwd {rows}x{n} {str(dtype)[6:]}"] = (
            lambda x=x, gamma=gamma, rstd=rrstd, dy=dy: (
                norm.rmsnorm_bwd(x, gamma, rstd, dy)),
            lambda o=lib_out, xg=xg, wg=wg, dy=dy: torch.autograd.grad(
                o, (xg, wg), dy, retain_graph=True),
            _bound_ms(3 * rows * n * esz + rows * 4 + 2 * n * 4,
                      8 * rows * n,
                      BF16_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S),
            err)
    for (rows, n), dname in SOFTMAX_BWD_SHAPES:
        dtype = getattr(torch, dname)
        y = norm.softmax_fwd((torch.randn((rows, n), generator=g, device=dev)
                              * 3).to(dtype))
        dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
        err = (norm.softmax_bwd(y, dy).float()
               - norm.softmax_bwd_plain(y, dy).float()).abs().max()
        out[f"softmax_bwd {rows}x{n} {dname}"] = (
            lambda y=y, dy=dy: norm.softmax_bwd(y, dy),
            lambda y=y, dy=dy: torch._softmax_backward_data(dy, y, -1,
                                                            y.dtype),
            _bound_ms(3 * y.numel() * y.element_size(), 4 * y.numel(),
                      BF16_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S),
            float(err))
    for (rows, n), dname, reverse in CUMSUM_SHAPES:
        x = torch.randn((rows, n), generator=g, device=dev).to(
            getattr(torch, dname))
        err = (reduction.cumsum(x, reverse=reverse).float()
               - reduction.cumsum_plain(x, reverse=reverse).float()
               ).abs().max()
        out[f"cumsum {rows}x{n} {dname}{' reverse' if reverse else ''}"] = (
            lambda x=x, reverse=reverse: reduction.cumsum(x, reverse=reverse),
            lambda x=x: torch.cumsum(x, -1),
            _bound_ms(2 * x.numel() * x.element_size(), x.numel(),
                      F32_OPS_PER_S), float(err))
    for n, kinds in ((4096, ("mean",)), (2 ** 26, ("sum", "max"))):
        x = torch.randn((n,), generator=g, device=dev)
        for kind in kinds:
            err = abs(float(reduction.reduce(x, kind))
                      - float(reduction.reduce_plain(x, kind)))
            lib = torch.amax if kind == "max" else torch.sum
            out[f"reduce {n} float32 {kind}"] = (
                lambda x=x, kind=kind: reduction.reduce(x, kind),
                lambda x=x, lib=lib: lib(x),
                _bound_ms(n * 4 + 4, n, F32_OPS_PER_S), err)
    return out


def _sweep(torch, norm, reduction, g, device_ms):
    """Device ms under other plan constants, each restored afterwards."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    keep = (norm.FILL_CTAS, norm.ROWS_MAX_N, norm.RMS_BLOCKS_PER_SM)
    out = {"cluster": {}, "rows_vs_block": {}, "rms_blocks_per_sm": {},
           "ln_bwd_blocks_per_sm": {}, "rms_bwd_blocks_per_sm": {},
           "ln_fwd_blocks_per_sm": {}, "ln_fwd_serving_warps": {},
           "reduce_cta_vs_grid": {}}
    try:
        for rows, n in SWEEP_WIDE:
            x = (torch.randn((rows, n), generator=g, device=dev) * 4).to(
                bf16)
            for c in (1, 2, 4, 8):
                norm.FILL_CTAS = rows * c
                plan = norm.softmax_plan(rows, n, bf16)
                out["cluster"][f"{rows}x{n} c={plan.cluster} "
                               f"threads={plan.threads}"] = min(
                    device_ms(lambda: norm.softmax_fwd(x)) for _ in range(3))
        norm.FILL_CTAS = keep[0]
        for rows, n in SWEEP_NARROW:
            x = (torch.randn((rows, n), generator=g, device=dev) * 4).to(
                bf16)
            for limit in (1024, 128):
                norm.ROWS_MAX_N = limit
                route = norm.softmax_plan(rows, n, bf16).route
                out["rows_vs_block"][f"{rows}x{n} {route}"] = min(
                    device_ms(lambda: norm.softmax_fwd(x)) for _ in range(3))
        norm.ROWS_MAX_N = keep[1]
        x = (torch.randn((4096, 1024), generator=g, device=dev) * 2 + 1).to(
            bf16)
        gamma = torch.rand((1024,), generator=g, device=dev) + 0.5
        for per_sm in (1, 2, 3, 4, 8):
            norm.RMS_BLOCKS_PER_SM = per_sm
            out["rms_blocks_per_sm"][str(per_sm)] = min(
                device_ms(lambda: norm.rmsnorm_fwd(x, gamma))
                for _ in range(3))
    finally:
        norm.FILL_CTAS, norm.ROWS_MAX_N, norm.RMS_BLOCKS_PER_SM = keep
    keep = (norm.LN_BWD_BLOCKS_PER_SM, reduction.REDUCE_CTA_MAX_BYTES,
            norm.LN_FWD_BLOCKS_PER_SM, norm.layernorm_fwd_plan)
    try:
        dy = torch.randn((4096, 1024), generator=g, device=dev).to(bf16)
        beta = torch.randn((1024,), generator=g, device=dev)
        _, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
        _, rrstd = norm.rmsnorm_fwd(x, gamma)
        for per_sm in (1, 2, 3, 4):
            # the grid of both backward warp routes (one kernel)
            norm.LN_BWD_BLOCKS_PER_SM = per_sm
            norm.LN_FWD_BLOCKS_PER_SM = per_sm
            out["ln_bwd_blocks_per_sm"][str(per_sm)] = min(
                device_ms(lambda: norm.layernorm_bwd(x, gamma, mean, rstd,
                                                     dy))
                for _ in range(3))
            out["rms_bwd_blocks_per_sm"][str(per_sm)] = min(
                device_ms(lambda: norm.rmsnorm_bwd(x, gamma, rrstd, dy))
                for _ in range(3))
            out["ln_fwd_blocks_per_sm"][str(per_sm)] = min(
                device_ms(lambda: norm.layernorm_fwd(x, gamma, beta))
                for _ in range(3))
        norm.LN_FWD_BLOCKS_PER_SM = keep[2]
        # the serving shapes: the plan's CTAs against CTAs of more warps
        # (a plan with `warps` warps a CTA in place of ceil(rows / SMs))
        plan_of = keep[3]
        for rows in LN_SERVE_ROWS:
            xs = x[:rows]
            for warps in (0, 2, 4, 8):
                def forced(r, n, dtype, sms=norm.H100_SMS, warps=warps):
                    plan = plan_of(r, n, dtype, sms)
                    if not warps or plan.route != "warp":
                        return plan
                    return plan._replace(threads=32 * warps,
                                         blocks=-(-r // warps))
                norm.layernorm_fwd_plan = forced
                key = f"{rows}x1024 warps={warps or 'plan'}"
                out["ln_fwd_serving_warps"][key] = min(
                    device_ms(lambda: norm.layernorm_fwd(xs, gamma, beta))
                    for _ in range(3))
            norm.layernorm_fwd_plan = plan_of
        for dtype, ns in ((torch.float32, (4096, 8192, 16384, 32768, 65536)),
                          (bf16, (65536, 131072))):
            for n in ns:
                v = torch.randn((n,), generator=g, device=dev).to(dtype)
                for limit in (0, 1 << 20):
                    reduction.REDUCE_CTA_MAX_BYTES = limit
                    plan = reduction.reduce_plan(n, dtype)
                    key = (f"{n} {str(dtype)[6:]} {plan.route} "
                           f"threads={plan.threads} vecs={plan.vecs}")
                    out["reduce_cta_vs_grid"][key] = min(
                        device_ms(lambda: reduction.reduce(v, "sum"))
                        for _ in range(3))
    finally:
        (norm.LN_BWD_BLOCKS_PER_SM, reduction.REDUCE_CTA_MAX_BYTES,
         norm.LN_FWD_BLOCKS_PER_SM, norm.layernorm_fwd_plan) = keep
    if hasattr(norm, "softmax_bwd_plan"):
        out.update(_sweep_bwd_scan(torch, norm, reduction, g, device_ms))
    return out


def _sweep_bwd_scan(torch, norm, reduction, g, device_ms):
    """The softmax backward's and the scan's constants, each restored."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    out = {"softmax_bwd_lanes": {}, "softmax_bwd_rows_blocks_per_sm": {},
           "softmax_bwd_rows_vs_block": {}, "softmax_bwd_cluster": {},
           "cumsum_chunks": {}}
    keep = (norm.SOFTMAX_BWD_LANE_VALUES, norm.SOFTMAX_BWD_ROWS_BLOCKS_PER_SM,
            norm.SOFTMAX_BWD_ROWS_MAX_N, norm.SOFTMAX_BWD_FILL_CTAS,
            reduction.CUMSUM_CTAS_PER_SM, reduction.CUMSUM_MIN_CHUNK)

    def pair(rows, n, dtype=bf16):
        y = norm.softmax_fwd((torch.randn((rows, n), generator=g,
                                          device=dev) * 3).to(dtype))
        return y, torch.randn((rows, n), generator=g, device=dev).to(dtype)

    def best(fn):
        return min(device_ms(fn) for _ in range(3))

    try:
        for n in (10, 33, 256, 512):
            y, dy = pair(4096, n)
            for values in (1, 2, 4, 8, 16):
                norm.SOFTMAX_BWD_LANE_VALUES = values
                plan = norm.softmax_bwd_plan(4096, n, bf16)
                key = f"4096x{n} lanes={plan.lanes} k={plan.per_thread}"
                if key not in out["softmax_bwd_lanes"]:
                    out["softmax_bwd_lanes"][key] = best(
                        lambda: norm.softmax_bwd(y, dy))
        norm.SOFTMAX_BWD_LANE_VALUES = keep[0]
        for n in (2, 10):
            y, dy = pair(4096, n)
            for per_sm in (1, 2, 4, 8, 16):
                norm.SOFTMAX_BWD_ROWS_BLOCKS_PER_SM = per_sm
                out["softmax_bwd_rows_blocks_per_sm"][
                    f"4096x{n} {per_sm}"] = best(
                        lambda: norm.softmax_bwd(y, dy))
        norm.SOFTMAX_BWD_ROWS_BLOCKS_PER_SM = keep[1]
        for n in (64, 128, 256, 512, 1024):
            y, dy = pair(4096, n)
            for limit in (1024, 0):
                norm.SOFTMAX_BWD_ROWS_MAX_N = limit
                route = norm.softmax_bwd_plan(4096, n, bf16).route
                out["softmax_bwd_rows_vs_block"][f"4096x{n} {route}"] = best(
                    lambda: norm.softmax_bwd(y, dy))
        norm.SOFTMAX_BWD_ROWS_MAX_N = keep[2]
        for rows, n in SWEEP_WIDE + ((2048, 32000),):
            y, dy = pair(rows, n)
            for c in (1, 2, 4, 8):
                norm.SOFTMAX_BWD_FILL_CTAS = rows * c
                plan = norm.softmax_bwd_plan(rows, n, bf16)
                out["softmax_bwd_cluster"][
                    f"{rows}x{n} c={plan.cluster} threads={plan.threads} "
                    f"vecs={plan.per_thread}"] = best(
                        lambda: norm.softmax_bwd(y, dy))
        norm.SOFTMAX_BWD_FILL_CTAS = keep[3]
        for (rows, n), dtype in (((3, 1000003), torch.float32),
                                 ((1, 2 ** 24), torch.float32),
                                 ((1, 1000003), bf16)):
            x = torch.randn((rows, n), generator=g, device=dev).to(dtype)
            for per_sm in (2, 4, 8, 16):
                for least in (1024, 2048, 4096):
                    reduction.CUMSUM_CTAS_PER_SM = per_sm
                    reduction.CUMSUM_MIN_CHUNK = least
                    plan = reduction.cumsum_plan(rows, n, dtype)
                    key = (f"{rows}x{n} {str(dtype)[6:]} chunk={plan.chunk} "
                           f"chunks={plan.chunks}")
                    if key not in out["cumsum_chunks"]:
                        out["cumsum_chunks"][key] = best(
                            lambda: reduction.cumsum(x))
    finally:
        (norm.SOFTMAX_BWD_LANE_VALUES, norm.SOFTMAX_BWD_ROWS_BLOCKS_PER_SM,
         norm.SOFTMAX_BWD_ROWS_MAX_N, norm.SOFTMAX_BWD_FILL_CTAS,
         reduction.CUMSUM_CTAS_PER_SM, reduction.CUMSUM_MIN_CHUNK) = keep
    return out


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="also time other plan constants")
    ap.add_argument("--profile", action="store_true",
                    help="also give device time by kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_bench: no CUDA device visible", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.kernels import _build, norm, reduction
    from flexflow_tpu_torch.tools.decode_bench import _by_kernel, _device_ms

    def device_ms(fn):
        return _device_ms(torch, fn, lambda: None)

    _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "package": norm.__file__,
           # empty where this process loaded a library built earlier
           "ptxas": [r for src in ("norm.cu", "reduction.cu")
                     for r in _build.ptxas_report(src)
                     if re.search(r"softmax_(?!bwd_rows)|rmsnorm_|"
                                  r"layernorm_|column_sums|reduce_|cumsum_|"
                                  r"softmax_bwd_rows_kernel<.*, (2|16|32), "
                                  r"1>", str(r["kernel"]))]}
    # yardsticks of this timing: an empty kernel (the floor any call pays)
    # and a copy of the (4096, 1024) and (128, 30522) bf16 inputs, one read
    # and one write of the bytes, as a norm or softmax moves them
    out["empty_kernel_ms"] = [device_ms(lambda: torch.cuda._sleep(0))
                              for _ in range(2)]
    for rows, n in ((4096, 1024), (128, 30522)):
        x = torch.randn((rows, n), device="cuda").to(torch.bfloat16)
        out[f"copy_ms {rows}x{n}"] = [device_ms(x.clone) for _ in range(2)]
    routes = [r for r in (getattr(norm, "ROUTES", None),
                          getattr(reduction, "ROUTES", None)) if r is not None]
    for name, (kernel, lib, bound, err) in _cases(torch, F, norm, reduction,
                                                   g).items():
        for counts in routes:
            for key in counts:
                counts[key] = 0
        kernel()
        row = {"ms": [device_ms(kernel) for _ in range(args.repeat)],
               "library_ms": [device_ms(lib) for _ in range(2)],
               "bound_ms": bound, "max_abs_err_vs_plain": err}
        if routes:
            row["routes"] = {k: n for counts in routes
                             for k, n in counts.items() if n}
        if args.profile:
            row["by_kernel_us"] = _by_kernel(torch, kernel, lambda: None)
        out[name] = row
    if args.sweep:
        if not hasattr(norm, "layernorm_fwd_plan"):
            raise SystemExit("norm_bench --sweep: this checkout has no "
                             "layernorm_fwd_plan")
        out["sweep"] = _sweep(torch, norm, reduction, g, device_ms)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
