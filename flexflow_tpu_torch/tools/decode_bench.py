"""Time the decode-attention kernels on one NVIDIA GPU.

    python flexflow_tpu_torch/tools/decode_bench.py [--repeat N] [--sweep]

Builds the kernel library, prints what ptxas reported for the decode
kernels (registers, stack, spills), then times both entries of the TPU
kernel `_call_decode` in bf16 at the serving path's shapes (16 heads of
64, cache M = 1024 rows):
 - `decode_attention`, B = 8 slots, C = 1, ragged positions (a decode
   iteration);
 - `multiquery_decode_attention`, B = 8, C = 16, the same positions;
 - `multiquery_decode_attention`, B = 1, C = 16 at position 480 (one
   slot's prefill chunk, what the batcher runs);
 - `multiquery_decode_attention`, B = 8, C = 4, ragged positions, the
   last slot at 1022 so two of its queries lie past the cache's last row
   (speculative decoding's verify at spec_tokens = 3);
each beside `scaled_dot_product_attention` with a bool mask on the same
inputs (the library yardstick; it reads all M rows of every slot) and the
least time the card could take (the attended cache rows read once at
3.35 TB/s). Device time from CUDA events around each call, the host's
calls queued behind a sleep kernel and L2 flushed between calls (the
serving path finds the cache cold): `repeat` rounds of 50 calls after a
warm-up, each round's mean. Also the host's microseconds to issue one
call (`repeat` rounds of 200). Prints the calls per route where the
package counts them, and one JSON line.

It also reports, for both entries at a cache that fits the TPU kernel's
one block (M = 128 <= block_k), how far the kernel's bf16 output lies
from its plain version (largest difference, share of elements not equal
to the bit): the single-block order, (p / l) rounded before p.v, is the
plain version's.

`--profile` adds each shape's device time by kernel (torch.profiler
over 20 calls), which splits a call into its launches. `--sweep` (a
checkout with `decode_plan`) times the four shapes under
other split rules (decode.SPLIT_ROWS, decode.MAX_SPLITS): how the rule in
kernels/decode.py was tuned.

It uses only the wrappers and absolute imports, so run as a file with an
older checkout's root first on PYTHONPATH it times that checkout's
kernels: the way to compare a parent with a change within one call
(parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
B, M, H, D = 8, 1024, 16, 64
POS8 = [0, 37, 255, 511, 700, 880, 1000, 1023 - 16]
# the verify's base positions: ragged, the last slot at the cache's edge
POS_VERIFY = [0, 37, 255, 511, 700, 880, 1000, 1022]
# (name, wrapper, slots, queries per slot, positions)
SHAPES = (("decode_b8_c1", "decode_attention", 8, 1, POS8),
          ("mq_b8_c16", "multiquery_decode_attention", 8, 16, POS8),
          ("mq_b1_c16", "multiquery_decode_attention", 1, 16, [480]),
          ("verify_b8_c4", "multiquery_decode_attention", 8, 4, POS_VERIFY))


def _device_ms(torch, fn, flush, n=50):
    """Mean device ms of fn() over n calls, each between its own pair of
    CUDA events with `flush` before it (outside the pair), queued while
    the device sleeps (so that the events time device work, not the
    host's launches)."""
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
            flush()
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


def _host_us(torch, fn, n=200):
    """Host microseconds to issue one call (checks, plan, allocation and
    launches, no wait for the device), mean over n calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def _by_kernel(torch, fn, flush, n=20):
    """Device us per call of each kernel fn() launches (the flush's
    kernels left out), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush()
    fn()
    torch.cuda.synchronize()
    per = {}
    # idle padding at the session's edges, where the profiler drops
    # records (tools/serve_profile.py trace_device; not imported, so an
    # older checkout first on PYTHONPATH profiles the same way)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(n):
            flush()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        time.sleep(0.05)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "elementwise" not in e.name \
                and "fill" not in e.name.lower():
            per[e.name[:80]] = per.get(e.name[:80], 0.0) + \
                e.time_range.elapsed_us() / n
    return per


# the single-block order: M <= block_k
SINGLE_M = 128
SINGLE = (("decode_b8_c1_m128", "decode_attention", 8, 1,
           [0, 5, 37, 60, 90, 100, 120, 127]),
          ("mq_b1_c16_m128", "multiquery_decode_attention", 1, 16, [40]))


def _agreement(torch, dec, g):
    """{shape: (largest |kernel - plain|, share of elements not equal)}
    in bf16 at a one-block cache, over 4 draws of the inputs."""
    out = {}
    for name, wrapper, b, c, pos in SINGLE:
        worst, differ, total = 0.0, 0, 0
        for _ in range(4):
            q, kc, vc = (torch.randn(shape, generator=g, device="cuda")
                         .to(torch.bfloat16)
                         for shape in ((b, c, H, D), (b, SINGLE_M, H, D),
                                       (b, SINGLE_M, H, D)))
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            got = getattr(dec, wrapper)(q, kc, vc, p, scale=D ** -0.5,
                                        block_k=512)
            ref = dec.decode_attention_plain(q, kc, vc, p, D ** -0.5)
            diff = (got.float() - ref.float()).abs()
            worst = max(worst, float(diff.max()))
            differ += int((got != ref).sum())
            total += got.numel()
        out[name] = {"max_abs_diff": worst, "share_unequal": differ / total}
    return out


def _cases(torch, F, dec, g):
    """{shape name: (kernel call, SDPA call, bound ms)} on fresh inputs."""
    dev = torch.device("cuda")
    scale = D ** -0.5
    out = {}
    for name, wrapper, b, c, pos in SHAPES:
        q, kc, vc = (torch.randn(shape, generator=g, device=dev)
                     .to(torch.bfloat16)
                     for shape in ((b, c, H, D), (b, M, H, D), (b, M, H, D)))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        fn = getattr(dec, wrapper)
        qpos = p.long()[:, None] + torch.arange(c, device=dev)[None, :]
        mask = (torch.arange(M, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]             # (B, 1, C, M)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
        rows = sum(min(x + c, M) for x in pos)
        nbytes = (2 * rows * H * D + 2 * q.numel()) * 2 + 4 * len(pos)

        def kernel(fn=fn, q=q, kc=kc, vc=vc, p=p):
            return fn(q, kc, vc, p, scale=scale, block_k=512)

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  scale=scale)
        out[name] = (kernel, sdpa, nbytes / HBM_BYTES_PER_S * 1e3)
    return out


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="also time other split rules")
    ap.add_argument("--profile", action="store_true",
                    help="also give device time by kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_bench: no CUDA device visible", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.kernels import _build
    from flexflow_tpu_torch.kernels import decode as dec

    _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    cases = _cases(torch, F, dec, g)
    out = {"device": torch.cuda.get_device_name(0), "package": dec.__file__,
           # empty where this process loaded a library built earlier
           "ptxas": _build.ptxas_report("decode_attention.cu"),
           "single_block_vs_plain": _agreement(torch, dec, g)}
    routes = getattr(dec, "ROUTES", None)
    for name, (kernel, sdpa, bound) in cases.items():
        if routes is not None:
            for key in routes:
                routes[key] = 0
        row = {"ms": [_device_ms(torch, kernel, flush)
                      for _ in range(args.repeat)],
               "sdpa_ms": _device_ms(torch, sdpa, flush),
               "bound_ms": bound,
               "host_us": [_host_us(torch, kernel)
                           for _ in range(args.repeat)]}
        if routes is not None:
            row["routes"] = {k: n for k, n in routes.items() if n}
        if args.profile:
            row["by_kernel_us"] = _by_kernel(torch, kernel, flush)
        out[name] = row
    if args.sweep:
        if not hasattr(dec, "decode_plan"):
            raise SystemExit("decode_bench --sweep: this checkout has no "
                             "decode_plan")
        rule = (dec.SPLIT_ROWS, dec.MAX_SPLITS)
        sweep = []
        for rows, max_splits in ((64, 4), (64, 8), (64, 16), (64, 32),
                                 (32, 32), (128, 16), (128, 8)):
            dec.SPLIT_ROWS, dec.MAX_SPLITS = rows, max_splits
            sweep.append({"split_rows_min": rows, "max_splits": max_splits,
                          **{name: min(_device_ms(torch, kernel, flush)
                                       for _ in range(3))
                             for name, (kernel, _, _) in cases.items()}})
        dec.SPLIT_ROWS, dec.MAX_SPLITS = rule
        out["sweep"] = sweep
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
