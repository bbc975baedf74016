"""How closely the bf16 flash backward agrees with its plain version on one
NVIDIA GPU, over many seeded causal inputs at the training shapes.

    python flexflow_tpu_torch/tools/flash_agreement.py [--seeds N]

For each seed, q, k, v and the cotangent are N(0, 1) in bf16 at the
packed training shape (8, 512, 16 heads of 64) and at the tensor-parallel
rank's blhd shape (8, 512, 8, 64), causal; the forward and backward run
through the wrappers on the card and the plain versions run on the same
inputs (delta computed as the card checks compute it). The error of each
gradient is taken as a ratio to the bf16 gradient tolerance of
chip_smoke.py and tests/test_torch_cuda.py, 1e-3 + 1e-2 |plain|: a ratio
above 1 fails that check. Prints one JSON line: per shape, the seeds
whose worst ratio exceeds 1 and the largest ratios. Like flash_bench.py
it uses only the wrappers and absolute imports, so an older checkout's
root first on PYTHONPATH measures that checkout's kernels.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_agreement: no CUDA device visible", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": torch.cuda.get_device_name(0), "package": fa.__file__,
           "seeds": args.seeds,
           "tolerance": "|card - plain| <= 1e-3 + 1e-2 |plain|"}
    ratios = {"packed": [], "blhd": []}
    for seed in range(args.seeds):
        g = torch.Generator(device="cuda").manual_seed(1000 + seed)
        for layout, (b, l, h, d) in (("packed", (8, 512, 16, 64)),
                                     ("blhd", (8, 512, 8, 64))):
            q, k, v, do = (torch.randn((b, l, h, d), generator=g,
                                       device="cuda").bfloat16()
                           for _ in range(4))
            scale = d ** -0.5
            if layout == "packed":
                q, k, v, do = (t.reshape(b, l, h * d) for t in (q, k, v, do))
                o, lse = fa.flash_fwd(q, k, v, h, scale=scale, causal=True)
                grads = fa.flash_bwd(q, k, v, o, lse, do, h, scale=scale,
                                     causal=True)
                delta = (do.float() * o.float()).reshape(b, l, h, d).sum(-1)
                ref = fa.flash_bwd_plain(q, k, v, do, lse, delta, h, scale,
                                         True)
            else:
                o, lse = fa.flash_fwd_heads(q, k, v, scale=scale,
                                            causal=True)
                grads = fa.flash_bwd_heads(q, k, v, o, lse, do, scale=scale,
                                           causal=True)
                delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
                ref = fa.flash_bwd_heads_plain(q, k, v, do, lse, delta,
                                               scale, True, "blhd")
            worst = max(float(((a.float() - r.float()).abs()
                               / (1e-3 + 1e-2 * r.float().abs())).max())
                        for a, r in zip(grads, ref))
            ratios[layout].append(worst)
    for layout, rs in ratios.items():
        out[layout] = {"failing_seeds": sum(r > 1 for r in rs),
                       "max_ratio": max(rs),
                       "largest_ratios": sorted(rs)[-5:]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
