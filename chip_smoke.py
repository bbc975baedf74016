#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and exits non-zero:
 1. device  — require CUDA, print the card's name and power limit, set
              and print the TF32 flags;
 2. build   — compile the port's CUDA kernels from csrc/ and time it;
 3. kernels — hold every kernel of the serving, training and kernel-tier
              paths against its plain PyTorch version on the card, in f32
              and bf16, at the shapes its path gives it (and for softmax
              and RMSNorm forward every route of their plans at N in {1,
              2, 10, 33, 300, 1000, 1024, 30522, 70000} x R in {1, 8, 16,
              128, 4095}; for LayerNorm forward every route at N in {1,
              2, 33, 300, 1000, 1024, 2048, 2049, 58080}, for LayerNorm
              backward at N in {1, 2, 33, 300, 1000, 1024, 2048, 2049,
              14520, 14528} and for RMSNorm backward at N in {1, 2, 33,
              300, 1000, 1024, 2048, 2049, 14528}, each x R in {1, 7, 8,
              9, 4095}, with and without the affine weights, the warp
              routes at the path shape (4096, 1024) equal to the bit to
              their CPU emulations; for the reduction both routes at n in
              {0, 1,
              4096, 4097, 1000003, 2^26}, aligned and one element off,
              and at the route threshold; for the softmax backward every
              route at N in {1, 2, 10, 33, 512, 513, 1000, 1024, 30522,
              70000} x R in {1, 8, 16, 128, 4095} and N = 300000, for the
              scan both routes, forward and reverse, at 12 (rows, N) from
              (1, 1) to (1, 2^24), each equal to the bit to its route's
              emulation; two calls giving the same
              bits), and time kernel, plain version and one library call
              beside the least time the card could take (softmax at every
              path's shape, LayerNorm also at the training shape, the
              softmax backward and the scan at the kernel table's shapes
              of every route; the fused optimizer update at the flagship's
              195 weight shapes, Adam with bf16 and f32 moments, with and
              without weight decay, SGD plain, with momentum and nesterov,
              three updates each equal to the bit to the per-tensor loop,
              and on a ragged list of unaligned views); print
              ptxas's registers, spills and shared memory of the bf16
              tensor-core flash kernels, of the softmax, RMSNorm and
              LayerNorm forward kernels, the LayerNorm and RMSNorm
              backward kernels, the softmax backward and the reduction and
              scan kernels, and the decode, flash, softmax, RMSNorm,
              LayerNorm, reduce and cumsum calls per route (tc: bf16
              tensor cores, cc: CUDA cores; rows, block, cluster, loop;
              warp, block; cta, grid; row, split) with each decode row's
              plan (route, splits; a split call is a kernel and a combine
              launch);
 4. serve   — the full-width serve-bench LM (hidden 1024, 16 heads,
              12 layers, vocab 30522, window 512; random weights from a
              fixed generator, bf16 mixed precision) through
              ContinuousBatcher(num_slots=8, max_len=1024, page_size=16):
              16 requests, prompts of 32-512 tokens, 32-64 new tokens
              each; every request must finish with exactly its token
              count, every serving kernel must have launched, every
              decode and multi-query call must have taken the tc route,
              every softmax (the LM head over 30522) the cluster route,
              and every LayerNorm forward the warp route;
 5. cross   — the first token's probabilities for two prompts on the card
              against the port on the CPU (plain versions), same weights;
 6. train   — bench.py's flagship BERT encoder at full width (batch 8,
              seq 512, hidden 1024, 16 heads, 12 layers, FFN 4096, vocab
              30522; bf16 mixed precision, Adam alpha 1e-4 with bf16
              moments) through FFModel.compile and fit on random tokens
              and labels from np.random.RandomState(0): warm-up steps,
              then timed steps; every loss finite, every training kernel
              launched its count per step (the 12 + 12 flash launches on
              the bf16 tensor-core route, the classifier's softmax forward
              and backward on the rows route, the 24 LayerNorm forward and
              24 backward
              launches on the warp route, the 2 reductions on the cta
              route), and the kernel
              registry (its auto policy) picked the kernels;
 7. train-witness — the train phase's first three steps again from the
              same weights and batch in f32 on the card and in f32 on the
              CPU: per-step losses against the CPU's, and the classifier's
              logit gap before and after the first step;
 8. train-cross — the loss and gradient norms of the first two steps
              (one Adam update with bf16 moments between them) of the
              same encoder cut to 2 layers, in f32, on the card against
              the port on the CPU, same weights and batch;
 9. tier    — the JAX package's kernel-tier graph (input (8, 512, 1024)
              -> layer_norm -> rms_norm -> dense(10) -> softmax, sparse CE
              and accuracy, SGD lr 0.05, data from RandomState(8)): 3 fit
              steps on the card in bf16 under kernel_impl="pallas" (each
              kernel's launches per step asserted, the softmax on the rows
              route, forward and backward, the RMSNorm and the LayerNorm
              forward and backward on the warp route, the reductions on
              the cta route) and under
              "reference"
              (no kernel launches), and on the CPU in f32 as a witness;
10. ref-vs-kernel — the flagship cut to 2 layers, f32, two Adam steps on
              the card under kernel_impl="pallas" and "reference" (flash
              against the einsum core, the CUDA norms against the
              reference lowerings): loss and six gradient norms.
11. standalone — the public entries no model path calls: head-separated
              flash attention in the bhld layout (forward and backward
              through its autograd Function, at the TP rank's shape),
              `fused_cumsum` (forward and its reversed-scan gradient) at
              (4096, 1024) on the scan's row route and one `cumsum` at
              (3, 1000003) on its split route; each kernel's launches and
              the scan's routes counted.
12. tp      — two ranks sharing cuda:0 (gloo, collectives staged through
              host memory) train the train phase's encoder, full width,
              under compile(parallel_axes={"model": 2}): 5 steps from the
              same weights and batch; every rank's loss the same bits at
              every step, the replicated weights the same bits at the
              end, per step and rank exactly 12 head-separated flash
              forward and backward launches (blhd, on the tensor-core
              route) and no packed one,
              the LayerNorm, softmax and reduction counts (and routes) of
              the train phase, and the first three losses within 2e-2 of
              the train
              phase's;
13. tp-cross — in the same ranks, the train-cross model (2 layers, f32,
              same weights and batch) under model=2: loss and the six
              whole-gradient norms of two steps against the train-cross
              phase's card run, within 1e-4.
14. train-graph — the train phase's flagship from the same initial
              weights and batch: 12 steps through
              fit(steps_per_execution=4) (a CUDA graph of 4 captured steps,
              replayed) against 12 eager steps, every loss and every final
              weight the same bits; launches counted from the warm-up
              dispatch and the capture (2 x 4 x a step's); host wall a
              step, device busy, idle share, launches a step and MFU for
              K = 1 eager and K = 4 graphed (tools/train_profile.py
              profile_fit), and peak memory of each run;
15. mlp     — the digits gate's MLP (64 -> 128 -> 64 -> 10, RELU, Adam
              2e-3, batch 64) on make_synthetic's seeded data, trained
              eagerly, with steps_per_execution=4, with accum_steps=2 and
              through attached (shuffled) dataloaders: eval accuracy > 0.9
              each, the K=4 run's losses those of the eager run, the eager
              run's launches per step asserted.

Prints one JSON line per phase, then the kernel table
({"kernels": [...]}), the card's name and power limit, and last
{"ok": true, "device": {...}}. Exits 2 without printing a result when no
CUDA device is visible.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense, no TC f32

# bench.py's flagship training configuration
TRAIN = dict(batch=8, seq=512, hidden=1024, heads=16, layers=12,
             vocab=30522)
SERVE_KERNELS = ("decode_attention", "multiquery_decode_attention",
                 "layernorm_fwd", "softmax_fwd")
# launches per training step of the full-width flagship (12 layers)
TRAIN_PER_STEP = {"flash_fwd": 12, "flash_bwd": 12, "layernorm_fwd": 24,
                  "layernorm_bwd": 24, "softmax_fwd": 1, "softmax_bwd": 1,
                  "reduce": 2, "optimizer_adam": 1}
TRAIN_KERNELS = tuple(TRAIN_PER_STEP)
# the same launches by route: the flash kernels in bf16, so all on the
# tensor cores; the classifier's (4096, 2) softmax, forward and backward,
# on the "rows" route;
# the (4096, 1024) LayerNorm forward and backward on "warp"; the loss's
# and the accuracy's 4096-element means on "cta" (one launch each)
TRAIN_ROUTES_PER_STEP = {"flash_fwd/tc": 12, "flash_bwd/tc": 12,
                         "flash_fwd/cc": 0, "flash_bwd/cc": 0,
                         "softmax_fwd/rows": 1, "softmax_bwd/rows": 1,
                         "layernorm_fwd/warp": 24, "layernorm_bwd/warp": 24,
                         "reduce/cta": 2}
# launches per step of the kernel-tier graph under kernel_impl="pallas"
TIER_PER_STEP = {"layernorm_fwd": 1, "layernorm_bwd": 1, "rmsnorm_fwd": 1,
                 "rmsnorm_bwd": 1, "softmax_fwd": 1, "softmax_bwd": 1,
                 "reduce": 2, "optimizer_sgd": 1}
# the tier's (4096, 10) softmax, forward and backward, takes "rows", its
# (4096, 1024) RMSNorm
# and LayerNorm, forward and backward, "warp", its two 4096-element means
# "cta"
TIER_ROUTES_PER_STEP = {"softmax_fwd/rows": 1, "softmax_bwd/rows": 1,
                        "rmsnorm_fwd/warp": 1,
                        "rmsnorm_bwd/warp": 1, "layernorm_fwd/warp": 1,
                        "layernorm_bwd/warp": 1, "reduce/cta": 2}
TIER_KERNELS = tuple(TIER_PER_STEP)
# families the registry must pick the kernel for on the training path
# (the optimizer update is a family of the port's own)
TRAIN_FAMILIES = ("attention", "layernorm", "softmax", "reduction",
                  "optimizer")
# launches per step and rank of the full-width flagship under model=2:
# the head-separated flash kernels in place of the packed ones
TP_PER_STEP = {"flash_fwd_blhd": 12, "flash_bwd_blhd": 12, "flash_fwd": 0,
               "flash_bwd": 0, "layernorm_fwd": 24, "layernorm_bwd": 24,
               "softmax_fwd": 1, "softmax_bwd": 1, "reduce": 2,
               "optimizer_adam": 1}
TP_ROUTES_PER_STEP = {"flash_fwd_blhd/tc": 12, "flash_bwd_blhd/tc": 12,
                      "flash_fwd_blhd/cc": 0, "flash_bwd_blhd/cc": 0,
                      "softmax_fwd/rows": 1, "softmax_bwd/rows": 1,
                      "layernorm_fwd/warp": 24, "layernorm_bwd/warp": 24,
                      "reduce/cta": 2}
TP_KERNELS = ("flash_fwd_blhd", "flash_bwd_blhd")
# launches of the standalone entries (phase 11): fused_cumsum forward and
# backward at (4096, 1024) on "row", one cumsum at (3, 1000003) on "split"
# (its two launches counted once)
STANDALONE_LAUNCHES = {"flash_fwd_bhld": 1, "flash_bwd_bhld": 1,
                       "cumsum": 3, "cumsum/row": 2, "cumsum/split": 1}
STANDALONE_KERNELS = ("flash_fwd_bhld", "flash_bwd_bhld", "cumsum")
# the train-graph phase: fit(steps_per_execution=GRAPH_K) for GRAPH_STEPS
# steps against as many eager steps
GRAPH_K, GRAPH_STEPS = 4, 12
# launches per step of the mlp phase's MLP (64 -> 128 -> 64 -> 10, batch
# 64): the (64, 10) softmax, forward and backward, the means of the loss,
# the accuracy and the sparse cce metric, one Adam update
MLP_PER_STEP = {"softmax_fwd": 1, "softmax_bwd": 1, "reduce": 3,
                "optimizer_adam": 1}


def train_step_flops(batch, seq, hidden, layers, **_) -> float:
    """bench.py `train_step_flops` times the batch: 6 x matmul parameters
    x tokens plus the attention score and context products; the
    embedding gather is not counted."""
    params = layers * (2 * hidden * 4 * hidden + 4 * hidden * hidden)
    per_sample = 6.0 * params * seq + layers * 6.0 * 2.0 * seq * seq * hidden
    return per_sample * batch


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters=20, flush=None):
    """Mean device ms of fn() over `iters` calls after a warm-up, each call
    between its own pair of CUDA events; `flush` runs between calls
    (outside the timed window) where the real caller finds L2 cold.

    The host queues every call while the device spins in a long sleep
    kernel, so the events time device work only, not the host's Python
    and launch overhead between two calls (a small kernel runs in less
    time than its wrapper takes to launch it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(4):
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        pairs = []
        for _ in range(iters):
            if flush is not None:
                flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        ran_dry = slept.query()  # the sleep ended before the host finished
        torch.cuda.synchronize()
        if not ran_dry:
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        cycles *= 4
    raise RuntimeError("could not queue the timed calls ahead of the device")


def _span_ms(torch, fn, iters=3):
    """Device ms from an event before `iters` back-to-back calls of fn()
    to one after them, over `iters`, after a warm-up: for a function of
    thousands of launches, whose host issue rate bounds it, and which
    cannot be queued ahead of the device as _time_ms does."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, F):
    """Each kernel against its plain version at the serving shapes; returns
    {kernel name: table row} (launches filled in after the serve phase)."""
    from flexflow_tpu_torch.kernels import decode, norm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    B, M, H, D = 8, 1024, 16, 64
    scale = 1.0 / D ** 0.5
    # ragged positions, from a nearly empty slot to a full one
    pos8 = torch.tensor([0, 37, 255, 511, 700, 880, 1000, 1023 - 16],
                        dtype=torch.int32, device=dev)

    def decode_case(name, b, c, pos, dtype, tol):
        q = torch.randn((b, c, H, D), generator=g, device=dev).to(dtype)
        kc = torch.randn((b, M, H, D), generator=g, device=dev).to(dtype)
        vc = torch.randn((b, M, H, D), generator=g, device=dev).to(dtype)
        fn = getattr(decode, name)
        plan = decode.decode_plan(b, c, M, H, D, 512, dtype, dtype)
        out = fn(q, kc, vc, pos, scale=scale, block_k=512)
        ref = decode.decode_attention_plain(q, kc, vc, pos, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol[0] + tol[1] * ref.float().abs()).all())
        row = {"shape": f"B={b} C={c} M={M} h={H} d={D} {dtype}".replace(
            "torch.", ""), "max_abs_err": float(err.max()),
            "tolerance": f"|err| <= {tol[0]} + {tol[1]}*|plain|",
            "plan": {"route": plan.route, "splits": plan.splits,
                     "split_rows": plan.split_rows, "single": plan.single,
                     "launches_per_call": plan.launches}}
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
        if dtype != torch.bfloat16:
            return row
        # timing: the cache is cold on the serving path (12 layers' caches
        # stream through between two launches of one layer)
        esz = kc.element_size()
        rows = (pos.long() + c).clamp(max=M)
        attended = sum(min(int(p) + j + 1, M) for p in pos.tolist()
                       for j in range(c))
        nbytes = (2 * int(rows.sum()) * H * D * esz + 2 * q.numel() * esz
                  + pos.numel() * 4)
        ops = 4 * H * D * attended
        bound, by = _bound(nbytes, ops, "bfloat16")
        qpos = pos.long()[:, None] + torch.arange(c, device=dev)[None, :]
        mask = (torch.arange(M, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]          # (B, 1, C, M)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
        row.update(
            ms=_time_ms(torch, lambda: fn(q, kc, vc, pos, scale=scale,
                                          block_k=512), flush=flush),
            plain_ms=_time_ms(torch, lambda: decode.decode_attention_plain(
                q, kc, vc, pos, scale), flush=flush),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale), flush=flush),
            bound_ms=bound, bound_by=by)
        return row

    bf16_tol, f32_tol = (4e-3, 2e-2), (1e-5, 1e-4)
    table = {}
    for name, c, b, pos in (
            ("decode_attention", 1, B, pos8),
            ("multiquery_decode_attention", 16, B, pos8)):
        decode_case(name, b, c, pos, torch.float32, f32_tol)
        table[name] = decode_case(name, b, c, pos, torch.bfloat16, bf16_tol)
    # the serving path's chunk: one slot, 16 queries mid-prompt
    table["multiquery_decode_attention"]["serving_shape"] = decode_case(
        "multiquery_decode_attention", 1, 16,
        torch.tensor([480], dtype=torch.int32, device=dev), torch.bfloat16,
        bf16_tol)

    def norm_case(name, rows, n, dtype, tol, timed):
        x = (torch.randn((rows, n), generator=g, device=dev) * 3 + 1).to(
            dtype)
        if name == "layernorm_fwd":
            gamma = torch.rand((n,), generator=g, device=dev) + 0.5
            beta = torch.randn((n,), generator=g, device=dev)
            out = norm.layernorm_fwd(x, gamma, beta)[0]
            ref = norm.layernorm_fwd_plain(x, gamma, beta, 1e-5)[0]
            run = lambda: norm.layernorm_fwd(x, gamma, beta)  # noqa: E731
            plain = lambda: norm.layernorm_fwd_plain(  # noqa: E731
                x, gamma, beta, 1e-5)
            g16, b16 = gamma.to(dtype), beta.to(dtype)
            lib = lambda: F.layer_norm(x, (n,), g16, b16, 1e-5)  # noqa: E731
            esz = x.element_size()
            nbytes = 2 * x.numel() * esz + 2 * n * 4 + 2 * rows * 4
            ops = 8 * x.numel()
        else:
            out = norm.softmax_fwd(x)
            if not torch.equal(norm.softmax_fwd(x), out):
                raise AssertionError(f"softmax_fwd: R={rows} N={n} {dtype} "
                                     "differs between two calls")
            ref = norm.softmax_fwd_plain(x)
            run = lambda: norm.softmax_fwd(x)  # noqa: E731
            plain = lambda: norm.softmax_fwd_plain(x)  # noqa: E731
            lib = lambda: torch.softmax(x, dim=-1)  # noqa: E731
            nbytes = 2 * x.numel() * x.element_size()
            ops = 5 * x.numel()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol[0] + tol[1] * ref.float().abs()).all())
        row = {"shape": f"R={rows} N={n} {dtype}".replace("torch.", ""),
               "max_abs_err": float(err.max()),
               "tolerance": f"|err| <= {tol[0]} + {tol[1]}*|plain|"}
        plan_of = (norm.softmax_plan if name == "softmax_fwd"
                   else norm.layernorm_fwd_plan)
        row["plan"] = plan_of(rows, n, dtype, torch.cuda.
                              get_device_properties(dev).
                              multi_processor_count)._asdict()
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
        if name == "layernorm_fwd" and rows == 4096:
            # the warp route's every step is rounded on its own: the CPU
            # emulation of its order gives the kernel's bits
            got = norm.layernorm_fwd(x, gamma, beta)
            emu = norm.layernorm_fwd_warp_plain(
                x.cpu(), gamma.cpu(), beta.cpu(), 1e-5, x.data_ptr() % 16)
            if row["plan"]["route"] != "warp" or not all(
                    torch.equal(a.cpu(), b) for a, b in zip(got, emu)):
                raise AssertionError(f"layernorm_fwd at {row['shape']}: "
                                     f"{row['plan']}, or not the bits of "
                                     "layernorm_fwd_warp_plain")
            row["warp_plain_same_bits"] = True
        if timed:
            bound, by = _bound(nbytes, ops, "bfloat16" if dtype ==
                               torch.bfloat16 else "float32")
            # activations arrive hot in L2 from the op before: no flush
            row.update(ms=_time_ms(torch, run), plain_ms=_time_ms(
                torch, plain), library_ms=_time_ms(torch, lib),
                bound_ms=bound, bound_by=by)
        return row

    for name, n, tol in (("layernorm_fwd", 1024, (1e-2, 1e-2)),
                         ("softmax_fwd", 30522, (1e-6, 1e-2))):
        norm_case(name, 128, n, torch.float32, (1e-5, 1e-4), False)
        table[name] = norm_case(name, 8 * 16, n, torch.bfloat16, tol, True)
        # the serving path: 8 decode rows / 16 rows of a prefill chunk
        table[name]["serving_shape"] = norm_case(
            name, 8, n, torch.bfloat16, tol, True)
    # the other shapes the paths give them: LayerNorm's 24 launches a
    # training step; softmax over a prefill chunk's 16 rows, the training
    # step's classifier (4096, 2) and the tier's dense(10) (4096, 10)
    table["layernorm_fwd"]["training_shape"] = norm_case(
        "layernorm_fwd", 4096, 1024, torch.bfloat16, (1e-2, 1e-2), True)
    # the train-witness's f32 steps
    table["layernorm_fwd"]["training_shape_f32"] = norm_case(
        "layernorm_fwd", 4096, 1024, torch.float32, (1e-5, 1e-4), True)
    table["layernorm_fwd"]["ms_includes"] = "1 launch"
    table["softmax_fwd"]["path_shapes"] = {
        path: norm_case("softmax_fwd", rows, n, torch.bfloat16,
                        (1e-6, 1e-2), True)
        for path, rows, n in (("prefill chunk", 16, 30522),
                              ("train step", 4096, 2),
                              ("tier step", 4096, 10))}
    del flush_buf
    table.update(train_kernels(torch, F, g))
    table.update(tier_kernels(torch, F, g))
    table.update(heads_kernels(torch, F, g))
    table.update(cumsum_kernels(torch, g))
    table.update(optimizer_kernels(torch, g))
    edges = norm_route_edges(torch, g)
    edges.update(bwd_route_edges(torch, g))
    for name in ("softmax_fwd", "rmsnorm_fwd", "layernorm_fwd",
                 "layernorm_bwd", "rmsnorm_bwd", "reduce", "softmax_bwd",
                 "cumsum"):
        table[name]["edges"] = edges[name]
    return table


def _flagship_weight_shapes():
    """The flagship's 195 weight shapes, from its graph (no weights
    drawn)."""
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models import TransformerConfig, \
        build_bert_encoder

    m = FFModel(FFConfig(batch_size=TRAIN["batch"], device="cpu"))
    tok = m.create_tensor([TRAIN["batch"], TRAIN["seq"]], DataType.DT_INT32)
    build_bert_encoder(m, tok, TransformerConfig(
        num_layers=TRAIN["layers"]))
    return [ws.dims for op in m.ops for ws in op.specs]


def optimizer_kernels(torch, g):
    """The fused optimizer update (csrc/optimizer.cu) at the flagship's
    195 weight shapes: Adam with bf16 and with f32 moments, with and
    without weight decay; SGD plain, with momentum and nesterov (weight
    decay on nesterov). Three updates of each from zero state against the
    per-tensor loop on the card, every weight and moment the same bits
    (both round each operation on its own, in the same order); a ragged
    list (sizes 1, 7, 4097, 2^20 + 3, each view one element off, so no
    tensor takes the vector path) the same way. Timed: the kernel, the
    loop and the library: for Adam on f32 moments
    `torch.optim.Adam(fused=True)` (a landmark, not the same function:
    eps on the bias-corrected sqrt(v)), for SGD `torch.optim.SGD(
    fused=True)` (the same update);
    the bound is the bytes (each of w, g, m, v read once, w, m, v written
    once) over the HBM rate."""
    from flexflow_tpu_torch.kernels import optimizer as kopt

    import math

    dev = torch.device("cuda")
    shapes = _flagship_weight_shapes()
    n_el = sum(math.prod(d) for d in shapes)

    def state(moments, offset=0, sizes=None):
        def make(n, dtype, scale):
            buf = torch.randn((n + offset,), generator=g, device=dev)
            return (scale * buf).to(dtype)[offset:]
        dims = [(n,) for n in sizes] if sizes else shapes
        numel = [math.prod(d) for d in dims]
        ws = [make(n, torch.float32, 0.02).view(d) for n, d in
              zip(numel, dims)]
        gs = [make(n, torch.float32, 1e-3).view(d) for n, d in
              zip(numel, dims)]
        ms = [torch.zeros_like(w, dtype=moments) for w in ws]
        vs = [torch.zeros_like(w, dtype=moments) for w in ws]
        return ws, gs, ms, vs

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    rows = {}
    cases = [("optimizer_adam", "bf16 moments", torch.bfloat16, 0.0),
             ("optimizer_adam", "bf16 moments, wd 0.01", torch.bfloat16,
              0.01),
             ("optimizer_adam", "f32 moments", torch.float32, 0.0),
             ("optimizer_adam", "f32 moments, wd 0.01", torch.float32, 0.01),
             ("optimizer_sgd", "plain", None, 0.0),
             ("optimizer_sgd", "momentum 0.9", None, 0.0),
             ("optimizer_sgd", "nesterov 0.9, wd 0.01", None, 0.01)]
    for name, label, moments, wd in cases:
        for ragged in (False, True):
            ws, gs, ms, vs = state(moments or torch.float32,
                                   1 if ragged else 0,
                                   (1, 7, 4097, 2**20 + 3) if ragged
                                   else None)
            ref = [[t.clone() for t in ts] for ts in (ws, ms, vs)]
            step = torch.zeros((), dtype=torch.int32, device=dev)
            lr = torch.tensor(1e-4 if moments else 0.05, device=dev)
            mom = 0.0 if label == "plain" or moments else 0.9

            def run():
                if moments:
                    kopt.adam(ws, gs, ms, vs, step, lr, beta1=0.9,
                              beta2=0.999, eps=1e-8, weight_decay=wd)
                else:
                    kopt.sgd(ws, gs, ms, lr, momentum=mom,
                             nesterov="nesterov" in label, weight_decay=wd)

            def plain():
                if moments:
                    kopt.adam_plain(ref[0], gs, ref[1], ref[2], step, lr,
                                    0.9, 0.999, 1e-8, wd)
                else:
                    kopt.sgd_plain(ref[0], gs, ref[1], lr, mom,
                                   "nesterov" in label, wd)

            for _ in range(3):
                run()
                plain()
                step.add_(1)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in
                      zip(ws, ref[0]) if a.numel())
            if not (same(ws, ref[0]) and same(ms, ref[1])
                    and same(vs, ref[2])):
                raise AssertionError(f"{name} ({label}, ragged={ragged}) "
                                     "differs from the per-tensor loop after "
                                     f"3 updates (max |w err| {err})")
            if ragged:
                continue
            key = f"{name} {label}"
            row = {"shape": f"{len(shapes)} tensors, {n_el} elements, "
                            f"{label}", "max_abs_err": err,
                   "tolerance": "the same bits as the plain loop (w, m, v) "
                                "after 3 updates, and on a ragged list"}
            if wd == 0.0 or "nesterov" in label:
                msz = 0 if not moments else (2 if moments == torch.bfloat16
                                             else 4)
                has_v = 0 if label == "plain" else 1
                per = (12 + 4 * msz if moments
                       else 12 + 8 * has_v)
                bound, by = _bound(per * n_el, 20 * n_el, "float32")
                row.update(bytes_per_element=per, bound_ms=bound,
                           bound_by=by, ms=_time_ms(torch, run, iters=10),
                           plain_ms=_span_ms(torch, plain, iters=3),
                           plain_timing="events around 3 back-to-back "
                                        "calls: the loop's ~3,100 launches "
                                        "a call are not queued ahead")
                row["library_ms"] = None
                if moments != torch.bfloat16:
                    params = [torch.nn.Parameter(w.clone()) for w in ws]
                    for p_, g_ in zip(params, gs):
                        p_.grad = g_
                    if moments:
                        lib = torch.optim.Adam(params, lr=1e-4, fused=True)
                        row["library"] = ("torch.optim.Adam(fused=True), f32 "
                                          "moments: not the same function "
                                          "(eps on the bias-corrected "
                                          "sqrt(v))")
                    else:
                        lib = torch.optim.SGD(
                            params, lr=0.05, momentum=mom,
                            nesterov="nesterov" in label, weight_decay=wd,
                            fused=True)
                        row["library"] = ("torch.optim.SGD(fused=True): the "
                                          "same update (its buffer starts "
                                          "as g, = momentum * 0 + g)")
                    row["library_ms"] = _time_ms(torch, lib.step, iters=10)
                    del params, lib
            rows[key] = row
            del ws, gs, ms, vs, ref
            torch.cuda.empty_cache()
    table = {}
    for name, main in (("optimizer_adam", "optimizer_adam bf16 moments"),
                       ("optimizer_sgd", "optimizer_sgd momentum 0.9")):
        table[name] = dict(rows[main], cases={
            k: v for k, v in rows.items() if k.startswith(name)},
            ms_includes="1 launch (195 tensors)")
    return table


# the edge shapes every softmax_fwd and rmsnorm_fwd route is held at:
# N x R, f32 and bf16 (RMSNorm with and without gamma); N = 300000 is
# wider than a cluster of 8 holds (softmax's loop route)
NORM_EDGE_N = (1, 2, 10, 33, 300, 1000, 1024, 30522, 70000)
NORM_EDGE_R = (1, 8, 16, 128, 4095)
# the edge shapes of the LayerNorm forward and of the two warp-route
# backward kernels (LayerNorm, RMSNorm): N = 2049 the first of "block",
# 58080 the widest row the parent's LayerNorm forward took (N = 14520 the
# widest the LayerNorm backward's block route stages with gamma, 14528
# without); R = 7, 8, 9 about one CTA of 8 warps
LN_FWD_EDGE_N = (1, 2, 33, 300, 1000, 1024, 2048, 2049, 58080)
LN_EDGE_R = (1, 7, 8, 9, 4095)


def norm_route_edges(torch, g):
    """softmax_fwd, rmsnorm_fwd and layernorm_fwd against their plain
    versions at the edge shapes, every route of the three plans, at the
    tolerances of the path-shape checks; two calls give the same bits; an
    RMSNorm or LayerNorm row wider than a block's shared memory raises
    ValueError, where the parent refused it (RMSNorm) or its launch failed
    (LayerNorm). Also each cluster plan's cudaOccupancyMaxActiveClusters
    (at least 1). Returns {kernel: summary}."""
    from flexflow_tpu_torch.kernels import _build, norm

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sm_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-6, 1e-2)}
    rms_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
    ln_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
    out = {k: {"checked": 0, "routes": {}, "max_abs_err": 0.0}
           for k in ("softmax_fwd", "rmsnorm_fwd", "layernorm_fwd")}

    def note(name, route, row):
        rec = out[name]
        rec["checked"] += 1
        rec["routes"][route] = rec["routes"].get(route, 0) + 1
        rec["max_abs_err"] = max(rec["max_abs_err"], row["max_abs_err"])

    shapes = [(r, n) for n in NORM_EDGE_N for r in NORM_EDGE_R]
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n in shapes + [(1, 300000), (3, 300000)]:
            x = (torch.randn((rows, n), generator=g, device=dev) * 4).to(
                dtype)
            shape = f"R={rows} N={n} {dtype}".replace("torch.", "")
            plan = norm.softmax_plan(rows, n, dtype, sms)
            y = norm.softmax_fwd(x)
            note("softmax_fwd", plan.route, _agree(
                "softmax_fwd", y, norm.softmax_fwd_plain(x), sm_tol[dtype],
                shape))
            if not torch.equal(norm.softmax_fwd(x), y):
                raise AssertionError(f"softmax_fwd: {shape} differs between "
                                     "two calls")
            del x, y
        for rows, n in shapes:
            for affine in (True, False):
                x = (torch.randn((rows, n), generator=g, device=dev) * 2
                     + 1).to(dtype)
                gamma = (torch.rand((n,), generator=g, device=dev) + 0.5
                         if affine else None)
                shape = (f"R={rows} N={n} {dtype} "
                         f"{'affine' if affine else 'plain'}").replace(
                             "torch.", "")
                if n > norm.rmsnorm_max_n(dtype):
                    try:
                        norm.rmsnorm_fwd(x, gamma)
                    except ValueError:
                        out["rmsnorm_fwd"]["refused"] = shape
                        continue
                    raise AssertionError(f"rmsnorm_fwd took {shape}")
                plan = norm.rmsnorm_plan(rows, n, dtype, sms)
                y, rstd = norm.rmsnorm_fwd(x, gamma)
                ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
                note("rmsnorm_fwd", plan.route, _agree(
                    "rmsnorm_fwd", y, ry, rms_tol[dtype], shape))
                _agree("rmsnorm_fwd (rstd)", rstd, rrstd, rms_tol[
                    torch.float32], shape)
                y2, rstd2 = norm.rmsnorm_fwd(x, gamma)
                if not (torch.equal(y2, y) and torch.equal(rstd2, rstd)):
                    raise AssertionError(f"rmsnorm_fwd: {shape} differs "
                                         "between two calls")
                del x, y, y2
        ln_shapes = [(r, n) for n in LN_FWD_EDGE_N for r in LN_EDGE_R]
        for rows, n in ln_shapes + [(2, LN_FWD_EDGE_N[-1] + 1)]:
            for affine in (True, False):
                x = (torch.randn((rows, n), generator=g, device=dev) * 2
                     + 1).to(dtype)
                gamma = beta = None
                if affine:
                    gamma = torch.rand((n,), generator=g, device=dev) + 0.5
                    beta = torch.randn((n,), generator=g, device=dev)
                shape = (f"R={rows} N={n} {dtype} "
                         f"{'affine' if affine else 'plain'}").replace(
                             "torch.", "")
                if n > norm.layernorm_max_n(dtype):
                    try:
                        norm.layernorm_fwd(x, gamma, beta)
                    except ValueError:
                        out["layernorm_fwd"]["refused"] = shape
                        continue
                    raise AssertionError(f"layernorm_fwd took {shape}")
                plan = norm.layernorm_fwd_plan(rows, n, dtype, sms)
                got = norm.layernorm_fwd(x, gamma, beta)
                ry, rmean, rrstd = norm.layernorm_fwd_plain(x, gamma, beta,
                                                            1e-5)
                note("layernorm_fwd", plan.route, _agree(
                    "layernorm_fwd", got[0], ry, ln_tol[dtype], shape))
                for nm, a, b in (("mean", got[1], rmean),
                                 ("rstd", got[2], rrstd)):
                    _agree(f"layernorm_fwd ({nm})", a, b,
                           ln_tol[torch.float32], shape)
                again = norm.layernorm_fwd(x, gamma, beta)
                if not all(torch.equal(a, b) for a, b in zip(again, got)):
                    raise AssertionError(f"layernorm_fwd: {shape} differs "
                                         "between two calls")
                del x, got, again
    missing = [f"{k}/{r}" for k, routes in (
        ("softmax_fwd", norm.SOFTMAX_ROUTES),
        ("rmsnorm_fwd", norm.RMSNORM_ROUTES),
        ("layernorm_fwd", norm.LN_FWD_ROUTES)) for r in routes
        if r not in out[k]["routes"]]
    if missing:
        raise AssertionError(f"routes never held at the edges: {missing}")
    lib = _build.library()
    clusters = {}
    for rows, n in ((8, 30522), (16, 30522), (1, 70000), (4095, 70000)):
        for dtype in (torch.float32, torch.bfloat16):
            plan = norm.softmax_plan(rows, n, dtype, sms)
            fit = lib.ff_softmax_max_active_clusters(
                plan.threads, plan.per_thread, plan.cluster,
                _build.DTYPE_CODES[dtype])
            key = (f"R={rows} N={n} {dtype}: {plan.cluster} x "
                   f"{plan.threads}").replace("torch.", "")
            clusters[key] = fit
            if fit < 1:
                raise AssertionError(f"softmax_fwd cluster plan {key} does "
                                     f"not fit on the card ({fit})")
    out["softmax_fwd"]["max_active_clusters"] = clusters
    for rec in out.values():
        rec["tolerance"] = "the path shapes' (f32 and bf16)"
        rec["same_bits_on_two_calls"] = True
    return out


LN_BWD_EDGE_N = (1, 2, 33, 300, 1000, 1024, 2048, 2049, 14520, 14528)
# the softmax backward's: the forward's N and the rows route's last and
# the register routes' first (512, 513); N = 300000 takes "loop"
SOFTMAX_BWD_EDGE_N = (1, 2, 10, 33, 512, 513, 1000, 1024, 30522, 70000)
# the scan's (rows, N): "row" at the table's, the short and the many-row
# shapes, "split" from the first N past 4 tiles, at a chunk edge (3 x 175
# tiles + 1) and on the long rows
CUMSUM_EDGE = ((1, 1), (37, 300), (4096, 1024), (1, 4096), (1056, 5000),
               (1, 4097), (1055, 5000), (2, 3 * 1024 * 175 + 1),
               (3, 1000003), (1, 1000003), (132, 100000), (1, 2 ** 24))
RMS_BWD_EDGE_N = (1, 2, 33, 300, 1000, 1024, 2048, 2049, 14528)
# the reduce's element counts, each 16-byte aligned and one element past
REDUCE_EDGE_N = (0, 1, 4096, 4097, 1000003, 2 ** 26)


def bwd_route_edges(torch, g):
    """layernorm_bwd, rmsnorm_bwd, reduce, softmax_bwd and cumsum against
    their plain versions at the edge shapes, every route of the five
    plans, at the path-shape checks' tolerances; dx, dgamma / dbeta, the
    reduction, the softmax backward and the scan the same bits on two
    calls, the last two also the bits of their routes' emulations
    (`softmax_bwd_split_plain`, `cumsum_split_plain`); a LayerNorm row
    with gamma wider than the block route stages raises ValueError, where
    the parent's launch failed, and an RMSNorm row wider than
    MAX_BWD_COLS, where the parent raised. Also the reduce at the last n
    of "cta" and the first of "grid", at every 16-byte phase of the
    start. Returns {kernel: summary}."""
    from flexflow_tpu_torch.kernels import norm, reduction

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dx_tol = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
    out = {k: {"checked": 0, "routes": {}, "max_abs_err": 0.0}
           for k in ("layernorm_bwd", "rmsnorm_bwd", "reduce", "softmax_bwd",
                     "cumsum")}

    def note(name, route, err):
        rec = out[name]
        rec["checked"] += 1
        rec["routes"][route] = rec["routes"].get(route, 0) + 1
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    for dtype in (torch.float32, torch.bfloat16):
        for rows in LN_EDGE_R:
            for n in LN_BWD_EDGE_N:
                for affine in (True, False):
                    x = (torch.randn((rows, n), generator=g, device=dev) * 2
                         + 1).to(dtype)
                    dy = torch.randn((rows, n), generator=g,
                                     device=dev).to(dtype)
                    gamma = beta = None
                    if affine:
                        gamma = torch.rand((n,), generator=g,
                                           device=dev) + 0.5
                        beta = torch.zeros_like(gamma)
                    shape = (f"R={rows} N={n} {dtype} "
                             f"{'affine' if affine else 'plain'}").replace(
                                 "torch.", "")
                    _, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
                    if affine and n > norm.LN_BWD_BLOCK_AFFINE_MAX_N:
                        try:
                            norm.layernorm_bwd(x, gamma, mean, rstd, dy)
                        except ValueError:
                            out["layernorm_bwd"]["refused"] = shape
                            continue
                        raise AssertionError(f"layernorm_bwd took {shape}")
                    plan = norm.layernorm_bwd_plan(rows, n, dtype, sms)
                    dx, dg, db = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
                    rdx, rdg, rdb = norm.layernorm_bwd_plain(x, gamma, mean,
                                                             rstd, dy)
                    err = _agree("layernorm_bwd (dx)", dx, rdx,
                                 dx_tol[dtype], shape)["max_abs_err"]
                    if affine:
                        for nm, a, b in (("dgamma", dg, rdg),
                                         ("dbeta", db, rdb)):
                            err = max(err, _agree(
                                f"layernorm_bwd ({nm})", a, b, (1e-3, 1e-4),
                                shape)["max_abs_err"])
                        again = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
                        if not (torch.equal(again[1], dg)
                                and torch.equal(again[2], db)):
                            raise AssertionError(f"layernorm_bwd: {shape} "
                                                 "differs between two calls")
                    note("layernorm_bwd", plan.route, err)
                    del x, dy, dx
            for n in RMS_BWD_EDGE_N + (RMS_BWD_EDGE_N[-1] + 1,):
                for affine in (True, False):
                    x = (torch.randn((rows, n), generator=g, device=dev) * 2
                         + 1).to(dtype)
                    dy = torch.randn((rows, n), generator=g,
                                     device=dev).to(dtype)
                    gamma = torch.rand((n,), generator=g,
                                       device=dev) + 0.5 if affine else None
                    shape = (f"R={rows} N={n} {dtype} "
                             f"{'affine' if affine else 'plain'}").replace(
                                 "torch.", "")
                    _, rstd = norm.rmsnorm_fwd(x, gamma)
                    if n > norm.MAX_BWD_COLS:
                        try:
                            norm.rmsnorm_bwd(x, gamma, rstd, dy)
                        except ValueError:
                            out["rmsnorm_bwd"]["refused"] = shape
                            continue
                        raise AssertionError(f"rmsnorm_bwd took {shape}")
                    plan = norm.rmsnorm_bwd_plan(rows, n, dtype, sms)
                    dx, dg = norm.rmsnorm_bwd(x, gamma, rstd, dy)
                    rdx, rdg = norm.rmsnorm_bwd_plain(x, gamma, rstd, dy)
                    err = _agree("rmsnorm_bwd (dx)", dx, rdx, dx_tol[dtype],
                                 shape)["max_abs_err"]
                    again = norm.rmsnorm_bwd(x, gamma, rstd, dy)
                    if not torch.equal(again[0], dx):
                        raise AssertionError(f"rmsnorm_bwd: {shape} differs "
                                             "between two calls")
                    if affine:
                        err = max(err, _agree(
                            "rmsnorm_bwd (dgamma)", dg, rdg, (1e-3, 1e-4),
                            shape)["max_abs_err"])
                        if not torch.equal(again[1], dg):
                            raise AssertionError(f"rmsnorm_bwd: {shape} "
                                                 "differs between two calls")
                    note("rmsnorm_bwd", plan.route, err)
                    del x, dy, dx, again
    for dtype in (torch.float32, torch.bfloat16):
        last = reduction.REDUCE_CTA_MAX_BYTES // (
            4 if dtype == torch.float32 else 2)
        cases = [(n, off) for n in REDUCE_EDGE_N for off in (0, 1)]
        cases += [(n, off) for n in (last, last + 1)
                  for off in range(16 // (4 if dtype == torch.float32
                                          else 2))]
        for n, off in cases:
            x = torch.randn((n + off,), generator=g, device=dev).to(
                dtype)[off:]
            plan = reduction.reduce_plan(n, dtype)
            for kind in ("sum", "mean", "max"):
                shape = f"n={n} +{off} {dtype} {kind}".replace("torch.", "")
                got = reduction.reduce(x, kind)
                ref = reduction.reduce_plain(x, kind)
                err = abs(float(got) - float(ref)) if n or kind != "max" \
                    else 0.0
                lim = 1e-6 * float(x.float().abs().sum())
                ok = torch.equal(got, ref) if kind == "max" else err <= lim
                if not ok or not torch.equal(reduction.reduce(x, kind), got):
                    raise AssertionError(f"reduce at {shape}: {float(got)} "
                                         f"vs plain {float(ref)}, or two "
                                         "calls differ")
                note("reduce", plan.route, err)
            del x
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n in ([(r, n) for n in SOFTMAX_BWD_EDGE_N
                         for r in NORM_EDGE_R] + [(1, 300000), (3, 300000)]):
            y = norm.softmax_fwd((torch.randn((rows, n), generator=g,
                                              device=dev) * 3).to(dtype))
            dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
            shape = f"R={rows} N={n} {dtype}".replace("torch.", "")
            plan = norm.softmax_bwd_plan(rows, n, dtype, sms)
            dx = norm.softmax_bwd(y, dy)
            err = _agree("softmax_bwd", dx, norm.softmax_bwd_plain(y, dy),
                         (1e-6, 1e-4) if dtype == torch.float32
                         else (1e-4, 1e-2), shape)["max_abs_err"]
            emu = norm.softmax_bwd_split_plain(y, dy, plan.cluster,
                                               y.data_ptr() % 16)
            if not (torch.equal(dx, emu)
                    and torch.equal(norm.softmax_bwd(y, dy), dx)):
                raise AssertionError(f"softmax_bwd at {shape} ({plan}): not "
                                     "the bits of its emulation, or two "
                                     "calls differ")
            note("softmax_bwd", plan.route, err)
            del y, dy, dx, emu
        for rows, n in CUMSUM_EDGE:
            x = torch.randn((rows, n), generator=g, device=dev).to(dtype)
            plan = reduction.cumsum_plan(rows, n, dtype, sms)
            for reverse in (False, True):
                shape = (f"R={rows} N={n} {dtype}"
                         f"{' reverse' if reverse else ''}").replace(
                             "torch.", "")
                note("cumsum", plan.route, cumsum_case(
                    torch, reduction, x, reverse, sms, shape))
            del x
    missing = [f"{k}/{r}" for k, routes in (
        ("layernorm_bwd", norm.LN_BWD_ROUTES),
        ("rmsnorm_bwd", norm.RMS_BWD_ROUTES),
        ("reduce", reduction.REDUCE_ROUTES),
        ("softmax_bwd", norm.SOFTMAX_BWD_ROUTES),
        ("cumsum", reduction.CUMSUM_ROUTES)) for r in routes
        if r not in out[k]["routes"]]
    if missing:
        raise AssertionError(f"routes never held at the edges: {missing}")
    out["layernorm_bwd"]["tolerance"] = (
        "dx the path shapes' (f32 and bf16); dgamma, dbeta |err| <= 1e-3 + "
        "1e-4*|plain|")
    out["rmsnorm_bwd"]["tolerance"] = (
        "dx the path shapes' (f32 and bf16); dgamma |err| <= 1e-3 + "
        "1e-4*|plain|")
    out["reduce"]["tolerance"] = "max exact; sum, mean |err| <= 1e-6 sum|x|"
    out["softmax_bwd"]["tolerance"] = (
        "the path shapes' (f32 and bf16); dx the bits of "
        "softmax_bwd_split_plain")
    out["cumsum"]["tolerance"] = (
        "the kernel row's; out the bits of cumsum_split_plain, forward and "
        "reverse")
    for rec in out.values():
        rec["same_bits_on_two_calls"] = True
    return out


def _agree(name, out, ref, tol, shape):
    err = (out.float() - ref.float()).abs()
    row = {"shape": shape, "max_abs_err": float(err.max()),
           "tolerance": f"|err| <= {tol[0]} + {tol[1]}*|plain|"}
    if not bool((err <= tol[0] + tol[1] * ref.float().abs()).all()):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}: {row}")
    return row


def train_kernels(torch, F, g):
    """The training path's kernels against their plain versions at the
    training shapes, in f32 and bf16; timed in bf16 (the training path's
    dtype). Returns {kernel name: table row}."""
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import norm

    dev = torch.device("cuda")
    b, l, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"], 64
    e = h * d
    scale = d ** -0.5
    table = {}
    f32_tol = (1e-5, 1e-4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # flash forward and backward, (b, l, h*d), not causal (BERT)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (rnd(b, l, e).to(dtype) for _ in range(4))
        shape = f"b={b} l={l} h={h} d={d} {dtype}".replace("torch.", "")
        tol = f32_tol if dtype == torch.float32 else (4e-3, 2e-2)
        o, lse = fa.flash_fwd(q, k, v, h, scale=scale)
        ro, rlse = fa.flash_fwd_plain(q, k, v, h, scale, False)
        fwd = _agree("flash_fwd", o, ro, tol, shape)
        _agree("flash_fwd (lse)", lse, rlse, f32_tol, shape)
        grads = fa.flash_bwd(q, k, v, o, lse, do, h, scale=scale)
        delta = (do.float() * o.float()).reshape(b, l, h, d).sum(-1)
        ref = fa.flash_bwd_plain(q, k, v, do, lse, delta, h, scale, False)
        # bf16: the same bf16-rounded ds and p as the plain version; f32
        # sums in another order may move a result by one bf16 ulp (<= 2^-7)
        btol = f32_tol if dtype == torch.float32 else (1e-3, 1e-2)
        bwd = [_agree(f"flash_bwd ({n})", a, r, btol, shape)
               for n, a, r in zip(("dq", "dk", "dv"), grads, ref)]
        bwd = dict(bwd[0], max_abs_err=max(r["max_abs_err"] for r in bwd))
    torch.cuda.synchronize()
    esz = q.element_size()
    fwd_bytes = 4 * b * l * e * esz + b * l * h * 4
    fwd_bound = _bound(fwd_bytes, 4 * b * h * l * l * d, "bfloat16")
    bwd_bytes = 8 * b * l * e * esz + 2 * b * l * h * 4
    bwd_bound = _bound(bwd_bytes, 10 * b * h * l * l * d, "bfloat16")
    qt, kt, vt, dot = (t.reshape(b, l, h, d).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    fwd.update(
        ms=_time_ms(torch, lambda: fa.flash_fwd(q, k, v, h, scale=scale)),
        plain_ms=_time_ms(torch, lambda: fa.flash_fwd_plain(
            q, k, v, h, scale, False)),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale)),
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library="F.scaled_dot_product_attention on (b, h, l, d)")
    table["flash_fwd"] = fwd
    bwd.update(
        ms=_time_ms(torch, lambda: fa.flash_bwd(q, k, v, o, lse, do, h,
                                                scale=scale)),
        plain_ms=_time_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, do, lse, delta, h, scale, False)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), dot, retain_graph=True)),
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library="SDPA's backward through autograd",
        ms_includes="delta = sum(dO * O) per head in torch (2 kernels: "
                    "the f32 product, the sum) + the dq and dk/dv "
                    "launches")
    table["flash_bwd"] = bwd
    del sdpa_out, qg, kg, vg

    # LayerNorm backward, R = b*l rows of the hidden width
    r, n = b * l, TRAIN["hidden"]
    for dtype in (torch.float32, torch.bfloat16):
        x = (rnd(r, n) * 2 + 1).to(dtype)
        dy = rnd(r, n).to(dtype)
        gamma, beta = rnd(n).abs() + 0.5, rnd(n)
        _, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
        dx, dg, db = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        rdx, rdg, rdb = norm.layernorm_bwd_plain(x, gamma, mean, rstd, dy)
        shape = f"R={r} N={n} {dtype}".replace("torch.", "")
        tol = f32_tol if dtype == torch.float32 else (2e-2, 2e-2)
        ln = _agree("layernorm_bwd (dx)", dx, rdx, tol, shape)
        # dgamma / dbeta: f32 sums over 4096 rows in another order
        for nm, a, ref_ in (("dgamma", dg, rdg), ("dbeta", db, rdb)):
            row = _agree(f"layernorm_bwd ({nm})", a, ref_, (1e-3, 1e-4),
                         shape)
            ln["max_abs_err"] = max(ln["max_abs_err"], row["max_abs_err"])
        again = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        if not (torch.equal(again[1], dg) and torch.equal(again[2], db)):
            raise AssertionError("layernorm_bwd: dgamma / dbeta differ "
                                 "between two runs")
        # the warp route's every step is rounded on its own: the CPU
        # emulation of its order gives the kernel's bits
        plan = norm.layernorm_bwd_plan(r, n, dtype, torch.cuda.
                                       get_device_properties(dev).
                                       multi_processor_count)
        emu = norm.layernorm_bwd_warp_plain(
            x.cpu(), gamma.cpu(), mean.cpu(), rstd.cpu(), dy.cpu(),
            plan.blocks, x.data_ptr() % 16, plan.threads // 32)
        if plan.route != "warp" or not all(
                torch.equal(a.cpu(), b) for a, b in zip((dx, dg, db), emu)):
            raise AssertionError(f"layernorm_bwd at {shape}: {plan}, or not "
                                 "the bits of layernorm_bwd_warp_plain")
    ln["plan"] = plan._asdict()
    ln["warp_plain_same_bits"] = True
    g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [n], g16, b16,
                                                       1e-5)
    esz = x.element_size()
    ln_bytes = 3 * r * n * esz + 2 * r * 4 + 3 * n * 4
    ln_bound = _bound(ln_bytes, 10 * r * n, "bfloat16")
    ln.update(
        ms=_time_ms(torch, lambda: norm.layernorm_bwd(x, gamma, mean, rstd,
                                                      dy)),
        plain_ms=_time_ms(torch, lambda: norm.layernorm_bwd_plain(
            x, gamma, mean, rstd, dy)),
        library_ms=_time_ms(
            torch, lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [n], lmean, lrstd, g16, b16, [True, True, True])),
        bound_ms=ln_bound[0], bound_by=ln_bound[1],
        library="torch.ops.aten.native_layer_norm_backward (bf16 gamma)",
        ms_includes="2 launches (the warp route's rows, then the dgamma / "
                    "dbeta column sums as a programmatic dependent)")
    table["layernorm_bwd"] = ln

    # softmax backward: the classifier's (b*l, 2) probabilities (the
    # table's row), the tier's (4096, 10), and the wide shapes of its
    # other routes; every one the bits of its route's emulation
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {}
    for path, r, n in (("train step", b * l, 2), ("tier step", 4096, 10),
                       ("cluster", 8, 30522), ("cluster 16", 16, 30522),
                       ("block", 128, 30522), ("NMT projection", 2048, 32000),
                       ("block mid", 4096, 1024)):
        dtypes = ((torch.float32, torch.bfloat16) if n <= 10
                  else (torch.bfloat16,))
        for dtype in dtypes:
            y = norm.softmax_fwd((rnd(r, n) * 3).to(dtype))
            dy = rnd(r, n).to(dtype)
            shapes[f"{path} {str(dtype)[6:]}"] = softmax_bwd_case(
                torch, norm, y, dy, sms)
    sm = dict(shapes.pop("train step bfloat16"),
              library="torch._softmax_backward_data",
              ms_includes="1 launch",
              note="N = 2: bound by launch latency, not by bytes")
    sm["path_shapes"] = shapes
    table["softmax_bwd"] = sm
    return table


def softmax_bwd_case(torch, norm, y, dy, sms):
    """softmax_bwd on (y, dy): within tolerance of its plain version,
    equal to the bit to its route's emulation (`softmax_bwd_split_plain`,
    run on the card in torch's elementwise kernels) and the same bits on
    two calls; timed beside its plain version and
    `torch._softmax_backward_data`, hot in L2 (the cotangent arrives from
    the op before). Returns a table row with the plan."""
    rows, n = y.shape
    shape = f"R={rows} N={n} {y.dtype}".replace("torch.", "")
    plan = norm.softmax_bwd_plan(rows, n, y.dtype, sms)
    dx = norm.softmax_bwd(y, dy)
    row = _agree("softmax_bwd", dx, norm.softmax_bwd_plain(y, dy),
                 (1e-6, 1e-4) if y.dtype == torch.float32 else (1e-4, 1e-2),
                 shape)
    emu = norm.softmax_bwd_split_plain(y, dy, plan.cluster,
                                       y.data_ptr() % 16)
    if not (torch.equal(dx, emu) and torch.equal(norm.softmax_bwd(y, dy),
                                                 dx)):
        raise AssertionError(f"softmax_bwd at {shape} ({plan}): not the "
                             "bits of its emulation, or two calls differ")
    bound, by = _bound(3 * y.numel() * y.element_size(), 4 * y.numel(),
                       str(y.dtype)[6:])
    row.update(plan=plan._asdict(), emulation_same_bits=True,
               ms=_time_ms(torch, lambda: norm.softmax_bwd(y, dy)),
               plain_ms=_time_ms(torch, lambda: norm.softmax_bwd_plain(y,
                                                                       dy)),
               library_ms=_time_ms(torch, lambda: torch.
                                   _softmax_backward_data(dy, y, -1,
                                                          y.dtype)),
               bound_ms=bound, bound_by=by)
    return row


def tier_kernels(torch, F, g):
    """RMSNorm forward and backward and the scalar reduction against their
    plain versions, in f32 and bf16, at the kernel-tier graph's shapes
    (RMSNorm (4096, 1024); the loss and accuracy terms, 4096 f32
    elements), at edge shapes, and the reduction at 2^26 f32 elements;
    dgamma and the reduction bit-identical over two runs; RMSNorm
    backward at (4096, 1024) the bits of its warp route's emulation. Timed
    at the path's shapes (bf16 RMSNorm; the backward also in f32). Returns
    {kernel name: table row}."""
    from flexflow_tpu_torch.kernels import norm, reduction

    dev = torch.device("cuda")
    table = {}
    f32_tol = (1e-5, 1e-4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def rms_case(rows, n, dtype, affine):
        x = (rnd(rows, n) * 2 + 1).to(dtype)
        dy = rnd(rows, n).to(dtype)
        gamma = rnd(n).abs() + 0.5 if affine else None
        shape = (f"R={rows} N={n} {dtype} "
                 f"{'affine' if affine else 'plain'}").replace("torch.", "")
        tol = f32_tol if dtype == torch.float32 else (2e-2, 2e-2)
        y, rstd = norm.rmsnorm_fwd(x, gamma)
        y2, rstd2 = norm.rmsnorm_fwd(x, gamma)
        if not (torch.equal(y2, y) and torch.equal(rstd2, rstd)):
            raise AssertionError(f"rmsnorm_fwd: {shape} differs between two "
                                 "calls")
        ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
        fwd = _agree("rmsnorm_fwd", y, ry, tol, shape)
        fwd["plan"] = norm.rmsnorm_plan(rows, n, dtype)._asdict()
        _agree("rmsnorm_fwd (rstd)", rstd, rrstd, f32_tol, shape)
        dx, dg = norm.rmsnorm_bwd(x, gamma, rstd, dy)
        rdx, rdg = norm.rmsnorm_bwd_plain(x, gamma, rstd, dy)
        bwd = _agree("rmsnorm_bwd (dx)", dx, rdx, tol, shape)
        plan = norm.rmsnorm_bwd_plan(rows, n, dtype, torch.cuda.
                                     get_device_properties(dev).
                                     multi_processor_count)
        bwd["plan"] = plan._asdict()
        if rows == TRAIN["batch"] * TRAIN["seq"]:
            # the warp route's every step is rounded on its own: the CPU
            # emulation of its order gives the kernel's bits
            emu = norm.rmsnorm_bwd_warp_plain(
                x.cpu(), gamma.cpu() if affine else None, rstd.cpu(),
                dy.cpu(), plan.blocks, x.data_ptr() % 16, plan.threads // 32)
            if plan.route != "warp" or not torch.equal(dx.cpu(), emu[0]) \
                    or (affine and not torch.equal(dg.cpu(), emu[1])):
                raise AssertionError(f"rmsnorm_bwd at {shape}: {plan}, or "
                                     "not the bits of rmsnorm_bwd_warp_plain")
            bwd["warp_plain_same_bits"] = True
        if affine:
            # dgamma: f32 sums over the rows in another order
            row = _agree("rmsnorm_bwd (dgamma)", dg, rdg, (1e-3, 1e-4), shape)
            bwd["max_abs_err"] = max(bwd["max_abs_err"], row["max_abs_err"])
            if not torch.equal(norm.rmsnorm_bwd(x, gamma, rstd, dy)[1], dg):
                raise AssertionError("rmsnorm_bwd: dgamma differs between "
                                     "two runs")
        return fwd, bwd, (x, gamma, rstd, dy)

    r, n = TRAIN["batch"] * TRAIN["seq"], TRAIN["hidden"]
    worst = {"rmsnorm_fwd": 0.0, "rmsnorm_bwd": 0.0}
    edges, timed = [], {}
    for rows, cols in ((r, n), (37, 300), (4095, 1000), (1, 33)):
        for dtype in (torch.float32, torch.bfloat16):
            for affine in (True, False):
                fwd, bwd, args = rms_case(rows, cols, dtype, affine)
                worst["rmsnorm_fwd"] = max(worst["rmsnorm_fwd"],
                                           fwd["max_abs_err"])
                worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"],
                                           bwd["max_abs_err"])
                if (rows, cols) != (r, n):
                    edges.append(fwd["shape"])
                elif affine:
                    timed[dtype] = (fwd, bwd, args)
    fwd, bwd, (x, gamma, rstd, dy) = timed[torch.bfloat16]
    esz = x.element_size()
    g16 = gamma.to(x.dtype)
    xg = x.detach().requires_grad_()
    wg = g16.detach().requires_grad_()
    lib_out = F.rms_norm(xg, (n,), wg, 1e-6)
    fwd_bound = _bound(2 * r * n * esz + n * 4 + r * 4, 4 * r * n,
                       "bfloat16")
    bwd_bound = _bound(3 * r * n * esz + 2 * n * 4 + r * 4, 8 * r * n,
                       "bfloat16")
    fwd.update(
        max_abs_err=worst["rmsnorm_fwd"], edge_shapes=edges,
        ms=_time_ms(torch, lambda: norm.rmsnorm_fwd(x, gamma)),
        plain_ms=_time_ms(torch, lambda: norm.rmsnorm_fwd_plain(
            x, gamma, 1e-6)),
        library_ms=_time_ms(torch, lambda: F.rms_norm(x, (n,), g16, 1e-6)),
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
        library="F.rms_norm (bf16 weight)")
    table["rmsnorm_fwd"] = fwd
    bwd.update(
        max_abs_err=worst["rmsnorm_bwd"], edge_shapes=edges,
        ms=_time_ms(torch, lambda: norm.rmsnorm_bwd(x, gamma, rstd, dy)),
        plain_ms=_time_ms(torch, lambda: norm.rmsnorm_bwd_plain(
            x, gamma, rstd, dy)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (xg, wg), dy, retain_graph=True)),
        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library="F.rms_norm's backward through autograd (bf16 weight)",
        ms_includes="2 launches (the warp route's rows, then the dgamma "
                    "column sums as a programmatic dependent)")
    # the f32 shape, beside F.rms_norm's backward with an f32 weight
    _, f32_bwd, (x, gamma, rstd, dy) = timed[torch.float32]
    xg = x.detach().requires_grad_()
    wg = gamma.detach().requires_grad_()
    lib_out = F.rms_norm(xg, (n,), wg, 1e-6)
    f32_bound = _bound(3 * r * n * 4 + 2 * n * 4 + r * 4, 8 * r * n,
                       "float32")
    f32_bwd.update(
        ms=_time_ms(torch, lambda: norm.rmsnorm_bwd(x, gamma, rstd, dy)),
        plain_ms=_time_ms(torch, lambda: norm.rmsnorm_bwd_plain(
            x, gamma, rstd, dy)),
        library_ms=_time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (xg, wg), dy, retain_graph=True)),
        bound_ms=f32_bound[0], bound_by=f32_bound[1])
    bwd["f32_shape"] = f32_bwd
    table["rmsnorm_bwd"] = bwd
    del lib_out, xg, wg

    def reduce_case(x, kind):
        out = reduction.reduce(x, kind)
        ref = reduction.reduce_plain(x, kind)
        shape = f"n={x.numel()} {x.dtype} {kind}".replace("torch.", "")
        err = abs(float(out) - float(ref)) if x.numel() or kind != "max" \
            else 0.0
        if kind == "max":
            ok = torch.equal(out, ref)
            tol = "exact"
        else:
            lim = 1e-6 * float(x.float().abs().sum())
            ok = err <= lim
            tol = f"|err| <= 1e-6 * sum|x| = {lim}"
        if not ok or out.dtype != torch.float32 or out.shape != ():
            raise AssertionError(f"reduce disagrees with its plain version "
                                 f"at {shape}: {float(out)} vs {float(ref)}")
        if not torch.equal(reduction.reduce(x, kind), out):
            raise AssertionError(f"reduce: {shape} differs between two runs")
        return {"shape": shape, "max_abs_err": err, "tolerance": tol}

    rows = []
    for numel in (4096, 0, 1, 4097, 1000003):
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(numel).to(dtype)
            for kind in ("sum", "mean", "max"):
                rows.append(reduce_case(x, kind))
                if numel > 1:  # off the 16-byte boundary: scalar loads
                    rows.append(reduce_case(x[1:], kind))
    # the loss's (b, l, 1) log-likelihoods and the accuracy's (b, l) hits
    ll = -(rnd(TRAIN["batch"], TRAIN["seq"], 1).abs())
    big = rnd(2 ** 26)
    for kind in ("sum", "max"):
        rows.append(reduce_case(big, kind))
    red = dict(reduce_case(ll, "mean"))
    red.update(
        max_abs_err=max(row["max_abs_err"] for row in rows),
        checked=[row["shape"] for row in rows],
        ms=_time_ms(torch, lambda: reduction.reduce(ll, "mean")),
        plain_ms=_time_ms(torch, lambda: reduction.reduce_plain(ll, "mean")),
        library_ms=_time_ms(torch, lambda: torch.sum(ll)),
        bound_ms=_bound(ll.numel() * 4 + 4, ll.numel(), "float32")[0],
        bound_by="bytes", library="torch.sum",
        plan=reduction.reduce_plan(ll.numel(), ll.dtype)._asdict(),
        ms_includes="1 launch (the cta route)",
        note="4096 elements: launch latency rules")
    large = {}
    for kind, lib in (("sum", torch.sum), ("max", torch.amax)):
        b_ms, by = _bound(big.numel() * 4 + 4, big.numel(), "float32")
        large[kind] = dict(
            ms=_time_ms(torch, lambda: reduction.reduce(big, kind)),
            plain_ms=_time_ms(torch, lambda: reduction.reduce_plain(big,
                                                                    kind)),
            library_ms=_time_ms(torch, lambda: lib(big)),
            bound_ms=b_ms, bound_by=by,
            library=f"torch.{lib.__name__}",
            ms_includes="2 launches (the grid route's block partials, then "
                        "their sum as a programmatic dependent)")
    red["at_2^26_f32"] = large
    table["reduce"] = red
    del big
    return table


def heads_kernels(torch, F, g):
    """The head-separated flash kernels (B7) against their plain versions
    in both layouts: at the TP rank's shape (8, 512, 8, 64) in bf16, not
    causal and causal; at (2, 100 -> 130, 3, 64) in f32 (lq != lk); at
    head dim 128. Timed at the rank's shape, bf16, not causal (BERT).
    Returns {kernel name: table row}."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    table = {}
    f32_tol, bf16_tol = (1e-5, 1e-4), (4e-3, 2e-2)
    # bf16 gradients: the same rounded ds and p as the plain version, f32
    # sums in another order move a result by one bf16 ulp (<= 2^-7)
    grad_tol = {torch.float32: f32_tol, torch.bfloat16: (1e-3, 1e-2)}
    b, l, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"] // 2, 64

    def make(layout, bb, lq, lk, hh, dd, dtype):
        def rnd(n):
            x = torch.randn((bb, n, hh, dd), generator=g, device=dev)
            x = x.to(dtype)
            return x.transpose(1, 2).contiguous() if layout == "bhld" else x
        return rnd(lq), rnd(lk), rnd(lk), rnd(lq)

    def check(layout, bb, lq, lk, hh, dd, dtype, causal):
        q, k, v, do = make(layout, bb, lq, lk, hh, dd, dtype)
        scale = dd ** -0.5
        shape = (f"b={bb} lq={lq} lk={lk} h={hh} d={dd} {layout} {dtype}"
                 f"{' causal' if causal else ''}").replace("torch.", "")
        o, lse = fa.flash_fwd_heads(q, k, v, scale=scale, causal=causal,
                                    layout=layout)
        ro, rlse = fa.flash_fwd_heads_plain(q, k, v, scale, causal, layout)
        fwd = _agree("flash_fwd_heads", o, ro,
                     f32_tol if dtype == torch.float32 else bf16_tol, shape)
        _agree("flash_fwd_heads (lse)", lse, rlse, f32_tol, shape)
        grads = fa.flash_bwd_heads(q, k, v, o, lse, do, scale=scale,
                                   causal=causal, layout=layout)
        delta = (do.float() * o.float()).sum(-1)
        if layout == "blhd":
            delta = delta.transpose(1, 2)
        ref = fa.flash_bwd_heads_plain(q, k, v, do, lse, delta, scale,
                                       causal, layout)
        rows = [_agree(f"flash_bwd_heads (d{n})", a, r_, grad_tol[dtype],
                       shape) for n, a, r_ in zip("qkv", grads, ref)]
        bwd = dict(rows[0], max_abs_err=max(r_["max_abs_err"]
                                            for r_ in rows))
        return fwd, bwd, (q, k, v, o, lse, do, delta)

    for layout in fa.LAYOUTS:
        worst = {"fwd": 0.0, "bwd": 0.0}
        checked = []
        for case in ((b, l, l, h, d, torch.bfloat16, True),
                     (2, 100, 130, 3, 64, torch.float32, True),
                     (2, 100, 130, 3, 64, torch.float32, False),
                     (2, 70, 33, 2, 128, torch.bfloat16, True),
                     (2, 70, 33, 2, 128, torch.float32, False),
                     (b, l, l, h, d, torch.bfloat16, False)):
            fwd, bwd, args = check(layout, *case)
            worst["fwd"] = max(worst["fwd"], fwd["max_abs_err"])
            worst["bwd"] = max(worst["bwd"], bwd["max_abs_err"])
            checked.append(fwd["shape"])
        # the last case is the rank's shape, bf16, not causal: timed
        q, k, v, o, lse, do, delta = args
        scale = d ** -0.5
        torch.cuda.synchronize()
        esz = q.element_size()
        fwd_bound = _bound(4 * b * l * h * d * esz + b * h * l * 4,
                           4 * b * h * l * l * d, "bfloat16")
        bwd_bound = _bound(8 * b * l * h * d * esz + 2 * b * h * l * 4,
                           10 * b * h * l * l * d, "bfloat16")
        qt, kt, vt, dot = (t.transpose(1, 2) if layout == "blhd" else t
                           for t in (q, k, v, do))
        qt, kt, vt, dot = (t.contiguous() for t in (qt, kt, vt, dot))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        fwd.update(
            max_abs_err=worst["fwd"], checked=checked,
            ms=_time_ms(torch, lambda: fa.flash_fwd_heads(
                q, k, v, scale=scale, layout=layout)),
            plain_ms=_time_ms(torch, lambda: fa.flash_fwd_heads_plain(
                q, k, v, scale, False, layout)),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale)),
            bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
            library="F.scaled_dot_product_attention on (b, h, l, d)")
        bwd.update(
            max_abs_err=worst["bwd"], checked=checked,
            ms=_time_ms(torch, lambda: fa.flash_bwd_heads(
                q, k, v, o, lse, do, scale=scale, layout=layout)),
            plain_ms=_time_ms(torch, lambda: fa.flash_bwd_heads_plain(
                q, k, v, do, lse, delta, scale, False, layout)),
            library_ms=_time_ms(torch, lambda: torch.autograd.grad(
                sdpa_out, (qg, kg, vg), dot, retain_graph=True)),
            bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
            library="SDPA's backward through autograd",
            ms_includes="delta = sum(dO * O) per head in torch (2 kernels: "
                    "the f32 product, the sum) + the dq and dk/dv "
                    "launches")
        table[f"flash_fwd_{layout}"] = fwd
        table[f"flash_bwd_{layout}"] = bwd
        del sdpa_out, qg, kg, vg
    return table


def cumsum_kernels(torch, g):
    """The scan (B9) against its plain version and, to the bit, its
    route's emulation (`cumsum_split_plain`, run on the card in torch's
    elementwise adds), forward and reverse, at (4096, 1024) f32 and bf16
    and (1, 1), (37, 300) ("row") and (3, 1000003) ("split"); timed at the
    kernel table's shapes: (4096, 1024) f32 (the row) and bf16, (3,
    1000003) f32 forward and reverse, (1, 2^24) f32 and (1, 1000003) bf16.
    Returns {"cumsum": table row}."""
    from flexflow_tpu_torch.kernels import reduction

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, worst = [], 0.0
    for shape in ((4096, 1024), (1, 1), (37, 300), (3, 1000003)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            for reverse in (False, True):
                name = (f"R={shape[0]} N={shape[1]} {dtype}"
                        f"{' reverse' if reverse else ''}").replace(
                            "torch.", "")
                worst = max(worst, cumsum_case(torch, reduction, x, reverse,
                                               sms, name))
                rows.append(name)
    row = {"shape": "R=4096 N=1024 float32", "max_abs_err": worst,
           "checked": rows, "emulation_same_bits": True,
           "tolerance": "|err| <= 1e-5 cumsum(|x|) + 1e-6 (+ 2^-7 |plain| "
                        "in bf16)"}
    notes = {}
    for shape, dtype, reverse in (((4096, 1024), torch.float32, False),
                                  ((4096, 1024), torch.bfloat16, False),
                                  ((3, 1000003), torch.float32, False),
                                  ((3, 1000003), torch.float32, True),
                                  ((1, 2 ** 24), torch.float32, False),
                                  ((1, 1000003), torch.bfloat16, False)):
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        n = x.numel()
        bound, by = _bound(2 * n * x.element_size(), n, "float32")
        plan = reduction.cumsum_plan(*shape, dtype, sms)
        t = dict(plan=plan._asdict(),
                 ms=_time_ms(torch, lambda: reduction.cumsum(
                     x, reverse=reverse)),
                 plain_ms=_time_ms(torch, lambda: reduction.cumsum_plain(
                     x, reverse=reverse)),
                 library_ms=_time_ms(torch, lambda: torch.cumsum(x, -1)),
                 bound_ms=bound, bound_by=by,
                 ms_includes=("2 launches (the chunk totals, then the scan "
                              "as a programmatic dependent)"
                              if plan.route == "split" else "1 launch"))
        if not notes:
            row.update(t, library="torch.cumsum along the last axis (the "
                                  "forward scan, also beside the reverse)")
        notes[f"R={shape[0]} N={shape[1]} {dtype}"
              f"{' reverse' if reverse else ''}".replace("torch.", "")] = t
        del x
    row["timed"] = notes
    return {"cumsum": row}


def cumsum_case(torch, reduction, x, reverse, sms, name):
    """cumsum of x within tolerance of its plain version, equal to the bit
    to `cumsum_split_plain` at its plan's chunk, the same bits on two
    calls; returns the largest difference from the plain version."""
    plan = reduction.cumsum_plan(x.numel() // x.shape[-1], x.shape[-1],
                                 x.dtype, sms)
    out = reduction.cumsum(x, reverse=reverse)
    ref = reduction.cumsum_plain(x, reverse=reverse)
    # f32 sums in another order: a few ulps of the running sum of |x|;
    # bf16 one rounding more
    lim = 1e-5 * reduction.cumsum_plain(x.float().abs(), reverse) + 1e-6
    if x.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.float().abs()
    err = (out.float() - ref.float()).abs()
    if out.dtype != x.dtype or not bool((err <= lim).all()):
        raise AssertionError(f"cumsum disagrees with its plain version at "
                             f"{name}: max err {float(err.max())}")
    emu = reduction.cumsum_split_plain(
        x, plan.chunk if plan.route == "split" else None, reverse)
    if not (torch.equal(out, emu)
            and torch.equal(reduction.cumsum(x, reverse=reverse), out)):
        raise AssertionError(f"cumsum at {name} ({plan}): not the bits of "
                             "its emulation, or two calls differ")
    return float(err.max())


def phase_standalone(torch):
    """The public entries no model path calls, driven as a user calls
    them: flash_attention_heads(layout="bhld") forward and backward at the
    TP rank's shape (bf16), fused_cumsum forward and backward at (4096,
    1024) f32 (the "row" route) and cumsum at (3, 1000003) f32 (the
    "split" route), counts from 0; each result finite and equal to its
    plain version's within the kernels phase's tolerances."""
    from flexflow_tpu_torch.kernels import (flash_attention as fa,
                                            launch_counts, reduction,
                                            reset_launch_counts)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(77)
    b, l, h, d = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"] // 2, 64
    q, k, v, do = (torch.randn((b, h, l, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    x = torch.randn((4096, 1024), generator=g, device=dev)
    gx = torch.randn((4096, 1024), generator=g, device=dev)
    long_x = torch.randn((3, 1000003), generator=g, device=dev)
    qg, kg, vg, xg = (t.clone().requires_grad_() for t in (q, k, v, x))
    torch.cuda.synchronize()
    reset_launch_counts()
    o = fa.flash_attention_heads(qg, kg, vg, layout="bhld")
    grads = torch.autograd.grad(o, (qg, kg, vg), do)
    c = reduction.fused_cumsum(xg)
    (dx,) = torch.autograd.grad(c, xg, gx)
    long_c = reduction.cumsum(long_x)
    torch.cuda.synchronize()
    launches = launch_counts()
    wrong = {k_: launches[k_] for k_, n in STANDALONE_LAUNCHES.items()
             if launches[k_] != n}
    if wrong:
        raise AssertionError(f"standalone launches {wrong}, expected "
                             f"{STANDALONE_LAUNCHES}")
    ro, rlse = fa.flash_fwd_heads_plain(q, k, v, d ** -0.5, False, "bhld")
    o, c = o.detach(), c.detach()
    checks = [_agree("flash_attention_heads", o, ro, (4e-3, 2e-2),
                     "bhld bf16")]
    delta = (do.float() * o.float()).sum(-1)
    for n, a, r_ in zip("qkv", grads, fa.flash_bwd_heads_plain(
            q, k, v, do, rlse, delta, d ** -0.5, False, "bhld")):
        checks.append(_agree(f"flash_attention_heads d{n}", a, r_,
                             (1e-3, 1e-2), "bhld bf16"))
    mag = reduction.cumsum_plain(x.abs())
    for name, a, r_, m in (
            ("fused_cumsum", c, reduction.cumsum_plain(x), mag),
            ("fused_cumsum grad", dx, reduction.cumsum_plain(gx, True),
             reduction.cumsum_plain(gx.abs(), True)),
            ("cumsum (3, 1000003) split", long_c,
             reduction.cumsum_plain(long_x), reduction.cumsum_plain(
                 long_x.abs()))):
        err = (a - r_).abs()
        if not (bool(torch.isfinite(a).all())
                and bool((err <= 1e-5 * m + 1e-6).all())):
            raise AssertionError(f"{name} disagrees with its plain version")
        checks.append({"shape": name, "max_abs_err": float(err.max())})
    return {"phase": "standalone", "launches": {k_: launches[k_] for k_ in
                                                STANDALONE_LAUNCHES},
            "checks": checks}


def _tp_jobs():
    """The tp phase's two jobs (flexflow_tpu_torch/tools/tp_train.py)."""
    x, y = _train_batch()
    cx, cy = _cross_batch()
    layers = 2
    train = {"axes": {"model": 2},
             "widths": {"num_layers": TRAIN["layers"]}, "x": x, "y": y,
             "steps": 5, "count_steps": 3, "seed": 0, "mixed": True,
             "adam": (1e-4, "bfloat16")}
    cross = {"axes": {"model": 2}, "widths": {"num_layers": layers},
             "x": cx, "y": cy, "seed": 1, "mixed": False,
             "adam": (1e-4, "bfloat16"), "grad_steps": 2,
             "grad_norms_of": (("tok_emb", "weight"), ("layer0_attn", "wq"),
                               ("layer0_attn", "wv"), ("layer0_ln1", "gamma"),
                               (f"layer{layers - 1}_ln2", "beta"),
                               ("cls", "kernel"))}
    return [train, cross]


def phase_tp(torch, train_losses, cross_card):
    """Two ranks on cuda:0 (tools/tp_train.py run_rank): the full-width
    flagship under model=2 (tp) and the train-cross model under model=2
    (tp-cross). Returns the two phase records and rank 0's launches."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.tools.tp_train import spawn_jobs

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_jobs(2, "cuda", _tp_jobs(), timeout_s=900)
    wall = time.perf_counter() - t0
    tp = [r["jobs"][0] for r in ranks]
    cross = [r["jobs"][1] for r in ranks]
    first = tp[0]
    for i, r in enumerate(tp[1:], 1):
        if r["losses"] != first["losses"]:
            raise AssertionError(f"tp: rank {i} losses {r['losses']} differ "
                                 f"from rank 0's {first['losses']}")
        if r["replicated_digest"] != first["replicated_digest"]:
            raise AssertionError(f"tp: rank {i}'s replicated weights differ "
                                 "from rank 0's after the last step")
    expected = {**TP_PER_STEP, **TP_ROUTES_PER_STEP}
    for i, r in enumerate(tp):
        wrong = {k: r["launches_per_step"][k] for k, n in expected.items()
                 if r["launches_per_step"][k] != n}
        if wrong:
            raise AssertionError(f"tp: rank {i} launches per step {wrong}, "
                                 f"expected {expected}")
    losses = first["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"tp: non-finite loss {losses}")
    rels = [abs(a - c) / abs(c) for a, c in zip(losses[:3],
                                                 train_losses[:3])]
    if max(rels) > 2e-2:
        raise AssertionError(f"tp: losses {losses[:3]} vs one device "
                             f"{train_losses[:3]} (relative {rels})")
    host = ranks[0]["host"]
    record = {
        "phase": "tp", "axes": {"model": 2}, "world_size":
            host["process_count"], "backend": host["backend"],
        "devices": [r["host"]["device"] for r in ranks],
        "host_staging": host["host_staging"],
        "layers": TRAIN["layers"], "steps": len(losses),
        "losses": losses, "one_device_losses": train_losses[:3],
        "max_relative_diff_first3": max(rels),
        "launches_per_step": {k: first["launches_per_step"][k]
                              for k in TP_PER_STEP},
        "routes_per_step": {k: first["launches_per_step"][k]
                            for k in TP_ROUTES_PER_STEP},
        "staged_per_step_rank0": first["staged_per_step"],
        "ms_per_step_rank0": first["ms_per_step"],
        "ms_per_step_note": "two ranks time-sharing one card over a "
                            "host-staged gloo transport: not a TP speed",
        "peak_mem_gib_by_rank": [r["peak_mem_gib"] for r in tp],
        "build_s_by_rank": [r["build_s"] for r in tp],
        "spawn_wall_s": wall,
        "tolerance": "ranks' losses and replicated weights identical; "
                     "|loss - one device| <= 2e-2 |one device|, steps 1-3"}
    for i, r in enumerate(cross[1:], 1):
        if r["steps"] != cross[0]["steps"]:
            raise AssertionError(f"tp-cross: rank {i} differs from rank 0")
    worst = _compare_steps("tp-cross", cross[0]["steps"], cross_card,
                           ("model=2", "one device"), 1e-4)
    record_cross = {
        "phase": "tp-cross", "layers": 2, "dtype": "float32",
        "optimizer": "Adam alpha 1e-4, bf16 moments",
        "tp": cross[0]["steps"], "one_device": cross_card,
        "max_relative_diff": worst,
        "tolerance": "|model=2 - one device| <= 1e-4 |one device| (loss "
                     "and each whole-gradient norm, steps 1 and 2)"}
    launches = {k: int(round(first["launches_per_step"][k] * 3))
                for k in (*TP_KERNELS, "optimizer_adam")}
    return record, record_cross, launches


def _cls_margins(torch, model, x):
    """The classifier's logit gap z1 - z0 per token (min, mean, max) and
    the smallest and largest output probability, through the inference
    walk on the model's current weights."""
    cls = next(op for op in model.ops if op.name == "cls")
    vals = model.executor.forward_values(
        {model.input_ops[0].name: torch.from_numpy(x).to(model.device)})
    z = vals[cls.outputs[0].guid].float()
    p = vals[model.final_tensor.guid].float()
    gap = z[..., 1] - z[..., 0]
    return {"gap_min": float(gap.min()), "gap_mean": float(gap.mean()),
            "gap_max": float(gap.max()), "p_min": float(p.min()),
            "p_max": float(p.max())}


def _train_batch():
    """bench.py `_run`'s batch: tokens and labels from RandomState(0)."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, seq = TRAIN["batch"], TRAIN["seq"]
    x = rng.randint(0, TRAIN["vocab"], size=(b, seq)).astype(np.int32)
    y = rng.randint(0, 2, size=(b, seq, 1)).astype(np.int32)
    return x, y


def phase_train(torch, warmup=3, steps=10):
    """Full-width training through compile and fit; returns the phase's
    record (launches per step among them) and the initial weights on the
    host. The classifier's margins are read before and after the first
    step (outside the timed and counted steps)."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    selected_before = _selections(TRAIN_FAMILIES)
    t0 = time.perf_counter()
    model = build_bench_model("cuda", TRAIN["layers"], True, 0)
    build_s = time.perf_counter() - t0
    init = {op: {w: t.cpu().clone() for w, t in ws.items()}
            for op, ws in model.params.items()}
    n_params = sum(t.numel() for ws in init.values() for t in ws.values())
    b, seq = TRAIN["batch"], TRAIN["seq"]
    x, y = _train_batch()
    margins = [_cls_margins(torch, model, x)]
    # fit returns one summary per epoch (one step each here); the per-step
    # losses and times are its step_records
    model.fit(x, y, batch_size=b, epochs=1)
    warm = list(model.step_records)
    margins.append(_cls_margins(torch, model, x))
    model.fit(x, y, batch_size=b, epochs=warmup - 1)
    warm += model.step_records
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    model.fit(x, y, batch_size=b, epochs=steps)
    hist = model.step_records
    torch.cuda.synchronize()
    launches = launch_counts()
    losses = [r["loss"] for r in warm + hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    expected = {**TRAIN_PER_STEP, **TRAIN_ROUTES_PER_STEP}
    wrong = {k: launches[k] / steps for k, n in expected.items()
             if launches[k] != n * steps}
    if wrong:
        raise AssertionError(f"training path launches per step {wrong}, "
                             f"expected {expected}")
    # the registry's auto policy chose the kernels, and never a reference
    # lowering, on the card
    selected = {k: v - selected_before[k]
                for k, v in _selections(TRAIN_FAMILIES).items()}
    if any(selected[(f, "pallas")] <= 0 or selected[(f, "reference")] != 0
           for f in TRAIN_FAMILIES):
        raise AssertionError(f"kernel registry selections on the training "
                             f"path: {selected}")
    step_ms = np.array([r["step_ms"] for r in hist])
    flops = train_step_flops(**TRAIN)
    med_s = float(np.median(step_ms)) / 1e3
    return {
        "phase": "train", "params": n_params, "model_build_s": build_s,
        "batch": b, "seq": seq, "warmup_steps": warmup, "steps": steps,
        "ms_per_step_median": float(np.median(step_ms)),
        "ms_per_step_mean": float(step_ms.mean()),
        "ms_per_step_min": float(step_ms.min()),
        "samples_per_s": b / med_s,
        "flops_per_step": flops,
        "mfu_bf16_peak": flops / med_s / PEAK_OPS_PER_S["bfloat16"],
        "losses": losses,
        "cls_margins_before_after_step1": margins,
        "launches": launches,
        "launches_per_step": {k: launches[k] / steps for k in TRAIN_KERNELS},
        "routes_per_step": {k: launches[k] / steps
                            for k in TRAIN_ROUTES_PER_STEP},
        "ff_kernel_selected_total": {f"{f}/{i}": v
                                     for (f, i), v in selected.items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }, init


def _selections(families):
    """ff_kernel_selected_total by (family, impl)."""
    from flexflow_tpu_torch.obs import REGISTRY

    fam = REGISTRY.counter(
        "ff_kernel_selected_total",
        "Kernel-tier selections by op family and implementation",
        labels=("op", "impl"))
    return {(f, i): fam.value(op=f, impl=i) for f in families
            for i in ("pallas", "reference")}


def phase_train_witness(torch, init, bf16_losses, steps=3):
    """The train phase's first steps again from the same weights and
    batch, in f32 on the card and in f32 on the CPU (plain versions):
    per-step losses of the card's f32 run against the CPU's within 1e-3
    relative, and of the train phase's bf16 run (bf16 activations, the
    timed path) against the CPU's within 2e-2, the bf16 tolerance of
    tests/test_torch_train.py. Both also use Adam with bf16 moments."""
    import numpy as np

    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    x, y = _train_batch()
    out = {}
    for name, dev, seed in (("card_f32", "cuda", 3), ("cpu_f32", "cpu", 4)):
        t0 = time.perf_counter()
        m = build_bench_model(dev, TRAIN["layers"], False, seed)
        m.load_params(init)
        margins = [_cls_margins(torch, m, x)]
        m.fit(x, y, batch_size=TRAIN["batch"], epochs=1)
        losses = [r["loss"] for r in m.step_records]
        margins.append(_cls_margins(torch, m, x))
        m.fit(x, y, batch_size=TRAIN["batch"], epochs=steps - 1)
        losses += [r["loss"] for r in m.step_records]
        out[name] = {"losses": losses, "cls_margins_before_after_step1":
                     margins, "seconds": time.perf_counter() - t0}
        del m
    worst = {"card_f32": 0.0, "card_bf16": 0.0}
    for name, got, tol in (("card_f32", out["card_f32"]["losses"], 1e-3),
                           ("card_bf16", bf16_losses[:steps], 2e-2)):
        for i, (a, c) in enumerate(zip(got, out["cpu_f32"]["losses"])):
            rel = abs(a - c) / abs(c)
            worst[name] = max(worst[name], rel)
            if not (np.isfinite(a) and rel <= tol):
                raise AssertionError(f"train-witness: step {i + 1} loss "
                                     f"{name} {a} vs cpu_f32 {c}")
    frac0 = float((y == 0).mean())
    return {"phase": "train-witness", "layers": TRAIN["layers"],
            "steps": steps, "card_bf16_losses": bf16_losses[:steps], **out,
            "max_relative_diff": worst,
            "label0_share": frac0,
            # log_softmax of probabilities (p0, p1) = (0, 1) exactly
            "loss_if_sure_of_class": {
                c: float(np.log1p(np.exp(-1.0)) + (frac0 if c else 1 - frac0))
                for c in (0, 1)},
            "tolerance": "|loss - cpu_f32| <= 1e-3 |cpu_f32| (card_f32), "
                         "2e-2 |cpu_f32| (card_bf16), each step"}


def _cross_batch():
    import numpy as np

    rng = np.random.RandomState(5)
    b, seq = TRAIN["batch"], TRAIN["seq"]
    x = rng.randint(0, TRAIN["vocab"], size=(b, seq)).astype(np.int32)
    y = rng.randint(0, 2, size=(b, seq, 1)).astype(np.int32)
    return x, y


def _two_steps(torch, m, x, y, layers):
    """Loss and six gradient norms of two steps of model `m`, one Adam
    update (bf16 moments) between them."""
    gstep = m.executor.build_grad_metrics_step(m.loss.fn, m.metrics,
                                               m.final_tensor)
    inputs = {m.input_ops[0].name: torch.from_numpy(x).to(m.device)}
    label = torch.from_numpy(y).to(m.device)
    out = []
    for step in (1, 2):
        grads, mvals = gstep(inputs, label)
        norms = {f"{op}/{w}": float(grads[op][w].float().norm())
                 for op, w in (("tok_emb", "weight"),
                               ("layer0_attn", "wq"),
                               ("layer0_attn", "wv"),
                               ("layer0_ln1", "gamma"),
                               (f"layer{layers - 1}_ln2", "beta"),
                               ("cls", "kernel"))}
        out.append({"step": step, "loss": float(mvals["loss"]),
                    "grad_norms": norms})
        if step == 1:
            m.optimizer.update(m.executor.parameters(), grads, m.opt_state)
    return out


def _compare_steps(phase, got, want, names, tol):
    """Worst relative difference of loss and norms, step by step; raises
    past `tol` or on a non-finite value."""
    import numpy as np

    worst = 0.0
    for a_rec, b_rec in zip(got, want):
        checks = {"loss": (a_rec["loss"], b_rec["loss"])}
        checks.update({k: (v, b_rec["grad_norms"][k])
                       for k, v in a_rec["grad_norms"].items()})
        for k, (a, c) in checks.items():
            if not np.isfinite(a):
                raise AssertionError(f"{phase}: non-finite {k} ({names[0]}) "
                                     f"at step {a_rec['step']}")
            rel = abs(a - c) / max(abs(c), 1e-30)
            worst = max(worst, rel)
            if rel > tol:
                raise AssertionError(
                    f"{phase}: step {a_rec['step']} {k} {names[0]} {a} vs "
                    f"{names[1]} {c} (relative {rel})")
    return worst


def phase_train_cross(torch, layers=2):
    """Loss and gradient norms of the first two steps, card vs CPU, f32,
    same weights and batch; between them one Adam update (bf16 moments)
    on each side. Each side under auto: the kernels on the card, the
    reference lowerings on the CPU."""
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    gpu = build_bench_model("cuda", layers, False, 1)
    cpu = build_bench_model("cpu", layers, False, 2)
    cpu.load_params({op: {w: t.cpu() for w, t in ws.items()}
                     for op, ws in gpu.params.items()})
    x, y = _cross_batch()
    out = {}
    for name, m in (("card", gpu), ("cpu", cpu)):
        out[name] = _two_steps(torch, m, x, y, layers)
    worst = _compare_steps("train-cross", out["card"], out["cpu"],
                           ("card", "cpu"), 1e-3)
    return {"phase": "train-cross", "layers": layers, "dtype": "float32",
            "optimizer": "Adam alpha 1e-4, bf16 moments",
            "card": out["card"], "cpu": out["cpu"],
            "max_relative_diff": worst,
            "tolerance": "|card - cpu| <= 1e-3 |cpu| (loss and each norm, "
                         "steps 1 and 2)"}


def phase_ref_vs_kernel(torch, layers=2):
    """The flagship at `layers` layers, f32, on the card: two steps (one
    Adam update between) under kernel_impl="pallas" — flash attention,
    the CUDA LayerNorm, softmax and reduction — and under "reference" —
    the einsum core and the reference lowerings — from the same weights
    and batch. Each model is compiled just before its steps: the loss
    reduction reads the knob of the last compile."""
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_bench_model

    x, y = _cross_batch()
    out, launches = {}, {}
    for impl in ("pallas", "reference"):
        m = build_bench_model("cuda", layers, False, 1, kernel_impl=impl)
        torch.cuda.synchronize()
        reset_launch_counts()
        out[impl] = _two_steps(torch, m, x, y, layers)
        torch.cuda.synchronize()
        launches[impl] = launch_counts()
        del m
    missing = [k for k in TRAIN_KERNELS if launches["pallas"][k] == 0]
    ran = {k: n for k, n in launches["reference"].items() if n}
    if missing or ran:
        raise AssertionError(f"ref-vs-kernel: kernels not launched under "
                             f"pallas {missing}, launched under reference "
                             f"{ran}")
    worst = _compare_steps("ref-vs-kernel", out["pallas"], out["reference"],
                           ("pallas", "reference"), 1e-3)
    return {"phase": "ref-vs-kernel", "layers": layers, "dtype": "float32",
            "optimizer": "Adam alpha 1e-4, bf16 moments",
            "pallas": out["pallas"], "reference": out["reference"],
            "launches_pallas": launches["pallas"],
            "max_relative_diff": worst,
            "tolerance": "|pallas - reference| <= 1e-3 |reference| (loss "
                         "and each norm, steps 1 and 2)"}


def phase_tier(torch, steps=3):
    """The kernel-tier graph for `steps` fit steps (one batch each, data
    from RandomState(8)): on the card in bf16 under kernel_impl="pallas"
    and "reference", and on the CPU in f32 (the witness). Launches per
    step under pallas exactly TIER_PER_STEP, none under reference; losses
    within 2e-2 relative of each other and of the witness at every step."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_tier_model

    rng = np.random.RandomState(8)
    b = TRAIN["batch"]
    x = rng.randn(steps * b, TRAIN["seq"], TRAIN["hidden"]).astype(
        np.float32)
    y = rng.randint(0, 10, size=(steps * b, TRAIN["seq"], 1)).astype(
        np.int32)
    out = {}
    for name, device, mixed, impl in (
            ("card_pallas_bf16", "cuda", True, "pallas"),
            ("card_reference_bf16", "cuda", True, "reference"),
            ("cpu_f32", "cpu", False, "auto")):
        m = build_tier_model(device, mixed, impl)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        m.fit(x, y, batch_size=b, epochs=1)
        hist = m.step_records  # `steps` steps in the one epoch
        torch.cuda.synchronize()
        out[name] = {"losses": [r["loss"] for r in hist],
                     "accuracy": [r["accuracy"] for r in hist],
                     "launches": launch_counts(),
                     "seconds": time.perf_counter() - t0}
        del m
    got = out["card_pallas_bf16"]["launches"]
    expected = {**TIER_PER_STEP, **TIER_ROUTES_PER_STEP}
    wrong = {k: got[k] for k, n in expected.items() if got[k] != n * steps}
    extra = {k: n for k, n in got.items() if n and k not in expected}
    ran = {k: n for k, n in out["card_reference_bf16"]["launches"].items()
           if n}
    if wrong or extra or ran:
        raise AssertionError(f"tier: launches under pallas {wrong} {extra} "
                             f"(expected {expected} per step), under "
                             f"reference {ran}")
    worst = {}
    for a, c in (("card_pallas_bf16", "card_reference_bf16"),
                 ("card_pallas_bf16", "cpu_f32"),
                 ("card_reference_bf16", "cpu_f32")):
        rels = [abs(p - q) / abs(q) for p, q in zip(out[a]["losses"],
                                                      out[c]["losses"])]
        worst[f"{a} vs {c}"] = max(rels)
        if len(rels) != steps or not all(np.isfinite(out[a]["losses"])) \
                or max(rels) > 2e-2:
            raise AssertionError(f"tier: losses {a} {out[a]['losses']} vs "
                                 f"{c} {out[c]['losses']}")
    return {"phase": "tier", "shape": [b, TRAIN["seq"], TRAIN["hidden"]],
            "steps": steps, **out,
            "launches_per_step_pallas": {k: got[k] / steps
                                         for k in expected},
            "max_relative_diff": worst,
            "tolerance": "|loss - other| <= 2e-2 |other| at every step"}


def phase_train_graph(torch):
    """The train phase's flagship, from the same initial weights (the
    seed-0 generator) and batch: GRAPH_STEPS steps through
    fit(steps_per_execution=GRAPH_K) (a CUDA graph of GRAPH_K captured
    steps) against as many eager steps; every step's loss and every
    final weight the same bits. Launches counted from 0 before the
    graphed fit: the first dispatch's GRAPH_K steps run eagerly (the
    warm-up) and are captured once, the replays launch nothing from the
    host, so each kernel counts 2 x GRAPH_K x its launches a step. Then
    host wall, device busy and idle a step for K = 1 eager and K =
    GRAPH_K graphed (tools/train_profile.py profile_fit), peak memory of
    each run, MFU."""
    import numpy as np

    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.tools.train_profile import build_bench_model, \
        profile_fit

    b, k, n = TRAIN["batch"], GRAPH_K, GRAPH_STEPS
    x, y = _train_batch()
    xs, ys = np.concatenate([x] * n), np.concatenate([y] * n)
    flops = train_step_flops(**TRAIN)
    runs = {}
    for name, steps_per_execution in (("eager", 1), ("graph", k)):
        model = build_bench_model("cuda", TRAIN["layers"], True, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        model.fit(xs, ys, batch_size=b, epochs=1,
                  steps_per_execution=steps_per_execution)
        torch.cuda.synchronize()
        launches = launch_counts()
        recs = model.step_records
        losses = [v for r in recs for v in r.get("losses", [r["loss"]])]
        run = {"losses": losses, "records": len(recs),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": {kk: launches[kk] for kk in TRAIN_PER_STEP}}
        weights = {f"{op}/{w}": t.detach().cpu()
                   for op, ws in model.params.items() for w, t in ws.items()}
        prof = profile_fit(model, x, y, b, 3 * k, steps_per_execution)
        med = prof["wall_ms_per_step"] / 1e3
        run.update(prof, mfu_bf16_peak=flops / med /
                   PEAK_OPS_PER_S["bfloat16"])
        run.pop("kernels")
        runs[name] = (run, weights)
        del model
        torch.cuda.empty_cache()
    (eager, w_eager), (graph, w_graph) = runs["eager"], runs["graph"]
    if len(eager["losses"]) != n or len(graph["losses"]) != n \
            or not all(np.isfinite(graph["losses"])):
        raise AssertionError(f"train-graph: losses {eager['losses']} vs "
                             f"{graph['losses']}")
    diff = max(abs(a - c) / abs(c) for a, c in zip(graph["losses"],
                                                    eager["losses"]))
    same_weights = all(torch.equal(w_graph[kk], t)
                       for kk, t in w_eager.items())
    if diff != 0.0 or not same_weights:
        raise AssertionError(f"train-graph: the graphed steps differ from "
                             f"the eager ones (loss rel diff {diff}, "
                             f"weights equal: {same_weights})")
    wrong = {kk: graph["launches"][kk] for kk, per in TRAIN_PER_STEP.items()
             if graph["launches"][kk] != 2 * k * per}
    if wrong or eager["launches"]["optimizer_adam"] != n:
        raise AssertionError(f"train-graph: launches {wrong} (expected "
                             f"2 x {k} x {TRAIN_PER_STEP}), eager "
                             f"{eager['launches']}")
    return {"phase": "train-graph", "steps": n, "steps_per_execution": k,
            "eager": eager, "graph": graph,
            "max_relative_loss_diff": diff, "weights_same_bits": True,
            "tolerance": "per-step losses and final weights equal to the "
                         "bit (the same kernels in the same order)",
            "ms_per_step_median": {"eager_k1": eager["ms_per_step_median"],
                                   f"graph_k{k}": graph["ms_per_step_median"]},
            "flops_per_step": flops}


def _synthetic(n=2048, dim=64, classes=10, seed=0):
    """tests/test_mnist_mlp.py `make_synthetic`: a learnable linear task
    from seeded numpy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    w = rng.randn(dim, classes).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)[:, None]


def phase_mlp(torch, epochs=12):
    """The digits gate's MLP (64 -> 128 -> 64 -> 10, RELU, softmax, Adam
    2e-3, batch 64) on make_synthetic's data, on the card: trained eagerly
    and with steps_per_execution=4 from the same weights (every epoch's
    loss within 1e-6 relative: the same steps, the epoch summing a
    dispatch's f32 mean for its four losses), with accum_steps=2 and
    through attached dataloaders (shuffled); each ends with eval accuracy
    > 0.9 on the first 512 samples. Launches per step of the eager run
    asserted (MLP_PER_STEP). Then eval, fit, eval, fit, eval (eager, then
    K=4): each eval after a fit equal to a fresh model's given the
    trained weights."""
    import numpy as np

    from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig,
                                    FFModel, MetricsType, SingleDataLoader)
    from flexflow_tpu_torch.kernels import launch_counts, \
        reset_launch_counts

    x, y = _synthetic()
    bs = 64

    def build():
        m = FFModel(FFConfig(batch_size=bs, device="cuda"))
        t = m.create_tensor([bs, 64])
        t = m.dense(t, 128, ActiMode.AC_MODE_RELU)
        t = m.dense(t, 64, ActiMode.AC_MODE_RELU)
        m.softmax(m.dense(t, 10))
        # weights from compile's default generator (seed 0)
        m.compile(optimizer=AdamOptimizer(m, alpha=2e-3),
                  metrics=[MetricsType.METRICS_ACCURACY,
                           MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
        return m

    out = {}
    for name, kw in (("eager", {}), ("k4", {"steps_per_execution": 4}),
                     ("accum2", {"accum_steps": 2}), ("dataloader", {})):
        m = build()
        if name == "dataloader":
            SingleDataLoader(m, m.input_ops[0].outputs[0], x, shuffle=True,
                             seed=5)
            SingleDataLoader(m, m.label_tensor, y, shuffle=True, seed=5)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = m.fit(None if name == "dataloader" else x,
                     None if name == "dataloader" else y, epochs=epochs,
                     **kw)
        torch.cuda.synchronize()
        launches = launch_counts()
        ev = m.eval(x[:512], y[:512])
        out[name] = {"losses": [h["loss"] for h in hist],
                     "train_accuracy": hist[-1]["accuracy"],
                     "eval": ev, "seconds": time.perf_counter() - t0,
                     "optimizer_steps": int(m.opt_state["step"]),
                     "launches": {kk: launches[kk] for kk in MLP_PER_STEP}}
        if not (ev["accuracy"] > 0.9 and np.all(np.isfinite(
                out[name]["losses"]))):
            raise AssertionError(f"mlp {name}: {out[name]}")
        del m
    steps = epochs * (len(x) // bs)
    wrong = {kk: out["eager"]["launches"][kk] for kk, per in
             MLP_PER_STEP.items()
             if out["eager"]["launches"][kk] != per * steps}
    diff = max(abs(a - c) / abs(c) for a, c in zip(out["k4"]["losses"],
                                                    out["eager"]["losses"]))
    if wrong or diff > 1e-6 or out["accum2"]["optimizer_steps"] != steps // 2:
        raise AssertionError(f"mlp: launches {wrong} (expected "
                             f"{MLP_PER_STEP} x {steps}), K=4 vs eager loss "
                             f"rel diff {diff}, accum2 "
                             f"{out['accum2']['optimizer_steps']} steps")
    # eval, fit, eval, fit, eval: the bf16 casts of the weights that eval
    # reads are cached by weight version (core/op.py Op.w); the update
    # kernel and a graph replay write the weights through raw pointers
    # and bump the versions, so each eval after a fit equals a fresh
    # model's given the trained weights. K=4 over 12 steps: the first fit
    # one captured dispatch and two replays, the second replays only
    refit = {}
    xs, ys, xe, ye = x[:bs * 12], y[:bs * 12], x[:512], y[:512]
    for name, k in (("eager", 1), ("k4", 4)):
        m = build()
        losses = [m.eval(xe, ye)["loss"]]
        for _ in range(2):
            m.fit(xs, ys, epochs=1, steps_per_execution=k)
            after = m.eval(xe, ye)
            fresh = build()
            fresh.load_params(m.params)
            want = fresh.eval(xe, ye)
            if after != want or after["loss"] == losses[-1]:
                raise AssertionError(
                    f"mlp eval-fit-eval ({name}): eval after fit {after}, "
                    f"a fresh model with the trained weights {want}, eval "
                    f"losses before {losses}")
            losses.append(after["loss"])
            del fresh
        refit[name] = {"eval_losses": losses}
        del m
    return {"phase": "mlp", "epochs": epochs, "batch": bs, **out,
            "k4_vs_eager_max_relative_loss_diff": diff,
            "eval_fit_eval": refit,
            "tolerance": "eval accuracy > 0.9 each; K=4 epoch losses within "
                         "1e-6 relative of the eager run's; each eval after a "
                         "fit equal in every key to a fresh model's"}


def _prefill_probs(torch, model, prompt, chunk, max_len):
    """First-token distribution of `prompt`, prefilled chunk by chunk into
    fresh one-slot caches through the executor (the batcher's path)."""
    import numpy as np

    from flexflow_tpu_torch.serving.sched.kvpool import kv_cache_spec

    caches = {name: {var: torch.zeros((1, max_len, h, d), dtype=cdt,
                                      device=model.device)
                     for var in ("k_cache", "v_cache")}
              for name, h, d, _, cdt in kv_cache_spec(model)}
    name = model.input_ops[0].name
    for off in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - off)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n] = prompt[off:off + n]
        vals = model.executor.forward_values(
            {name: torch.from_numpy(toks).to(model.device)}, state=caches,
            decode_pos=off)
    return vals[model.final_tensor.guid][0, n - 1].float().cpu()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import _build, launch_counts, \
        reset_launch_counts
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    t_start = time.perf_counter()
    # 1) device. f32 products in full f32 (no TF32) on both paths; the
    # serving path itself is bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    _emit({"phase": "device", "name": torch.cuda.get_device_name(0),
           "nvidia_smi": card, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2) build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [line.strip() for log in _build.BUILD_INFO.get("ptxas", {}).values()
             for line in log.splitlines()
             if "registers" in line or "Compiling entry" in line]
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "compiled": _build.BUILD_INFO["compiled"], "ptxas": ptxas})

    # 3) kernels
    from flexflow_tpu_torch.kernels import flash_attention as fa
    reset_launch_counts()
    table = phase_kernels(torch, F)
    from flexflow_tpu_torch.kernels import decode as dec
    from flexflow_tpu_torch.kernels import norm, reduction
    _emit({"phase": "kernels", "table": table,
           # the decode and flash calls of this phase by route: tc the
           # bf16 tensor-core kernels, cc the CUDA-core ones; softmax and
           # RMSNorm forward, LayerNorm backward and the reduce by their
           # plans' routes
           "decode_routes": dict(dec.ROUTES),
           "flash_routes": dict(fa.ROUTES),
           "norm_routes": dict(norm.ROUTES),
           "reduce_routes": dict(reduction.ROUTES),
           "flash_tc_ptxas": fa.tc_kernel_report(),
           # empty where this process loaded a library built earlier
           "norm_fwd_ptxas": [
               r for r in _build.ptxas_report("norm.cu")
               if r["kernel"].startswith(("softmax_", "rmsnorm_warp",
                                          "rmsnorm_block", "layernorm_fwd"))
               and not r["kernel"].startswith("softmax_bwd")],
           # layernorm_bwd_warp_kernel<T, V, false> is RMSNorm's backward
           "ln_bwd_ptxas": [
               r for r in _build.ptxas_report("norm.cu")
               if r["kernel"].startswith(("layernorm_bwd", "rmsnorm_bwd",
                                          "ln_column_sums"))],
           # the register and loop routes, and the rows route at the
           # paths' (lanes, values a lane): (2, 1) and (16, 1)
           "softmax_bwd_ptxas": [
               r for r in _build.ptxas_report("norm.cu")
               if r["kernel"].startswith("softmax_bwd_") and (
                   not r["kernel"].startswith("softmax_bwd_rows")
                   or r["kernel"].endswith((", 2, 1>", ", 16, 1>")))],
           "reduce_ptxas": [r for r in _build.ptxas_report("reduction.cu")
                            if r["kernel"].startswith(("reduce_",
                                                       "cumsum_"))]})

    # 4) serve: full width, random weights from a fixed generator
    hidden, heads, layers, vocab, window = 1024, 16, 12, 30522, 512
    num_slots, max_len, page = 8, 1024, 16
    t0 = time.perf_counter()
    lm = build_tiny_lm(num_slots, window, vocab=vocab, hidden=hidden,
                       heads=heads, layers=layers, mixed_precision=True,
                       device="cuda",
                       generator=torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for ws in lm.params.values()
                   for t in ws.values())
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    with ContinuousBatcher(lm, max_len=max_len, num_slots=num_slots,
                           page_size=page) as cb:  # warm-up: cuBLAS init
        cb.submit(rng.randint(0, vocab, size=40), 4).result(timeout=600)
    plens = rng.randint(32, 513, size=16)
    news = rng.randint(32, 65, size=16)
    prompts = [rng.randint(0, vocab, size=int(n)).astype(np.int32)
               for n in plens]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with ContinuousBatcher(lm, max_len=max_len, num_slots=num_slots,
                           page_size=page) as cb:
        reqs = [cb.submit(p, int(n)) for p, n in zip(prompts, news)]
        outs = [r.result(timeout=900) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = cb.stats()
    launches = launch_counts()
    for r, out, n in zip(reqs, outs, news):
        if len(out) != int(n):
            raise AssertionError(f"request {r.id}: {len(out)} tokens, "
                                 f"expected {int(n)}")
        if out.min() < 0 or out.max() >= vocab:
            raise AssertionError(f"request {r.id}: token out of range")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
    # bf16 caches, head dim 64: every decode call on the tensor-core route
    off_route = {k: (launches[k], launches[f"{k}/tc"])
                 for k in ("decode_attention", "multiquery_decode_attention")
                 if launches[f"{k}/tc"] != launches[k]}
    if off_route:
        raise AssertionError(f"decode calls (all, tc) off the tensor-core "
                             f"route on the serving path: {off_route}")
    # the LM head's softmax over the vocabulary, 8 decode rows or 16 rows
    # of a prefill chunk: every call split over a thread-block cluster
    softmax_routes = {k: n for k, n in launches.items()
                      if k.startswith("softmax_fwd/")}
    if softmax_routes["softmax_fwd/cluster"] != launches["softmax_fwd"]:
        raise AssertionError(f"softmax_fwd calls off the cluster route on "
                             f"the serving path: {softmax_routes}")
    # LayerNorm forward over 8 decode rows or 16 rows of a prefill chunk of
    # the hidden width: every call a warp a row
    if launches["layernorm_fwd/warp"] != launches["layernorm_fwd"]:
        raise AssertionError(
            f"layernorm_fwd calls off the warp route on the serving path: "
            f"{launches['layernorm_fwd/warp']} of "
            f"{launches['layernorm_fwd']}")
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    generated = int(sum(len(o) for o in outs))
    serve = {
        "phase": "serve", "params": n_params, "model_build_s": build_s,
        "requests": len(reqs), "prompt_tokens": int(plens.sum()),
        "generated_tokens": generated, "wall_s": wall,
        "tokens_per_s": generated / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_iter_ms": stats["decode_iter_s"] * 1e3,
        "decode_iterations": stats["decode_iterations"],
        "prefill_chunks": stats["prefill_chunks"],
        "decode_routes": {k: launches[k] for k in launches
                          if k.startswith(("decode_attention/",
                                           "multiquery_decode_attention/"))},
        "softmax_routes": softmax_routes,
        "layernorm_fwd_routes": {k: n for k, n in launches.items()
                                 if k.startswith("layernorm_fwd/")},
        "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    _emit(serve)

    # 5) cross-check: the same weights on the CPU, plain versions
    cpu = build_tiny_lm(num_slots, window, vocab=vocab, hidden=hidden,
                        heads=heads, layers=layers, mixed_precision=True,
                        device="cpu",
                        generator=torch.Generator().manual_seed(1))
    cpu.load_params({op: {w: t.cpu() for w, t in ws.items()}
                     for op, ws in lm.params.items()})
    cross = []
    for plen in (40, 75):
        prompt = rng.randint(0, vocab, size=plen).astype(np.int32)
        p_gpu = _prefill_probs(torch, lm, prompt, page, 128)
        p_cpu = _prefill_probs(torch, cpu, prompt, page, 128)
        if not (torch.isfinite(p_gpu).all() and p_gpu.shape == (vocab,)):
            raise AssertionError("non-finite or misshapen probabilities")
        err = float((p_gpu - p_cpu).abs().max())
        tol = 0.05 * float(p_cpu.max())
        cross.append({"prompt_len": plen, "max_abs_err": err,
                      "tolerance": tol, "max_prob": float(p_cpu.max()),
                      "sum": float(p_gpu.sum()),
                      "argmax_agrees": int(p_gpu.argmax()) == int(
                          p_cpu.argmax())})
        if err > tol:
            raise AssertionError(f"card vs CPU first-token probabilities: "
                                 f"{cross[-1]}")
    _emit({"phase": "cross", "checks": cross,
           "tolerance": "max|p_card - p_cpu| <= 0.05 * max(p_cpu)",
           "seconds_since_start": time.perf_counter() - t_start})

    # 6) train, 7) train-witness, 8) train-cross
    train, init = phase_train(torch)
    _emit(train)
    _emit(dict(phase_train_witness(torch, init, train["losses"]),
               seconds_since_start=time.perf_counter() - t_start))
    del init
    train_cross = phase_train_cross(torch)
    _emit(dict(train_cross,
               seconds_since_start=time.perf_counter() - t_start))

    # 9) tier, 10) ref-vs-kernel
    tier = phase_tier(torch)
    _emit(dict(tier, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(phase_ref_vs_kernel(torch),
               seconds_since_start=time.perf_counter() - t_start))

    # 11) standalone, 12) tp, 13) tp-cross
    standalone = phase_standalone(torch)
    _emit(dict(standalone, seconds_since_start=time.perf_counter() - t_start))
    tp, tp_cross, tp_launches = phase_tp(torch, train["losses"],
                                         train_cross["card"])
    _emit(dict(tp, seconds_since_start=time.perf_counter() - t_start))
    _emit(dict(tp_cross, seconds_since_start=time.perf_counter() - t_start))

    # 14) train-graph, 15) mlp
    train_graph = phase_train_graph(torch)
    _emit(dict(train_graph, seconds_since_start=time.perf_counter() - t_start))
    mlp = phase_mlp(torch)
    _emit(dict(mlp, seconds_since_start=time.perf_counter() - t_start))

    # 16) the kernel table, the card, the result. A kernel's launches are
    # those of the path(s) that run it (serve, train, tier, standalone, tp
    # on rank 0, train-graph's graphed fit, mlp's eager fit), each counted
    # from 0 just before its path ran
    src = "flexflow_tpu_torch/csrc/"
    replaces = {
        "decode_attention": "flexflow_tpu/kernels/pallas/decode.py:130",
        "multiquery_decode_attention":
            "flexflow_tpu/kernels/pallas/decode.py:130",
        "layernorm_fwd": "flexflow_tpu/kernels/pallas/norm.py:98",
        "softmax_fwd": "flexflow_tpu/kernels/pallas/norm.py:369",
        "flash_fwd": "flexflow_tpu/kernels/flash_attention.py:256",
        "flash_bwd": "flexflow_tpu/kernels/flash_attention.py:412",
        "layernorm_bwd": "flexflow_tpu/kernels/pallas/norm.py:130",
        "softmax_bwd": "flexflow_tpu/kernels/pallas/norm.py:369",
        "rmsnorm_fwd": "flexflow_tpu/kernels/pallas/norm.py:251",
        "rmsnorm_bwd": "flexflow_tpu/kernels/pallas/norm.py:274",
        "reduce": "flexflow_tpu/kernels/pallas/reduction.py:52",
        "flash_fwd_blhd": "flexflow_tpu/kernels/flash_attention.py:110",
        "flash_bwd_blhd": "flexflow_tpu/kernels/flash_attention.py:613",
        "flash_fwd_bhld": "flexflow_tpu/kernels/flash_attention.py:110",
        "flash_bwd_bhld": "flexflow_tpu/kernels/flash_attention.py:613",
        "cumsum": "flexflow_tpu/kernels/pallas/reduction.py:127",
        # no Pallas kernel: the JAX update, which XLA fuses
        "optimizer_adam": "flexflow_tpu/runtime/optimizers.py:110",
        "optimizer_sgd": "flexflow_tpu/runtime/optimizers.py:53",
    }
    # the flash rows: timed in bf16, the tensor-core kernels; their f32
    # route runs the CUDA-core kernels of flash_attention.cu
    flash_tc = src + "flash_attention_tc.cu"
    sources = {"decode_attention": src + "decode_attention.cu",
               "multiquery_decode_attention": src + "decode_attention.cu",
               "flash_fwd": flash_tc, "flash_bwd": flash_tc,
               "reduce": src + "reduction.cu",
               "flash_fwd_blhd": flash_tc, "flash_bwd_blhd": flash_tc,
               "flash_fwd_bhld": flash_tc, "flash_bwd_bhld": flash_tc,
               "cumsum": src + "reduction.cu",
               "optimizer_adam": src + "optimizer.cu",
               "optimizer_sgd": src + "optimizer.cu"}
    kernels = []
    for name in replaces:
        by_path = {}
        if name in SERVE_KERNELS:
            by_path["serve"] = launches[name]
        if name in TRAIN_KERNELS:
            by_path["train"] = train["launches"][name]
        if name in TIER_KERNELS:
            by_path["tier"] = tier["card_pallas_bf16"]["launches"][name]
        if name in STANDALONE_KERNELS:
            by_path["standalone"] = standalone["launches"][name]
        if name in TP_KERNELS or name == "optimizer_adam":
            by_path["tp"] = tp_launches[name]
        if name in TRAIN_PER_STEP:
            by_path["train-graph"] = train_graph["graph"]["launches"][name]
        if name in MLP_PER_STEP:
            by_path["mlp"] = mlp["eager"]["launches"][name]
        row = dict(
            name=name, route="cuda", source=sources.get(name, src + "norm.cu"),
            replaces=replaces[name], launches=sum(by_path.values()),
            launches_by_path=by_path, **table[name])
        if name.startswith("flash_"):
            row["f32_source"] = src + "flash_attention.cu"
        kernels.append(row)
    _emit({"kernels": kernels})
    print(_card_line(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
