#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure propagates and exits non-zero:
 1. device  — require CUDA, print the card's name and power limit, set
              and print the TF32 flags;
 2. build   — compile the port's CUDA kernels from csrc/ and time it;
 3. kernels — hold every kernel of the serving path against its plain
              PyTorch version on the card, at the shapes the serving path
              gives it, and time kernel, plain version and one library
              call beside the least time the card could take;
 4. serve   — the full-width serve-bench LM (hidden 1024, 16 heads,
              12 layers, vocab 30522, window 512; random weights from a
              fixed generator, bf16 mixed precision) through
              ContinuousBatcher(num_slots=8, max_len=1024, page_size=16):
              16 requests, prompts of 32-512 tokens, 32-64 new tokens
              each; every request must finish with exactly its token
              count and every kernel must have launched;
 5. cross   — the first token's probabilities for two prompts on the card
              against the port on the CPU (plain versions), same weights.

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
        out = fn(q, kc, vc, pos, scale=scale, block_k=512)
        ref = decode.decode_attention_plain(q, kc, vc, pos, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= tol[0] + tol[1] * ref.float().abs()).all())
        row = {"shape": f"B={b} C={c} M={M} h={H} d={D} {dtype}".replace(
            "torch.", ""), "max_abs_err": float(err.max()),
            "tolerance": f"|err| <= {tol[0]} + {tol[1]}*|plain|"}
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
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {row['shape']}: {row}")
        if timed:
            bound, by = _bound(nbytes, ops, "bfloat16")
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
    del flush_buf
    return table


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
    table = phase_kernels(torch, F)
    _emit({"phase": "kernels", "table": table})

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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
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

    # 6) the kernel table, the card, the result
    src = "flexflow_tpu_torch/csrc/"
    replaces = {
        "decode_attention": "flexflow_tpu/kernels/pallas/decode.py:115",
        "multiquery_decode_attention":
            "flexflow_tpu/kernels/pallas/decode.py:115",
        "layernorm_fwd": "flexflow_tpu/kernels/pallas/norm.py:98",
        "softmax_fwd": "flexflow_tpu/kernels/pallas/norm.py:369",
    }
    sources = {"decode_attention": src + "decode_attention.cu",
               "multiquery_decode_attention": src + "decode_attention.cu",
               "layernorm_fwd": src + "norm.cu",
               "softmax_fwd": src + "norm.cu"}
    kernels = [dict(name=name, route="cuda", source=sources[name],
                    replaces=replaces[name], launches=launches[name],
                    **table[name]) for name in replaces]
    _emit({"kernels": kernels})
    print(_card_line(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
