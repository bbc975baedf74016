"""Decode attention over the slot-dense KV cache: CUDA kernel and plain version.

Replaces flexflow_tpu/kernels/pallas/decode.py `_call_decode` through its
two entries, `fused_decode_attention` (C = 1, every decode iteration) and
`fused_multiquery_decode_attention` (C >= 1, every chunked-prefill chunk).
The kernel is csrc/decode_attention.cu. On the card it is bound by the
bytes of the cache rows it reads (a quarter of an operation per byte at
C = 1); its design stops each slot at the last row its queries may
attend and stages those rows through shared memory in 16-byte chunks,
one block per (query tile, head, slot).

Layouts as in the JAX package: q (B, C, h, d) projections of the tokens
at positions pos[b] + j, caches (B, M, h, d) ALREADY written at those
rows, pos (B,) int32. Query j of slot b attends rows k <= pos[b] + j.
Output (B, C, h, d) in q's dtype.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build

NEG_INF = -1e30
# cache rows per shared-memory tile: two f32 tiles of 64 x (d + 1) plus the
# query tile fit the default 48 KB at d = 64
MAX_TILE_K = 64

# kernel launches per wrapper, a plain count the serving path is read by
LAUNCHES: Dict[str, int] = {"decode_attention": 0,
                            "multiquery_decode_attention": 0}


def decode_attention_plain(q, k_cache, v_cache, pos, scale: float):
    """The reference: the (B, h, C, M) logits written out, as the JAX
    package's einsum lowering (ops/attention.py `_decode_step`) does.
    Scores and softmax in f32; probabilities and V rounded to q's dtype
    before the product, as the TPU kernel does."""
    b, c = q.shape[0], q.shape[1]
    m = k_cache.shape[1]
    dt = q.dtype
    qpos = pos.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    mask = (torch.arange(m, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None, :, :]            # (B, 1, C, M)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.to(dt).float()) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt).float(),
                       v_cache.to(dt).float())
    return out.to(dt)


def _check(q, k_cache, v_cache, pos):
    if q.dim() != 4:
        raise ValueError(
            f"q must be (B, C, heads, head_dim), got shape {tuple(q.shape)}")
    b, c, h, d = q.shape
    if c < 1:
        raise ValueError(f"need >= 1 query token per slot, got q {q.shape}")
    if (k_cache.dim() != 4 or k_cache.shape[0] != b
            or tuple(k_cache.shape[2:]) != (h, d)):
        raise ValueError(
            f"k_cache must be (B={b}, M, {h}, {d}), got "
            f"{tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache {tuple(v_cache.shape)} != k_cache "
                         f"{tuple(k_cache.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if k_cache.dtype != v_cache.dtype:
        raise TypeError(f"k_cache {k_cache.dtype} != v_cache "
                        f"{v_cache.dtype}")
    devices = {t.device for t in (q, k_cache, v_cache, pos)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {devices}")


def _decode(name, q, k_cache, v_cache, pos, scale, block_k):
    _check(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    for tname, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                     ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    b, c, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    tile_k = max(1, min(int(block_k), MAX_TILE_K))
    with torch.cuda.device(q.device):
        err = lib.ff_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), b, c, k_cache.shape[1], h, d,
            float(scale), tile_k, _build.DTYPE_CODES[q.dtype],
            _build.DTYPE_CODES[k_cache.dtype], _build.stream_ptr(q.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


def decode_attention(q, k_cache, v_cache, pos, *, scale: float,
                     block_k: int = 512):
    """One decode step for every slot: q (B, 1, h, d). `block_k` caps the
    cache rows the kernel stages per tile (at most MAX_TILE_K)."""
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError(
            f"decode_attention takes one query token per slot, got "
            f"C={q.shape[1]}; use multiquery_decode_attention")
    return _decode("decode_attention", q, k_cache, v_cache, pos, scale,
                   block_k)


def multiquery_decode_attention(q, k_cache, v_cache, pos, *, scale: float,
                                block_k: int = 512):
    """C query tokens per slot in one launch: q (B, C, h, d), query j of
    slot b at position pos[b] + j — the chunk-offset prefill entry."""
    return _decode("multiquery_decode_attention", q, k_cache, v_cache, pos,
                   scale, block_k)
