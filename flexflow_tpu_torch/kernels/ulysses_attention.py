"""Ulysses (all-to-all) sequence parallelism for attention (counterpart
of flexflow_tpu/kernels/ulysses_attention.py).

q, k and v are this rank's blocks of the sequence, (B, L/s, H, D), cut
over the `seq` axis of s ranks. One tiled all-to-all
(runtime/collectives.py `all_to_all`: the heads split over the ranks,
the positions concatenated) gives each rank the whole sequence for H/s
of the heads, (B, L, H/s, D); the rank attends them exactly, and a
second all-to-all restores the sequence cut. The backward of each
all-to-all is the opposite one.

The local core is the port's flash kernel (B1: `flash_attention` on the
packed (B, L, H/s * D) view, a free reshape), where the attention op's
`_use_flash` chooses it, or the JAX package's einsum core: f32 logits
times the scale, the causal mask tril(ones(lq, lk), lk - lq) at -1e30,
an f32 softmax, the context product in v's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..runtime.collectives import all_to_all
from .flash_attention import flash_attention


def check_ulysses(heads: int, seq_len: int, axis_size: int,
                  axis_name: str = "seq") -> None:
    """JAX `ulysses_attention_sharded`'s errors: the heads and the global
    sequence length must divide over the axis."""
    if heads % axis_size:
        raise ValueError(
            f"ulysses attention needs num_heads ({heads}) divisible by "
            f"the '{axis_name}' axis size ({axis_size}); use ring attention "
            "for head counts that don't divide")
    if seq_len % axis_size:
        raise ValueError(
            f"sequence length {seq_len} not divisible by '{axis_name}' "
            f"axis size {axis_size}")


def ulysses_attention(q, k, v, mesh, axis: str = "seq",
                      causal: bool = False, scale: Optional[float] = None,
                      use_flash: bool = False, block_q: int = 512,
                      block_k: int = 512) -> torch.Tensor:
    """This rank's output block (B, L/s, H, D) of attention over the whole
    sequence, from its q, k, v blocks (see the module docstring)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    check_ulysses(q.shape[2], q.shape[1] * mesh.size(axis), mesh.size(axis),
                  axis)

    def to_heads(x):
        return all_to_all(x, mesh, axis, split=2, concat=1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)  # (B, L, H/s, D)
    b, lq, hh, d = qh.shape
    if use_flash:
        ctx = flash_attention(qh.flatten(2), kh.flatten(2), vh.flatten(2),
                              hh, scale=scale, causal=causal,
                              block_q=block_q, block_k=block_k
                              ).reshape(b, lq, hh, vh.shape[-1])
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                              kh.float()) * scale
        if causal:
            lk = kh.shape[1]
            mask = torch.ones((lq, lk), dtype=torch.bool,
                              device=q.device).tril(lk - lq)
            logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(vh.dtype), vh)
    return all_to_all(ctx.to(q.dtype), mesh, axis, split=1, concat=2)
