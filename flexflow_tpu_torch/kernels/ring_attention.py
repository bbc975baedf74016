"""Ring attention over a mesh axis (counterpart of
flexflow_tpu/kernels/ring_attention.py).

q, k and v are this rank's blocks of the sequence, (B, L/s, H, D), cut
over the `seq` axis of s ranks. The rank attends its q block to the K/V
block it holds, then rotates K and V one step around the ring
(runtime/collectives.py `ppermute`, coordinate i to i + 1) and attends
the next, s - 1 rotations in all, merging the blocks' contributions
with the online softmax in f32. JAX's guard for fully masked rows is
kept (a row max of -inf contributes nothing), and so are its causal
offsets: the q block at idx * L/s, the held K/V block, which came from
coordinate src = idx - i after i rotations, at src * L/s.

The block core is two einsums outside any kernel, as in the JAX package
(`torch.matmul` here). The backward is autograd's through the ring: the
rotations' backward is the opposite rotation. K and V rotate as one
tensor (concatenated on the last dim), one collective a step. The row
maxima are taken outside autograd: the merged softmax does not depend
on them, so their gradient is zero in exact arithmetic.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..runtime.collectives import ppermute


def _block_attend(q, k, v, scale, q_offset: int, k_offset: int,
                  causal: bool):
    """One block's unnormalised softmax: numerator (B, Lq, H, Dv), row max
    (B, H, Lq) and row sum (B, H, Lq), in f32 (JAX `_block_attend`)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(lq, device=q.device)[:, None]
        kpos = k_offset + torch.arange(lk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, -math.inf)
    with torch.no_grad():
        m = logits.amax(dim=-1)
        m_safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(torch.isinf(logits), 0.0, p)
    lsum = p.sum(dim=-1)
    num = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return num, m, lsum


def ring_attention(q, k, v, mesh, axis: str = "seq", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """This rank's output block (B, L/s, H, Dv) of attention over the whole
    sequence, from its q, k, v blocks (see the module docstring)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, idx = mesh.size(axis), mesh.index(axis)
    b, lq, h, _ = q.shape
    dk, lk = k.shape[-1], k.shape[1]
    acc = torch.zeros((b, lq, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, h, lq), -math.inf, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    kv = torch.cat([k, v], dim=-1)
    for i in range(s):
        src = (idx - i) % s
        num, m_blk, l_blk = _block_attend(q, kv[..., :dk], kv[..., dk:],
                                          scale, idx * lq, src * lk, causal)
        with torch.no_grad():
            m_new = torch.maximum(m, m_blk)
            m_new_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            corr_old = torch.where(torch.isinf(m), 0.0,
                                   torch.exp(m - m_new_safe))
            corr_blk = torch.where(torch.isinf(m_blk), 0.0,
                                   torch.exp(m_blk - m_new_safe))
        lsum = lsum * corr_old + l_blk * corr_blk
        acc = (acc * corr_old.transpose(1, 2)[..., None]
               + num * corr_blk.transpose(1, 2)[..., None])
        m = m_new
        if i < s - 1:
            kv = ppermute(kv, mesh, axis, 1)
    denom = torch.clamp(lsum, min=1e-20).transpose(1, 2)[..., None]
    return (acc / denom).to(q.dtype)
