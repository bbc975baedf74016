"""Flash attention on packed (b, l, heads * d) tensors: CUDA kernels,
plain versions and the autograd Function.

`flash_fwd` replaces flexflow_tpu/kernels/flash_attention.py
`_flash_fwd_packed`, `flash_bwd` replaces `_flash_bwd_packed` (its dq and
dk/dv kernels), and `flash_attention` is the counterpart of
`flash_attention_packed` with its custom VJP. The kernels are
csrc/flash_attention.cu. At the training shapes they are bound by
operations (4 b h l^2 d flops forward, 10 b h l^2 d backward); the design
is one block per (query tile, head, batch row) with an f32 online softmax
over key tiles in shared memory (forward, dq) and one per (key tile,
head, batch row) streaming query tiles (dk, dv).

Layouts as in the JAX package: q (b, lq, h*d), k and v (b, lk, h*d), the
heads packed in the trailing axis; o in q's dtype, lse (b, lq, h) f32.
Causal masking keeps key j for query i when j <= i + (lk - lq).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from . import _build

NEG_INF = -1e30
# query / key rows per shared-memory tile: at d = 64 the forward's three
# f32 tiles and the score tile take 66 KB of the 227 KB a block may use
MAX_TILE = 64
MAX_HEAD_DIM = 128

# kernel launches per wrapper (flash_bwd's dq and dk/dv launches count
# once), a plain count the training path is read by
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd": 0}


def _heads(x, heads: int):
    """(b, l, h*d) -> (b, h, l, d) view."""
    b, l, e = x.shape
    return x.reshape(b, l, heads, e // heads).transpose(1, 2)


def _unheads(x):
    """(b, h, l, d) -> (b, l, h*d)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _mask(lq: int, lk: int, causal: bool, device):
    """(lq, lk) bool of the kept scores, or None when every score is kept."""
    if not causal:
        return None
    qi = torch.arange(lq, device=device)[:, None]
    kj = torch.arange(lk, device=device)[None, :]
    return kj <= qi + (lk - lq)


def flash_fwd_plain(q, k, v, heads: int, scale: float, causal: bool):
    """(o, lse) with the whole (lq, lk) score matrix written out: scores,
    max, exp and sum in f32, masked scores -1e30, p rounded to v's dtype
    before p.v, the `l == 0` guard, lse = m + log(l) — the single-block
    branch of `_fwd_kernel_packed`."""
    dt = q.dtype
    qh, kh, vh = (_heads(t, heads).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale      # (b, h, lq, lk)
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), vh) / l_safe
    lse = (m + torch.log(l_safe))[..., 0].transpose(1, 2)   # (b, lq, h)
    return _unheads(o).to(dt), lse.contiguous()


def flash_bwd_plain(q, k, v, do, lse, delta, heads: int, scale: float,
                    causal: bool):
    """(dq, dk, dv) from the recomputed probabilities, as
    `_bwd_dq_kernel_packed` / `_bwd_dkv_kernel_packed`: p = exp(s - lse)
    (masked p = 0), ds = p * (do.v - delta), p and ds rounded to the stored
    dtype before each product, dq and dk scaled once at the end."""
    dt = q.dtype
    qh, kh, vh, doh = (_heads(t, heads).float() for t in (q, k, v, do))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = (p * (dp - delta.transpose(1, 2)[..., None])).to(dt).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    return tuple(_unheads(t).to(dt) for t in (dq, dk, dv))


def _check(name, heads, q, k, v, *more):
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name}: {tname} must be (b, l, heads*d), got "
                             f"shape {tuple(t.shape)}")
    b, lq, e = q.shape
    if heads < 1 or e % heads:
        raise ValueError(f"{name}: embed dim {e} not divisible by heads "
                         f"{heads}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != e:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be ({b}, lk, {e})")
    if lq < 1 or k.shape[1] < 1:
        raise ValueError(f"{name}: need lq >= 1 and lk >= 1, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for tname, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}, q is {q.dtype}")
    devices = {t.device for t in (q, k, v, *more)}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices: {devices}")
    dev = q.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if e // heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {e // heads} > {MAX_HEAD_DIM}, "
                         "the kernel's largest")
    if not all(t.is_contiguous() for t in (q, k, v, *more)):
        raise ValueError(f"{name}: operands must be contiguous")
    return True


def _tiles(block_q: int, block_k: int):
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q {block_q} and block_k {block_k} must be "
                         ">= 1")
    return min(int(block_q), MAX_TILE), min(int(block_k), MAX_TILE)


def flash_fwd(q, k, v, heads: int, *, scale: float, causal: bool = False,
              block_q: int = MAX_TILE, block_k: int = MAX_TILE):
    """(o, lse): softmax(q k^T * scale) v per head. `block_q` / `block_k`
    cap the kernel's query and key tiles (at most MAX_TILE rows)."""
    on_card = _check("flash_fwd", heads, q, k, v)
    bq, bk = _tiles(block_q, block_k)
    if not on_card:
        return flash_fwd_plain(q, k, v, heads, scale, causal)
    b, lq, e = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, lq, heads), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.ff_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, lq, k.shape[1], heads, e // heads,
            float(scale), int(bool(causal)), bq, bk,
            _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd(q, k, v, o, lse, do, heads: int, *, scale: float,
              causal: bool = False, block_q: int = MAX_TILE,
              block_k: int = MAX_TILE):
    """(dq, dk, dv) for the cotangent `do` of o = flash_fwd(q, k, v)[0].
    delta = sum_d do * o per head is one f32 torch reduction here, outside
    the kernel, as the JAX package computes it."""
    on_card = _check("flash_bwd", heads, q, k, v, o, lse, do)
    bq, bk = _tiles(block_q, block_k)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)}")
    b, lq, e = q.shape
    if tuple(lse.shape) != (b, lq, heads) or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: lse must be ({b}, {lq}, {heads}) "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")
    delta = (do.float() * o.float()).reshape(b, lq, heads, e // heads).sum(-1)
    do = do.to(q.dtype)
    if not on_card:
        return flash_bwd_plain(q, k, v, do, lse, delta, heads, scale, causal)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.ff_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, lq, k.shape[1], heads, e // heads, float(scale),
            int(bool(causal)), bq, bk, _build.DTYPE_CODES[q.dtype],
            _build.stream_ptr(q.device))
    _build.check(err, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse), as the JAX custom VJP's forward rule."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, causal, block_q, block_k):
        o, lse = flash_fwd(q, k, v, heads, scale=scale, causal=causal,
                           block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (heads, scale, causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        heads, scale, causal, block_q, block_k = ctx.args
        dq, dk, dv = flash_bwd(q, k, v, o, lse, g.contiguous(), heads,
                               scale=scale, causal=causal, block_q=block_q,
                               block_k=block_k)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, num_heads: int, *,
                    scale: Optional[float] = None, causal: bool = False,
                    block_q: int = MAX_TILE, block_k: int = MAX_TILE):
    """Flash attention on packed (b, l, num_heads*head_dim) tensors with
    its backward through the kernels (counterpart of
    `flash_attention_packed`). Returns the context in q's layout."""
    e = q.shape[-1]
    if e % num_heads:
        raise ValueError(f"embed dim {e} not divisible by heads {num_heads}")
    if scale is None:
        scale = 1.0 / math.sqrt(e // num_heads)
    return _FlashAttention.apply(q, k, v, int(num_heads), float(scale),
                                 bool(causal), int(block_q), int(block_k))
