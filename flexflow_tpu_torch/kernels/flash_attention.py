"""Flash attention: CUDA kernels, plain versions and the autograd
Functions, in the JAX package's two layout families.

Packed (b, l, heads * d), lse (b, lq, heads): `flash_fwd` replaces
flexflow_tpu/kernels/flash_attention.py `_flash_fwd_packed`, `flash_bwd`
replaces `_flash_bwd_packed` (its dq and dk/dv kernels), and
`flash_attention` is the counterpart of `flash_attention_packed` with its
custom VJP: the one-device attention op's path.

Head-separated, layout "blhd" (b, l, h, d) or "bhld" (b, h, l, d), lse
(b, h, lq): `flash_fwd_heads` replaces `_flash_fwd`, `flash_bwd_heads`
replaces `_flash_bwd` (`_bwd_dq_kernel`, `_bwd_dkv_kernel`), and
`flash_attention_heads` is the counterpart of `flash_attention(layout=)`
with the custom VJP of `_flash_attention_bhld`: the path of attention
with its heads sharded over a tensor-parallel mesh (ops/attention.py).
The JAX blhd wrapper transposes to bhld around its kernel; here the
kernel takes each tensor's batch, row and head strides, so neither
layout is copied.

Both families run the same kernels, and the C entry picks the route by
dtype (`flash_route` is the rule, with no CUDA call in it):
  - bf16, the training path's dtype under mixed precision, runs the
    tensor-core kernels of csrc/flash_attention_tc.cu: `wgmma` on 64-row
    warpgroup tiles fed by TMA through rings of shared-memory stages,
    the online softmax in registers. TMA needs every operand's base
    address 16-byte aligned and each stride but the head dim's a
    multiple of 16 bytes; a bf16 CUDA tensor that breaks this raises
    ValueError (it is never sent to another kernel). Tiles are 64 rows
    (a warpgroup's), up to 128.
  - f32 runs the CUDA-core kernels of csrc/flash_attention.cu: a
    tensor-core product in f32 is TF32, about three decimal digits,
    short of the f32 tolerances its users hold (1e-5 + 1e-4 relative on
    the kernels; 1e-3 and 1e-4 on the cross runs). Tiles of at most 64.
`block_q` / `block_k` (FFConfig.flash_block_q/k, default 512) cap the
query and key tiles on either route: on the f32 route at MAX_TILE rows,
on the bf16 route rounded up to TC_TILE and at most TC_MAX_TILE.
`LAUNCHES` counts launches per wrapper, `ROUTES` per wrapper and route
("flash_fwd/tc", "flash_fwd/cc", ...). o is in q's dtype, lse f32.
Causal masking keeps key j for query i when j <= i + (lk - lq).

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. The kernels read any strides
but need the head dim contiguous (stride 1): a wrapper raises on any
other, and the one copy the autograd Functions make is of a cotangent
that arrives with another stride, in their backward.
"""
from __future__ import annotations

import ctypes
import math
import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

NEG_INF = -1e30
# f32 route: query / key rows per shared-memory tile; at d = 64 the
# forward's three f32 tiles and the score tile take 66 KB of the 227 KB a
# block may use. block_q / block_k cap the tiles at this.
MAX_TILE = 64
# bf16 route: tiles come in multiples of a warpgroup's 64 rows (the
# `wgmma` M), up to 128; block_q / block_k are rounded up to TC_TILE and
# capped at TC_MAX_TILE
TC_TILE = 64
TC_MAX_TILE = 128
MAX_HEAD_DIM = 128
# TMA's rules for a tensor it loads: base address and every stride (of a
# dim longer than 1) in bytes a multiple of this
TMA_ALIGN = 16

LAYOUTS = ("blhd", "bhld")

# kernel launches per wrapper (a backward's dq and dk/dv launches count
# once), the head-separated ones per layout: plain counts the training
# paths are read by
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd": 0,
                            "flash_fwd_blhd": 0, "flash_fwd_bhld": 0,
                            "flash_bwd_blhd": 0, "flash_bwd_bhld": 0}
# the same launches by route: "tc" the bf16 tensor-core kernels, "cc" the
# f32 CUDA-core ones
ROUTES: Dict[str, int] = {f"{name}/{route}": 0 for name in LAUNCHES
                          for route in ("tc", "cc")}


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


def _fwd_math(qh, kh, vh, scale: float, causal: bool, pdt):
    """(o f32, lse f32) of f32 (b, h, l, d) operands, p rounded to `pdt`."""
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale      # (b, h, lq, lk)
    mask = _mask(qh.shape[2], kh.shape[2], causal, qh.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.matmul(p.to(pdt).float(), vh) / l_safe
    return o, (m + torch.log(l_safe))[..., 0]               # lse (b, h, lq)


def _bwd_math(qh, kh, vh, doh, lse, delta, scale: float, causal: bool, dt):
    """(dq, dk, dv) f32 of f32 (b, h, l, d) operands; lse and delta
    (b, h, lq); p and ds rounded to `dt` before each product."""
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    mask = _mask(qh.shape[2], kh.shape[2], causal, qh.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), doh)
    return dq, dk, dv


def flash_fwd_plain(q, k, v, heads: int, scale: float, causal: bool):
    """(o, lse) with the whole (lq, lk) score matrix written out: scores,
    max, exp and sum in f32, masked scores -1e30, p rounded to v's dtype
    before p.v, the `l == 0` guard, lse = m + log(l) — the single-block
    branch of `_fwd_kernel_packed`."""
    qh, kh, vh = (_heads(t, heads).float() for t in (q, k, v))
    o, lse = _fwd_math(qh, kh, vh, scale, causal, v.dtype)
    return _unheads(o).to(q.dtype), lse.transpose(1, 2).contiguous()


def flash_bwd_plain(q, k, v, do, lse, delta, heads: int, scale: float,
                    causal: bool):
    """(dq, dk, dv) from the recomputed probabilities, as
    `_bwd_dq_kernel_packed` / `_bwd_dkv_kernel_packed`: p = exp(s - lse)
    (masked p = 0), ds = p * (do.v - delta), p and ds rounded to the stored
    dtype before each product, dq and dk scaled once at the end. lse and
    delta are (b, lq, h)."""
    qh, kh, vh, doh = (_heads(t, heads).float() for t in (q, k, v, do))
    grads = _bwd_math(qh, kh, vh, doh, lse.transpose(1, 2),
                      delta.transpose(1, 2), scale, causal, q.dtype)
    return tuple(_unheads(t).to(q.dtype) for t in grads)


def _to_bhld(x, layout: str):
    return x.transpose(1, 2) if layout == "blhd" else x


def flash_fwd_heads_plain(q, k, v, scale: float, causal: bool,
                          layout: str = "blhd"):
    """(o, lse (b, h, lq)) in the head-separated `layout`: the math of
    `flash_fwd_plain` (the single-block branch of `_fwd_kernel`)."""
    qh, kh, vh = (_to_bhld(t, layout).float() for t in (q, k, v))
    o, lse = _fwd_math(qh, kh, vh, scale, causal, v.dtype)
    return _to_bhld(o, layout).to(q.dtype), lse


def flash_bwd_heads_plain(q, k, v, do, lse, delta, scale: float,
                          causal: bool, layout: str = "blhd"):
    """(dq, dk, dv) in the head-separated `layout`, lse and delta (b, h,
    lq): the math of `_bwd_dq_kernel` / `_bwd_dkv_kernel`."""
    qh, kh, vh, doh = (_to_bhld(t, layout).float() for t in (q, k, v, do))
    grads = _bwd_math(qh, kh, vh, doh, lse, delta, scale, causal, q.dtype)
    return tuple(_to_bhld(t, layout).to(q.dtype) for t in grads)


def _delta_terms(do, o):
    """do * o in f32, elementwise (delta = its sum over the head dim): one
    kernel, as the f32 zero makes the product f32 with no f32 copy of do
    or o, and the same values as do.float() * o.float()."""
    zero = torch.zeros(1, dtype=torch.float32, device=o.device)
    return torch.addcmul(zero, do, o)


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


def _check_blocks(block_q: int, block_k: int) -> None:
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q {block_q} and block_k {block_k} must be "
                         ">= 1")


Strides = Tuple[int, int, int]


class Route(NamedTuple):
    """The kernel route of one launch and its tile caps in rows."""
    name: str       # "tc" (bf16, tensor cores) or "cc" (f32, CUDA cores)
    block_q: int
    block_k: int


# one tensor a kernel reads or writes: its name, base address (bytes),
# (batch, row, head) element strides and (batch, rows, heads) extents
Operand = Tuple[str, int, Strides, Tuple[int, int, int]]


def flash_fits(dtype, head_dim: int) -> bool:
    """Whether the kernels take packed (b, l, h * head_dim) tensors of
    `dtype` at all: a head dim in 1..MAX_HEAD_DIM and, in bf16, rows of
    whole TMA_ALIGN-byte units (a multiple of 8 elements). The auto
    policy (ops/attention.py `_use_flash`) keeps other shapes on the
    einsum core; `flash_route` raises for them."""
    if head_dim < 1 or head_dim > MAX_HEAD_DIM:
        return False
    return dtype != torch.bfloat16 or (2 * head_dim) % TMA_ALIGN == 0


def flash_route(dtype, head_dim: int, operands: Sequence[Operand],
                block_q: int, block_k: int) -> Route:
    """The route and tile caps of a launch, from plain ints: bf16 runs
    the tensor-core kernels ("tc": TMA and `wgmma`), f32 the CUDA-core
    ones ("cc"). On "tc" each of `operands` (the bf16 tensors the
    kernels load or store) must have a base address and, for every dim
    longer than 1, a positive stride in bytes that are multiples of
    TMA_ALIGN: TMA's rules. A breach raises ValueError naming the rule;
    nothing falls back to the other route. Caps: "cc" takes
    min(block, MAX_TILE); "tc" rounds up to TC_TILE, at most
    TC_MAX_TILE."""
    _check_blocks(block_q, block_k)
    if head_dim < 1 or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {head_dim} outside 1..{MAX_HEAD_DIM}, "
                         "the kernels' range")
    if dtype == torch.float32:
        return Route("cc", min(int(block_q), MAX_TILE),
                     min(int(block_k), MAX_TILE))
    if dtype != torch.bfloat16:
        raise TypeError(f"no flash kernel for {dtype}")
    for name, addr, strides, extents in operands:
        if addr % TMA_ALIGN:
            raise ValueError(
                f"{name}: base address {addr:#x} is not {TMA_ALIGN}-byte "
                "aligned, as the bf16 tensor-core kernels' TMA loads need")
        for axis, st, n in zip(("batch", "row", "head"), strides, extents):
            if n > 1 and (st <= 0 or (2 * st) % TMA_ALIGN):
                raise ValueError(
                    f"{name}: {axis} stride {st} elements ({2 * st} bytes) "
                    f"is not a positive multiple of {TMA_ALIGN} bytes, as "
                    "the bf16 tensor-core kernels' TMA loads need (bf16 "
                    "needs the head dim and every row a multiple of 8 "
                    "elements apart)")

    def cap(block):
        rounded = -(-int(block) // TC_TILE) * TC_TILE
        return min(rounded, TC_MAX_TILE)
    return Route("tc", cap(block_q), cap(block_k))


def _packed(t, d: int) -> Strides:
    """(batch, row, head) element strides of a (b, l, h*d) tensor."""
    return t.stride(0), t.stride(1), d * t.stride(2)


def _heads_layout(t, layout: str) -> Strides:
    """(batch, row, head) element strides of a blhd or bhld tensor."""
    if layout == "blhd":
        return t.stride(0), t.stride(1), t.stride(2)
    return t.stride(0), t.stride(2), t.stride(1)


def _stat(t, order: str) -> Strides:
    """(batch, row, head) strides of a per-row f32 statistic (lse, delta)
    stored (b, lq, h) ("bl") or (b, h, lq) ("bh")."""
    if order == "bl":
        return t.stride(0), t.stride(1), t.stride(2)
    return t.stride(0), t.stride(2), t.stride(1)


FWD_OPERANDS = ("q", "k", "v", "o", "lse")
BWD_OPERANDS = ("q", "k", "v", "do", "lse", "delta", "dq", "dk", "dv")


def launch_route(name: str, names: Sequence[str], tensors,
                 layouts: Sequence[Strides], dims, block_q: int,
                 block_k: int) -> Route:
    """`flash_route` of one C entry's launch: `tensors` (named `names`)
    with their (batch, row, head) strides; the query-side ones (q, o, do,
    dq, lse, delta) have lq rows, the key-side ones lk."""
    b, lq, lk, h, d = dims
    operands = [(f"{name}: {n}", t.data_ptr(), lay,
                 (b, lk if n in ("k", "v", "dk", "dv") else lq, h))
                for n, t, lay in zip(names, tensors, layouts)
                if t.dtype == torch.bfloat16]
    return flash_route(tensors[0].dtype, d, operands, block_q, block_k)


def _call(fn, name: str, names, tensors, layouts: Sequence[Strides], dims,
          scale, causal, block_q, block_k):
    q = tensors[0]
    b, lq, lk, h, d = dims
    route = launch_route(name, names, tensors, layouts, dims, block_q,
                         block_k)
    # the CUDA-core kernels take a row's offset in 32 bits
    if route.name == "cc" and \
            max(lq, lk) * max(lay[1] for lay in layouts) >= 2 ** 31:
        raise ValueError(f"{name}: row offsets of {max(lq, lk)} rows reach "
                         "2^31 elements, past the f32 kernels' 32-bit row "
                         "offsets")
    strides = (ctypes.c_longlong * (3 * len(layouts)))(
        *[int(x) for lay in layouts for x in lay])
    with torch.cuda.device(q.device):
        err = fn(*[t.data_ptr() for t in tensors], strides, b, lq, lk, h, d,
                 float(scale), int(bool(causal)), route.block_q,
                 route.block_k, _build.DTYPE_CODES[q.dtype],
                 _build.stream_ptr(q.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    ROUTES[f"{name}/{route.name}"] += 1


def _launch_fwd(name, tensors, layouts, dims, scale, causal, bq, bk):
    """One forward launch: tensors (q, k, v, o, lse) with their strides."""
    _call(_build.library().ff_flash_fwd, name, FWD_OPERANDS, tensors,
          layouts, dims, scale, causal, bq, bk)


def _launch_bwd(name, tensors, layouts, dims, scale, causal, bq, bk):
    """The dq and dk/dv launches: tensors (q, k, v, do, lse, delta, dq,
    dk, dv) with their strides."""
    _call(_build.library().ff_flash_bwd, name, BWD_OPERANDS, tensors,
          layouts, dims, scale, causal, bq, bk)


def flash_fwd(q, k, v, heads: int, *, scale: float, causal: bool = False,
              block_q: int = TC_MAX_TILE, block_k: int = TC_MAX_TILE):
    """(o, lse): softmax(q k^T * scale) v per head. `block_q` / `block_k`
    cap the kernel's query and key tiles: at MAX_TILE rows in f32,
    rounded up to TC_TILE and at most TC_MAX_TILE in bf16 (`flash_route`,
    which also raises for a bf16 tensor TMA cannot load)."""
    on_card = _check("flash_fwd", heads, q, k, v)
    _check_blocks(block_q, block_k)
    if not on_card:
        return flash_fwd_plain(q, k, v, heads, scale, causal)
    b, lq, e = q.shape
    d = e // heads
    o = torch.empty_like(q)
    lse = torch.empty((b, lq, heads), dtype=torch.float32, device=q.device)
    _launch_fwd("flash_fwd", (q, k, v, o, lse),
                [_packed(t, d) for t in (q, k, v, o)] + [_stat(lse, "bl")],
                (b, lq, k.shape[1], heads, d), scale, causal, block_q,
                block_k)
    return o, lse


def flash_bwd(q, k, v, o, lse, do, heads: int, *, scale: float,
              causal: bool = False, block_q: int = TC_MAX_TILE,
              block_k: int = TC_MAX_TILE):
    """(dq, dk, dv) for the cotangent `do` of o = flash_fwd(q, k, v)[0].
    delta = sum_d do * o per head is one f32 torch reduction here, outside
    the kernel, as the JAX package computes it."""
    on_card = _check("flash_bwd", heads, q, k, v, o, lse, do)
    _check_blocks(block_q, block_k)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)}")
    b, lq, e = q.shape
    if tuple(lse.shape) != (b, lq, heads) or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: lse must be ({b}, {lq}, {heads}) "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")
    delta = _delta_terms(do, o).reshape(b, lq, heads, e // heads).sum(-1)
    do = do.to(q.dtype)
    if not on_card:
        return flash_bwd_plain(q, k, v, do, lse, delta, heads, scale, causal)
    d = e // heads
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tensors = (q, k, v, do, lse, delta, dq, dk, dv)
    layouts = ([_packed(t, d) for t in (q, k, v, do)]
               + [_stat(lse, "bl"), _stat(delta, "bl")]
               + [_packed(t, d) for t in (dq, dk, dv)])
    _launch_bwd("flash_bwd", tensors, layouts, (b, lq, k.shape[1], heads, d),
                scale, causal, block_q, block_k)
    return dq, dk, dv


def _check_heads(name: str, layout: str, q, k, v, *more):
    """Validate head-separated operands; True when they are on the card.
    Returns (b, h, lq, lk, d) beside it."""
    if layout not in LAYOUTS:
        raise ValueError(f"{name}: layout={layout!r}: expected 'blhd' or "
                         "'bhld'")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: {tname} must be 4-D ({layout}), got "
                             f"shape {tuple(t.shape)}")
    qh, kh = _to_bhld(q, layout), _to_bhld(k, layout)
    b, h, lq, d = qh.shape
    lk = kh.shape[2]
    if k.shape != v.shape or kh.shape[0] != b or kh.shape[1] != h \
            or kh.shape[3] != d:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both match q "
                         f"{tuple(q.shape)} but for the key length "
                         f"({layout})")
    if lq < 1 or lk < 1 or d < 1:
        raise ValueError(f"{name}: need lq, lk and d >= 1, got q "
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
    dims = (b, h, lq, lk, d)
    if dev.type == "cpu":
        return False, dims
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {d} > {MAX_HEAD_DIM}, the "
                         "kernel's largest")
    for t in (q, k, v, *more):
        if t.dim() == 4 and t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must have stride 1 (got "
                             f"strides {t.stride()}); make the tensor "
                             "contiguous where it is produced")
    return True, dims


def flash_fwd_heads(q, k, v, *, scale: float, causal: bool = False,
                    block_q: int = TC_MAX_TILE, block_k: int = TC_MAX_TILE,
                    layout: str = "blhd"):
    """(o, lse): softmax(q k^T * scale) v per head, q (b, lq, h, d) and k,
    v (b, lk, h, d) in "blhd", or (b, h, l, d) in "bhld"; o in q's layout
    and dtype, lse (b, h, lq) f32. Any strides with the head dim
    contiguous (in bf16 also TMA's 16-byte rules, `flash_route`);
    `block_q` / `block_k` cap the kernel's tiles as in `flash_fwd`."""
    on_card, (b, h, lq, lk, d) = _check_heads("flash_fwd_heads", layout, q,
                                               k, v)
    _check_blocks(block_q, block_k)
    if not on_card:
        return flash_fwd_heads_plain(q, k, v, scale, causal, layout)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    _launch_fwd(f"flash_fwd_{layout}", (q, k, v, o, lse),
                [_heads_layout(t, layout) for t in (q, k, v, o)]
                + [_stat(lse, "bh")], (b, lq, lk, h, d), scale, causal,
                block_q, block_k)
    return o, lse


def flash_bwd_heads(q, k, v, o, lse, do, *, scale: float,
                    causal: bool = False, block_q: int = TC_MAX_TILE,
                    block_k: int = TC_MAX_TILE, layout: str = "blhd"):
    """(dq, dk, dv) for the cotangent `do` of o = flash_fwd_heads(q, k,
    v)[0], each in its operand's layout and dtype. delta = sum_d do * o
    per head is one f32 torch reduction here, as `_flash_bwd` computes it;
    the kernel reads it in place, whatever its strides."""
    on_card, (b, h, lq, lk, d) = _check_heads("flash_bwd_heads", layout, q,
                                               k, v, o, lse, do)
    _check_blocks(block_q, block_k)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_bwd_heads: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)}")
    if tuple(lse.shape) != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd_heads: lse must be ({b}, {h}, {lq}) "
                         f"float32, got {tuple(lse.shape)} {lse.dtype}")
    # (b, h, lq) as a view: blhd's sum is (b, lq, h)
    delta = _to_bhld(_delta_terms(do, o).sum(-1), layout)
    do = do.to(q.dtype)
    if not on_card:
        return flash_bwd_heads_plain(q, k, v, do, lse, delta, scale, causal,
                                     layout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tensors = (q, k, v, do, lse, delta, dq, dk, dv)
    layouts = ([_heads_layout(t, layout) for t in (q, k, v, do)]
               + [_stat(lse, "bh"), _stat(delta, "bh")]
               + [_heads_layout(t, layout) for t in (dq, dk, dv)])
    _launch_bwd(f"flash_bwd_{layout}", tensors, layouts, (b, lq, lk, h, d),
                scale, causal, block_q, block_k)
    return dq, dk, dv


def tc_kernel_report():
    """Each bf16 tensor-core kernel as this process built it: ptxas's
    registers, stack and spills (`_build.ptxas_report`) beside its dynamic
    shared memory in bytes. Empty when the library was built earlier."""
    lib = _build.library()
    kinds = {"flash_fwd_tc": 0, "flash_bwd_dq_tc": 1, "flash_bwd_dkv_tc": 2}
    out = []
    for row in _build.ptxas_report("flash_attention_tc.cu"):
        m = re.fullmatch(r"(\w+)<([\d, ]+)>", str(row["kernel"]))
        if m and m.group(1) in kinds:
            kind = kinds[m.group(1)]
            args = [int(x) for x in m.group(2).split(",")]
            # forward <DP, BK, CW>; dq and dk/dv <DP, CW>
            dp, cw, bk = ((args[0], args[2], args[1]) if kind == 0
                          else (args[0], args[1], 0))
            row = dict(row, smem_bytes=int(
                lib.ff_flash_tc_smem_bytes(kind, dp, cw, bk)))
        out.append(row)
    return out


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
                    block_q: int = TC_MAX_TILE, block_k: int = TC_MAX_TILE):
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


class _FlashAttentionHeads(torch.autograd.Function):
    """Saves (q, k, v, o, lse), as `_flash_attention_fwd_rule`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k, layout):
        o, lse = flash_fwd_heads(q, k, v, scale=scale, causal=causal,
                                 block_q=block_q, block_k=block_k,
                                 layout=layout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, causal, block_q, block_k, layout)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, block_q, block_k, layout = ctx.args
        if g.stride(-1) != 1:
            # autograd may hand over a cotangent with a strided head dim
            # (an expanded or transposed gradient): the kernel's one copy
            g = g.contiguous()
        dq, dk, dv = flash_bwd_heads(q, k, v, o, lse, g, scale=scale,
                                     causal=causal, block_q=block_q,
                                     block_k=block_k, layout=layout)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_heads(q, k, v, *, scale: Optional[float] = None,
                          causal: bool = False, block_q: int = TC_MAX_TILE,
                          block_k: int = TC_MAX_TILE, layout: str = "blhd"):
    """Flash attention on head-separated tensors with its backward through
    the kernels (counterpart of the JAX `flash_attention`): q (b, lq, h,
    d), k and v (b, lk, h, d) with layout="blhd", the attention op's
    layout, or (b, h, l, d) with layout="bhld". Returns the context in
    q's layout."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttentionHeads.apply(q, k, v, float(scale), bool(causal),
                                      int(block_q), int(block_k), layout)
