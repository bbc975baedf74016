"""Decode attention over the slot-dense KV cache: CUDA kernels and plain
version.

Replaces flexflow_tpu/kernels/pallas/decode.py `_call_decode` through its
two entries, `fused_decode_attention` (C = 1, every decode iteration) and
`fused_multiquery_decode_attention` (C >= 1, every chunked-prefill chunk).
The kernels are csrc/decode_attention.cu. On the card they are bound by
the bytes of the cache rows they read (a quarter of an operation per
byte at C = 1), so the design is about bytes in flight on every SM:

`decode_plan` (shapes and dtypes only: it never reads `pos`, which lives
on the device, so a call stays free of host synchronisation) cuts the
cache into `splits` spans of `split_rows` rows. One block per (query
tile of 16, split, head, slot) reads only the rows its queries may
attend and writes f32 partials (m, l, acc) to a scratch tensor; a split
that lies past a slot's last attended row exits at once; a second launch
merges the partials (with one split the first launch writes the output
and there is no second). Routes, decided by the plan before the launch:
  - "tc": q and both caches bf16, head dim a multiple of 8 up to 256 —
    `mma.sync` m16n8k16 on the tensor cores, Q, K and V in bf16 through
    `cp.async` 16-byte copies (their base addresses 16-byte aligned,
    else ValueError: a call is never sent to the other route);
  - "cc": everything else (f32 operands: tensor-core f32 is TF32, short
    of the f32 tolerances; head dims such as 12 in bf16) — f32 FMA
    through shared memory, in the TPU kernel's order.
When M <= block_k ("single": the TPU kernel's one cache block) both
routes keep that block's op order: the row's final max and sum first,
then (p / l) rounded to q's dtype before p.v, so greedy decode stays
token-identical to the einsum chain. Otherwise the unnormalised p is
rounded before p.v and the output divided by l at the end.

Layouts as in the JAX package: q (B, C, h, d) projections of the tokens
at positions pos[b] + j, caches (B, M, h, d) ALREADY written at those
rows, pos (B,) int32. Query j of slot b attends rows k <= pos[b] + j.
Output (B, C, h, d) in q's dtype.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. `LAUNCHES` counts calls per
wrapper (a split call is two launches, counted once), `ROUTES` the same
calls per wrapper and route ("decode_attention/tc", ...).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import _build

NEG_INF = -1e30
# cc route: cache rows per shared-memory tile; two f32 tiles of 64 x
# (d + 1) plus the query tile fit the default 48 KB at d = 64
MAX_TILE_K = 64
# tc route: cache rows per ring stage (16 per warp of 4), and its widest
# head dim
TC_TILE_K = 64
TC_MAX_HEAD_DIM = 256
# split rule: at least SPLIT_ROWS rows per split (one tc stage), at most
# MAX_SPLITS splits. Tuned on an H100 by tools/decode_bench.py --sweep: at
# M = 1024, 8 splits of 128 rows beat 16 of 64 on every shape (fewer
# partials to merge, two tiles in flight per block) and 4 of 256 on the
# prefill chunk, the batcher's most frequent call (4 won the B = 8,
# C = 16 batch by 4%)
SPLIT_ROWS = 64
MAX_SPLITS = 8
# queries per block (one m16 tile); rows per partial
Q_TILE = 16
ROUTE_CODES = {"cc": 0, "tc": 1}

# kernel calls per wrapper, a plain count the serving path is read by
LAUNCHES: Dict[str, int] = {"decode_attention": 0,
                            "multiquery_decode_attention": 0}
# the same calls by route
ROUTES: Dict[str, int] = {f"{name}/{route}": 0 for name in LAUNCHES
                          for route in ROUTE_CODES}


class DecodePlan(NamedTuple):
    """How one call runs on the card (`decode_plan`)."""
    route: str          # "tc" or "cc"
    split_rows: int     # cache rows per split
    splits: int         # splits of the cache; > 1: partials + combine
    single: bool        # M <= block_k: the one-block op order
    tile_k: int         # cache rows per staged tile
    scratch_floats: int  # f32 partials the wrapper allocates (0: none)

    @property
    def launches(self) -> int:
        return 2 if self.splits > 1 else 1


def decode_plan(B: int, C: int, M: int, H: int, D: int, block_k: int,
                q_dtype, kv_dtype) -> DecodePlan:
    """The route, split and tiles of a call, from shapes and dtypes alone
    (never from `pos`). "tc" when q and both caches are bf16 and D is a
    multiple of 8 up to TC_MAX_HEAD_DIM, else "cc". "single" exactly when
    M <= max(1, block_k), as the TPU kernel's one block (n_kb == 1);
    then one split covers the cache. Otherwise split_rows is M /
    MAX_SPLITS rounded up to a multiple of SPLIT_ROWS (at least
    SPLIT_ROWS): M = 1024 gives 8 splits of 128 rows, 128 blocks for one
    slot's 16-token chunk over 16 heads."""
    for name, n in (("B", B), ("C", C), ("M", M), ("H", H), ("D", D)):
        if int(n) < 1:
            raise ValueError(f"decode_plan: {name} = {n} must be >= 1")
    tc = (q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16
          and D % 8 == 0 and D <= TC_MAX_HEAD_DIM)
    single = M <= max(1, block_k)  # the TPU kernel clamps block_k to >= 1
    if single:
        rows, splits = M, 1
    else:
        per = -(-M // MAX_SPLITS)
        rows = max(SPLIT_ROWS, -(-per // SPLIT_ROWS) * SPLIT_ROWS)
        splits = -(-M // rows)
    q_tiles = -(-C // Q_TILE)
    scratch = B * H * q_tiles * splits * Q_TILE * (D + 2) \
        if splits > 1 else 0
    return DecodePlan(
        route="tc" if tc else "cc", split_rows=rows, splits=splits,
        single=single,
        tile_k=TC_TILE_K if tc else max(1, min(block_k, MAX_TILE_K)),
        scratch_floats=scratch)


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
    m = k_cache.shape[1]
    plan = decode_plan(b, c, m, h, d, block_k, q.dtype, k_cache.dtype)
    if plan.route == "tc":
        for tname, t in (("q", q), ("k_cache", k_cache),
                         ("v_cache", v_cache)):
            if t.data_ptr() % 16:
                raise ValueError(
                    f"{name}: {tname} base address {t.data_ptr():#x} is not "
                    "16-byte aligned, as the bf16 tensor-core route's "
                    "16-byte copies need")
    out = torch.empty_like(q)
    part = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                        device=q.device) if plan.splits > 1 else None)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.ff_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None, b, c, m, h, d,
            float(scale), plan.tile_k, plan.split_rows, plan.splits,
            int(plan.single), ROUTE_CODES[plan.route],
            _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_cache.dtype],
            _build.stream_ptr(q.device))
    _build.check(err, name)
    LAUNCHES[name] += 1
    ROUTES[f"{name}/{plan.route}"] += 1
    return out


def decode_attention(q, k_cache, v_cache, pos, *, scale: float,
                     block_k: int = 512):
    """One decode step for every slot: q (B, 1, h, d). `block_k` is the
    TPU kernel's cache block: M <= block_k keeps its one-block op order
    (`decode_plan`); on the cc route it also caps the staged tile."""
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
