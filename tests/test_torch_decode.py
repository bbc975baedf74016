"""Decode attention's launch plan and split-KV algebra on the CPU.

`decode_plan` (flexflow_tpu_torch/kernels/decode.py) decides from shapes
and dtypes alone how the CUDA kernels of csrc/decode_attention.cu run a
call: the route (tc: bf16 tensor cores; cc: f32 FMA), the cache rows per
split, the number of splits and whether the call keeps the TPU kernel's
one-block op order. The kernels cannot run here, so the split-and-combine
algebra they implement is held against the JAX package's Pallas kernel
(interpret mode) by a torch helper of this file that computes each
split's partials (m, l, acc) and merges them as the combine kernel does.
The kernels themselves are held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.pallas.decode import (
    fused_decode_attention, fused_multiquery_decode_attention)
from flexflow_tpu_torch.kernels import decode, launch_counts

BF16, F32 = torch.bfloat16, torch.float32
# f32: the same math, summed in another order and merged across splits
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("qdt,kvdt,d,route", [
    (BF16, BF16, 64, "tc"), (BF16, BF16, 8, "tc"), (BF16, BF16, 256, "tc"),
    (BF16, BF16, 12, "cc"), (BF16, BF16, 264, "cc"), (F32, F32, 64, "cc"),
    (F32, BF16, 64, "cc"), (BF16, F32, 64, "cc")])
def test_plan_route_by_dtype_and_head_dim(qdt, kvdt, d, route):
    plan = decode.decode_plan(8, 1, 1024, 16, d, 512, qdt, kvdt)
    assert plan.route == route
    assert plan.tile_k == (decode.TC_TILE_K if route == "tc"
                           else decode.MAX_TILE_K)


@pytest.mark.parametrize("m", [1, 40, 513, 1024, 1100, 4096, 100_000])
def test_plan_splits_from_m_alone(m):
    plans = [decode.decode_plan(b, c, m, h, d, 512, qdt, kvdt)
             for b, c, h, d, qdt, kvdt in (
                 (1, 1, 16, 64, BF16, BF16), (8, 16, 16, 64, BF16, BF16),
                 (3, 17, 2, 12, F32, F32), (2, 5, 4, 128, BF16, F32))]
    assert len({(p.split_rows, p.splits, p.single) for p in plans}) == 1
    p = plans[0]
    assert p.splits == -(-m // p.split_rows)  # the splits cover the cache
    if not p.single:
        assert p.split_rows % decode.SPLIT_ROWS == 0
        assert p.splits <= decode.MAX_SPLITS
        assert p.split_rows * (p.splits - 1) < m


@pytest.mark.parametrize("m,block_k,single", [
    (40, 64, True), (64, 64, True), (65, 64, False), (512, 512, True),
    (1024, 512, False), (1, 0, True), (2, 0, False)])
def test_plan_single_exactly_when_cache_fits_one_block(m, block_k, single):
    """The TPU kernel runs one block when max(1, min(block_k, M)) == M."""
    plan = decode.decode_plan(4, 3, m, 2, 16, block_k, BF16, BF16)
    assert plan.single is single
    if single:
        assert (plan.splits, plan.split_rows, plan.launches) == (1, m, 1)
        assert plan.scratch_floats == 0


def test_plan_fills_the_card_for_a_prefill_chunk():
    """One slot's 16-token chunk over a 1024-row cache and 16 heads: at
    least 128 blocks (the parent kernel launched 16); the decode batch
    of 8 slots several times that."""
    # the grid: (query tiles of 16 x splits, heads, slots)
    chunk = decode.decode_plan(1, 16, 1024, 16, 64, 512, BF16, BF16)
    assert chunk.route == "tc" and not chunk.single
    assert chunk.splits * 16 * 1 >= 128
    batch = decode.decode_plan(8, 1, 1024, 16, 64, 512, BF16, BF16)
    assert batch.splits * 16 * 8 >= 2 * 132
    assert batch.launches == 2
    # partials: (m, l) and a 16 x d acc per (query tile, split, head, slot)
    assert batch.scratch_floats == 8 * 16 * 1 * batch.splits * 16 * 66
    wide = decode.decode_plan(8, 17, 1024, 16, 64, 512, BF16, BF16)
    assert wide.scratch_floats == 2 * batch.scratch_floats


def test_plan_rejects_empty_shapes():
    with pytest.raises(ValueError, match="M = 0"):
        decode.decode_plan(1, 1, 0, 1, 8, 512, BF16, BF16)


def test_cpu_calls_run_the_plain_version_and_count_nothing():
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 1, 2, 8), generator=g)
    kc = torch.randn((2, 20, 2, 8), generator=g)
    vc = torch.randn((2, 20, 2, 8), generator=g)
    pos = torch.tensor([3, 19], dtype=torch.int32)
    before = launch_counts()
    assert {f"{n}/{r}" for n in decode.LAUNCHES for r in ("tc", "cc")} \
        <= set(before)
    out = decode.decode_attention(q, kc, vc, pos, scale=0.3, block_k=4)
    torch.testing.assert_close(
        out, decode.decode_attention_plain(q, kc, vc, pos, 0.3))
    assert launch_counts() == before


NEG_INF = decode.NEG_INF


def _split_combine(q, kc, vc, pos, scale, rows, log2):
    """The split path's algebra in f32: each split of `rows` cache rows
    gives (m, l, acc) over the rows its queries may attend (m = -1e30,
    l = 0 where none), and the combine merges them, skipping empty
    splits: out = sum w_s acc_s / sum w_s l_s, w_s = e^(m_s - m*), with
    the l == 0 -> 1 guard. `log2`: scores pre-scaled by log2 e and exp2,
    as the tc route keeps them. Returns (out (B, C, h, d), count of
    (slot, head, query, split) partials with no attended row)."""
    b, c, h, d = q.shape
    m = kc.shape[1]
    ex = torch.exp2 if log2 else torch.exp
    s = torch.einsum("bqhd,bkhd->bhqk", q, kc) * scale
    if log2:
        s = s * float(np.log2(np.e))
    qpos = pos.long()[:, None] + torch.arange(c)[None, :]      # (B, C)
    keep = (torch.arange(m)[None, None, :] <= qpos[:, :, None])[:, None]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    ms, ls, accs = [], [], []
    for lo in range(0, m, rows):
        part = s[..., lo:lo + rows]
        mx = part.amax(-1)                                    # (B, h, C)
        mu = torch.where(mx == NEG_INF, torch.zeros_like(mx), mx)
        p = ex(part - mu[..., None])                          # masked: 0
        ms.append(mx)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bkhd->bhqd", p, vc[:, lo:lo + rows]))
    mall, lall, aall = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    valid = lall > 0
    mx = torch.where(valid, mall, torch.full_like(mall, NEG_INF)).amax(0)
    mu = torch.where(mx == NEG_INF, torch.zeros_like(mx), mx)
    w = torch.where(valid, ex(mall - mu), torch.zeros_like(mall))
    tot = (w * lall).sum(0)
    tot = torch.where(tot == 0, torch.ones_like(tot), tot)
    out = (w[..., None] * aall).sum(0) / tot[..., None]
    return out.permute(0, 2, 1, 3), int((~valid).sum())


@pytest.mark.parametrize("log2", [False, True])
@pytest.mark.parametrize("rows", [4, 8, 16])
@pytest.mark.parametrize("c", [1, 3])
def test_split_and_combine_matches_pallas(c, rows, log2):
    """Ragged positions leave later splits empty for short slots; the
    merge of the partials meets the Pallas kernel's multi-block online
    softmax (block_k 8) in f32."""
    rng = np.random.RandomState(30 + c + rows)
    b, m, h, d = 4, 40, 3, 16
    q = rng.randn(b, c, h, d).astype(np.float32)
    kc = rng.randn(b, m, h, d).astype(np.float32)
    vc = rng.randn(b, m, h, d).astype(np.float32)
    pos = np.array([0, 5, 21, m - c], np.int32)
    scale = d ** -0.5
    jfn = fused_decode_attention if c == 1 \
        else fused_multiquery_decode_attention
    ref = np.asarray(jfn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(pos), scale=scale, block_k=8,
                         interpret=True), np.float32)
    out, empty = _split_combine(*(torch.from_numpy(a)
                                  for a in (q, kc, vc, pos)), scale, rows,
                                log2)
    assert empty > 0  # the test covers the empty-split merge
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def test_split_and_combine_at_the_plan_of_a_long_cache():
    """The plan's own split (M = 1100 at block_k 512: 6 splits of 192
    rows, the last of 140) through the helper, against the Pallas
    kernel."""
    plan = decode.decode_plan(3, 2, 1100, 2, 8, 512, F32, F32)
    assert (plan.splits, plan.split_rows, plan.single) == (6, 192, False)
    rng = np.random.RandomState(41)
    q = rng.randn(3, 2, 2, 8).astype(np.float32)
    kc = rng.randn(3, 1100, 2, 8).astype(np.float32)
    vc = rng.randn(3, 1100, 2, 8).astype(np.float32)
    pos = np.array([0, 600, 1098], np.int32)
    ref = np.asarray(fused_multiquery_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        scale=0.35, block_k=512, interpret=True), np.float32)
    out, empty = _split_combine(*(torch.from_numpy(a)
                                  for a in (q, kc, vc, pos)), 0.35,
                                plan.split_rows, True)
    assert empty > 0
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
