"""flexflow_tpu_torch on the card: each CUDA kernel against its plain
version, the continuous batcher on the card against the port on the
CPU, and one training step on the card against the port on the CPU.
Every test is marked `cuda` and skips without a GPU. This file imports
no jax, so it also runs where only the port's dependencies are
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import time

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import decode, flash_attention, \
    launch_counts, norm, optimizer, reduction, reset_launch_counts

pytestmark = pytest.mark.cuda

# f32: the kernel and the plain version differ only in summation order.
# bf16: outputs are rounded to bf16 (2^-8 relative) after f32 math that
# rounds p at another point (before vs after normalisation): a few ulps.
F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=4e-3, rtol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(out, ref, tol):
    torch.testing.assert_close(out.float(), ref.float(), **tol)


# (C, M, block_k): M <= block_k runs the single-block order (M = 300: two
# passes over 5 tiles); M = 1100 at block_k 512 the split path (6 splits
# of 192 rows, the last of 140, 3 ring stages)
@pytest.mark.parametrize("c,m,block_k", [
    (1, 40, 8), (3, 40, 8), (17, 40, 8), (1, 40, 64), (3, 40, 64),
    (17, 40, 64), (3, 300, 512), (1, 1100, 512), (16, 1100, 512)])
@pytest.mark.parametrize("qdt,kvdt", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("d", [12, 16, 64])  # 12 x bf16: no 16-byte rows
def test_decode_kernel_matches_plain(dev, c, m, block_k, qdt, kvdt, d):
    g = torch.Generator(device=dev).manual_seed(c * 100 + block_k + d + m)
    b, h = 4, 3
    q = torch.randn((b, c, h, d), generator=g, device=dev).to(qdt)
    kc = torch.randn((b, m, h, d), generator=g, device=dev).to(kvdt)
    vc = torch.randn((b, m, h, d), generator=g, device=dev).to(kvdt)
    # ragged: the first row only, mid-cache, the window ending at the edge
    # (at M = 1100 some splits of every slot but the last are empty)
    mid = {40: (5, 21), 300: (70, 200)}.get(m, (70, 600))
    pos = torch.tensor([0, *mid, m - c], dtype=torch.int32, device=dev)
    name = "decode_attention" if c == 1 else "multiquery_decode_attention"
    fn = getattr(decode, name)
    # the route rule: the tensor cores for bf16 q and caches with d a
    # multiple of 8, CUDA-core f32 FMA otherwise
    route = "tc" if qdt == kvdt == torch.bfloat16 and d % 8 == 0 else "cc"
    reset_launch_counts()
    out = fn(q, kc, vc, pos, scale=d ** -0.5, block_k=block_k)
    ref = decode.decode_attention_plain(q, kc, vc, pos, d ** -0.5)
    assert out.dtype == qdt and out.shape == q.shape
    counts = launch_counts()
    assert counts[f"{name}/{route}"] == 1 and counts[name] == 1, counts
    _close(out, ref, BF16_TOL if torch.bfloat16 in (qdt, kvdt) else F32_TOL)


NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _tc_split_order(q, kc, vc, pos, scale, plan):
    """The tensor-core route's split-path op order, in torch: per split,
    per 64-row tile, each warp's 16 rows through an online softmax in the
    exp2 domain (scores pre-scaled by log2 e, masked at -1e30, a row with
    nothing attended yet keeping 0 as its reference max) with the
    unnormalised p rounded to bf16 before p.v, as the JAX multi-block
    path rounds; then the warps, then the splits merged. It differs from
    the kernel only in the order of f32 sums."""
    b_, c, h, d = q.shape
    m = kc.shape[1]
    t_all = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc.float()) * (
        scale * LOG2E)
    vf = vc.float()

    def merge(ms, ls, accs):
        ms, ls, accs = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        mx = torch.where(ls > 0, ms, torch.full_like(ms, NEG_INF)).amax(0)
        mu = torch.where(mx == NEG_INF, torch.zeros_like(mx), mx)
        w = torch.where(ls > 0, torch.exp2(ms - mu), torch.zeros_like(ms))
        return mx, (w * ls).sum(0), (w[..., None] * accs).sum(0)

    out = torch.empty((b_, c, h, d), device=q.device)
    for b in range(b_):
        p0 = int(pos[b])
        for j0 in range(0, c, 16):
            nq = min(16, c - j0)
            span = max(0, min(p0 + j0 + nq, m))
            lim = p0 + j0 + torch.arange(nq, device=q.device)
            parts = []
            for lo in range(0, span, plan.split_rows):
                hi = min(lo + plan.split_rows, span)
                warps = []
                for w in range(4):
                    mw = torch.full((h, nq), NEG_INF, device=q.device)
                    lw = torch.zeros((h, nq), device=q.device)
                    aw = torch.zeros((h, nq, d), device=q.device)
                    for t0 in range(lo, hi, 64):
                        k0, k1 = t0 + 16 * w, min(t0 + 16 * w + 16, hi)
                        if k0 >= k1:
                            continue
                        keys = torch.arange(k0, k1, device=q.device)
                        t = torch.where(keys[None, :] <= lim[:, None],
                                        t_all[b, :, j0:j0 + nq, k0:k1],
                                        NEG_INF)
                        m_new = torch.maximum(mw, t.amax(-1))
                        mu = torch.where(m_new == NEG_INF,
                                         torch.zeros_like(m_new), m_new)
                        corr = torch.exp2(mw - mu)
                        p = torch.exp2(t - mu[..., None])
                        lw = lw * corr + p.sum(-1)
                        aw = aw * corr[..., None] + torch.einsum(
                            "hqk,khd->hqd", p.to(torch.bfloat16).float(),
                            vf[b, k0:k1])
                        mw = m_new
                    warps.append((mw, lw, aw))
                parts.append(merge(*zip(*warps)))
            _, tot, acc = merge(*zip(*parts))
            tot = torch.where(tot == 0, torch.ones_like(tot), tot)
            out[b, j0:j0 + nq] = (acc / tot[..., None]).permute(1, 0, 2)
    return out.to(torch.bfloat16)


# (C, M, block_k): the split path with one split (M = 40), with two query
# tiles, with 6 splits of 3 ring stages and the combine (M = 1100); the
# single path over 5 tiles (M = 300)
@pytest.mark.parametrize("c,m,block_k", [
    (3, 40, 8), (17, 40, 8), (1, 1100, 512), (16, 1100, 512),
    (3, 300, 512)])
@pytest.mark.parametrize("d", [8, 16, 64, 128, 256])  # every padded d
def test_decode_tc_kernel_keeps_its_op_order(dev, c, m, block_k, d):
    """Each head dim the tensor-core kernel pads to (16, 32 .. 256),
    within one bf16 ulp (2^-7 relative, 2^-10 absolute) of its own op
    order: the single path's is the plain version's ((p / l) rounded
    before p.v); the split path's, the unnormalised p rounded, is
    `_tc_split_order`. Against the plain version the split path differs
    by where p is rounded, at wide head dims by more than BF16_TOL
    always covers."""
    g = torch.Generator(device=dev).manual_seed(7 * c + block_k + d + m)
    b, h = 4, 3
    q, kc, vc = (torch.randn(shape, generator=g, device=dev)
                 .to(torch.bfloat16)
                 for shape in ((b, c, h, d), (b, m, h, d), (b, m, h, d)))
    pos = torch.tensor([0, 5, m // 2, m - c], dtype=torch.int32, device=dev)
    plan = decode.decode_plan(b, c, m, h, d, block_k, torch.bfloat16,
                              torch.bfloat16)
    assert plan.route == "tc" and plan.single == (m <= block_k)
    fn = decode.decode_attention if c == 1 \
        else decode.multiquery_decode_attention
    out = fn(q, kc, vc, pos, scale=d ** -0.5, block_k=block_k)
    ref = decode.decode_attention_plain(q, kc, vc, pos, d ** -0.5) \
        if plan.single else _tc_split_order(q, kc, vc, pos.cpu(),
                                            d ** -0.5, plan)
    _close(out, ref, dict(atol=2 ** -10, rtol=2 ** -7))


def test_decode_tc_route_alignment(dev):
    """The tensor-core route copies 16-byte chunks of q and the caches: a
    contiguous operand whose base is not 16-byte aligned raises (it is
    never sent to the other route); an aligned one runs."""
    g = torch.Generator(device=dev).manual_seed(5)
    b, c, m, h, d = 2, 3, 200, 2, 16

    def shifted(shape):  # contiguous, its base 2 bytes past an alignment
        n = int(np.prod(shape))
        flat = torch.randn((n + 1,), generator=g, device=dev)
        return flat.to(torch.bfloat16)[1:].view(shape)

    q = torch.randn((b, c, h, d), generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((b, m, h, d), generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor([7, m - c], dtype=torch.int32, device=dev)
    reset_launch_counts()
    for args in ((shifted(q.shape), kc, vc), (q, shifted(kc.shape), vc),
                 (q, kc, shifted(vc.shape))):
        assert all(t.is_contiguous() for t in args)
        with pytest.raises(ValueError, match="16-byte aligned"):
            decode.multiquery_decode_attention(*args, pos, scale=0.25)
    assert launch_counts()["multiquery_decode_attention"] == 0
    out = decode.multiquery_decode_attention(q, kc, vc, pos, scale=0.25)
    _close(out, decode.decode_attention_plain(q, kc, vc, pos, 0.25),
           BF16_TOL)


@pytest.mark.parametrize("hidden,heads", [(32, 4), (64, 2)])  # d 8, 32
def test_batcher_bf16_decode_kernels_match_einsum_chain(dev, hidden, heads):
    """Greedy tokens of the bf16 LM through the continuous batcher at
    max_len <= block_k (the single-block order, tensor-core route) equal
    those of the einsum decode chain: only the two decode families are
    switched, every other op runs the same way in both runs."""
    from flexflow_tpu_torch.kernels.registry import KERNELS
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    lm = build_tiny_lm(2, 16, vocab=50, hidden=hidden, heads=heads,
                       mixed_precision=True, device="cuda",
                       generator=torch.Generator().manual_seed(21))
    assert 32 <= lm.config.flash_block_k
    rng = np.random.RandomState(22)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (5, 11, 3, 8)]

    def run(impl):
        reset_launch_counts()
        with KERNELS.override("attention_decode", impl), \
                KERNELS.override("attention_decode_mq", impl), \
                ContinuousBatcher(lm, max_len=32, num_slots=2, page_size=4,
                                  max_queue=8) as cb:
            toks = [r.result(timeout=120).tolist()
                    for r in [cb.submit(p, 12) for p in prompts]]
        return toks, launch_counts()

    kernel, counts = run("pallas")
    assert counts["decode_attention/tc"] > 0, counts
    assert counts["multiquery_decode_attention/tc"] > 0, counts
    assert counts["decode_attention/cc"] == 0, counts
    einsum, counts = run("reference")
    assert counts["decode_attention"] == 0, counts
    assert counts["multiquery_decode_attention"] == 0, counts
    assert kernel == einsum


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [32, 1024, 20000])  # 20000: > 48 KB of smem
@pytest.mark.parametrize("affine", [True, False])
def test_layernorm_kernel_matches_plain(dev, dtype, n, affine):
    g = torch.Generator(device=dev).manual_seed(n)
    x = (torch.randn((5, 3, n), generator=g, device=dev) * 2 + 1).to(dtype)
    gamma = torch.rand((n,), generator=g, device=dev) + 0.5 if affine \
        else None
    beta = torch.randn((n,), generator=g, device=dev) if affine else None
    y, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
    ry, rmean, rrstd = norm.layernorm_fwd_plain(x, gamma, beta, 1e-5)
    assert y.dtype == dtype and y.shape == x.shape
    assert mean.shape == (15, 1) and rstd.dtype == torch.float32
    _close(y, ry, F32_TOL if dtype == torch.float32
           else dict(atol=1e-2, rtol=1e-2))
    _close(mean, rmean, F32_TOL)
    _close(rstd, rrstd, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [7, 30522])
def test_softmax_kernel_matches_plain(dev, dtype, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = (torch.randn((2, 5, n), generator=g, device=dev) * 4).to(dtype)
    y = norm.softmax_fwd(x)
    assert y.dtype == dtype and y.shape == x.shape
    _close(y, norm.softmax_fwd_plain(x), dict(atol=1e-7, rtol=1e-4)
           if dtype == torch.float32 else dict(atol=1e-6, rtol=1e-2))


def test_kernels_count_launches_and_reject_strided(dev):
    x = torch.randn((4, 64), device=dev)
    reset_launch_counts()
    norm.softmax_fwd(x)
    norm.layernorm_fwd(x)
    assert launch_counts()["softmax_fwd"] == 1
    assert launch_counts()["layernorm_fwd"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        norm.softmax_fwd(x.t())
    assert launch_counts()["softmax_fwd"] == 1


def test_batcher_on_card_matches_cpu_port(dev):
    """Greedy tokens through the continuous batcher on the card (kernels)
    equal the port's on the CPU (plain versions), same f32 weights."""
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    cpu = build_tiny_lm(2, 12, vocab=50, device="cpu")
    gpu = build_tiny_lm(2, 12, vocab=50, device="cuda")
    gpu.load_params(cpu.params)
    rng = np.random.RandomState(15)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (4, 9, 3, 7)]

    def run(model):
        with ContinuousBatcher(model, max_len=24, num_slots=2, page_size=4,
                               max_queue=8) as cb:
            return [r.result(timeout=120).tolist()
                    for r in [cb.submit(p, 10) for p in prompts]]

    reset_launch_counts()
    on_card = run(gpu)
    serving = ("decode_attention", "multiquery_decode_attention",
               "layernorm_fwd", "softmax_fwd")
    assert all(launch_counts()[k] > 0 for k in serving), launch_counts()
    assert on_card == run(cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,h,d,block", [
    (64, 64, 2, 64, 64),     # one tile each way
    (100, 130, 3, 32, 64),   # ragged tiles, lq != lk (causal offset)
    (40, 40, 2, 16, 16),     # tiles smaller than the kernel's largest
    (33, 70, 1, 128, 32),    # the largest head dim
    # bf16: the shared-memory rings wrap several times, ragged ends
    (300, 520, 2, 64, 512),
    # bf16: d 128 as two 64-column TMA boxes, 8 key tiles of 128
    (129, 1000, 1, 128, 512),
    (70, 33, 2, 48, 512)])   # a head dim padded to 64 by TMA's zero fill
def test_flash_kernels_match_plain(dev, dtype, causal, lq, lk, h, d, block):
    g = torch.Generator(device=dev).manual_seed(lq * 7 + lk + d)
    b = 2

    def rnd(l):
        return torch.randn((b, l, h * d), generator=g, device=dev).to(dtype)

    q, k, v, do = rnd(lq), rnd(lk), rnd(lk), rnd(lq)
    scale = d ** -0.5
    reset_launch_counts()
    o, lse = flash_attention.flash_fwd(q, k, v, h, scale=scale,
                                       causal=causal, block_q=block,
                                       block_k=block)
    ro, rlse = flash_attention.flash_fwd_plain(q, k, v, h, scale, causal)
    assert o.dtype == dtype and lse.shape == (b, lq, h)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _close(o, ro, tol)
    _close(lse, rlse, F32_TOL)
    grads = flash_attention.flash_bwd(q, k, v, o, lse, do, h, scale=scale,
                                      causal=causal, block_q=block,
                                      block_k=block)
    delta = (do.float() * o.float()).reshape(b, lq, h, d).sum(-1)
    ref = flash_attention.flash_bwd_plain(q, k, v, do, lse, delta, h, scale,
                                          causal)
    # bf16: the same rounded ds and p as the plain version; f32 sums in
    # another order may move a result by one bf16 ulp (<= 2^-7 relative)
    for out, want in zip(grads, ref):
        assert out.dtype == dtype
        _close(out, want, F32_TOL if dtype == torch.float32
               else dict(atol=1e-3, rtol=1e-2))
    assert launch_counts()["flash_fwd"] == 1
    assert launch_counts()["flash_bwd"] == 1
    # bf16 runs the tensor-core kernels, f32 the CUDA-core ones
    route, other = ("tc", "cc") if dtype == torch.bfloat16 else ("cc", "tc")
    for name in ("flash_fwd", "flash_bwd"):
        assert launch_counts()[f"{name}/{route}"] == 1
        assert launch_counts()[f"{name}/{other}"] == 0


@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,h,d,block", [
    (64, 64, 2, 64, 64),     # one tile each way
    (100, 130, 3, 32, 64),   # ragged tiles, lq != lk (causal offset)
    (40, 40, 2, 16, 16),     # tiles smaller than the kernel's largest
    (33, 70, 1, 128, 32),    # the largest head dim
    (70, 33, 2, 64, 32),     # lq > lk: causal rows that see no key
    (300, 520, 2, 64, 512),  # bf16: the rings wrap several times
    (129, 1000, 1, 128, 512),  # bf16: d 128 as two TMA boxes
    (70, 33, 2, 48, 512)])   # a head dim padded to 64
def test_flash_heads_kernels_match_plain(dev, layout, dtype, causal, lq, lk,
                                         h, d, block):
    """B7: the head-separated kernels in both layouts, forward and
    backward, against their plain versions; bhld's rows of one head are
    contiguous and its heads are not."""
    g = torch.Generator(device=dev).manual_seed(lq * 5 + lk + d)
    b = 2

    def rnd(l):
        x = torch.randn((b, l, h, d), generator=g, device=dev).to(dtype)
        return x.transpose(1, 2).contiguous() if layout == "bhld" else x

    q, k, v, do = rnd(lq), rnd(lk), rnd(lk), rnd(lq)
    scale = d ** -0.5
    reset_launch_counts()
    o, lse = flash_attention.flash_fwd_heads(
        q, k, v, scale=scale, causal=causal, block_q=block, block_k=block,
        layout=layout)
    ro, rlse = flash_attention.flash_fwd_heads_plain(q, k, v, scale, causal,
                                                     layout)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (b, h, lq)
    _close(o, ro, F32_TOL if dtype == torch.float32 else BF16_TOL)
    _close(lse, rlse, F32_TOL)
    grads = flash_attention.flash_bwd_heads(
        q, k, v, o, lse, do, scale=scale, causal=causal, block_q=block,
        block_k=block, layout=layout)
    delta = (do.float() * o.float()).sum(-1)
    if layout == "blhd":
        delta = delta.transpose(1, 2)
    ref = flash_attention.flash_bwd_heads_plain(q, k, v, do, lse, delta,
                                                scale, causal, layout)
    for out, want in zip(grads, ref):
        assert out.dtype == dtype and out.shape == want.shape
        _close(out, want, F32_TOL if dtype == torch.float32
               else dict(atol=1e-3, rtol=1e-2))
    assert launch_counts()[f"flash_fwd_{layout}"] == 1
    assert launch_counts()[f"flash_bwd_{layout}"] == 1
    assert launch_counts()["flash_fwd"] == 0
    route = "tc" if dtype == torch.bfloat16 else "cc"
    assert launch_counts()[f"flash_fwd_{layout}/{route}"] == 1
    assert launch_counts()[f"flash_bwd_{layout}/{route}"] == 1


@pytest.mark.parametrize("case", ["base", "head_dim_12", "row_stride"])
def test_flash_bf16_view_tma_cannot_load_raises(dev, case):
    """A bf16 CUDA tensor that breaks TMA's 16-byte rules raises
    ValueError naming the rule, and nothing launches: it is never sent to
    the CUDA-core kernels or the plain version."""
    b, l, h, d = 2, 40, 2, 12 if case == "head_dim_12" else 64
    q = torch.randn((b, l, h * d), device=dev).bfloat16()
    if case == "base":          # the whole tensor 2 bytes off 16
        bad = torch.zeros(b * l * h * d + 1, device=dev,
                          dtype=torch.bfloat16)[1:].view(b, l, h * d)
        match = "base address"
    elif case == "head_dim_12":  # heads 24 bytes apart
        bad = q.clone()
        match = "head stride 12 elements"
    else:                       # blhd rows 4 elements past the data
        bad = torch.zeros((b, l, h * d + 4), device=dev,
                          dtype=torch.bfloat16)[..., :h * d]
        match = "row stride 132 elements"
    bad.copy_(q)
    reset_launch_counts()
    heads, bad_heads = q.view(b, l, h, d), bad.view(b, l, h, d)
    with pytest.raises(ValueError, match=match):
        flash_attention.flash_fwd_heads(heads, bad_heads, heads, scale=0.3)
    if case != "row_stride":    # packed operands must be contiguous
        with pytest.raises(ValueError, match=match):
            flash_attention.flash_fwd(q, bad, q, h, scale=0.3)
        o = torch.zeros_like(q)
        lse = torch.zeros((b, l, h), device=dev)
        with pytest.raises(ValueError, match=match):
            flash_attention.flash_bwd(q, q, bad, o, lse, q, h, scale=0.3)
    torch.cuda.synchronize()
    assert not any(launch_counts().values()), launch_counts()


def test_flash_heads_kernel_reads_strided_views(dev):
    """A bhld view of blhd storage (no copy) gives the blhd result."""
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((2, 48, 4, 64), generator=g, device=dev)
               for _ in range(3))
    o, lse = flash_attention.flash_fwd_heads(q, k, v, scale=0.125)
    ot, lset = flash_attention.flash_fwd_heads(
        *(t.transpose(1, 2) for t in (q, k, v)), scale=0.125,
        layout="bhld")
    assert torch.equal(o, ot.transpose(1, 2)) and torch.equal(lse, lset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 1024), (37, 300), (1, 1),
                                   (3, 1000003), (2, 3, 1030)])
def test_cumsum_kernel_matches_plain(dev, dtype, shape):
    """B9: forward and reverse scans against the plain version; rows
    longer than one tile carry across tiles."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    reset_launch_counts()
    for reverse in (False, True):
        out = reduction.cumsum(x, reverse=reverse)
        ref = reduction.cumsum_plain(x, reverse=reverse)
        assert out.dtype == dtype and out.shape == x.shape
        # f32 sums of the same terms in another order (the kernel's carry
        # adds one tile total at a time): a few f32 ulps of the running
        # sum of |x| over up to ~1000 tiles; bf16 adds one rounding of the
        # output. A lost or doubled carry is off by a whole tile's sum.
        mag = reduction.cumsum_plain(x.float().abs(), reverse=reverse)
        lim = 1e-5 * mag + 1e-6
        if dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * ref.float().abs()
        assert bool(((out.float() - ref.float()).abs() <= lim).all())
    assert launch_counts()["cumsum"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(4096, 1024), (37, 300)])
@pytest.mark.parametrize("affine", [True, False])
def test_layernorm_bwd_kernel_matches_plain(dev, dtype, rows, n, affine):
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(dtype)
    dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    gamma = torch.rand((n,), generator=g, device=dev) + 0.5 if affine \
        else None
    beta = torch.randn((n,), generator=g, device=dev) if affine else None
    _, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
    dx, dg, db = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
    rdx, rdg, rdb = norm.layernorm_bwd_plain(x, gamma, mean, rstd, dy)
    assert dx.dtype == dtype
    _close(dx, rdx, F32_TOL if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    if affine:
        # sums over `rows` f32 terms in another order
        _close(dg, rdg, dict(atol=1e-3, rtol=1e-4))
        _close(db, rdb, dict(atol=1e-3, rtol=1e-4))
        again = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        assert torch.equal(again[1], dg) and torch.equal(again[2], db)
    else:
        assert dg is None and db is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 30522])
def test_softmax_bwd_kernel_matches_plain(dev, dtype, n):
    g = torch.Generator(device=dev).manual_seed(n + 5)
    y = norm.softmax_fwd(
        (torch.randn((9, n), generator=g, device=dev) * 3).to(dtype))
    dy = torch.randn((9, n), generator=g, device=dev).to(dtype)
    dx = norm.softmax_bwd(y, dy)
    assert dx.dtype == dtype
    _close(dx, norm.softmax_bwd_plain(y, dy),
           dict(atol=1e-6, rtol=1e-4) if dtype == torch.float32
           else dict(atol=1e-4, rtol=1e-2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(4096, 1024), (37, 300), (1, 20000)])
@pytest.mark.parametrize("affine", [True, False])
def test_rmsnorm_kernels_match_plain(dev, dtype, rows, n, affine):
    g = torch.Generator(device=dev).manual_seed(rows + n + 7)
    x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(dtype)
    dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    gamma = torch.rand((n,), generator=g, device=dev) + 0.5 if affine \
        else None
    reset_launch_counts()
    y, rstd = norm.rmsnorm_fwd(x, gamma)
    ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
    assert y.dtype == dtype and rstd.shape == (rows, 1)
    f32 = dtype == torch.float32
    _close(y, ry, F32_TOL if f32 else dict(atol=2e-2, rtol=2e-2))
    _close(rstd, rrstd, F32_TOL)
    if n > norm.MAX_BWD_COLS:
        return
    dx, dg = norm.rmsnorm_bwd(x, gamma, rstd, dy)
    rdx, rdg = norm.rmsnorm_bwd_plain(x, gamma, rstd, dy)
    _close(dx, rdx, F32_TOL if f32 else dict(atol=2e-2, rtol=2e-2))
    assert launch_counts()["rmsnorm_fwd"] == 1
    assert launch_counts()["rmsnorm_bwd"] == 1
    if affine:
        # f32 sums over `rows` terms in another order
        _close(dg, rdg, dict(atol=1e-3, rtol=1e-4))
        assert torch.equal(norm.rmsnorm_bwd(x, gamma, rstd, dy)[1], dg)
    else:
        assert dg is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 1, 7, 4096, 1_000_003])
@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
def test_reduce_kernel_matches_plain(dev, dtype, n, kind):
    g = torch.Generator(device=dev).manual_seed(n + 11)
    x = torch.randn((n,), generator=g, device=dev).to(dtype)
    reset_launch_counts()
    out = reduction.reduce(x, kind)
    ref = reduction.reduce_plain(x, kind)
    assert out.dtype == torch.float32 and out.shape == ()
    assert launch_counts()["reduce"] == 1
    if kind == "max":
        assert torch.equal(out, ref)
    else:
        # f32 sums in another order
        assert abs(float(out) - float(ref)) <= \
            1e-6 * float(x.float().abs().sum()) + 1e-30
    assert torch.equal(reduction.reduce(x, kind), out)
    # a view off the 16-byte boundary takes the unvectorised loads
    if n > 1:
        tail = x[1:]
        _close(reduction.reduce(tail, kind),
               reduction.reduce_plain(tail, kind),
               dict(atol=1e-6 * float(x.float().abs().sum()) + 1e-30,
                    rtol=0))


def test_reduce_autograd_on_card(dev):
    x = torch.randn((3, 5), device=dev, requires_grad=True)
    (g,) = torch.autograd.grad(reduction.fused_reduce(x, "mean"), x)
    torch.testing.assert_close(g, torch.full_like(x, 1 / 15))
    with pytest.raises(TypeError, match="forward-only"):
        torch.autograd.grad(reduction.fused_reduce(x, "max"), x)


def test_registry_selects_the_kernels_on_the_card(dev):
    from flexflow_tpu_torch.kernels.registry import FAMILIES, KernelRegistry

    reg = KernelRegistry()
    for fam in FAMILIES:
        c = reg.select(fam, device=dev, record=False)
        assert c and c.reason == "default"
    assert not reg.select("softmax", device="cpu", record=False)


def test_fit_step_on_card_matches_cpu_port(dev):
    """One SGD step of a small encoder through the card's kernels (f32)
    against the port on the CPU, same weights and batch."""
    from flexflow_tpu_torch.models import (TransformerConfig,
                                           build_bert_encoder)
    from flexflow_tpu_torch.runtime.optimizers import SGDOptimizer
    from flexflow_tpu_torch import FFConfig, FFModel, DataType, LossType

    def build(device):
        cfg = FFConfig(batch_size=4, allow_mixed_precision=False,
                       device=device)
        m = FFModel(cfg)
        tok = m.create_tensor([4, 80], DataType.DT_INT32)
        build_bert_encoder(m, tok, TransformerConfig(
            hidden_size=64, embedding_size=64, num_heads=4, num_layers=2,
            sequence_length=80, vocab_size=97))
        m.compile(optimizer=SGDOptimizer(m, lr=0.05, momentum=0.9),
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  generator=torch.Generator().manual_seed(3))
        return m

    cpu, gpu = build("cpu"), build("cuda")
    gpu.load_params(cpu.params)
    rng = np.random.RandomState(4)
    x = rng.randint(0, 97, size=(4, 80)).astype(np.int32)
    y = rng.randint(0, 2, size=(4, 80, 1)).astype(np.int32)
    reset_launch_counts()
    h_gpu = gpu.fit(x, y, batch_size=4, epochs=1)
    for k in ("flash_fwd", "flash_bwd", "layernorm_fwd", "layernorm_bwd",
              "softmax_fwd", "softmax_bwd"):
        assert launch_counts()[k] > 0, (k, launch_counts())
    h_cpu = cpu.fit(x, y, batch_size=4, epochs=1)
    assert h_gpu[0]["loss"] == pytest.approx(h_cpu[0]["loss"], rel=1e-4)
    # one step: its StepStats record holds the epoch's loss
    assert [r["loss"] for r in gpu.step_stats.records()] == \
        [h_gpu[0]["loss"]]
    for op, ws in cpu.params.items():
        for w, t in ws.items():
            torch.testing.assert_close(gpu.params[op][w].cpu(), t,
                                       atol=1e-5, rtol=1e-4)


# softmax_fwd and rmsnorm_fwd by route (kernels/norm.py softmax_plan,
# rmsnorm_plan) at the edge shapes: N x R, f32 and bf16
NORM_EDGE_N = [1, 2, 10, 33, 300, 1000, 1024, 30522, 70000]
NORM_EDGE_R = [1, 8, 16, 128, 4095]
SOFTMAX_TOL = {torch.float32: dict(atol=1e-7, rtol=1e-4),
               torch.bfloat16: dict(atol=1e-6, rtol=1e-2)}


def _softmax_route_case(dev, rows, n, dtype, x=None):
    if x is None:
        g = torch.Generator(device=dev).manual_seed(rows * 7 + n)
        x = (torch.randn((rows, n), generator=g, device=dev) * 4).to(dtype)
    plan = norm.softmax_plan(rows, n, dtype,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count)
    reset_launch_counts()
    y = norm.softmax_fwd(x)
    counts = launch_counts()
    assert counts["softmax_fwd"] == 1
    assert counts[f"softmax_fwd/{plan.route}"] == 1, (plan, counts)
    assert y.dtype == dtype and y.shape == x.shape
    _close(y, norm.softmax_fwd_plain(x), SOFTMAX_TOL[dtype])
    assert torch.equal(norm.softmax_fwd(x), y)  # the same bits every call
    return plan, y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", NORM_EDGE_R)
@pytest.mark.parametrize("n", NORM_EDGE_N)
def test_softmax_routes_match_plain(dev, n, rows, dtype):
    _softmax_route_case(dev, rows, n, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3])
def test_softmax_loop_route_matches_plain(dev, rows, dtype):
    plan, _ = _softmax_route_case(dev, rows, 300000, dtype)
    assert plan.route == "loop"


@pytest.mark.parametrize("rows,n", [(8, 30522), (16, 30522), (1, 70000)])
@pytest.mark.parametrize("clusters", [2, 4, 8])
def test_softmax_cluster_sizes_match_plain(dev, rows, n, clusters):
    """Every cluster size the plan may choose (FILL_CTAS set to ask for
    it), held against the plain version and the split emulation."""
    keep = norm.FILL_CTAS
    try:
        norm.FILL_CTAS = rows * clusters
        for dtype in (torch.float32, torch.bfloat16):
            plan, y = _softmax_route_case(dev, rows, n, dtype)
            # a row of 70000 needs 4 CTAs' registers at least
            assert (plan.route, plan.cluster) == ("cluster", max(
                clusters, 4 if n > 32768 else 1)), plan
            x = (torch.randn((rows, n), device=dev) * 4).to(dtype)
            y = norm.softmax_fwd(x)
            _close(y, norm.softmax_split_plain(x.cpu(), plan.cluster).to(dev),
                   SOFTMAX_TOL[dtype])
    finally:
        norm.FILL_CTAS = keep


def test_softmax_cluster_sizes_fit_the_card(dev):
    """cudaOccupancyMaxActiveClusters at the plans' sizes: every cluster
    the plan may launch fits on the card at least once."""
    from flexflow_tpu_torch.kernels import _build

    lib = _build.library()
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n in ((8, 30522), (16, 30522), (1, 70000), (4095, 70000),
                        (64, 30522)):
            plan = norm.softmax_plan(rows, n, dtype)
            got = lib.ff_softmax_max_active_clusters(
                plan.threads, plan.per_thread, plan.cluster,
                _build.DTYPE_CODES[dtype])
            assert got >= 1, (rows, n, dtype, plan, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", NORM_EDGE_R)
@pytest.mark.parametrize("n", NORM_EDGE_N)
@pytest.mark.parametrize("affine", [True, False])
def test_rmsnorm_routes_match_plain(dev, n, rows, dtype, affine):
    g = torch.Generator(device=dev).manual_seed(rows * 3 + n)
    x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(dtype)
    gamma = torch.rand((n,), generator=g, device=dev) + 0.5 if affine \
        else None
    if n > norm.rmsnorm_max_n(dtype):  # the parent refused it too
        with pytest.raises(ValueError, match="shared memory"):
            norm.rmsnorm_fwd(x, gamma)
        return
    plan = norm.rmsnorm_plan(rows, n, dtype)
    reset_launch_counts()
    y, rstd = norm.rmsnorm_fwd(x, gamma)
    assert launch_counts()[f"rmsnorm_fwd/{plan.route}"] == 1
    ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
    _close(y, ry, F32_TOL if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    _close(rstd, rrstd, F32_TOL)
    y2, rstd2 = norm.rmsnorm_fwd(x, gamma)
    assert torch.equal(y2, y) and torch.equal(rstd2, rstd)
    if plan.route == "warp":
        # the emulation repeats the warp route's order of operations
        ey, erstd = norm.rmsnorm_warp_plain(
            x.cpu(), gamma.cpu() if affine else None, 1e-6)
        assert torch.equal(rstd.cpu(), erstd)
        assert torch.equal(y.cpu(), ey)


@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("n", [1, 33, 300, 30522])
def test_norm_vector_routes_read_rows_at_any_phase(dev, offset, n):
    """bf16 x starting `offset` elements past a 16-byte boundary (rows of
    N = 30522 are 4 mod 16 bytes long besides): y lands at x's phase, and
    both kernels agree with their plain versions."""
    rows = 9
    buf = torch.randn(rows * n + 16, device=dev).bfloat16()
    x = buf[offset:offset + rows * n].view(rows, n)
    assert x.data_ptr() % 16 == 2 * offset
    plan, y = _softmax_route_case(dev, rows, n, torch.bfloat16, x=x)
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    gamma = torch.rand(n, device=dev) + 0.5
    y, rstd = norm.rmsnorm_fwd(x, gamma)
    ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
    _close(y, ry, dict(atol=2e-2, rtol=2e-2))
    _close(rstd, rrstd, F32_TOL)


def test_norm_forward_wrappers_raise_where_the_parent_raised(dev):
    x = torch.randn((4, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        norm.softmax_fwd(x.t())
    with pytest.raises(ValueError, match="contiguous"):
        norm.rmsnorm_fwd(x.t())
    with pytest.raises(ValueError, match="non-empty"):
        norm.softmax_fwd(torch.zeros((0, 64), device=dev))
    with pytest.raises(ValueError, match="gamma must be"):
        norm.rmsnorm_fwd(x, torch.ones(63, device=dev))
    with pytest.raises(ValueError, match="several devices"):
        norm.rmsnorm_fwd(x, torch.ones(64))
    with pytest.raises(ValueError, match="shared memory"):
        norm.rmsnorm_fwd(torch.randn((2, 58081), device=dev))


# layernorm_bwd by route (kernels/norm.py layernorm_bwd_plan) at the edge
# shapes: N x R, f32 and bf16, with and without gamma; N = MAX_BWD_COLS is
# the widest row the parent's block kernel took
LN_BWD_EDGE_N = [1, 2, 33, 300, 1000, 1024, 2048, 2049,
                 norm.LN_BWD_BLOCK_AFFINE_MAX_N, norm.MAX_BWD_COLS]
LN_BWD_EDGE_R = [1, 7, 8, 9, 4095]
LN_BWD_DX_TOL = {torch.float32: F32_TOL,
                 torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# dgamma / dbeta against the plain version: f32 sums over the rows in
# another order (the kernel table's tolerance)
LN_BWD_SUM_TOL = dict(atol=1e-3, rtol=1e-4)


def _ln_bwd_route_case(dev, x, dy, gamma):
    """layernorm_bwd on the card against its plain version, its route
    counted, dgamma / dbeta the same bits on two calls; on the warp route
    dx, dgamma and dbeta equal to the bit to `layernorm_bwd_warp_plain`
    (every step of the kernel rounded by __fmul_rn / __fadd_rn /
    __fdiv_rn, none fused). Returns the plan."""
    rows, n = x.shape
    beta = torch.zeros(n, device=dev) if gamma is not None else None
    _, mean, rstd = norm.layernorm_fwd(x.contiguous(), gamma, beta)
    plan = norm.layernorm_bwd_plan(
        rows, n, x.dtype,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    reset_launch_counts()
    dx, dg, db = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
    counts = launch_counts()
    assert counts["layernorm_bwd"] == 1
    assert counts[f"layernorm_bwd/{plan.route}"] == 1, (plan, counts)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert dx.data_ptr() % 16 == x.data_ptr() % 16
    rdx, rdg, rdb = norm.layernorm_bwd_plain(x, gamma, mean, rstd, dy)
    _close(dx, rdx, LN_BWD_DX_TOL[x.dtype])
    if gamma is None:
        assert dg is None and db is None
    else:
        _close(dg, rdg, LN_BWD_SUM_TOL)
        _close(db, rdb, LN_BWD_SUM_TOL)
        again = norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        assert torch.equal(again[1], dg) and torch.equal(again[2], db)
        assert torch.equal(again[0], dx)
    if plan.route == "warp":
        edx, edg, edb = norm.layernorm_bwd_warp_plain(
            x.cpu(), gamma.cpu() if gamma is not None else None, mean.cpu(),
            rstd.cpu(), dy.cpu(), plan.blocks, x.data_ptr() % 16,
            plan.threads // 32)
        assert torch.equal(dx.cpu(), edx)
        if gamma is not None:
            assert torch.equal(dg.cpu(), edg) and torch.equal(db.cpu(), edb)
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", LN_BWD_EDGE_R)
@pytest.mark.parametrize("n", LN_BWD_EDGE_N)
@pytest.mark.parametrize("affine", [True, False])
def test_layernorm_bwd_routes_match_plain(dev, n, rows, dtype, affine):
    g = torch.Generator(device=dev).manual_seed(rows * 5 + n)
    x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(dtype)
    dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    gamma = torch.rand((n,), generator=g, device=dev) + 0.5 if affine \
        else None
    if affine and n > norm.LN_BWD_BLOCK_AFFINE_MAX_N:
        # the parent's launch failed here (shared memory); now a ValueError
        _, mean, rstd = norm.layernorm_fwd(x, gamma, torch.zeros_like(gamma))
        with pytest.raises(ValueError, match="shared memory"):
            norm.layernorm_bwd(x, gamma, mean, rstd, dy)
        return
    plan = _ln_bwd_route_case(dev, x, dy, gamma)
    assert plan.route == ("warp" if n <= norm.LN_BWD_WARP_MAX_N
                          else "block")


@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("n", [1, 33, 300, 1000])
@pytest.mark.parametrize("dy_offset", ["same", "other"])
def test_layernorm_bwd_reads_rows_at_any_phase(dev, offset, n, dy_offset):
    """bf16 x starting `offset` elements past a 16-byte boundary, dy at the
    same phase (16-byte loads) or at another (element loads): dx lands at
    x's phase and matches the plain version and the warp emulation."""
    rows = 37
    g = torch.Generator(device=dev).manual_seed(offset * 100 + n)
    buf = torch.randn(rows * n + 16, generator=g, device=dev).bfloat16()
    x = buf[offset:offset + rows * n].view(rows, n)
    dbuf = torch.randn(rows * n + 16, generator=g, device=dev).bfloat16()
    d0 = offset if dy_offset == "same" else (offset + 3) % 8
    dy = dbuf[d0:d0 + rows * n].view(rows, n)
    assert x.data_ptr() % 16 == 2 * offset
    gamma = torch.rand(n, generator=g, device=dev) + 0.5
    assert _ln_bwd_route_case(dev, x, dy, gamma).route == "warp"


def test_layernorm_bwd_refuses_what_the_parent_refused(dev):
    x = torch.randn((2, norm.MAX_BWD_COLS + 1), device=dev)
    stat = torch.zeros((2, 1), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        norm.layernorm_bwd(x, None, stat, stat, x)
    y = torch.randn((4, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        norm.layernorm_bwd(y.t().contiguous().t(), None,
                           torch.zeros((4, 1), device=dev),
                           torch.ones((4, 1), device=dev), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0, 1, 4096, 4097, 1_000_003, 2 ** 26])
@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
@pytest.mark.parametrize("offset", [0, 1])
def test_reduce_routes_match_plain(dev, dtype, n, kind, offset):
    """Both routes of `reduce_plan`, x 16-byte aligned and one element
    past it: the route counted, the plain version's result (max exactly,
    sum and mean within f32 rounding of sum |x|), the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(n + 13)
    x = torch.randn((n + offset,), generator=g, device=dev).to(dtype)[offset:]
    plan = reduction.reduce_plan(n, dtype)
    reset_launch_counts()
    out = reduction.reduce(x, kind)
    counts = launch_counts()
    assert counts["reduce"] == 1 and counts[f"reduce/{plan.route}"] == 1
    ref = reduction.reduce_plain(x, kind)
    assert out.dtype == torch.float32 and out.shape == ()
    if kind == "max":
        assert torch.equal(out, ref)
    else:
        assert abs(float(out) - float(ref)) <= \
            1e-6 * float(x.float().abs().sum()) + 1e-30
    assert torch.equal(reduction.reduce(x, kind), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_at_the_route_threshold(dev, dtype):
    """The last n the "cta" route takes and the first of "grid", with a
    NaN in the max and every 16-byte phase of the start."""
    last = reduction.REDUCE_CTA_MAX_BYTES // torch.tensor(
        [], dtype=dtype).element_size()
    g = torch.Generator(device=dev).manual_seed(7)
    base = torch.randn((last + 16,), generator=g, device=dev).to(dtype)
    for n, route in ((last, "cta"), (last + 1, "grid")):
        for offset in range(0, 16 // base.element_size()):
            x = base[offset:offset + n]
            assert reduction.reduce_plan(n, dtype).route == route
            for kind in ("sum", "mean", "max"):
                out = reduction.reduce(x, kind)
                ref = reduction.reduce_plain(x, kind)
                if kind == "max":
                    assert torch.equal(out, ref)
                else:
                    assert abs(float(out) - float(ref)) <= \
                        1e-6 * float(x.float().abs().sum())
        y = base[:n].clone()
        y[n // 3] = float("nan")
        assert torch.isnan(reduction.reduce(y, "max"))


# layernorm_fwd by route (kernels/norm.py layernorm_fwd_plan) at the edge
# shapes: N x R, f32 and bf16, with and without gamma and beta; N = 58080
# is the widest row the parent's block kernel took
LN_FWD_EDGE_N = [1, 2, 33, 300, 1000, 1024, 2048, 2049,
                 norm.layernorm_max_n(torch.float32)]
LN_FWD_EDGE_R = [1, 7, 8, 9, 4095]
LN_FWD_Y_TOL = {torch.float32: F32_TOL,
                torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def _ln_fwd_route_case(dev, x, gamma, beta):
    """layernorm_fwd on the card against its plain version, its route
    counted, y and the statistics the same bits on two calls; on the warp
    route y, mean and rstd equal to the bit to `layernorm_fwd_warp_plain`
    (every step of the kernel rounded on its own, none fused). Returns
    the plan."""
    rows, n = x.shape
    plan = norm.layernorm_fwd_plan(
        rows, n, x.dtype,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    reset_launch_counts()
    y, mean, rstd = norm.layernorm_fwd(x, gamma, beta)
    counts = launch_counts()
    assert counts["layernorm_fwd"] == 1
    assert counts[f"layernorm_fwd/{plan.route}"] == 1, (plan, counts)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.data_ptr() % 16 == x.data_ptr() % 16
    assert mean.shape == (rows, 1) and rstd.dtype == torch.float32
    ry, rmean, rrstd = norm.layernorm_fwd_plain(x, gamma, beta, 1e-5)
    _close(y, ry, LN_FWD_Y_TOL[x.dtype])
    _close(mean, rmean, F32_TOL)
    _close(rstd, rrstd, F32_TOL)
    again = norm.layernorm_fwd(x, gamma, beta)
    assert all(torch.equal(a, b) for a, b in zip(again, (y, mean, rstd)))
    if plan.route == "warp":
        ey, emean, erstd = norm.layernorm_fwd_warp_plain(
            x.cpu(), gamma.cpu() if gamma is not None else None,
            beta.cpu() if beta is not None else None, 1e-5,
            x.data_ptr() % 16)
        assert torch.equal(mean.cpu(), emean)
        assert torch.equal(rstd.cpu(), erstd)
        assert torch.equal(y.cpu(), ey)
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", LN_FWD_EDGE_R)
@pytest.mark.parametrize("n", LN_FWD_EDGE_N)
@pytest.mark.parametrize("affine", [True, False])
def test_layernorm_fwd_routes_match_plain(dev, n, rows, dtype, affine):
    g = torch.Generator(device=dev).manual_seed(rows * 11 + n)
    x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(dtype)
    gamma = beta = None
    if affine:
        gamma = torch.rand((n,), generator=g, device=dev) + 0.5
        beta = torch.randn((n,), generator=g, device=dev)
    plan = _ln_fwd_route_case(dev, x, gamma, beta)
    assert plan.route == ("warp" if n <= norm.LN_FWD_WARP_MAX_N
                          else "block")


@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("n", [1, 33, 300, 1000])
def test_layernorm_fwd_reads_rows_at_any_phase(dev, offset, n):
    """bf16 x starting `offset` elements past a 16-byte boundary: y lands
    at x's phase and matches the plain version and the warp emulation;
    gamma and beta one element past a 16-byte boundary (element loads)."""
    rows = 37
    g = torch.Generator(device=dev).manual_seed(offset * 10 + n)
    buf = torch.randn(rows * n + 16, generator=g, device=dev).bfloat16()
    x = buf[offset:offset + rows * n].view(rows, n)
    assert x.data_ptr() % 16 == 2 * offset
    gamma = torch.rand(n + 1, generator=g, device=dev)[1:] + 0.5
    beta = torch.randn(n + 1, generator=g, device=dev)[1:]
    assert _ln_fwd_route_case(dev, x, gamma, beta).route == "warp"


def test_layernorm_fwd_raises_where_the_parent_raised_or_failed(dev):
    """The parent's launch failed above 58080 columns (shared memory);
    now a ValueError that names the limit."""
    x = torch.randn((4, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        norm.layernorm_fwd(x.t())
    with pytest.raises(ValueError, match="non-empty"):
        norm.layernorm_fwd(torch.zeros((0, 64), device=dev))
    with pytest.raises(ValueError, match="several devices"):
        norm.layernorm_fwd(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="58080"):
        norm.layernorm_fwd(torch.randn((2, 58081), device=dev))


# rmsnorm_bwd by route (kernels/norm.py rmsnorm_bwd_plan) at the edge
# shapes; N = MAX_BWD_COLS is the widest row the parent's kernel took
RMS_BWD_EDGE_N = [1, 2, 33, 300, 1000, 1024, 2048, 2049, norm.MAX_BWD_COLS]


def _rms_bwd_route_case(dev, x, dy, gamma):
    """rmsnorm_bwd on the card against its plain version, its route
    counted, dx and dgamma the same bits on two calls; on the warp route
    both equal to the bit to `rmsnorm_bwd_warp_plain`. Returns the
    plan."""
    rows, n = x.shape
    _, rstd = norm.rmsnorm_fwd(x.contiguous(), gamma)
    plan = norm.rmsnorm_bwd_plan(
        rows, n, x.dtype,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    reset_launch_counts()
    dx, dg = norm.rmsnorm_bwd(x, gamma, rstd, dy)
    counts = launch_counts()
    assert counts["rmsnorm_bwd"] == 1
    assert counts[f"rmsnorm_bwd/{plan.route}"] == 1, (plan, counts)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    assert dx.data_ptr() % 16 == x.data_ptr() % 16
    rdx, rdg = norm.rmsnorm_bwd_plain(x, gamma, rstd, dy)
    _close(dx, rdx, LN_BWD_DX_TOL[x.dtype])
    again = norm.rmsnorm_bwd(x, gamma, rstd, dy)
    assert torch.equal(again[0], dx)
    if gamma is None:
        assert dg is None
    else:
        _close(dg, rdg, LN_BWD_SUM_TOL)
        assert torch.equal(again[1], dg)
    if plan.route == "warp":
        edx, edg = norm.rmsnorm_bwd_warp_plain(
            x.cpu(), gamma.cpu() if gamma is not None else None, rstd.cpu(),
            dy.cpu(), plan.blocks, x.data_ptr() % 16, plan.threads // 32)
        assert torch.equal(dx.cpu(), edx)
        if gamma is not None:
            assert torch.equal(dg.cpu(), edg)
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", LN_BWD_EDGE_R)
@pytest.mark.parametrize("n", RMS_BWD_EDGE_N)
@pytest.mark.parametrize("affine", [True, False])
def test_rmsnorm_bwd_routes_match_plain(dev, n, rows, dtype, affine):
    g = torch.Generator(device=dev).manual_seed(rows * 13 + n)
    x = (torch.randn((rows, n), generator=g, device=dev) * 2 + 1).to(dtype)
    dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    gamma = torch.rand((n,), generator=g, device=dev) + 0.5 if affine \
        else None
    plan = _rms_bwd_route_case(dev, x, dy, gamma)
    assert plan.route == ("warp" if n <= norm.LN_BWD_WARP_MAX_N
                          else "block")


@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("n", [1, 33, 300, 1000])
@pytest.mark.parametrize("dy_offset", ["same", "other"])
def test_rmsnorm_bwd_reads_rows_at_any_phase(dev, offset, n, dy_offset):
    """bf16 x starting `offset` elements past a 16-byte boundary, dy at the
    same phase (16-byte loads) or at another (element loads): dx lands at
    x's phase and matches the plain version and the warp emulation."""
    rows = 37
    g = torch.Generator(device=dev).manual_seed(offset * 100 + n + 1)
    buf = torch.randn(rows * n + 16, generator=g, device=dev).bfloat16()
    x = buf[offset:offset + rows * n].view(rows, n)
    dbuf = torch.randn(rows * n + 16, generator=g, device=dev).bfloat16()
    d0 = offset if dy_offset == "same" else (offset + 3) % 8
    dy = dbuf[d0:d0 + rows * n].view(rows, n)
    assert x.data_ptr() % 16 == 2 * offset
    gamma = torch.rand(n, generator=g, device=dev) + 0.5
    assert _rms_bwd_route_case(dev, x, dy, gamma).route == "warp"


def test_rmsnorm_bwd_refuses_what_the_parent_refused(dev):
    x = torch.randn((2, norm.MAX_BWD_COLS + 1), device=dev)
    rstd = torch.ones((2, 1), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        norm.rmsnorm_bwd(x, None, rstd, x)
    y = torch.randn((4, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        norm.rmsnorm_bwd(y.t().contiguous().t(), None,
                         torch.ones((4, 1), device=dev), y)
    with pytest.raises(ValueError, match="rstd must be"):
        norm.rmsnorm_bwd(y, None, torch.ones((3, 1), device=dev), y)


# softmax_bwd by route (kernels/norm.py softmax_bwd_plan) at the edge
# shapes: the forward's N x R and the rows route's last N and the
# register routes' first (512, 513)
SOFTMAX_BWD_EDGE_N = [1, 2, 10, 33, 512, 513, 1000, 1024, 30522, 70000]
SOFTMAX_BWD_TOL = {torch.float32: dict(atol=1e-6, rtol=1e-4),
                   torch.bfloat16: dict(atol=1e-4, rtol=1e-2)}


def _softmax_bwd_route_case(dev, y, dy):
    """softmax_bwd on the card: its route counted, dx at y's 16-byte
    phase, within tolerance of the plain version, equal to the bit to
    `softmax_bwd_split_plain` at the plan's split (every product and sum
    rounded on its own, in the kernel's order; the emulation runs on the
    card in torch's elementwise kernels, none fused) and the same bits on
    two calls. Returns the plan."""
    rows, n = y.shape
    plan = norm.softmax_bwd_plan(
        rows, n, y.dtype,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    reset_launch_counts()
    dx = norm.softmax_bwd(y, dy)
    counts = launch_counts()
    assert counts["softmax_bwd"] == 1
    assert counts[f"softmax_bwd/{plan.route}"] == 1, (plan, counts)
    assert dx.dtype == y.dtype and dx.shape == y.shape
    assert dx.data_ptr() % 16 == y.data_ptr() % 16
    _close(dx, norm.softmax_bwd_plain(y, dy), SOFTMAX_BWD_TOL[y.dtype])
    emu = norm.softmax_bwd_split_plain(y, dy, plan.cluster,
                                       y.data_ptr() % 16)
    assert torch.equal(dx, emu), (plan, float((dx.float()
                                               - emu.float()).abs().max()))
    assert torch.equal(norm.softmax_bwd(y, dy), dx)
    return plan


def _softmax_bwd_inputs(dev, rows, n, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    y = norm.softmax_fwd(
        (torch.randn((rows, n), generator=g, device=dev) * 3).to(dtype))
    dy = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    return y, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", NORM_EDGE_R)
@pytest.mark.parametrize("n", SOFTMAX_BWD_EDGE_N)
def test_softmax_bwd_routes_match_plain_and_emulation(dev, n, rows, dtype):
    y, dy = _softmax_bwd_inputs(dev, rows, n, dtype, rows * 11 + n)
    plan = _softmax_bwd_route_case(dev, y, dy)
    assert plan.route == ("rows" if n <= norm.SOFTMAX_BWD_ROWS_MAX_N
                          else "block" if plan.cluster == 1 else "cluster")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(1, 300000), (3, 300000),
                                    (2, 131073)])
def test_softmax_bwd_loop_route_matches_plain_and_emulation(dev, rows, n,
                                                            dtype):
    y, dy = _softmax_bwd_inputs(dev, rows, n, dtype, rows + n)
    plan = _softmax_bwd_route_case(dev, y, dy)
    # bf16 rows up to 262144 still fit a cluster of 8
    assert plan.route == ("loop" if n > 262144 or dtype == torch.float32
                          else "cluster")


@pytest.mark.parametrize("rows,n", [(8, 30522), (16, 30522), (1, 70000),
                                    (128, 30522)])
@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
def test_softmax_bwd_cluster_sizes_match_emulation(dev, rows, n, clusters):
    """Every cluster size the plan may choose (SOFTMAX_BWD_FILL_CTAS set
    to ask for it), against the plain version and the emulation."""
    keep = norm.SOFTMAX_BWD_FILL_CTAS
    try:
        norm.SOFTMAX_BWD_FILL_CTAS = rows * clusters
        for dtype in (torch.float32, torch.bfloat16):
            y, dy = _softmax_bwd_inputs(dev, rows, n, dtype, clusters + n)
            plan = _softmax_bwd_route_case(dev, y, dy)
            # CTAs whose 1024 threads hold the row at 4 vector pairs each
            need = norm._pow2_at_least(-(-n * y.element_size() // 16
                                         // (1024 * 4)))
            assert plan.cluster == max(clusters, need), plan
    finally:
        norm.SOFTMAX_BWD_FILL_CTAS = keep


@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("n", [1, 33, 300, 1000, 30522])
@pytest.mark.parametrize("dy_offset", ["same", "other"])
def test_softmax_bwd_reads_rows_at_any_phase(dev, offset, n, dy_offset):
    """bf16 y starting `offset` elements past a 16-byte boundary, dy at
    the same phase (16-byte loads) or another (element loads): dx lands at
    y's phase, the emulation's bits."""
    rows = 37
    g = torch.Generator(device=dev).manual_seed(offset * 100 + n + 2)
    buf = torch.softmax(torch.randn(rows * n + 16, generator=g,
                                    device=dev), 0).bfloat16()
    y = buf[offset:offset + rows * n].view(rows, n)
    dbuf = torch.randn(rows * n + 16, generator=g, device=dev).bfloat16()
    d0 = offset if dy_offset == "same" else (offset + 3) % 8
    dy = dbuf[d0:d0 + rows * n].view(rows, n)
    assert y.data_ptr() % 16 == 2 * offset
    _softmax_bwd_route_case(dev, y, dy)


# cumsum by route (kernels/reduction.py cumsum_plan): "row" at the
# table's, the short and the many-row shapes, "split" from the first N
# past CUMSUM_ROW_MAX_N, at chunk edges, and the long rows
CUMSUM_EDGE = [(1, 1), (37, 300), (4096, 1024), (1, 4096), (1056, 5000),
               (1, 4097), (1055, 5000), (2, 3 * 1024 * 175 + 1),
               (3, 1000003), (1, 1000003), (132, 100000), (1, 2 ** 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", CUMSUM_EDGE)
def test_cumsum_routes_match_plain_and_emulation(dev, rows, n, dtype):
    """Forward and reverse scans: within chip_smoke's tolerance of the
    plain version, equal to the bit to `cumsum_split_plain` at the plan's
    chunk (on the card, torch's elementwise adds), the same bits on two
    calls, one call on the plan's route each."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = torch.randn((rows, n), generator=g, device=dev).to(dtype)
    plan = reduction.cumsum_plan(
        rows, n, dtype,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.route == ("row" if rows >= 1056 or n <= 4096 else "split")
    for reverse in (False, True):
        reset_launch_counts()
        out = reduction.cumsum(x, reverse=reverse)
        counts = launch_counts()
        assert counts["cumsum"] == 1
        assert counts[f"cumsum/{plan.route}"] == 1, (plan, counts)
        ref = reduction.cumsum_plain(x, reverse=reverse)
        mag = reduction.cumsum_plain(x.float().abs(), reverse=reverse)
        lim = 1e-5 * mag + 1e-6
        if dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * ref.float().abs()
        assert bool(((out.float() - ref.float()).abs() <= lim).all())
        emu = reduction.cumsum_split_plain(
            x, plan.chunk if plan.route == "split" else None, reverse)
        assert torch.equal(out, emu), (plan, reverse)
        assert torch.equal(reduction.cumsum(x, reverse=reverse), out)


def test_cumsum_split_gradient_is_the_reversed_scan(dev):
    """fused_cumsum's gradient on the split route: the reversed scan of
    the cotangent, two launches a call counted once."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((3, 1000003), generator=g, device=dev)
    gx = torch.randn((3, 1000003), generator=g, device=dev)
    xg = x.clone().requires_grad_()
    reset_launch_counts()
    c = reduction.fused_cumsum(xg)
    (dx,) = torch.autograd.grad(c, xg, gx)
    counts = launch_counts()
    assert counts["cumsum"] == 2 and counts["cumsum/split"] == 2, counts
    plan = reduction.cumsum_plan(3, 1000003, torch.float32)
    assert torch.equal(dx, reduction.cumsum_split_plain(gx, plan.chunk,
                                                        True))


def _opt_tensors(dev, sizes, moments, seed, offset=0):
    """Weights, gradients and state of `sizes`, each a view at `offset`
    elements into its own buffer (offset 1: no tensor 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(n, dtype, scale=1.0):
        buf = (scale * torch.randn((n + offset,), generator=g, device=dev)
               ).to(dtype)
        return buf[offset:]

    ws = [make(n, torch.float32) for n in sizes]
    gs = [make(n, torch.float32, 0.1) for n in sizes]
    ms = [make(n, moments, 0.01) for n in sizes]
    vs = [make(n, moments, 1e-4).abs() for n in sizes]
    return ws, gs, ms, vs


OPT_SIZES = (1, 7, 4097, 1024 * 1024 + 3, 8192, 8191)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adam_kernel_matches_plain_to_the_bit(dev, moments, wd, offset):
    """Three Adam updates of a ragged list (sizes 1, 7, 4097, 2^20 + 3,
    8192, 8191; aligned and one element off), the kernel against the
    per-tensor loop on the card: every weight and moment the same bits,
    one launch an update, step read and not advanced."""
    ws, gs, ms, vs = _opt_tensors(dev, OPT_SIZES, moments, 3, offset)
    ref = [[t.clone() for t in ts] for ts in (ws, ms, vs)]
    step = torch.zeros((), dtype=torch.int32, device=dev)
    lr = torch.tensor(1e-3, device=dev)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd)
    for _ in range(3):
        reset_launch_counts()
        optimizer.adam(ws, gs, ms, vs, step, lr, **hyper)
        assert launch_counts()["optimizer_adam"] == 1
        optimizer.adam_plain(*ref[:1], gs, *ref[1:], step, lr,
                             hyper["beta1"], hyper["beta2"], hyper["eps"],
                             wd)
        step.add_(1)
    for got, want in zip((ws, ms, vs), ref):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("momentum,nesterov,wd", [
    (0.0, False, 0.0), (0.0, False, 0.01), (0.9, False, 0.0),
    (0.9, True, 0.01)])
def test_sgd_kernel_matches_plain_to_the_bit(dev, momentum, nesterov, wd,
                                             offset):
    ws, gs, bufs, _ = _opt_tensors(dev, OPT_SIZES, torch.float32, 4, offset)
    ref = [[t.clone() for t in ts] for ts in (ws, bufs)]
    lr = torch.tensor(0.05, device=dev)
    for _ in range(3):
        reset_launch_counts()
        optimizer.sgd(ws, gs, bufs, lr, momentum=momentum,
                      nesterov=nesterov, weight_decay=wd)
        assert launch_counts()["optimizer_sgd"] == 1
        optimizer.sgd_plain(ref[0], gs, ref[1], lr, momentum, nesterov, wd)
    for got, want in zip((ws, bufs), ref):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_optimizer_kernel_splits_long_lists(dev):
    """More tensors than one launch takes: one launch a slice."""
    per = optimizer.max_tensors()
    sizes = [5] * (per + 3)
    ws, gs, ms, vs = _opt_tensors(dev, sizes, torch.float32, 5)
    ref = [[t.clone() for t in ts] for ts in (ws, ms, vs)]
    step = torch.zeros((), dtype=torch.int32, device=dev)
    lr = torch.tensor(1e-2, device=dev)
    reset_launch_counts()
    optimizer.adam(ws, gs, ms, vs, step, lr, beta1=0.9, beta2=0.999,
                   eps=1e-8)
    assert launch_counts()["optimizer_adam"] == 2
    optimizer.adam_plain(ref[0], gs, ref[1], ref[2], step, lr, 0.9, 0.999,
                         1e-8, 0.0)
    for got, want in zip((ws, ms, vs), ref):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _card_mlp(dev, mixed=False):
    from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig,
                                    FFModel, MetricsType)
    m = FFModel(FFConfig(batch_size=16, allow_mixed_precision=mixed,
                         device=str(dev)))
    t = m.create_tensor([16, 12])
    t = m.dense(t, 32, ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(t, 4))
    m.compile(optimizer=AdamOptimizer(m, alpha=1e-2,
                                      moments_dtype=torch.bfloat16),
              metrics=[MetricsType.METRICS_ACCURACY,
                       MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m


def test_fit_steps_per_execution_graph_matches_eager(dev):
    """fit(steps_per_execution=4) on the card (a CUDA graph of 4 captured
    steps, replayed) against eager single steps from the same weights:
    every loss and every weight the same bits, the launches counted at
    the warm-up and the capture only, a new lr read by the replays."""
    rng = np.random.RandomState(2)
    x = rng.randn(16 * 13, 12).astype(np.float32)
    y = rng.randint(0, 4, size=(16 * 13, 1)).astype(np.int32)
    eager, graphed = _card_mlp(dev), _card_mlp(dev)
    graphed.load_params({op: {w: t.cpu() for w, t in ws.items()}
                         for op, ws in eager.params.items()})
    for m in (eager, graphed):
        m.fit(x, y, epochs=1, steps_per_execution=1 if m is eager else 4)
        m.set_learning_rate(3e-3)
    reset_launch_counts()
    he = eager.fit(x, y, epochs=2)
    eager_launches = launch_counts()["optimizer_adam"]
    reset_launch_counts()
    hg = graphed.fit(x, y, epochs=2, steps_per_execution=4)
    # 13 steps an epoch: 3 replayed dispatches and 1 trailing step
    assert eager_launches == 26
    assert launch_counts()["optimizer_adam"] == 2
    assert [r["steps"] for r in graphed.step_stats.records()] == \
        [4, 4, 4, 1] * 2
    assert torch.equal(eager.opt_state["step"], graphed.opt_state["step"])
    for op, ws in eager.params.items():
        for w, t in ws.items():
            assert torch.equal(t, graphed.params[op][w]), (op, w)
    losses_e = [r["loss"] for r in eager.step_stats.records()]
    for a, b in zip(he, hg):
        assert a["accuracy"] == b["accuracy"]
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-6)
    assert all(np.isfinite(losses_e))


@pytest.mark.parametrize("k", [1, 4])
def test_eval_after_fit_reads_the_trained_weights_on_card(dev, k):
    """A bf16 model on the card: eval, fit, eval, fit, eval. Eval's bf16
    casts of the weights are cached by weight version; the update kernel
    (K = 1) and a graph replay (K = 4: the first fit one captured
    dispatch and two replays, the second fit replays only) write the
    weights through raw pointers and bump the versions, so each eval
    after a fit equals a fresh model's given the trained weights."""
    rng = np.random.RandomState(3)
    x = rng.randn(16 * 12, 12).astype(np.float32)
    y = rng.randint(0, 4, size=(16 * 12, 1)).astype(np.int32)
    m = _card_mlp(dev, mixed=True)
    before = m.eval(x, y)
    for launches in ((12, 8), (12, 0)):
        reset_launch_counts()
        m.fit(x, y, epochs=1, steps_per_execution=k)
        assert launch_counts()["optimizer_adam"] == launches[k == 4]
        after = m.eval(x, y)
        fresh = _card_mlp(dev, mixed=True)
        fresh.load_params(m.params)
        assert after == fresh.eval(x, y)
        assert after["loss"] != before["loss"]
        before = after


def test_reference_impl_runs_the_plain_update_on_card(dev):
    """The update under the registry's "reference": the per-tensor loop on
    the card, no launch, the kernel's bits (fit from the same weights,
    every other family on auto)."""
    from flexflow_tpu_torch.kernels.registry import KERNELS

    rng = np.random.RandomState(5)
    x = rng.randn(16 * 5, 12).astype(np.float32)
    y = rng.randint(0, 4, size=(16 * 5, 1)).astype(np.int32)
    fused, plain = _card_mlp(dev), _card_mlp(dev)
    plain.load_params({op: {w: t.cpu() for w, t in ws.items()}
                       for op, ws in fused.params.items()})
    reset_launch_counts()
    fused.fit(x, y, epochs=2)
    assert launch_counts()["optimizer_adam"] == 10
    reset_launch_counts()
    with KERNELS.override("optimizer", "reference"):
        plain.fit(x, y, epochs=2)
    assert launch_counts()["optimizer_adam"] == 0
    for op, ws in fused.params.items():
        for w, t in ws.items():
            assert torch.equal(t, plain.params[op][w]), (op, w)


def _route_case(dev, case):
    """(function of no arguments, the route it must take) for a planned
    route with a programmatic dependent launch or a thread-block cluster."""
    g = torch.Generator(device=dev).manual_seed(len(case))

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if case == "softmax_fwd/cluster":
        x = rnd(8, 30522)
        return lambda: norm.softmax_fwd(x)
    if case == "softmax_bwd/cluster":
        y, dy = torch.softmax(rnd(8, 30522).float(), -1).bfloat16(), \
            rnd(8, 30522)
        return lambda: norm.softmax_bwd(y, dy)
    if case == "layernorm_bwd/warp":
        x, dy = rnd(4096, 1024), rnd(4096, 1024)
        gamma = torch.rand((1024,), generator=g, device=dev) + 0.5
        _, mean, rstd = norm.layernorm_fwd(x, gamma, torch.zeros_like(gamma))
        return lambda: norm.layernorm_bwd(x, gamma, mean, rstd, dy)
    if case == "reduce/grid":
        x = rnd(1 << 22, dtype=torch.float32)
        return lambda: reduction.reduce(x, "sum")
    if case == "cumsum/split":
        x = rnd(3, 1000003, dtype=torch.float32)
        return lambda: reduction.cumsum(x)
    b, m, h, d = 8, 1024, 16, 64
    q, kc, vc = rnd(b, 1, h, d), rnd(b, m, h, d), rnd(b, m, h, d)
    pos = torch.tensor([0, 37, 255, 511, 700, 880, 1000, 1022],
                       dtype=torch.int32, device=dev)
    return lambda: decode.decode_attention(q, kc, vc, pos, scale=0.125,
                                           block_k=512)


@pytest.mark.parametrize("case", [
    "softmax_fwd/cluster", "softmax_bwd/cluster", "layernorm_bwd/warp",
    "reduce/grid", "cumsum/split", "decode_attention/tc"])
def test_planned_routes_replay_in_a_cuda_graph(dev, case):
    """The routes that launch a programmatic dependent (LayerNorm
    backward's column sums, the reduce's finish, the scan's chunk scan,
    decode's combine) or a thread-block cluster (softmax), captured in a
    CUDA graph and replayed twice: the eager call's bits, on its route."""
    fn = _route_case(dev, case)
    reset_launch_counts()
    eager = fn()
    assert launch_counts()[case] == 1, launch_counts()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    eager = eager if isinstance(eager, tuple) else (eager,)
    out = out if isinstance(out, tuple) else (out,)
    for _ in range(2):
        for t in out:
            if t is not None:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert (a is None and b is None) or torch.equal(a, b), case


# -- serving's compiled dispatches (CUDA graphs) -----------------------------
def _serve_lm(seed, hidden=64, heads=4, batch=2, window=16):
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    return build_tiny_lm(batch, window, vocab=50, hidden=hidden, heads=heads,
                         mixed_precision=True, device="cuda",
                         generator=torch.Generator().manual_seed(seed))


def _snapshot(tree):
    return {n: {v: t.clone() for v, t in c.items()} for n, c in tree.items()}


def _restore(tree, saved):
    for n, c in tree.items():
        for v, t in c.items():
            t.copy_(saved[n][v])


def _same_tree(a, b):
    return all(torch.equal(a[n][v], b[n][v]) for n in a for v in a[n])


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_batcher_replays_equal_the_eager_walk_to_the_bit(dev, temperature):
    """One decode iteration and one prefill chunk of a batcher, through
    the eager walk and through a graph replay, on the same caches and
    inputs: the same probabilities, picks and cache rows, to the bit."""
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    lm = _serve_lm(31)
    cb = ContinuousBatcher(lm, max_len=64, num_slots=2, page_size=8,
                           temperature=temperature, top_k=5)
    g = torch.Generator(device=dev).manual_seed(32)
    with torch.no_grad():
        for c in cb._caches.values():
            for t in c.values():
                t.copy_(torch.randn(t.shape, generator=g, device=dev))
        saved = _snapshot(cb._caches)
        dec = np.array([7, 3, 40, 21, 11, -5], np.int32)  # toks, pos, keys
        chunk = np.array([4, 9, 1, 33, 2, 8, 0, 0, 37], np.int32)  # at 37
        cb._decode_dispatch(dec)          # warm-up, then capture
        cb._chunk_dispatch(1, chunk)
        runs = []
        for replay in (True, False):
            _restore(cb._caches, saved)
            if replay:
                toks = cb._decode_dispatch(dec)
            else:
                cb._dec_in.put(dec)
                cb._decode_walk()
                toks = cb._dec_tok.cpu().numpy()
            dprobs = cb._dec_probs.clone()
            if replay:
                cb._chunk_dispatch(1, chunk)
            else:
                cb._chunk_in.put(chunk)
                cb._chunk_walk(1)()
            runs.append((toks, dprobs, cb._chunk_probs.clone(),
                         _snapshot(cb._caches)))
    (t0, d0, c0, k0), (t1, d1, c1, k1) = runs
    assert cb.graphs == {"warmups": 2, "captures": 2, "replays": 2,
                         "eager_walks": 0}
    assert np.array_equal(t0, t1)
    assert torch.equal(d0, d1) and torch.equal(c0, c1)
    assert _same_tree(k0, k1)


def test_session_graph_of_k_steps_equals_eager_steps(dev):
    """The session's K-step dispatch replayed against the same K steps
    run eagerly from the same carry and caches: tokens, carry and cache
    rows the same bits."""
    from flexflow_tpu_torch.serving import GenerativeSession

    lm = _serve_lm(41)
    s = GenerativeSession(lm, max_len=48)
    prompt = np.random.RandomState(3).randint(1, 50, size=(2, 9))
    s.generate(prompt, 9, tokens_per_dispatch=4)   # captures k=4
    call, out = s._decode_scan(4, 0.0, None)
    assert call.graph is not None
    with torch.no_grad():
        saved = _snapshot(s._caches)
        carry = [t.clone() for t in (s._tok, s._pos, s._keys)]
        runs = []
        for replay in (True, False):
            _restore(s._caches, saved)
            for t, c in zip((s._tok, s._pos, s._keys), carry):
                t.copy_(c)
            call() if replay else call.fn()
            runs.append((out.clone(), s._tok.clone(), s._pos.clone(),
                         _snapshot(s._caches)))
    (o0, t0, p0, k0), (o1, t1, p1, k1) = runs
    assert torch.equal(o0, o1) and torch.equal(t0, t1)
    assert torch.equal(p0, p1) and _same_tree(k0, k1)
    assert s.counts["replays"] >= 2


def _serve_tokens(model, prompts, **kw):
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    with ContinuousBatcher(model, max_len=48, num_slots=2, page_size=4,
                           max_queue=8, **kw) as cb:
        toks = [r.result(timeout=120).tolist()
                for r in [cb.submit(p, 8) for p in prompts]]
        return toks, cb


def test_batcher_recaptures_after_load_params(dev):
    """The stale-cast trap: a batcher that served, then had new weights
    loaded, serves what a fresh batcher over the new weights serves (its
    graphs read the bf16 weight casts they were captured with, so a
    weight change must re-capture)."""
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    lm, other = _serve_lm(51), _serve_lm(52)
    rng = np.random.RandomState(53)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (5, 11, 7)]
    want, _ = _serve_tokens(other, prompts)
    with ContinuousBatcher(lm, max_len=48, num_slots=2, page_size=4,
                           max_queue=8, prefix_cache_pages=0) as cb:
        first = [cb.submit(p, 8).result(timeout=120).tolist()
                 for p in prompts]
        captured = cb.graphs["captures"]
        lm.load_params(other.params)
        second = [cb.submit(p, 8).result(timeout=120).tolist()
                  for p in prompts]
        assert cb.graphs["captures"] > captured
    assert second == want and first != want


def test_two_replicas_of_one_model_capture_at_once(dev):
    """Two fleet replicas sharing one model warm up and capture their
    graphs at the same time on one card (one scheduler thread each: the
    process-wide gc guard, the bf16 casts made once and outside any
    capture) and serve the greedy tokens one replica serves alone."""
    import threading

    from flexflow_tpu_torch.serving.fleet import Replica

    lm = _serve_lm(71)
    rng = np.random.RandomState(72)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (5, 11, 7, 9, 13, 6)]
    solo = Replica("solo", lm, max_len=48, num_slots=2, page_size=4)
    try:
        want = [solo.submit(p, 8).result(timeout=120).tolist()
                for p in prompts]
    finally:
        solo.stop()
    # a fresh model of the same weights: no cast is cached yet, so the
    # two replicas' first walks race to make them
    lm2 = _serve_lm(71)
    reps = [Replica(f"r{i}", lm2, max_len=48, num_slots=2, page_size=4)
            for i in range(2)]
    try:
        go = threading.Barrier(2)
        got = [None, None]

        def serve(i):
            go.wait(timeout=60)
            hs = [reps[i].submit(p, 8) for p in prompts]
            got[i] = [h.result(timeout=120).tolist() for h in hs]

        ts = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert got == [want, want]
        for r in reps:
            g = r.batcher.stats()["graphs"]
            assert g["captures"] >= 2 and g["eager_walks"] == 0, g
    finally:
        for r in reps:
            r.stop()


def test_import_into_a_captured_decode_graph_continues_unified(dev):
    """A prefill replica parks a request, its rows are exported and
    imported into a decode replica whose decode graph is already
    captured: the imported request's tokens, greedy and sampled with
    one seed, are a unified batcher's (the import writes the captured
    caches in place)."""
    from flexflow_tpu_torch.serving.sched import (ContinuousBatcher,
                                                  RequestCancelled,
                                                  RequestState)

    lm = _serve_lm(81)
    rng = np.random.RandomState(82)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (9, 17)]
    for temperature in (0.0, 0.8):
        kw = dict(max_len=48, num_slots=2, page_size=4,
                  temperature=temperature, top_k=5)
        with ContinuousBatcher(lm, **kw) as uni:
            want = [uni.submit(p, 8, seed=5 + i).result(timeout=120)
                    .tolist() for i, p in enumerate(prompts)]
        with ContinuousBatcher(lm, role="prefill", **kw) as pre, \
                ContinuousBatcher(lm, role="decode", **kw) as dec:
            # the decode replica's graphs captured by its own traffic
            dec.submit(prompts[0], 4).result(timeout=120)
            captured = dec.graphs["captures"]
            assert captured >= 1
            for i, p in enumerate(prompts):
                req = pre.submit(p, 8, seed=5 + i)
                deadline = time.monotonic() + 120
                while req.state is not RequestState.PARKED:
                    assert time.monotonic() < deadline and not req.done()
                    time.sleep(0.002)
                exp = pre.request_export(req).wait(60)
                assert exp["bytes"] == sum(
                    r.nbytes for r in exp["rows"].values())
                inner = dec.request_import(
                    exp["desc"], exp["rows"], req.prompt, exp["last_tok"],
                    8 - len(req.tokens), seed=req.seed).wait(60)
                assert pre.release_parked(req)
                with pytest.raises(RequestCancelled):
                    req.result(timeout=60)
                got = req.tokens + inner.result(timeout=120).tolist()
                assert got == want[i], (temperature, i)
            assert dec.graphs["captures"] == captured


def test_batcher_captures_while_another_thread_uses_the_card(dev):
    """Capture runs in the scheduler thread only: a thread that keeps
    launching matmuls on its own stream meanwhile neither breaks a
    capture nor changes a token."""
    import threading

    lm = _serve_lm(61)
    rng = np.random.RandomState(62)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (6, 13, 3, 9)]
    want, _ = _serve_tokens(lm, prompts)
    stop = threading.Event()
    errors = []

    def busy():
        try:
            stream = torch.cuda.Stream(dev)
            x = torch.randn((512, 512), device=dev)
            with torch.cuda.stream(stream):
                while not stop.is_set():
                    x = torch.tanh(x @ x)
                    stream.synchronize()
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    t = threading.Thread(target=busy)
    t.start()
    try:
        got, cb = _serve_tokens(lm, prompts)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not errors and got == want
    assert cb.graphs["captures"] > 0 and cb.graphs["eager_walks"] == 0


def test_session_sampled_tokens_same_at_any_dispatch_size(dev):
    """Sampled tokens on the card are identical at tokens_per_dispatch 1
    and 8 (the noise is a function of key, position and id, computed in
    the graph); another seed gives others."""
    from flexflow_tpu_torch.serving import GenerativeSession

    lm = _serve_lm(71)
    prompt = np.random.RandomState(72).randint(1, 50, size=(2, 6))
    kw = dict(temperature=1.0, top_k=10, seed=5)
    s = GenerativeSession(lm, max_len=48)
    one = s.generate(prompt, 20, tokens_per_dispatch=1, **kw)
    eight = s.generate(prompt, 20, tokens_per_dispatch=8, **kw)
    np.testing.assert_array_equal(one, eight)
    assert not np.array_equal(
        s.generate(prompt, 20, tokens_per_dispatch=8, temperature=1.0,
                   top_k=10, seed=6), one)
    assert s.counts["captures"] >= 3 and s.counts["replays"] > 0


def test_spec_replay_equals_the_eager_walk_to_the_bit(dev):
    """One speculative iteration (3 draft steps, the C = 4 verify, the
    accept) through its graph replay and through the eager walk, on the
    same caches and inputs, one slot's verify rows running past the cache
    edge: the picks, counts, probabilities and both models' cache rows
    the same bits; every pick the argmax of its verify row."""
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    lm = _serve_lm(81)
    draft = _serve_lm(82, hidden=32, heads=2)
    cb = ContinuousBatcher(lm, max_len=64, num_slots=2, page_size=8,
                           draft_model=draft, spec_tokens=3)
    g = torch.Generator(device=dev).manual_seed(83)
    with torch.no_grad():
        for tree in (cb._caches, cb._draft_caches):
            for c in tree.values():
                for t in c.values():
                    t.copy_(torch.randn(t.shape, generator=g, device=dev))
        saved = (_snapshot(cb._caches), _snapshot(cb._draft_caches))
        host = np.array([7, 3, 40, 62], np.int32)  # tokens, positions
        cb._spec_dispatch(host)                   # warm-up, then capture
        runs = []
        for replay in (True, False):
            _restore(cb._caches, saved[0])
            _restore(cb._draft_caches, saved[1])
            if replay:
                out = cb._spec_dispatch(host)
            else:
                cb._spec_in.put(host)
                cb._spec_walk()
                out = cb._spec_out.cpu().numpy()
            runs.append((out, cb._spec_probs.clone(),
                         _snapshot(cb._caches), _snapshot(cb._draft_caches)))
    (o0, p0, t0, d0), (o1, p1, t1, d1) = runs
    assert cb.graphs == {"warmups": 1, "captures": 1, "replays": 1,
                         "eager_walks": 0}
    assert np.array_equal(o0, o1) and torch.equal(p0, p1)
    assert _same_tree(t0, t1) and _same_tree(d0, d1)
    assert np.array_equal(p1.argmax(-1)[:, :3].cpu().numpy(), o1[:, :3])
    assert ((o1[:, 3] >= 1) & (o1[:, 3] <= 3)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernel_at_the_spec_shape_matches_plain(dev, dtype):
    """The multi-query kernel at speculative decoding's verify shape: 8
    slots of 4 queries over a 1024-row cache, ragged positions, one slot
    whose last queries lie past the cache's last row."""
    g = torch.Generator(device=dev).manual_seed(84)
    q = torch.randn((8, 4, 16, 64), generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn((8, 1024, 16, 64), generator=g, device=dev)
              .to(dtype) for _ in range(2))
    pos = torch.tensor([0, 37, 255, 511, 700, 880, 1000, 1022],
                       dtype=torch.int32, device=dev)
    reset_launch_counts()
    out = decode.multiquery_decode_attention(q, kc, vc, pos, scale=0.125,
                                             block_k=512)
    ref = decode.decode_attention_plain(q, kc, vc, pos, 0.125)
    _close(out, ref, F32_TOL if dtype == torch.float32 else BF16_TOL)
    route = "tc" if dtype == torch.bfloat16 else "cc"
    assert launch_counts()[f"multiquery_decode_attention/{route}"] == 1


def test_spec_tokens_equal_plain_f32_on_card_and_cpu(dev):
    """At f32, 2 layers: the speculative batcher's greedy tokens on the
    card (an untied 1-layer draft, and the target as its own draft) equal
    the card's plain greedy tokens and the CPU's speculative run's, and
    the card's spec counts the CPU's."""
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm

    def lm(layers, seed, device):
        return build_tiny_lm(2, 16, vocab=50, hidden=64, heads=4,
                             layers=layers, device=device,
                             generator=torch.Generator().manual_seed(seed))

    rng = np.random.RandomState(85)
    work = [(rng.randint(1, 50, size=(n,)).astype(np.int32), 48 - n)
            for n in (5, 11, 3, 20)]  # each ends at the cache edge

    def run(model, draft):
        with ContinuousBatcher(model, max_len=48, num_slots=2, page_size=4,
                               max_queue=8, draft_model=draft,
                               spec_tokens=3) as cb:
            toks = [r.result(timeout=120).tolist()
                    for r in [cb.submit(p, n) for p, n in work]]
        return toks, cb.stats()

    card, draft = lm(2, 86, "cuda"), lm(1, 87, "cuda")
    cpu, cpu_draft = lm(2, 86, "cpu"), lm(1, 87, "cpu")
    plain, _ = run(card, None)
    spec, st = run(card, draft)
    tied, st_tied = run(card, card)
    cpu_spec, cpu_st = run(cpu, cpu_draft)
    assert spec == tied == plain == cpu_spec
    # per-request sums (the EWMA also depends on which requests share an
    # iteration, which admission timing decides)
    for key in ("proposed", "accepted", "acceptance"):
        assert st["spec"][key] == cpu_st["spec"][key]
    assert st_tied["spec"]["acceptance"] == 1.0
    assert st["graphs"]["captures"] > 0 and st["graphs"]["eager_walks"] == 0


def test_graph_replays_draw_from_the_registered_generator(dev):
    """A CapturedCall that draws from its registered generator: the
    warm-up draws, then each replay draws anew, the numbers an eager
    draw from the same generator state gives, in order."""
    from flexflow_tpu_torch.runtime.graphs import CapturedCall, graph_counts

    g = torch.Generator(device=dev).manual_seed(7)
    out = torch.empty(4096, device=dev)
    call = CapturedCall(
        lambda: out.copy_(torch.rand(4096, generator=g, device=dev)), dev,
        [], graph_counts(), generators=[g])
    got = []
    for _ in range(4):
        call()
        got.append(out.clone())
    ref = torch.Generator(device=dev).manual_seed(7)
    want = [torch.rand(4096, generator=ref, device=dev) for _ in range(4)]
    assert call.counts["replays"] == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[1], got[2])


def test_f32_conv_runs_in_true_f32_on_card(dev):
    """Conv2DOp's product in f32 with the caller's TF32 flag on: forward
    and both gradients within 1e-5 of a float64 CPU run (TF32 would be
    ~1e-3 off), and the caller's flag unchanged after."""
    from flexflow_tpu_torch.ops.conv import _Conv2d

    g = torch.Generator().manual_seed(11)
    x = torch.randn((8, 64, 32, 32), generator=g)
    w = torch.randn((64, 32, 3, 3), generator=g) * 0.05
    dy = torch.randn((8, 64, 16, 16), generator=g)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        xc, wc = (t.to(dev).requires_grad_() for t in (x, w))
        y = _Conv2d.apply(xc, wc, (2, 2), (1, 1), 2)
        y.backward(dy.to(dev))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    xd, wd = (t.double().requires_grad_() for t in (x, w))
    yd = torch.nn.functional.conv2d(xd, wd, None, 2, 1, 1, 2)
    yd.backward(dy.double())
    for got, want in ((y, yd), (xc.grad, xd.grad), (wc.grad, wd.grad)):
        err = float((got.detach().cpu().double() - want.detach()).abs().max())
        assert err <= 1e-5 * float(want.detach().abs().max()), err


def _card_opset_model(device, kind, lr=0.05, mixed=True, seed=0):
    from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                    SGDOptimizer)

    m = FFModel(FFConfig(batch_size=4, allow_mixed_precision=mixed,
                         device=device, seed=seed))
    if kind == "conv":
        t = m.create_tensor([4, 3, 16, 16])
        t = m.batch_norm(m.conv2d(t, 8, 3, 3, 1, 1, 1, 1))
        t = m.dropout(m.flat(m.pool2d(t, 2, 2, 2, 2, 0, 0)), 0.3)
    else:
        t = m.create_tensor([4, 16, 32])
        t = m.multihead_attention(t, t, t, 32, 4, dropout=0.2)
        t = m.lstm(m.dropout(t, 0.1), 16, return_sequences=False)
    m.softmax(m.dense(t, 5, ActiMode.AC_MODE_NONE))
    m.compile(optimizer=SGDOptimizer(m, lr=lr),
              loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              generator=torch.Generator().manual_seed(1))
    return m


def _dispatch_losses(m, k):
    """The per-step losses of `m`'s last K-step dispatch: the captured
    graph's static output (runtime/executor.py MultiStep.out), which
    fit's StepStats record reduces to their mean, as JAX's does."""
    ms = m._multi_step(k)
    return [float(v) for v in ms.out[ms.keys.index("loss")].cpu()]


def _step_losses(m, x, y, k, batch):
    """Every step's loss of one epoch over (x, y): K = 1 from fit's
    StepStats records, one a step; K > 1 by one fit call a dispatch (the
    same steps in the same order), each dispatch's losses read from its
    graph's static output."""
    if k == 1:
        m.fit(x, y, epochs=1)
        return [r["loss"] for r in m.step_stats.records()]
    out = []
    for lo in range(0, len(x), k * batch):
        m.fit(x[lo:lo + k * batch], y[lo:lo + k * batch], epochs=1,
              steps_per_execution=k)
        out += _dispatch_losses(m, k)
    return out


@pytest.mark.parametrize("kind", ["conv", "attention"])
def test_dropout_graph_steps_equal_eager_steps_on_card(dev, kind):
    """12 steps of a dropout model (batch norm and dropout; attention
    dropout, dropout and LSTM) as 3 dispatches of a K = 4 CUDA graph
    against 12 eager steps from the same weights and seed: losses,
    weights and running statistics the same bits. With lr 0 and one
    batch, two replays give other losses (new masks)."""
    rng = np.random.RandomState(9)
    shape = (4, 3, 16, 16) if kind == "conv" else (4, 16, 32)
    x = rng.randn(48, *shape[1:]).astype(np.float32)
    y = rng.randint(0, 5, size=(48, 1)).astype(np.int32)
    runs = []
    for k in (1, 4):
        m = _card_opset_model("cuda", kind)
        runs.append((_step_losses(m, x, y, k, 4), m.params, m.state))
    (le, pe, se), (lg, pg, sg) = runs
    assert le == lg and len(le) == 12 and np.all(np.isfinite(le))
    for op, ws in pe.items():
        for w, t in ws.items():
            assert torch.equal(t, pg[op][w]), (op, w)
    for op, vs in se.items():
        for v, t in vs.items():
            assert torch.equal(t, sg[op][v]), (op, v)
    m = _card_opset_model("cuda", kind, lr=0.0)
    same = _step_losses(m, np.concatenate([x[:4]] * 12),
                        np.concatenate([y[:4]] * 12), 4, 4)
    d = [same[i:i + 4] for i in (0, 4, 8)]
    assert d[1] != d[2] and len(set(d[1] + d[2])) == 8


@pytest.mark.parametrize("kind", ["conv", "attention"])
def test_opset_f32_steps_on_card_match_cpu(dev, kind):
    """The same models in f32 on the card and on the CPU (their dropout
    masks come from two generators, so training is compared through
    eval): eval from the same weights and running statistics agrees
    within 1e-4, before and after each SGD step on the card whose
    weights and statistics the CPU model then loads."""
    rng = np.random.RandomState(10)
    shape = (4, 3, 16, 16) if kind == "conv" else (4, 16, 32)
    x = rng.randn(8, *shape[1:]).astype(np.float32)
    y = rng.randint(0, 5, size=(8, 1)).astype(np.int32)
    card = _card_opset_model("cuda", kind, mixed=False)
    cpu = _card_opset_model("cpu", kind, mixed=False)
    for _ in range(2):
        a, b = card.eval(x, y, batch_size=4), cpu.eval(x, y, batch_size=4)
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        card.fit(x, y, epochs=1)
        cpu.load_params({op: {w: t.cpu() for w, t in ws.items()}
                         for op, ws in card.params.items()})
        cpu.load_state({op: {v: t.cpu() for v, t in vs.items()}
                        for op, vs in card.state.items()})


def test_capture_survives_dead_graphs_in_reference_cycles(dev):
    """A captured call dropped in a reference cycle (as a model with a
    K-step graph is) must not be collected while another call captures:
    no collection runs until the second call's capture, where the first
    call's last outside reference goes and the collector is set to run
    at every allocation; the second call still captures and replays."""
    import gc

    from flexflow_tpu_torch.runtime.graphs import CapturedCall, graph_counts

    old = gc.get_threshold()
    gc.set_threshold(10**9, 10**9, 10**9)
    try:
        a_out = torch.zeros(4, device=dev)
        a = CapturedCall(lambda: a_out.add_(1), dev, [], graph_counts())
        a()
        a.cycle = a
        holder = [a]  # the only reference from outside the cycle
        del a
        b_out = torch.zeros(4, device=dev)
        calls = []

        def fn():
            calls.append(1)
            if len(calls) == 2:  # the capture (the first call: warm-up)
                holder.clear()
                gc.set_threshold(1, 1, 1)
            _ = [[] for _ in range(100)]  # allocations: a collection
            b_out.add_(1)

        b = CapturedCall(fn, dev, [], graph_counts())
        for _ in range(3):
            b()
    finally:
        gc.set_threshold(*old)
    torch.cuda.synchronize()
    assert b.counts["replays"] == 2 and float(b_out[0]) == 3.0


def _card_moe(device, mixed=True, experts=16, alpha=0.5, lambda_bal=0.01):
    """A 2-layer switch transformer (hidden 64, top-2, a capacity that
    drops assignments) on `device`, weights from a fixed generator, Adam."""
    import flexflow_tpu_torch as pt
    import flexflow_tpu_torch.models  # noqa: F401

    m = pt.FFModel(pt.FFConfig(batch_size=4, allow_mixed_precision=mixed,
                               device=device, seed=3))
    tokens = m.create_tensor([4, 32], pt.DataType.DT_INT32)
    pt.models.build_moe_transformer(m, tokens, pt.models.MoeTransformerConfig(
        hidden_size=64, num_heads=4, num_layers=2, num_experts=experts,
        top_k=2, capacity_factor=alpha, lambda_bal=lambda_bal,
        vocab_size=256))
    m.compile(optimizer=pt.AdamOptimizer(m, alpha=1e-3, moments_dtype=(
        torch.bfloat16 if mixed else torch.float32)),
        loss_type=pt.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
        generator=torch.Generator().manual_seed(3))
    return m


def test_moe_graph_steps_equal_eager_steps_on_card(dev):
    """12 steps of the switch transformer as 3 dispatches of a K = 4 CUDA
    graph against 12 eager steps from the same weights: losses (with the
    load-balance losses), weights and router state the same bits, and
    assignments dropped."""
    rng = np.random.RandomState(4)
    x = rng.randint(0, 256, size=(48, 32)).astype(np.int32)
    y = rng.randint(0, 2, size=(48, 32, 1)).astype(np.int32)
    runs = []
    for k in (1, 4):
        m = _card_moe("cuda")
        runs.append((_step_losses(m, x, y, k, 4), m.params, m.state))
    (le, pe, se), (lg, pg, sg) = runs
    assert le == lg and len(le) == 12 and np.all(np.isfinite(le))
    for op, ws in pe.items():
        for w, t in ws.items():
            assert torch.equal(t, pg[op][w]), (op, w)
    for op, vs in se.items():
        for v, t in vs.items():
            assert torch.equal(t, sg[op][v]), (op, v)
    assert all(float(vs["dropped"]) > 0 for vs in se.values())


def test_moe_walk_replays_equal_the_eager_walk_on_card(dev):
    """An inference walk of the MoE model handed its state, captured in a
    CUDA graph (runtime/graphs.py CapturedCall), against the eager walk:
    the outputs and the router state's increments the same bits."""
    from flexflow_tpu_torch.runtime.graphs import CapturedCall, graph_counts

    m = _card_moe("cuda")
    x = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, size=(4, 32)).astype(np.int32)).to(dev)
    feeds = {m.input_ops[0].name: x}
    out = torch.empty((4, 32, 2), dtype=torch.bfloat16, device=dev)

    def walk():
        with torch.no_grad():
            out.copy_(m.executor.forward_values(feeds, state=m.state)[
                m.final_tensor.guid])

    walk()
    eager = out.clone()
    d0 = {op: vs["dropped"].clone() for op, vs in m.state.items()}
    call = CapturedCall(walk, dev, [], graph_counts())
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    assert call.counts["replays"] == 2
    assert torch.equal(out, eager)
    for op, vs in m.state.items():
        # the eager walk, the warm-up and two replays (a capture runs
        # nothing): 4 walks
        assert torch.equal(vs["dropped"], 4 * d0[op]), op


def test_moe_gather_backward_same_bits_on_two_runs(dev):
    """The dispatch / combine backward is gathers only: two backward
    passes of one step give the same gradient bits (with atomics they
    could differ)."""
    m = _card_moe("cuda", experts=8, alpha=1.0)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randint(0, 256, size=(4, 32)).astype(
        np.int32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 2, size=(4, 32, 1)).astype(
        np.int32)).to(dev)
    step = m.executor.build_grad_metrics_step(m.loss.fn, m.metrics,
                                              m.final_tensor)
    g1, _ = step({m.input_ops[0].name: x}, y)
    g2, _ = step({m.input_ops[0].name: x}, y)
    for op, ws in g1.items():
        for w, t in ws.items():
            assert torch.equal(t, g2[op][w]), (op, w)
    assert float(g1["l1_moe_experts"]["kernel"].abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_tie_order_on_card_is_jax_lower_index_first(dev, dtype):
    """Planted ties (and bf16 gate probabilities near 1/256): TopKOp on
    the card gives the lower index first among equal values, as
    jax.lax.top_k, and the CPU's indices."""
    import flexflow_tpu_torch as pt

    rng = np.random.RandomState(9)
    near = (1 / 256 + rng.randint(-2, 3, size=(1024, 256)) * 2**-16)
    for arr, k in ((np.array([[0.1, 0.5, 0.5, 0.2, 0.5],
                              [0.3, 0.3, 0.3, 0.3, 0.3]]), 3), (near, 2)):
        arr = arr.astype(np.float32)
        outs = []
        for device in ("cuda", "cpu"):
            m = pt.FFModel(pt.FFConfig(batch_size=arr.shape[0],
                                       device=device))
            vals, idx = m.top_k(m.create_tensor(list(arr.shape)), k)
            m.compile(comp_mode=pt.CompMode.COMP_MODE_INFERENCE)
            with torch.no_grad():
                o = m.executor.forward_values({m.input_ops[0].name: (
                    torch.from_numpy(arr).to(dtype).to(device))})
            outs.append(o[idx.guid].cpu())
        assert torch.equal(outs[0], outs[1])
        # lower index first among ties: along each row, equal values come
        # in increasing index order
        v = torch.from_numpy(arr).to(dtype).float()
        picked = torch.gather(v, 1, outs[0].long())
        same = picked[:, 1:] == picked[:, :-1]
        assert bool((outs[0][:, 1:] > outs[0][:, :-1])[same].all())
    assert int(outs[0][0, 0]) in range(256)


def test_restore_into_a_captured_k_step_graph_replays_the_same_bits(
        dev, tmp_path):
    """A checkpoint restored in place into a model whose K = 4 graph is
    captured: the 4 steps after the restore repeat the 4 steps after the
    save to the bit, by replays only (no new capture)."""
    from flexflow_tpu_torch.runtime.durability import DurableCheckpointer

    rng = np.random.RandomState(4)
    x = rng.randn(16 * 4, 12).astype(np.float32)
    y = rng.randint(0, 4, size=(16 * 4, 1)).astype(np.int32)
    m = _card_mlp(dev, mixed=True)
    m.fit(x, y, epochs=1, steps_per_execution=4)
    ckpt = DurableCheckpointer(str(tmp_path))
    ckpt.save(m, step=4)
    m.fit(x, y, epochs=1, steps_per_execution=4)
    a = _dispatch_losses(m, 4)
    counts = dict(m._multi_step(4).counts)
    ckpt.restore_latest(m)
    m.fit(x, y, epochs=1, steps_per_execution=4)
    b = _dispatch_losses(m, 4)
    after = m._multi_step(4).counts
    assert a == b
    assert after["captures"] == counts["captures"] == 1
    assert after["replays"] == counts["replays"] + 1


def test_predict_on_card_matches_cpu(dev):
    """predict on the card (bf16 flagship widths cut small, a tail batch)
    against the port on the CPU from the same weights; two calls the same
    bits; the manual loop on the card equals fit there to the bit."""
    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel, LossType)
    from flexflow_tpu_torch.models import (TransformerConfig,
                                           build_bert_encoder)

    def bert(device, mixed):
        m = FFModel(FFConfig(batch_size=4, allow_mixed_precision=mixed,
                             device=device))
        tok = m.create_tensor([4, 64], DataType.DT_INT32)
        build_bert_encoder(m, tok, TransformerConfig(
            hidden_size=128, embedding_size=128, num_heads=2, num_layers=2,
            sequence_length=64, vocab_size=97))
        m.compile(optimizer=AdamOptimizer(m, alpha=1e-3),
                  loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  generator=torch.Generator().manual_seed(0))
        return m

    rng = np.random.RandomState(6)
    x = rng.randint(0, 97, size=(10, 64)).astype(np.int32)
    y = rng.randint(0, 2, size=(4, 64, 1)).astype(np.int32)
    card, cpu = bert(str(dev), False), bert("cpu", False)
    got = card.predict(x)
    assert got.dtype == np.float32 and got.shape == (10, 64, 2)
    np.testing.assert_array_equal(got, card.predict(x))
    np.testing.assert_allclose(got, cpu.predict(x), atol=1e-4, rtol=1e-3)
    a, b = bert(str(dev), True), bert(str(dev), True)
    a.set_iteration_batch([x[:4]], y)
    losses = []
    for _ in range(2):
        pred = a.forward()
        losses.append(float(a.loss.fn(pred, a._manual["label"])))
        a.zero_gradients()
        a.backward()
        a.update()
    b.fit(np.concatenate([x[:4], x[:4]]), np.concatenate([y, y]),
          batch_size=4, epochs=1)
    assert losses == [r["loss"] for r in b.step_stats.records()]
    for op, ws in b.params.items():
        for w, t in ws.items():
            assert torch.equal(a.params[op][w], t), (op, w)


def _card_bert(device, mixed, batch=4, seed=0):
    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel, LossType)
    from flexflow_tpu_torch.models import (TransformerConfig,
                                           build_bert_encoder)

    m = FFModel(FFConfig(batch_size=batch, allow_mixed_precision=mixed,
                         device=device))
    tok = m.create_tensor([batch, 64], DataType.DT_INT32)
    build_bert_encoder(m, tok, TransformerConfig(
        hidden_size=128, embedding_size=128, num_heads=2, num_layers=2,
        sequence_length=64, vocab_size=97))
    m.compile(optimizer=AdamOptimizer(m, alpha=1e-3),
              loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              generator=torch.Generator().manual_seed(seed))
    return m


def test_bucket_replay_equals_the_eager_walk_on_card(dev):
    """InferenceModel on the card: a bucket's first call captures, later
    calls replay; a replay gives the eager inference walk's bits at the
    bucket's shape (predict of the zero-padded batch), the hand-written
    kernels launched at the capture; an f32 model's buckets match the
    port on the CPU."""
    from flexflow_tpu_torch.serving import InferenceModel

    rng = np.random.RandomState(7)
    x = rng.randint(0, 97, size=(3, 64)).astype(np.int32)
    m = _card_bert(str(dev), True)
    im = InferenceModel(m, batch_buckets=(2, 4))
    reset_launch_counts()
    got = im.predict({"input_0": x})
    launches = launch_counts()
    assert launches["flash_fwd"] == 2 * 2  # warm-up and capture, 2 layers
    assert launches["layernorm_fwd"] > 0
    assert im.counts == {"warmups": 1, "captures": 1, "replays": 0,
                         "eager_walks": 0}
    np.testing.assert_array_equal(got, im.predict({"input_0": x}))
    assert im.counts["replays"] == 1 and im.counts["captures"] == 1
    padded = np.concatenate([x, np.zeros((1, 64), np.int32)])
    np.testing.assert_array_equal(got, m.predict(padded, batch_size=4)[:3])
    # over the largest bucket: chunks of 4 through the one graph
    x9 = rng.randint(0, 97, size=(9, 64)).astype(np.int32)
    assert im.predict({"input_0": x9}).shape == (9, 64, 2)
    assert im.counts["captures"] == 1
    card, cpu = _card_bert(str(dev), False), _card_bert("cpu", False)
    a = InferenceModel(card, batch_buckets=(4,)).predict({"input_0": x9})
    b = InferenceModel(cpu, batch_buckets=(4,)).predict({"input_0": x9})
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def _card_bn_net(dev, seed):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer

    m = FFModel(FFConfig(batch_size=8, allow_mixed_precision=True,
                         device=str(dev)))
    t = m.conv2d(m.create_tensor([8, 3, 16, 16]), 8, 3, 3, 1, 1, 1, 1,
                 use_bias=False)
    t = m.pool2d(m.batch_norm(t, relu=True), 2, 2, 2, 2, 0, 0)
    m.softmax(m.dense(m.flat(t), 4))
    m.compile(optimizer=SGDOptimizer(m, lr=0.05),
              generator=torch.Generator().manual_seed(seed))
    return m


def test_bucket_recaptures_after_load_params_and_fold(dev):
    """A captured bucket never replays stale: new weights (load_params)
    re-capture it, and fold_batchnorm's new executor drops it, so the
    folded graph (no batch-norm walk) is captured anew; the folded model
    predicts the unfolded one within bf16 rounding and refuses fit."""
    from flexflow_tpu_torch.serving import InferenceModel, fold_batchnorm

    rng = np.random.RandomState(8)
    x = rng.randn(16, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 4, size=(16, 1)).astype(np.int32)
    m, other = _card_bn_net(dev, 0), _card_bn_net(dev, 1)
    m.fit(x, y, epochs=1)
    other.fit(x, y, epochs=1)
    im = InferenceModel(m, batch_buckets=(8,))
    first = im.predict({"input_0": x[:5]})
    m.load_params(other.params)
    m.load_state(other.state)
    second = im.predict({"input_0": x[:5]})
    assert im.counts["captures"] == 2 and im.counts["replays"] == 0
    padded = np.concatenate([x[:5], np.zeros((3, 3, 16, 16), np.float32)])
    want = other.predict(padded, batch_size=8)[:5]
    np.testing.assert_array_equal(second, want)
    assert not np.array_equal(first, second)
    old = im._fns[8]
    assert fold_batchnorm(m) == ["batchnorm_0"]
    folded = im.predict({"input_0": x[:5]})
    assert im._fns[8] is not old and im.counts["captures"] == 3
    np.testing.assert_allclose(folded, want, atol=2e-2, rtol=5e-2)
    np.testing.assert_array_equal(folded, im.predict({"input_0": x[:5]}))
    assert im.counts["replays"] == 1
    with pytest.raises(RuntimeError, match="optimized for inference"):
        m.fit(x, y, epochs=1)


def test_bucket_captures_while_another_thread_replays(dev):
    """A DynamicBatcher thread captures its buckets while the continuous
    batcher's thread replays its decode graphs on the same card (two
    graph pools): the tokens and the bucket outputs are those of each
    path run alone."""
    import threading

    from flexflow_tpu_torch.serving import DynamicBatcher, InferenceModel
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    lm = _serve_lm(71)
    rng = np.random.RandomState(72)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (6, 13, 3, 9)]
    want, _ = _serve_tokens(lm, prompts)
    m = _card_bert(str(dev), True)
    xs = [rng.randint(0, 97, size=(n, 64)).astype(np.int32)
          for n in (1, 3, 2, 4, 1)]
    alone = [m.predict(np.concatenate(
        [x, np.zeros((4 - len(x) if len(x) > 1 else 0, 64), np.int32)]),
        batch_size=4 if len(x) > 1 else 1)[:len(x)] for x in xs]
    got, errors = [], []
    with ContinuousBatcher(lm, max_len=48, num_slots=2, page_size=4,
                           max_queue=64) as cb:
        # every graph of the continuous batcher captured first
        for r in [cb.submit(p, 8) for p in prompts]:
            r.result(timeout=120)
        stop = threading.Event()

        def serve():
            try:
                while not stop.is_set():
                    reqs = [cb.submit(p, 8) for p in prompts]
                    got.append([r.result(timeout=120).tolist()
                                for r in reqs])
            except Exception as e:  # surfaced by the assert below
                errors.append(e)

        t = threading.Thread(target=serve)
        t.start()
        try:
            im = InferenceModel(m, batch_buckets=(1, 4))
            with DynamicBatcher(im, max_batch_size=4,
                                max_delay_ms=0.0) as b:
                outs = [b.infer({"input_0": x}, timeout=120) for x in xs]
        finally:
            stop.set()
            t.join(timeout=120)
    assert not errors and got and all(g == want for g in got)
    assert im.counts["captures"] == 2 and im.counts["eager_walks"] == 0
    for o, a in zip(outs, alone):
        np.testing.assert_array_equal(o, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_heads_causal_at_the_mesh_serving_shape(dev, dtype):
    """B7 as a prefill on a data x model mesh runs it: causal, blhd, a
    rank's 8 of the serve LM's 16 heads over the 512-token window (4
    rows), against its plain version; counted on its layout."""
    g = torch.Generator(device=dev).manual_seed(47)
    b, l, h, d = 4, 512, 8, 64
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    reset_launch_counts()
    o, lse = flash_attention.flash_fwd_heads(q, k, v, scale=d ** -0.5,
                                             causal=True, layout="blhd")
    ro, rlse = flash_attention.flash_fwd_heads_plain(q, k, v, d ** -0.5,
                                                     True, "blhd")
    _close(o, ro, F32_TOL if dtype == torch.float32 else BF16_TOL)
    _close(lse, rlse, F32_TOL)
    assert launch_counts()["flash_fwd_blhd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_the_mesh_serving_shape(dev, dtype):
    """B5 as a mesh session's decode step runs it: a rank's 2 rows and 8
    heads over a 1024-row cache, both rows at one position."""
    g = torch.Generator(device=dev).manual_seed(48)
    b, m, h, d = 2, 1024, 8, 64
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(dtype)
    kc, vc = (torch.randn((b, m, h, d), generator=g, device=dev).to(dtype)
              for _ in range(2))
    pos = torch.full((b,), 80, dtype=torch.int32, device=dev)
    out = decode.decode_attention(q, kc, vc, pos, scale=d ** -0.5,
                                  block_k=512)
    ref = decode.decode_attention_plain(q, kc, vc, pos, d ** -0.5)
    _close(out, ref, F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("opt", [("sgd", 0.05), ("adam", 1e-3, "bfloat16")],
                         ids=["sgd", "adam_bf16_moments"])
def test_elastic_skip_leaves_card_state_bit_identical(dev, opt):
    """The elastic coordinator on one card (tools/tp_train.py
    elastic_job): NaN-poisoned steps 3-6, checkpoints every 2 steps. Each
    watchdog SKIP leaves the CUDA weights, the fused optimizer kernel's
    state (step, lr, moments) and the step count bit-identical; the
    rollback restores step 2's checkpoint; the optimizer kernel ran once
    a committed step."""
    import tempfile

    from flexflow_tpu_torch.tools.tp_train import elastic_job

    rng = np.random.RandomState(0)
    x = rng.randn(48, 32).astype(np.float32)
    y = rng.randint(0, 10, size=(48, 1)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        out = elastic_job({
            "optimizer": opt, "x": x, "y": y, "steps": 10,
            "faults": [("nan_step", s, (), 1) for s in range(3, 7)],
            "coordinator": {"checkpoint_every": 2},
            "checkpoint_dir": tmp, "skip_witness": True}, "cuda")
    assert out["model_device"].startswith("cuda")
    assert out["skips_identical"] == [True, True, True]
    kinds = [e[0] for e in out["events"]]
    assert kinds.count("watchdog.skip") == 3
    assert kinds.count("watchdog.rollback") == 1
    assert [e[1] for e in out["events"] if e[0] == "recovery.restore"] \
        == [2]
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3, 4, 5, 7, 8,
                                                   9]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    # one update a committed step: 0-2, the rollback's replay of 2-5,
    # then 7-9 (a skipped step launches none)
    name = "optimizer_sgd" if opt[0] == "sgd" else "optimizer_adam"
    assert out["launches"].get(name, 0) == 10


def _post_infer(port, name, x):
    import json
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v2/models/{name}/infer",
        data=json.dumps({"inputs": {"input_0": x.tolist()}}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.asarray(json.loads(r.read())["outputs"], np.float32)


def test_repository_entry_serves_new_weights_after_capture(dev, tmp_path):
    """Repository entries whose bucket graphs are captured take new
    weights in place, by an ONNX transfer_weights and by a checkpoint
    restore, and the next /infer serves them: each bucket re-captures
    on the weights' version bump (f32 ONNX entry against numpy within
    1e-4; the bf16 C-spec entry against the source model's own predict
    within BF16_TOL)."""
    import json

    from flexflow_tpu_torch import FFConfig, FFModel, LossType, \
        SGDOptimizer
    from flexflow_tpu_torch.native.c_model import model_from_spec
    from flexflow_tpu_torch.onnx import ONNXModel, wire
    from flexflow_tpu_torch.runtime.checkpoint import restore_checkpoint, \
        save_checkpoint
    from flexflow_tpu_torch.serving import InferenceServer, ModelRepository

    rng = np.random.RandomState(25)

    def mlp_onnx(path):
        w1 = rng.randn(6, 12).astype(np.float32)
        w2 = rng.randn(12, 3).astype(np.float32)
        wire.save(wire.make_model(
            [wire.make_node("MatMul", ["x", "w1"], ["h"], name="fc1"),
             wire.make_node("Relu", ["h"], ["hr"], name="relu1"),
             wire.make_node("MatMul", ["hr", "w2"], ["y"], name="fc2")],
            {"x": (8, 6)}, {"y": (8, 3)}, {"w1": w1, "w2": w2}), path)
        return w1, w2

    (tmp_path / "repo" / "mlp").mkdir(parents=True)
    mlp_onnx(str(tmp_path / "repo" / "mlp" / "model.onnx"))
    (tmp_path / "repo" / "mlp" / "config.json").write_text(json.dumps({
        "format": "onnx", "file": "model.onnx", "mixed_precision": False,
        "inputs": [{"dims": [8, 6], "dtype": "float32"}]}))
    spec = {"format": "flexflow_tpu_c_model", "config": {"batch_size": 8},
            "ops": [{"type": "input", "name": "input_0", "dims": [8, 6],
                     "dtype": "float32", "inputs": [], "outputs": [1]},
                    {"type": "dense", "name": "fc", "inputs": [1],
                     "outputs": [2], "params": {"out_dim": 3}},
                    {"type": "softmax", "name": "sm", "inputs": [2],
                     "outputs": [3], "params": {}}]}
    (tmp_path / "repo" / "cspec").mkdir()
    (tmp_path / "repo" / "cspec" / "spec.json").write_text(json.dumps(spec))
    (tmp_path / "repo" / "cspec" / "config.json").write_text(json.dumps(
        {"format": "ff_cspec", "file": "spec.json"}))

    server = InferenceServer()
    httpd = None
    try:
        assert ModelRepository(str(tmp_path / "repo")).load(
            server, strict=True) == ["cspec", "mlp"]
        httpd = server.serve_http(port=0)
        port = httpd.server_address[1]
        x = rng.randn(4, 6).astype(np.float32)
        for name in ("mlp", "cspec"):  # captures bucket 4, then replays
            _post_infer(port, name, x)
            _post_infer(port, name, x)
        ims = {n: server._models[n].model for n in ("mlp", "cspec")}
        assert all(im.counts["captures"] == 1 and im.counts["replays"] == 1
                   for im in ims.values())

        w1, w2 = mlp_onnx(str(tmp_path / "new.onnx"))
        scratch = FFModel(FFConfig(batch_size=8, device="cpu"))
        new = ONNXModel(str(tmp_path / "new.onnx"))
        new.apply(scratch, [scratch.create_tensor([8, 6])])
        assert new.transfer_weights(ims["mlp"].model) == 2
        np.testing.assert_allclose(_post_infer(port, "mlp", x),
                                   np.maximum(x @ w1, 0) @ w2,
                                   atol=1e-4, rtol=1e-4)

        # the same spec with other weights (the same seed would draw the
        # entry's own)
        other = model_from_spec(spec, config=FFConfig(device="cuda"))
        other.compile(optimizer=SGDOptimizer(other, lr=0.0),
                      loss_type=LossType.LOSS_IDENTITY)
        other.load_params({"fc": {"kernel": rng.randn(6, 3).astype(
            np.float32), "bias": rng.randn(3).astype(np.float32)}})
        path = save_checkpoint(str(tmp_path / "other"), other)
        restore_checkpoint(path, ims["cspec"].model)
        padded = np.concatenate([x, np.zeros((4, 6), np.float32)])
        _close(torch.from_numpy(_post_infer(port, "cspec", x)),
               torch.from_numpy(other.predict(padded)[:4]), BF16_TOL)
        assert all(im.counts["captures"] == 2 for im in ims.values())
    finally:
        if httpd is not None:
            httpd.shutdown()
        server.shutdown()
