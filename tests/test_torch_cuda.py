"""flexflow_tpu_torch on the card: each CUDA kernel against its plain
version, the continuous batcher on the card against the port on the
CPU, and one training step on the card against the port on the CPU.
Every test is marked `cuda` and skips without a GPU. This file imports
no jax, so it also runs where only the port's dependencies are
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
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
    assert gpu.step_records[0]["loss"] == h_gpu[0]["loss"]  # one step
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
    assert [r["steps"] for r in graphed.step_records] == [4, 4, 4, 1] * 2
    assert torch.equal(eager.opt_state["step"], graphed.opt_state["step"])
    for op, ws in eager.params.items():
        for w, t in ws.items():
            assert torch.equal(t, graphed.params[op][w]), (op, w)
    losses_e = [r["loss"] for r in eager.step_records]
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
