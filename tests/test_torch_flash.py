"""flexflow_tpu_torch flash attention on the CPU: the plain forward and
backward against the JAX package's Pallas kernels in interpret mode (as
tests/test_flash_attention.py runs them) — the packed kernels, and the
head-separated ones in both layouts (blhd, bhld) —, the autograd
Functions against the plain backward, and the wrappers' input checks. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.flash_attention import (_flash_fwd,
                                                  _flash_fwd_packed,
                                                  flash_attention,
                                                  flash_attention_packed)
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.kernels import launch_counts

TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# f32: the same math summed in another order; Pallas' several-block path
# also goes through the online softmax (observed <= 2e-6)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 outputs: a few bf16 ulps (2^-8 relative); Pallas rounds p to bf16
# relative to a running max per key block, the plain version relative to
# the row's final max
BF16_TOL = dict(rtol=3e-2, atol=3e-2)

# (b, lq, lk, heads, d, block_q, block_k): one block, several blocks with
# ragged edges, lq != lk (the causal offset lk - lq)
CASES = [(2, 16, 16, 2, 8, 512, 512),
         (1, 40, 40, 2, 16, 16, 16),
         (2, 24, 40, 3, 8, 16, 8)]


def _inputs(seed, b, lq, lk, h, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h * d).astype(np.float32)
            for n in (lq, lk, lk, lq)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,lq,lk,h,d,bq,bk", CASES)
def test_flash_fwd_plain_matches_pallas(dtype, causal, b, lq, lk, h, d, bq,
                                        bk):
    q, k, v, _ = _inputs(lq + lk + d, b, lq, lk, h, d)
    scale = d ** -0.5
    o, lse = _flash_fwd_packed(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                               jnp.asarray(v, dtype), h, scale, causal, bq,
                               bk, True)
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)]
    po, plse = fa.flash_fwd(*t, h, scale=scale, causal=causal, block_q=bq,
                            block_k=bk)
    assert po.dtype == TDT[dtype] and tuple(po.shape) == q.shape
    assert plse.dtype == torch.float32 and tuple(plse.shape) == (b, lq, h)
    np.testing.assert_allclose(
        po.float().numpy(), np.asarray(o, np.float32),
        **(F32_TOL if dtype == jnp.float32 else BF16_TOL))
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse), **F32_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,lq,lk,h,d,bq,bk", CASES)
def test_flash_bwd_plain_matches_pallas_vjp(dtype, causal, b, lq, lk, h, d,
                                            bq, bk):
    q, k, v, g = _inputs(7 * lq + lk + d, b, lq, lk, h, d)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    o, vjp = jax.vjp(
        lambda q_, k_, v_: flash_attention_packed(
            q_, k_, v_, h, scale=scale, causal=causal, block_q=bq,
            block_k=bk, interpret=True), jq, jk, jv)
    want = vjp(jg)
    tq, tk, tv, tg = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_(
        a is not g) for a in (q, k, v, g))
    out = fa.flash_attention(tq, tk, tv, h, scale=scale, causal=causal,
                             block_q=bq, block_k=bk)
    np.testing.assert_allclose(
        out.detach().float().numpy(), np.asarray(o, np.float32),
        **(F32_TOL if dtype == jnp.float32 else BF16_TOL))
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    # f32: sums over lk (lq) products, in another order (observed ~1e-6);
    # bf16: ds and p are rounded before each product, so a few ulps of
    # each summand
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == jnp.float32 \
        else dict(rtol=5e-2, atol=5e-2)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == TDT[dtype]
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **tol)


def test_flash_autograd_uses_the_plain_backward():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(3, 2, 9, 9, 2, 4))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, 2, causal=True)
    grads = torch.autograd.grad(out, (tq, tk, tv), g)
    o, lse = fa.flash_fwd_plain(q, k, v, 2, 0.5, True)
    delta = (g * o).reshape(2, 9, 2, 4).sum(-1)
    for a, w in zip(grads, fa.flash_bwd_plain(q, k, v, g, lse, delta, 2,
                                              0.5, True)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_flash_plain_counts_no_launch_and_checks_inputs():
    before = launch_counts()
    q = torch.zeros(2, 4, 6)
    fa.flash_fwd(q, q, q, 3, scale=1.0)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_fwd(q, q, q, 4, scale=1.0)
    with pytest.raises(ValueError, match=r"\(b, l, heads\*d\)"):
        fa.flash_fwd(q[0], q, q, 3, scale=1.0)
    with pytest.raises(ValueError, match="must both be"):
        fa.flash_fwd(q, torch.zeros(2, 5, 6), q, 3, scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), q.half(), q.half(), 3, scale=1.0)
    with pytest.raises(TypeError, match="k is"):
        fa.flash_fwd(q, q.bfloat16(), q, 3, scale=1.0)
    with pytest.raises(ValueError, match="block_q"):
        fa.flash_fwd(q, q, q, 3, scale=1.0, block_q=0)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_fwd(meta, meta, meta, 3, scale=1.0)
    o, lse = fa.flash_fwd(q, q, q, 3, scale=1.0)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_bwd(q, q, q, o, lse[..., :2], q, 3, scale=1.0)


def _heads_inputs(seed, b, lq, lk, h, d, layout):
    """q, k, v, cotangent as (b, l, h, d) arrays, or (b, h, l, d)."""
    rng = np.random.RandomState(seed)
    out = [rng.randn(b, n, h, d).astype(np.float32) for n in (lq, lk, lk, lq)]
    if layout == "bhld":
        out = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in out]
    return out


@pytest.mark.parametrize("layout", ["blhd", "bhld"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,lq,lk,h,d,bq,bk", CASES + [
    (1, 40, 24, 2, 8, 16, 8)])  # lq > lk: causal rows that see no key
def test_flash_heads_plain_matches_pallas(layout, dtype, causal, b, lq, lk,
                                          h, d, bq, bk):
    """B7: forward, lse and the VJP of the JAX `flash_attention(layout=)`
    in interpret mode against `flash_attention_heads` (plain versions):
    one key block, several with ragged edges, lq < lk and lq > lk (a
    causal row that attends no key averages every v, as the JAX kernel's
    masked softmax gives it)."""
    q, k, v, g = _heads_inputs(5 * lq + lk + d, b, lq, lk, h, d, layout)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    o, vjp = jax.vjp(
        lambda q_, k_, v_: flash_attention(
            q_, k_, v_, scale=scale, causal=causal, block_q=bq, block_k=bk,
            interpret=True, layout=layout), jq, jk, jv)
    want = vjp(jg)
    tq, tk, tv, tg = (torch.from_numpy(a).to(TDT[dtype]).requires_grad_(
        a is not g) for a in (q, k, v, g))
    out = fa.flash_attention_heads(tq, tk, tv, scale=scale, causal=causal,
                                   block_q=bq, block_k=bk, layout=layout)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == q.shape
    np.testing.assert_allclose(
        out.detach().float().numpy(), np.asarray(o, np.float32),
        **(F32_TOL if dtype == jnp.float32 else BF16_TOL))
    # lse against the bhld kernel's (b, h, lq, 1)
    to_bhld = (lambda a: jnp.swapaxes(a, 1, 2)) if layout == "blhd" \
        else (lambda a: a)
    _, jlse = _flash_fwd(to_bhld(jq), to_bhld(jk), to_bhld(jv), scale,
                         causal, bq, bk, True)
    _, plse = fa.flash_fwd_heads(tq.detach(), tk.detach(), tv.detach(),
                                 scale=scale, causal=causal, block_q=bq,
                                 block_k=bk, layout=layout)
    assert plse.dtype == torch.float32 and tuple(plse.shape) == (b, h, lq)
    np.testing.assert_allclose(plse.numpy(), np.asarray(jlse)[..., 0],
                               **F32_TOL)
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    # as the packed backward: f32 sums in another order; bf16 ds and p
    # rounded before each product
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == jnp.float32 \
        else dict(rtol=5e-2, atol=5e-2)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == TDT[dtype] and a.shape == (tq, tk, tv)[
            "qkv".index(name)].shape
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=name,
                                   **tol)


def test_flash_heads_layouts_and_packed_agree_exactly():
    """One function in three layouts: blhd, bhld and packed give the same
    bits on the CPU, forward and backward, and a strided view (bhld seen
    through a transpose) needs no copy."""
    q, k, v, g = (torch.from_numpy(a) for a in
                  _heads_inputs(11, 2, 12, 20, 3, 8, "blhd"))
    fwd = fa.flash_fwd_heads(q, k, v, scale=0.3, causal=True)
    t = [x.transpose(1, 2) for x in (q, k, v)]   # views, not copies
    fwd_t = fa.flash_fwd_heads(*t, scale=0.3, causal=True, layout="bhld")
    packed = fa.flash_fwd(q.flatten(2), k.flatten(2), v.flatten(2), 3,
                          scale=0.3, causal=True)
    assert torch.equal(fwd[0], fwd_t[0].transpose(1, 2))
    assert torch.equal(fwd[1], fwd_t[1])
    assert torch.equal(fwd[0].flatten(2), packed[0])
    assert torch.equal(fwd[1], packed[1].transpose(1, 2))
    grads = fa.flash_bwd_heads(q, k, v, fwd[0], fwd[1], g, scale=0.3,
                               causal=True)
    grads_t = fa.flash_bwd_heads(*t, fwd_t[0], fwd_t[1], g.transpose(1, 2),
                                 scale=0.3, causal=True, layout="bhld")
    for a, w in zip(grads, grads_t):
        assert torch.equal(a, w.transpose(1, 2))


def test_flash_heads_wrappers_check_inputs():
    q = torch.zeros(2, 4, 3, 8)
    before = launch_counts()
    fa.flash_fwd_heads(q, q, q, scale=1.0)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="layout="):
        fa.flash_fwd_heads(q, q, q, scale=1.0, layout="bld")
    with pytest.raises(ValueError, match="4-D"):
        fa.flash_fwd_heads(q[0], q, q, scale=1.0)
    with pytest.raises(ValueError, match="must both match"):
        fa.flash_fwd_heads(q, torch.zeros(2, 5, 2, 8),
                           torch.zeros(2, 5, 2, 8), scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd_heads(q.half(), q.half(), q.half(), scale=1.0)
    with pytest.raises(TypeError, match="v is"):
        fa.flash_fwd_heads(q, q, q.bfloat16(), scale=1.0)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_fwd_heads(meta, meta, meta, scale=1.0)
    o, lse = fa.flash_fwd_heads(q, q, q, scale=1.0)
    assert lse.shape == (2, 3, 4)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_bwd_heads(q, q, q, o, lse.transpose(1, 2), q, scale=1.0)


# flash_route: the bf16 / f32 route rule and TMA's 16-byte rules, on plain
# ints. A packed (b, l, h*d) bf16 operand at the training shape (8, 512,
# 16, 64): (batch, row, head) element strides (512 * 1024, 1024, 64).
TRAIN_OPERAND = ("q", 0x7F0000000000, (512 * 1024, 1024, 64), (8, 512, 16))


@pytest.mark.parametrize("dtype,operands,block_q,block_k,want", [
    # the training path: bf16 -> tensor cores, FFConfig's 512 caps at 128
    (torch.bfloat16, [TRAIN_OPERAND], 512, 512, ("tc", 128, 128)),
    # f32 -> CUDA cores, at most MAX_TILE rows, whatever the alignment
    (torch.float32, [TRAIN_OPERAND], 512, 512, ("cc", 64, 64)),
    (torch.float32, [("q", 0x7F0000000002, (9, 3, 1), (2, 5, 3))], 16, 32,
     ("cc", 16, 32)),
    # bf16 caps round up to the warpgroup's 64 rows, at most 128
    (torch.bfloat16, [TRAIN_OPERAND], 1, 64, ("tc", 64, 64)),
    (torch.bfloat16, [TRAIN_OPERAND], 65, 200, ("tc", 128, 128)),
    (torch.bfloat16, [TRAIN_OPERAND], 16, 128, ("tc", 64, 128)),
    # a dim of extent 1 is never stepped: its stride is not TMA's concern
    (torch.bfloat16, [("q", 0x7F0000000010, (3, 24, 5), (1, 1, 1))], 64, 64,
     ("tc", 64, 64)),
    # blhd and bhld at the tensor-parallel rank's shape (8, 512, 8, 64)
    (torch.bfloat16, [("q", 0x7F0000000000, (512 * 512, 512, 64),
                       (8, 512, 8))], 512, 512, ("tc", 128, 128)),
    (torch.bfloat16, [("q", 0x7F0000000000, (512 * 512, 64, 512 * 64),
                       (8, 512, 8))], 512, 512, ("tc", 128, 128)),
])
def test_flash_route_picks_kernel_and_caps(dtype, operands, block_q, block_k,
                                           want):
    route = fa.flash_route(dtype, 64, operands, block_q, block_k)
    assert (route.name, route.block_q, route.block_k) == want


@pytest.mark.parametrize("operand,match", [
    (("q", 0x7F0000000008, (512 * 1024, 1024, 64), (8, 512, 16)),
     "base address 0x7f0000000008 is not 16-byte aligned"),
    # d 12 packed, 4 heads: rows 96 bytes apart, heads 24
    (("k", 0x7F0000000000, (512 * 48, 48, 12), (8, 512, 4)),
     "head stride 12 elements"),
    (("v", 0x7F0000000000, (512 * 1028, 1028, 64), (8, 512, 16)),
     "row stride 1028 elements"),
    (("do", 0x7F0000000000, (4, 1024, 64), (8, 512, 16)),
     "batch stride 4 elements"),
    # a broadcast (stride 0) dim that TMA would have to step
    (("k", 0x7F0000000000, (0, 1024, 64), (8, 512, 16)),
     "batch stride 0 elements"),
])
def test_flash_route_raises_on_tma_breach(operand, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_route(torch.bfloat16, 64, [TRAIN_OPERAND, operand], 512,
                       512)
    # the f32 route has no such rule
    assert fa.flash_route(torch.float32, 64, [operand], 512, 512).name == "cc"


@pytest.mark.parametrize("head_dim,blocks,exc", [
    (129, (64, 64), "head_dim 129"),
    (0, (64, 64), "head_dim 0"),
    (64, (0, 64), "block_q 0"),
])
def test_flash_route_checks_head_dim_and_blocks(head_dim, blocks, exc):
    with pytest.raises(ValueError, match=exc):
        fa.flash_route(torch.bfloat16, head_dim, [TRAIN_OPERAND], *blocks)


def test_flash_launch_route_reads_tensors_as_the_launch_does():
    """`launch_route` builds the operands a launch hands the C entry: the
    packed training shape in bf16 goes to the tensor cores; a view whose
    rows are 1028 elements apart, or whose base is 2 bytes off, raises
    before anything launches; the f32 copy goes to the CUDA cores."""
    b, l, h, d = 2, 8, 4, 16
    q = torch.zeros(b, l, h * d, dtype=torch.bfloat16)
    dims = (b, l, l, h, d)
    lse = torch.zeros(b, l, h)
    names = fa.FWD_OPERANDS

    def layouts(*ts):
        return [fa._packed(t, d) for t in ts] + [fa._stat(lse, "bl")]

    route = fa.launch_route("flash_fwd", names, (q, q, q, q, lse),
                            layouts(q, q, q, q), dims, 512, 512)
    assert route == fa.Route("tc", 128, 128)
    wide = torch.zeros(b, l, h * d + 4, dtype=torch.bfloat16)[..., :h * d]
    with pytest.raises(ValueError, match="flash_fwd: k: row stride 68"):
        fa.launch_route("flash_fwd", names, (q, wide, q, q, lse),
                        layouts(q, wide, q, q), dims, 512, 512)
    off = torch.zeros(b * l * h * d + 1, dtype=torch.bfloat16)[1:].view(
        b, l, h * d)
    with pytest.raises(ValueError, match="flash_fwd: v: base address"):
        fa.launch_route("flash_fwd", names, (q, q, off, q, lse),
                        layouts(q, q, off, q), dims, 512, 512)
    f = q.float()
    assert fa.launch_route("flash_fwd", names, (f, f, f, f, lse),
                           layouts(f, f, f, f), dims, 32, 512) == \
        fa.Route("cc", 32, 64)
