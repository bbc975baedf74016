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
