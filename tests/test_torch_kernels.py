"""flexflow_tpu_torch kernels on the CPU: each plain version against the
JAX package's Pallas kernel in interpret mode (as
tests/test_pallas_kernels.py runs it), and the wrappers' input checks.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.pallas.decode import (
    fused_decode_attention, fused_multiquery_decode_attention)
from flexflow_tpu.kernels.pallas.norm import (_ln_bwd, _ln_fwd, _rms_bwd,
                                             _rms_fwd, fused_rmsnorm,
                                             fused_softmax)
from flexflow_tpu.kernels.pallas.reduction import (fused_cumsum,
                                                   fused_reduce)
from flexflow_tpu_torch.kernels import decode, launch_counts, norm, reduction

# f32: the same math, summed in another order (and, for Pallas' multi-
# block path, through the online softmax)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 outputs: a few ulps (2^-8 relative) — the two round the
# probabilities at different points (normalised vs per block)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)


def _randn(rng, shape):
    return rng.randn(*shape).astype(np.float32)


def _decode_pair(q, kc, vc, pos, c, block_k, dtype, kv_dtype):
    scale = 1.0 / np.sqrt(q.shape[-1])
    jfn = fused_decode_attention if c == 1 \
        else fused_multiquery_decode_attention
    ref = jfn(jnp.asarray(q, dtype), jnp.asarray(kc, kv_dtype),
              jnp.asarray(vc, kv_dtype), jnp.asarray(pos), scale=scale,
              block_k=block_k, interpret=True)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    fn = decode.decode_attention if c == 1 \
        else decode.multiquery_decode_attention
    out = fn(torch.from_numpy(q).to(tdt[dtype]),
             torch.from_numpy(kc).to(tdt[kv_dtype]),
             torch.from_numpy(vc).to(tdt[kv_dtype]), torch.from_numpy(pos),
             scale=scale, block_k=block_k)
    assert out.dtype == tdt[dtype] and tuple(out.shape) == q.shape
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("block_k", [64, 8])  # single- and multi-block
def test_decode_plain_matches_pallas(c, block_k):
    rng = np.random.RandomState(6 + c)
    b, m, h, d = 5, 24, 3, 8
    q = _randn(rng, (b, c, h, d))
    kc, vc = _randn(rng, (b, m, h, d)), _randn(rng, (b, m, h, d))
    # ragged: one live row, the window ending at the last row, mid-cache
    pos = np.array([0, 3, 11, m - c, 7], np.int32)
    out, ref = _decode_pair(q, kc, vc, pos, c, block_k, jnp.float32,
                            jnp.float32)
    np.testing.assert_allclose(out, ref, **F32_TOL)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("qdt", [jnp.float32, jnp.bfloat16])
def test_decode_plain_bf16_cache_matches_pallas(c, qdt):
    rng = np.random.RandomState(7 + c)
    b, m, h, d = 2, 16, 2, 16
    q = _randn(rng, (b, c, h, d))
    kc, vc = _randn(rng, (b, m, h, d)), _randn(rng, (b, m, h, d))
    pos = np.array([5, m - c], np.int32)
    for block_k in (64, 8):
        out, ref = _decode_pair(q, kc, vc, pos, c, block_k, qdt,
                                jnp.bfloat16)
        np.testing.assert_allclose(
            out, ref, **(F32_TOL if qdt == jnp.float32 else BF16_TOL))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_plain_matches_pallas(dtype):
    rng = np.random.RandomState(8)
    x = _randn(rng, (6, 5, 48)) * 3 + 1
    gamma = rng.rand(48).astype(np.float32) + 0.5
    beta = _randn(rng, (48,))
    y, mean, rstd = _ln_fwd(jnp.asarray(x, dtype), jnp.asarray(gamma),
                            jnp.asarray(beta), 1e-5, 4, True, True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    py, pmean, prstd = norm.layernorm_fwd(
        torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
        torch.from_numpy(beta), eps=1e-5)
    assert py.dtype == tdt and tuple(py.shape) == x.shape
    np.testing.assert_allclose(py.float().numpy(), np.asarray(y, np.float32),
                               **(F32_TOL if dtype == jnp.float32
                                  else BF16_TOL))
    np.testing.assert_allclose(pmean.numpy(), np.asarray(mean), **F32_TOL)
    np.testing.assert_allclose(prstd.numpy(), np.asarray(rstd), **F32_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_softmax_plain_matches_pallas_on_a_wide_row(dtype):
    rng = np.random.RandomState(9)
    x = _randn(rng, (6, 3000)) * 4
    ref = fused_softmax(jnp.asarray(x, dtype), block_rows=4, interpret=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    out = norm.softmax_fwd(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               **(F32_TOL if dtype == jnp.float32
                                  else dict(rtol=1e-2, atol=1e-6)))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_bwd_plain_matches_pallas(affine, dtype):
    rng = np.random.RandomState(10)
    x = _randn(rng, (7, 3, 40)) * 2 + 1
    dy = _randn(rng, (7, 3, 40))
    gamma = rng.rand(40).astype(np.float32) + 0.5
    jg = jnp.asarray(gamma) if affine else None
    _, mean, rstd = _ln_fwd(jnp.asarray(x, dtype), jg,
                            jnp.asarray(_randn(rng, (40,))) if affine
                            else None, 1e-5, 4, True, affine)
    dx, dg, db = _ln_bwd(jnp.asarray(x, dtype), jg, mean, rstd,
                         jnp.asarray(dy, dtype), 4, True, affine)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pdx, pdg, pdb = norm.layernorm_bwd(
        torch.from_numpy(x).to(tdt),
        torch.from_numpy(gamma) if affine else None,
        torch.from_numpy(np.array(mean)), torch.from_numpy(np.array(rstd)),
        torch.from_numpy(dy).to(tdt))
    assert pdx.dtype == tdt and tuple(pdx.shape) == x.shape
    np.testing.assert_allclose(pdx.float().numpy(),
                               np.asarray(dx, np.float32),
                               **(F32_TOL if dtype == jnp.float32
                                  else BF16_TOL))
    if not affine:
        assert pdg is None and pdb is None
        return
    # f32 sums over 21 rows, in another order
    for got, want in ((pdg, dg), (pdb, db)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 300])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_softmax_bwd_plain_matches_pallas_vjp(n, dtype):
    rng = np.random.RandomState(11 + n)
    x = _randn(rng, (5, 6, n)) * 3
    g = _randn(rng, (5, 6, n))
    y, vjp = jax.vjp(lambda a: fused_softmax(a, block_rows=4,
                                             interpret=True),
                     jnp.asarray(x, dtype))
    (want,) = vjp(jnp.asarray(g, dtype))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    ty = torch.from_numpy(np.array(y, np.float32)).to(tdt)
    got = norm.softmax_bwd(ty, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32_TOL if dtype == jnp.float32
                                  else BF16_TOL))


@pytest.mark.parametrize("affine", [True, False])
def test_norm_autograd_functions_match_torch(affine):
    """layernorm / softmax through their autograd Functions give torch's
    own gradients of the same math (f32)."""
    rng = np.random.RandomState(12)
    x0 = torch.from_numpy(_randn(rng, (6, 32)) * 2)
    g0 = torch.from_numpy(rng.rand(32).astype(np.float32) + 0.5)
    b0 = torch.from_numpy(_randn(rng, (32,)))
    cot = torch.from_numpy(_randn(rng, (6, 32)))
    x, g, b = (t.clone().requires_grad_() for t in (x0, g0, b0))
    y = norm.layernorm(x, g, b) if affine else norm.layernorm(x)
    y = norm.softmax(y)
    got = torch.autograd.grad(y, (x, g, b) if affine else (x,), cot)
    x, g, b = (t.clone().requires_grad_() for t in (x0, g0, b0))
    ref = torch.nn.functional.layer_norm(
        x, (32,), g if affine else None, b if affine else None, 1e-5)
    want = torch.autograd.grad(torch.softmax(ref, -1),
                               (x, g, b) if affine else (x,), cot)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_plain_versions_count_no_launch():
    before = launch_counts()
    x = torch.randn(3, 8)
    norm.softmax_fwd(x)
    y, mean, rstd = norm.layernorm_fwd(x)
    norm.layernorm_bwd(x, None, mean, rstd, y)
    norm.softmax_bwd(x, y)
    assert launch_counts() == before


def test_decode_wrappers_reject_bad_inputs():
    q = torch.zeros(2, 1, 3, 4)
    kc = vc = torch.zeros(2, 8, 3, 4)
    pos = torch.zeros(2, dtype=torch.int32)
    fn = decode.multiquery_decode_attention
    with pytest.raises(ValueError, match="one query token"):
        decode.decode_attention(torch.zeros(2, 2, 3, 4), kc, vc, pos,
                                scale=1.0)
    with pytest.raises(ValueError, match="q must be"):
        fn(torch.zeros(2, 3, 4), kc, vc, pos, scale=1.0)
    with pytest.raises(ValueError, match="k_cache must be"):
        fn(q, torch.zeros(2, 8, 3, 5), vc, pos, scale=1.0)
    with pytest.raises(ValueError, match="v_cache"):
        fn(q, kc, torch.zeros(2, 9, 3, 4), pos, scale=1.0)
    with pytest.raises(ValueError, match="pos must be"):
        fn(q, kc, vc, torch.zeros(3, dtype=torch.int32), scale=1.0)
    with pytest.raises(TypeError, match="int32"):
        fn(q, kc, vc, pos.long(), scale=1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(q.half(), kc, vc, pos, scale=1.0)
    with pytest.raises(TypeError, match="!= v_cache"):
        fn(q, kc, vc.bfloat16(), pos, scale=1.0)
    # a tensor on neither the CPU nor a GPU gets no quiet plain fallback
    meta = [t.to("meta") for t in (q, kc, vc, pos)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(*meta, scale=1.0)


def test_norm_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 6)
    g = torch.ones(6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm.softmax_fwd(x.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm.layernorm_fwd(x.half())
    with pytest.raises(ValueError, match="non-empty"):
        norm.softmax_fwd(torch.zeros(0, 6))
    with pytest.raises(ValueError, match="together"):
        norm.layernorm_fwd(x, g, None)
    with pytest.raises(ValueError, match=r"gamma/beta must be \(6,\)"):
        norm.layernorm_fwd(x, torch.ones(5), torch.zeros(5))
    with pytest.raises(TypeError, match="gamma/beta must be float32"):
        norm.layernorm_fwd(x, g.bfloat16(), g.bfloat16())
    with pytest.raises(ValueError, match="no kernel for device"):
        norm.softmax_fwd(x.to("meta"))
    _, mean, rstd = norm.layernorm_fwd(x)
    with pytest.raises(ValueError, match="dy"):
        norm.layernorm_bwd(x, None, mean, rstd, x.bfloat16())
    with pytest.raises(ValueError, match=r"mean must be \(4, 1\)"):
        norm.layernorm_bwd(x, None, mean[:3], rstd, x)
    with pytest.raises(ValueError, match="gamma must be"):
        norm.layernorm_bwd(x, g.bfloat16(), mean, rstd, x)
    with pytest.raises(ValueError, match="dy"):
        norm.softmax_bwd(x, x[:2])
    with pytest.raises(ValueError, match="no kernel for device"):
        norm.softmax_bwd(x.to("meta"), x.to("meta"))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_plain_matches_pallas(affine, dtype):
    """rmsnorm_fwd / rmsnorm_bwd plain against `_rms_fwd` / `_rms_bwd` in
    interpret mode: y, rstd, dx and dgamma."""
    rng = np.random.RandomState(20)
    x = _randn(rng, (7, 3, 40)) * 2 + 1
    dy = _randn(rng, (7, 3, 40))
    gamma = rng.rand(40).astype(np.float32) + 0.5
    jg = jnp.asarray(gamma) if affine else None
    jy, jrstd = _rms_fwd(jnp.asarray(x, dtype), jg, 1e-6, 4, True, affine)
    jdx, jdg = _rms_bwd(jnp.asarray(x, dtype), jg, jrstd,
                        jnp.asarray(dy, dtype), 4, True, affine)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(x).to(tdt)
    tg = torch.from_numpy(gamma) if affine else None
    y, rstd = norm.rmsnorm_fwd(tx, tg)
    assert y.dtype == tdt and tuple(y.shape) == x.shape
    assert rstd.dtype == torch.float32 and tuple(rstd.shape) == (21, 1)
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               **tol)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), **F32_TOL)
    dx, dg = norm.rmsnorm_bwd(tx, tg, rstd, torch.from_numpy(dy).to(tdt))
    assert dx.dtype == tdt
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), **tol)
    if affine:
        # f32 sums over 21 rows, in another order
        assert dg.dtype == torch.float32
        np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert dg is None and jdg is None


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_autograd_matches_jax_grad(affine, dtype):
    """The autograd Function `rmsnorm` against jax.grad through
    `fused_rmsnorm` (interpret mode), for a weighted-sum loss."""
    rng = np.random.RandomState(21)
    x = _randn(rng, (5, 33)) * 3
    w = _randn(rng, (5, 33))
    gamma = rng.rand(33).astype(np.float32) + 0.5

    def jloss(a, g):
        y = fused_rmsnorm(a, g if affine else None, block_rows=2,
                          interpret=True)
        return jnp.sum(y.astype(jnp.float32) * w)

    jx, jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x, dtype),
                                            jnp.asarray(gamma))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    y = norm.rmsnorm(tx, tg if affine else None)
    got = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(),
                              (tx, tg) if affine else (tx,))
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(jx, np.float32), **tol)
    if affine:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [0, 1, 129, 4096])
@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_reduce_plain_matches_pallas(n, kind, dtype):
    """reduce plain against `fused_reduce` in interpret mode, at odd and
    empty sizes; always an f32 scalar."""
    rng = np.random.RandomState(22 + n)
    x = (_randn(rng, (n,)) * 5).reshape(-1, 1) if n else \
        np.zeros((0, 3), np.float32)
    want = fused_reduce(jnp.asarray(x, dtype), kind, block_rows=8,
                        interpret=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = reduction.reduce(torch.from_numpy(x).to(tdt), kind)
    assert got.dtype == torch.float32 and got.shape == ()
    if kind == "max":
        assert float(got) == float(want)
    else:
        # f32 sums in another order
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(x).sum()))


@pytest.mark.parametrize("kind", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_reduce_vjp_broadcasts_like_jax(kind, dtype):
    rng = np.random.RandomState(23)
    x = _randn(rng, (4, 7))
    (want,) = jax.grad(lambda a: 3.0 * fused_reduce(
        a, kind, interpret=True), argnums=(0,))(jnp.asarray(x, dtype))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    (got,) = torch.autograd.grad(3.0 * reduction.fused_reduce(tx, kind), tx)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_fused_reduce_max_is_forward_only_like_jax():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    with pytest.raises(TypeError, match="forward-only"):
        jax.grad(lambda a: fused_reduce(a, "max", interpret=True))(
            jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = reduction.fused_reduce(tx, "max")
    assert float(out.detach()) == 5.0
    with pytest.raises(TypeError, match="forward-only"):
        torch.autograd.grad(out, tx)


def test_new_plain_versions_count_no_launch_and_check_inputs():
    before = launch_counts()
    x = torch.randn(3, 8)
    y, rstd = norm.rmsnorm_fwd(x, torch.ones(8))
    norm.rmsnorm_bwd(x, torch.ones(8), rstd, y)
    reduction.reduce(x, "mean")
    assert launch_counts() == before
    with pytest.raises(ValueError, match="kind must be"):
        reduction.reduce(x, "prod")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        reduction.reduce(x.half())
    with pytest.raises(ValueError, match="no kernel for device"):
        reduction.reduce(x.to("meta"))
    with pytest.raises(ValueError, match=r"gamma must be \(8,\) float32"):
        norm.rmsnorm_fwd(x, torch.ones(7))
    with pytest.raises(ValueError, match="gamma must be"):
        norm.rmsnorm_fwd(x, torch.ones(8).bfloat16())
    with pytest.raises(ValueError, match=r"rstd must be \(3, 1\)"):
        norm.rmsnorm_bwd(x, None, rstd[:2], x)
    with pytest.raises(ValueError, match="dy"):
        norm.rmsnorm_bwd(x, None, rstd, x.bfloat16())
    with pytest.raises(ValueError, match="no kernel for device"):
        norm.rmsnorm_fwd(x.to("meta"))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37), (3, 4, 300), (1, 1), (2, 1030)])
def test_cumsum_plain_and_vjp_match_pallas(dtype, shape):
    """B9: the inclusive scan and its VJP (the reversed scan) against the
    JAX `fused_cumsum` in interpret mode, 2-D and 3-D, rows longer than
    one 1024-element tile of the kernel."""
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    want, vjp = jax.vjp(lambda a: fused_cumsum(a, interpret=True), jx)
    (want_dx,) = vjp(jg)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    out = reduction.fused_cumsum(tx)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and dx.dtype == tdt and out.shape == shape
    # f32: the same f32 scan in another summation order; bf16: the same
    # f32 sums rounded once to bf16, one ulp (2^-8 relative) apart where
    # the two orders straddle a rounding boundary
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == jnp.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32), **tol)


def test_cumsum_reverse_and_input_checks():
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(reduction.cumsum(x),
                       torch.tensor([[0.0, 1, 3], [3, 7, 12]]))
    assert torch.equal(reduction.cumsum(x, reverse=True),
                       torch.tensor([[3.0, 3, 2], [12, 9, 5]]))
    before = launch_counts()
    reduction.cumsum(x)
    assert launch_counts() == before and "cumsum" in before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        reduction.cumsum(x.half())
    with pytest.raises(ValueError, match="trailing axis"):
        reduction.cumsum(torch.tensor(1.0))
    with pytest.raises(ValueError, match="no kernel for device"):
        reduction.cumsum(x.to("meta"))
    assert reduction.cumsum(torch.zeros(0, 4)).shape == (0, 4)
