"""The LayerNorm and RMSNorm backward and scalar reduction kernels'
plans and arithmetic, on the CPU.

`layernorm_bwd_plan` / `rmsnorm_bwd_plan`
(flexflow_tpu_torch/kernels/norm.py) and `reduce_plan`
(kernels/reduction.py) pick each call's route and launch from the shape
and dtype alone; these tests hold the routes at the paths' shapes and at
edge shapes, and hold every plan inside what the CUDA launchers of
csrc/norm.cu and csrc/reduction.cu accept, for every shape the parent
kernels took. The warp route's fixed-order arithmetic
(`layernorm_bwd_warp_plain`: the per-lane row sums, the butterfly, dgamma
and dbeta summed per warp, per CTA and over CTAs; `rmsnorm_bwd_warp_plain`
the same without the mean) is held against the JAX package's `_ln_bwd` /
`_rms_bwd` in interpret mode and `fused_layernorm`'s / `fused_rmsnorm`'s
VJPs, as tests/test_torch_kernels.py runs them. The kernels themselves
are held against these on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.pallas.norm import _ln_bwd, _ln_fwd, _rms_bwd, \
    _rms_fwd, fused_layernorm, fused_rmsnorm
from flexflow_tpu_torch.kernels import launch_counts, norm, reduction

DTYPES = [torch.float32, torch.bfloat16]
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# dx against the Pallas kernel: f32 sums of the same terms in another
# order; bf16 adds one rounding of dx (2^-8 relative)
DX_TOL = {jnp.float32: dict(rtol=1e-5, atol=1e-5),
          jnp.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# dgamma / dbeta: f32 sums over the rows in another order (the card's
# kernel table holds the kernel to its plain version at 1e-3, 1e-4)
SUM_TOL = dict(rtol=1e-4, atol=1e-4)
EDGE_N = [1, 2, 33, 300, 1000, 1024, 2048, 2049, norm.MAX_BWD_COLS]
EDGE_R = [1, 7, 8, 9, 4095]


@pytest.mark.parametrize("rows,n,route", [
    (4096, 1024, "warp"),         # the training step's 24 launches
    (64, 1024, "warp"), (37, 300, "warp"), (1, 1, "warp"),
    (4095, 2048, "warp"), (1, 2049, "block"), (4095, 14528, "block")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_bwd_plan_routes(rows, n, route, dtype):
    assert norm.layernorm_bwd_plan(rows, n, dtype).route == route


def test_layernorm_bwd_plan_at_the_training_shape():
    """(4096, 1024): one CTA of 8 warps an SM, a lane holding 32 values
    (4 bf16 vectors, 8 f32): one partial row of dgamma and of dbeta a
    CTA, 132 in place of the block route's 512."""
    for dtype, vecs in ((torch.bfloat16, 4), (torch.float32, 8)):
        plan = norm.layernorm_bwd_plan(4096, 1024, dtype)
        assert plan == norm.LnBwdPlan("warp", 256, 132, vecs)
    small = norm.layernorm_bwd_plan(4096, 1024, torch.bfloat16, sms=16)
    assert (small.route, small.blocks) == ("warp", 16)


def _ln_bwd_plan_fits(plan, rows, n, dtype):
    """What csrc/norm.cu launch_layernorm_bwd accepts for the plan."""
    esz = torch.tensor([], dtype=dtype).element_size()
    w = 16 // esz
    if plan.route == "warp":
        assert plan.vecs in ((1, 2, 4, 8) if esz == 2
                             else (1, 2, 4, 8, 16))
        assert plan.vecs * w <= 64 and 32 * plan.vecs * w >= n
        assert plan.threads == 256 and 1 <= plan.blocks <= 132
        assert plan.blocks <= -(-rows // 8)
        # a warp's rows share a 16-byte phase
        assert plan.blocks * (plan.threads // 32) * n * esz % 16 == 0
    else:
        assert plan.route == "block" and plan.vecs == 0
        assert (plan.threads, plan.blocks) == (256, -(-rows // 8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_bwd_plan_is_pure_and_refuses_no_shape_the_parent_took(
        dtype):
    """The same answer twice, from ints alone; every N up to the parent's
    MAX_BWD_COLS gets a kernel route inside what the launcher accepts;
    wider raises, as the parent's wrapper did."""
    ns = sorted(set(EDGE_N + [3, 31, 32, 64, 65, 511, 1023, 1025, 1536,
                              4096, 8191, 10000]))
    for rows in EDGE_R + [2, 100, 132, 1056, 1057, 10 ** 6]:
        for n in ns:
            plan = norm.layernorm_bwd_plan(rows, n, dtype)
            assert plan == norm.layernorm_bwd_plan(np.int64(rows), n, dtype)
            assert (plan.route == "warp") == (n <= 2048)
            _ln_bwd_plan_fits(plan, rows, n, dtype)
    with pytest.raises(ValueError, match=str(norm.MAX_BWD_COLS)):
        norm.layernorm_bwd_plan(1, norm.MAX_BWD_COLS + 1, dtype)
    with pytest.raises(ValueError, match=">= 1"):
        norm.layernorm_bwd_plan(0, 5, dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm.layernorm_bwd_plan(4, 5, torch.float16)


def test_layernorm_bwd_block_route_bounds():
    """The block route stages 4 floats a column with gamma (xhat, g and
    the two sums) and 2 without, beside 32 floats of reduction scratch,
    in a block's 227 KB: with gamma N <= 14520 (the parent's launch
    failed above it: the wrapper raises ValueError there), without it
    MAX_BWD_COLS = 14528, as the parent."""
    smem = norm.SMEM_BYTES
    assert (norm.LN_BWD_BLOCK_AFFINE_MAX_N, norm.MAX_BWD_COLS) == (14520,
                                                                    14528)
    assert (4 * 14520 + 32) * 4 <= smem < (4 * 14521 + 32) * 4
    assert (2 * 14528 + 32) * 4 <= smem
    x = torch.randn(2, 14528)
    stat = torch.zeros(2, 1)
    # the CPU takes the plain version at every N: no plan, no refusal
    assert norm.layernorm_bwd(x, torch.ones(14528), stat, stat + 1,
                              x)[1].shape == (14528,)


@pytest.mark.parametrize("n,dtype,route", [
    (4096, torch.float32, "cta"),     # the loss's and accuracy's terms
    (4096, torch.bfloat16, "cta"),
    (0, torch.float32, "cta"), (1, torch.float32, "cta"),
    (4097, torch.float32, "cta"), (1000003, torch.float32, "grid"),
    (2 ** 26, torch.float32, "grid"), (2 ** 26, torch.bfloat16, "grid")])
def test_reduce_plan_routes(n, dtype, route):
    assert reduction.reduce_plan(n, dtype).route == route


@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_plan_switches_at_the_threshold(dtype):
    """"cta" up to REDUCE_CTA_MAX_BYTES of x, "grid" past it; the loss's
    4096 f32 on one block of 256 threads with 4 vectors each."""
    esz = torch.tensor([], dtype=dtype).element_size()
    last = reduction.REDUCE_CTA_MAX_BYTES // esz
    assert reduction.reduce_plan(last, dtype).route == "cta"
    assert reduction.reduce_plan(last + 1, dtype).route == "grid"
    assert reduction.reduce_plan(4096, torch.float32) == \
        reduction.ReducePlan("cta", 256, 1, 4)


def _reduce_plan_fits(plan, n, dtype):
    """What csrc/reduction.cu launch_cta / launch_grid accept."""
    w = 16 // torch.tensor([], dtype=dtype).element_size()
    if plan.route == "cta":
        assert plan.vecs in (1, 2, 4, 8) and plan.blocks == 1
        assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
        assert n <= plan.threads * plan.vecs * w
    else:
        assert plan.route == "grid" and plan.threads == 256
        assert plan.blocks == min(1024, max(1, -(-n // 4096)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_reduce_plan_is_pure_and_takes_every_n(dtype):
    last = reduction.REDUCE_CTA_MAX_BYTES // torch.tensor(
        [], dtype=dtype).element_size()
    for n in sorted({0, 1, 2, 7, 31, 32, 33, 127, 128, 129, 1023, 1024,
                     1025, 2048, 4095, 4096, 4097, 8192, 16384, 30000,
                     last - 1, last, last + 1, 10 ** 6, 2 ** 26,
                     2 ** 31 + 5}):
        plan = reduction.reduce_plan(n, dtype)
        assert plan == reduction.reduce_plan(np.int64(n), dtype)
        _reduce_plan_fits(plan, n, dtype)
    with pytest.raises(ValueError, match=">= 0"):
        reduction.reduce_plan(-1, dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        reduction.reduce_plan(4, torch.float16)


def _jax_ln_bwd(x, dy, gamma, dtype, affine):
    """`_ln_fwd` then `_ln_bwd` in interpret mode: (dx, dg, db, mean,
    rstd) as numpy."""
    n = x.shape[-1]
    jg = jnp.asarray(gamma) if affine else None
    jb = jnp.asarray(np.linspace(-1, 1, n, dtype=np.float32)) if affine \
        else None
    _, mean, rstd = _ln_fwd(jnp.asarray(x, dtype), jg, jb, 1e-5, 16, True,
                            affine)
    dx, dg, db = _ln_bwd(jnp.asarray(x, dtype), jg, mean, rstd,
                         jnp.asarray(dy, dtype), 16, True, affine)
    return dx, dg, db, np.array(mean), np.array(rstd)


def _warp_pair(rows, n, dtype, affine, seed, phase=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, n).astype(np.float32) * 2 + 1
    dy = rng.randn(rows, n).astype(np.float32)
    gamma = rng.rand(n).astype(np.float32) + 0.5
    jdx, jdg, jdb, mean, rstd = _jax_ln_bwd(x, dy, gamma, dtype, affine)
    plan = norm.layernorm_bwd_plan(rows, n, TDT[dtype])
    got = norm.layernorm_bwd_warp_plain(
        torch.from_numpy(x).to(TDT[dtype]),
        torch.from_numpy(gamma) if affine else None,
        torch.from_numpy(mean), torch.from_numpy(rstd),
        torch.from_numpy(dy).to(TDT[dtype]), plan.blocks, phase,
        plan.threads // 32)
    return got, (jdx, jdg, jdb)


@pytest.mark.parametrize("rows,n", [(64, 1024), (37, 300), (9, 33),
                                    (5, 1000), (3, 2048), (1, 1)])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_bwd_warp_plain_matches_pallas(rows, n, affine, dtype):
    """The warp route's order (per-lane sums, a butterfly; dgamma and
    dbeta per warp, per CTA, over CTAs) against `_ln_bwd` in interpret
    mode: dx within DX_TOL, dgamma and dbeta within SUM_TOL."""
    (dx, dg, db), (jdx, jdg, jdb) = _warp_pair(rows, n, dtype, affine,
                                               rows * 7 + n)
    assert dx.dtype == TDT[dtype] and tuple(dx.shape) == (rows, n)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), **DX_TOL[dtype])
    if not affine:
        assert dg is None and db is None
        return
    for got, want in ((dg, jdg), (db, jdb)):
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_bwd_warp_plain_matches_the_public_vjp(dtype):
    """The training shape's width through `fused_layernorm`'s custom VJP
    (interpret mode), the entry the JAX model calls."""
    rng = np.random.RandomState(5)
    rows, n = 64, 1024
    x = rng.randn(rows, n).astype(np.float32) * 2 + 1
    dy = rng.randn(rows, n).astype(np.float32)
    gamma = rng.rand(n).astype(np.float32) + 0.5
    beta = rng.randn(n).astype(np.float32)
    _, vjp = jax.vjp(lambda a, g, b: fused_layernorm(
        a, g, b, block_rows=16, interpret=True), jnp.asarray(x, dtype),
        jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = vjp(jnp.asarray(dy, dtype))
    tx = torch.from_numpy(x).to(TDT[dtype])
    _, mean, rstd = norm.layernorm_fwd_plain(tx, torch.from_numpy(gamma),
                                             torch.from_numpy(beta), 1e-5)
    plan = norm.layernorm_bwd_plan(rows, n, TDT[dtype])
    dx, dg, db = norm.layernorm_bwd_warp_plain(
        tx, torch.from_numpy(gamma), mean, rstd,
        torch.from_numpy(dy).to(TDT[dtype]), plan.blocks, 0,
        plan.threads // 32)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), **DX_TOL[dtype])
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), **SUM_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **SUM_TOL)


@pytest.mark.parametrize("phase", [2, 6, 10, 14])
def test_layernorm_bwd_warp_plain_at_every_row_phase(phase):
    """bf16 rows of 300 (8 mod 16 bytes) and 33 (2 mod 16): heads and
    tails on the lanes the kernel gives them, against the plain version
    (the same terms in torch's order)."""
    rng = np.random.RandomState(phase)
    for n in (300, 33):
        x = torch.from_numpy(rng.randn(37, n).astype(np.float32) * 2 + 1)
        x = x.bfloat16()
        dy = torch.from_numpy(rng.randn(37, n).astype(np.float32))
        dy = dy.bfloat16()
        gamma = torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5)
        beta = torch.zeros(n)
        _, mean, rstd = norm.layernorm_fwd_plain(x, gamma, beta, 1e-5)
        got = norm.layernorm_bwd_warp_plain(x, gamma, mean, rstd, dy, 5,
                                            phase)
        want = norm.layernorm_bwd_plain(x, gamma, mean, rstd, dy)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=2e-2, atol=2e-2)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, **SUM_TOL)


def test_layernorm_bwd_warp_sums_are_fixed_by_the_grid():
    """dgamma and dbeta depend on the grid alone: the same bits on every
    call, and any two grids agree to f32 rounding."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(300, 64).astype(np.float32))
    dy = torch.from_numpy(rng.randn(300, 64).astype(np.float32))
    gamma = torch.from_numpy(rng.rand(64).astype(np.float32) + 0.5)
    _, mean, rstd = norm.layernorm_fwd_plain(x, gamma, torch.zeros(64), 1e-5)
    a = norm.layernorm_bwd_warp_plain(x, gamma, mean, rstd, dy, 38)
    b = norm.layernorm_bwd_warp_plain(x, gamma, mean, rstd, dy, 38)
    c = norm.layernorm_bwd_warp_plain(x, gamma, mean, rstd, dy, 3)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v)
        torch.testing.assert_close(u, w, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_plan_nothing_and_count_no_route():
    before = launch_counts()
    x = torch.randn(8, 1024)
    _, mean, rstd = norm.layernorm_fwd(x, torch.ones(1024), torch.zeros(1024))
    norm.layernorm_bwd(x, torch.ones(1024), mean, rstd, torch.randn(8, 1024))
    reduction.reduce(torch.randn(4096), "mean")
    assert launch_counts() == before
    assert {"layernorm_bwd/warp", "layernorm_bwd/block", "reduce/cta",
            "reduce/grid"} <= set(before)


def test_ptxas_report_names_bool_template_arguments():
    """The reduce kernels take a bool template argument: the ptxas
    report names each instantiation, as chip_smoke prints them."""
    from flexflow_tpu_torch.kernels._build import _kernel_name

    assert _kernel_name("_ZN12_GLOBAL__N_117reduce_cta_kernelIfLb1ELi4EEEv"
                        "PKT_ifPf") == "reduce_cta_kernel<float, true, 4>"
    assert _kernel_name("_ZN12_GLOBAL__N_121reduce_partial_kernelI13__nv_"
                        "bfloat16Lb0EEEvPKT_xiPf") == \
        "reduce_partial_kernel<bf16, false>"
    assert _kernel_name("_ZN12_GLOBAL__N_125layernorm_bwd_warp_kernelI13__"
                        "nv_bfloat16Li4EEEvPKT_PKfS6_S6_S4_PS2_PfS8_iii") \
        == "layernorm_bwd_warp_kernel<bf16, 4>"


# RMSNorm backward against the Pallas kernel, at the tolerances of
# tests/test_torch_kernels.py's RMSNorm check: dx f32 (rtol 1e-5, atol
# 1e-6), bf16 (2e-2, 1e-2); dgamma f32 sums over the rows in another order
RMS_DX_TOL = {jnp.float32: dict(rtol=1e-5, atol=1e-6),
              jnp.bfloat16: dict(rtol=2e-2, atol=1e-2)}
RMS_DG_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows,n,route", [
    (4096, 1024, "warp"),         # the tier step's one launch
    (64, 1024, "warp"), (37, 300, "warp"), (1, 1, "warp"),
    (4095, 2048, "warp"), (1, 2049, "block"), (4095, 14528, "block")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_bwd_plan_routes(rows, n, route, dtype):
    assert norm.rmsnorm_bwd_plan(rows, n, dtype).route == route


def test_rmsnorm_bwd_plan_at_the_tier_shape():
    """(4096, 1024): LayerNorm backward's grid, one CTA of 8 warps an SM,
    one partial row of dgamma a CTA: 132 in place of the parent's 512."""
    for dtype, vecs in ((torch.bfloat16, 4), (torch.float32, 8)):
        plan = norm.rmsnorm_bwd_plan(4096, 1024, dtype)
        assert plan == norm.RmsBwdPlan(
            "warp", 256, 132 * norm.LN_BWD_BLOCKS_PER_SM, vecs)
        assert tuple(plan) == tuple(norm.layernorm_bwd_plan(4096, 1024,
                                                            dtype))
    small = norm.rmsnorm_bwd_plan(4096, 1024, torch.bfloat16, sms=16)
    assert (small.route, small.blocks) == ("warp",
                                           16 * norm.LN_BWD_BLOCKS_PER_SM)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_bwd_plan_is_pure_and_refuses_no_shape_the_parent_took(
        dtype):
    """The same answer twice, from ints alone; every N up to the parent's
    MAX_BWD_COLS gets a route inside what the launcher accepts (the warp
    route's is LayerNorm backward's launcher); wider raises, as the
    parent's wrapper did."""
    ns = sorted(set(EDGE_N + [3, 31, 32, 64, 65, 511, 1023, 1025, 1536,
                              4096, 8191, 10000]))
    for rows in EDGE_R + [2, 100, 132, 1056, 1057, 10 ** 6]:
        for n in ns:
            plan = norm.rmsnorm_bwd_plan(rows, n, dtype)
            assert plan == norm.rmsnorm_bwd_plan(np.int64(rows), n, dtype)
            assert (plan.route == "warp") == (n <= 2048)
            _ln_bwd_plan_fits(plan, rows, n, dtype)
    with pytest.raises(ValueError, match=str(norm.MAX_BWD_COLS)):
        norm.rmsnorm_bwd_plan(1, norm.MAX_BWD_COLS + 1, dtype)
    with pytest.raises(ValueError, match=">= 1"):
        norm.rmsnorm_bwd_plan(0, 5, dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm.rmsnorm_bwd_plan(4, 5, torch.float16)


def _rms_warp_pair(rows, n, dtype, affine, seed, phase=0):
    """(the warp emulation, `_rms_fwd` then `_rms_bwd` in interpret
    mode): (dx, dgamma) each."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, n).astype(np.float32) * 2 + 1
    dy = rng.randn(rows, n).astype(np.float32)
    gamma = rng.rand(n).astype(np.float32) + 0.5
    jg = jnp.asarray(gamma) if affine else None
    _, rstd = _rms_fwd(jnp.asarray(x, dtype), jg, 1e-6, 16, True, affine)
    want = _rms_bwd(jnp.asarray(x, dtype), jg, rstd, jnp.asarray(dy, dtype),
                    16, True, affine)
    plan = norm.rmsnorm_bwd_plan(rows, n, TDT[dtype])
    got = norm.rmsnorm_bwd_warp_plain(
        torch.from_numpy(x).to(TDT[dtype]),
        torch.from_numpy(gamma) if affine else None,
        torch.from_numpy(np.array(rstd)), torch.from_numpy(dy).to(TDT[dtype]),
        plan.blocks, phase, plan.threads // 32)
    return got, want


def _rms_close(got, want, dtype, affine):
    (dx, dg), (jdx, jdg) = got, want
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), **RMS_DX_TOL[dtype])
    if not affine:
        assert dg is None and jdg is None
        return
    assert dg.dtype == torch.float32 and dg.shape == dx.shape[-1:]
    np.testing.assert_allclose(dg.numpy(), np.asarray(jdg), **RMS_DG_TOL)


@pytest.mark.parametrize("rows,n", [(64, 1024), (37, 300), (9, 33),
                                    (5, 1000), (3, 2048), (1, 1)])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_bwd_warp_plain_matches_pallas(rows, n, affine, dtype):
    """The warp route's order without the mean (per-lane sums of g *
    xhat, a butterfly; dgamma per warp, per CTA, over CTAs) against
    `_rms_bwd` in interpret mode."""
    got, want = _rms_warp_pair(rows, n, dtype, affine, rows * 5 + n)
    assert got[0].dtype == TDT[dtype] and tuple(got[0].shape) == (rows, n)
    _rms_close(got, want, dtype, affine)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_bwd_warp_plain_matches_the_public_vjp(dtype):
    """The tier's width through `fused_rmsnorm`'s custom VJP (interpret
    mode), the entry the JAX kernel tier calls."""
    rng = np.random.RandomState(6)
    rows, n = 64, 1024
    x = rng.randn(rows, n).astype(np.float32) * 2 + 1
    dy = rng.randn(rows, n).astype(np.float32)
    gamma = rng.rand(n).astype(np.float32) + 0.5
    _, vjp = jax.vjp(lambda a, g: fused_rmsnorm(a, g, block_rows=16,
                                                interpret=True),
                     jnp.asarray(x, dtype), jnp.asarray(gamma))
    jdx, jdg = vjp(jnp.asarray(dy, dtype))
    tx = torch.from_numpy(x).to(TDT[dtype])
    _, rstd = norm.rmsnorm_fwd_plain(tx, torch.from_numpy(gamma), 1e-6)
    plan = norm.rmsnorm_bwd_plan(rows, n, TDT[dtype])
    got = norm.rmsnorm_bwd_warp_plain(
        tx, torch.from_numpy(gamma), rstd, torch.from_numpy(dy).to(
            TDT[dtype]), plan.blocks, 0, plan.threads // 32)
    _rms_close(got, (jdx, jdg), dtype, True)


@pytest.mark.parametrize("phase", [2, 4, 6, 8, 10, 12, 14])
def test_rmsnorm_bwd_warp_plain_at_every_row_phase(phase):
    """bf16 rows of 300 (8 mod 16 bytes) and 33 (2 mod 16) from x's first
    row `phase` bytes past a 16-byte boundary: heads and tails on the
    lanes the kernel gives them, against `_rms_bwd`."""
    for n in (300, 33):
        got, want = _rms_warp_pair(37, n, jnp.bfloat16, True, phase + n,
                                   phase)
        _rms_close(got, want, jnp.bfloat16, True)


def test_rmsnorm_bwd_warp_sums_are_fixed_by_the_grid():
    """dgamma depends on the grid alone: the same bits on every call, and
    any two grids agree to f32 rounding."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(300, 64).astype(np.float32))
    dy = torch.from_numpy(rng.randn(300, 64).astype(np.float32))
    gamma = torch.from_numpy(rng.rand(64).astype(np.float32) + 0.5)
    _, rstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
    a = norm.rmsnorm_bwd_warp_plain(x, gamma, rstd, dy, 38)
    b = norm.rmsnorm_bwd_warp_plain(x, gamma, rstd, dy, 38)
    c = norm.rmsnorm_bwd_warp_plain(x, gamma, rstd, dy, 3)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v)
        torch.testing.assert_close(u, w, rtol=1e-5, atol=1e-5)


def test_layernorm_bwd_warp_plain_center_flag():
    """`center` (the kernel's kCenter) True is LayerNorm's route, the
    default, with dbeta; False drops the mean's terms and dbeta only: at
    mean 0 both give the same dgamma, and dx differs by m1 * rstd."""
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.randn(40, 96).astype(np.float32))
    dy = torch.from_numpy(rng.randn(40, 96).astype(np.float32))
    gamma = torch.from_numpy(rng.rand(96).astype(np.float32) + 0.5)
    _, rstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
    zero = torch.zeros_like(rstd)
    ln = norm.layernorm_bwd_warp_plain(x, gamma, zero, rstd, dy, 2)
    ln2 = norm.layernorm_bwd_warp_plain(x, gamma, zero, rstd, dy, 2,
                                        center=True)
    assert all(torch.equal(a, b) for a, b in zip(ln, ln2))
    rms = norm.layernorm_bwd_warp_plain(x, gamma, None, rstd, dy, 2,
                                        center=False)
    assert rms[2] is None and ln[2] is not None
    assert torch.equal(rms[1], ln[1])
    m1 = (dy * gamma).mean(dim=1, keepdim=True)
    torch.testing.assert_close(rms[0] - ln[0], (m1 * rstd).expand_as(x),
                               rtol=1e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(
        rms[:2], norm.rmsnorm_bwd_warp_plain(x, gamma, rstd, dy, 2)))


def test_cpu_rmsnorm_bwd_plans_nothing_and_counts_no_route():
    before = launch_counts()
    x = torch.randn(8, 1024)
    _, rstd = norm.rmsnorm_fwd(x, torch.ones(1024))
    norm.rmsnorm_bwd(x, torch.ones(1024), rstd, torch.randn(8, 1024))
    assert launch_counts() == before
    assert {"rmsnorm_bwd/warp", "rmsnorm_bwd/block"} <= set(before)
