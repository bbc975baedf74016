"""The softmax, RMSNorm and LayerNorm forward kernels' plans and
arithmetic, on the CPU.

`softmax_plan` / `rmsnorm_plan` / `layernorm_fwd_plan`
(flexflow_tpu_torch/kernels/norm.py) pick each call's route and launch
from the shape and dtype alone; these tests hold the routes at the paths'
shapes and at edge shapes, and hold every plan inside what the CUDA
launchers of csrc/norm.cu accept. The cluster route's split of a row
(`softmax_split_plain`), the RMSNorm warp route's fixed-order sum of x^2
(`rmsnorm_warp_plain`) and the LayerNorm warp route's two fixed-order sums
(`layernorm_fwd_warp_plain`) are held against the JAX package's Pallas
kernels in interpret mode, as tests/test_torch_kernels.py runs them. The
kernels themselves are held against these on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.pallas.norm import (_ln_fwd, _rms_fwd,
                                             fused_layernorm, fused_rmsnorm,
                                             fused_softmax)
from flexflow_tpu_torch.kernels import launch_counts, norm

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=1e-2)
# softmax: the kernel table's tolerances (chip_smoke.py), f32 probabilities
# of a 30522-wide row are ~3e-5, so 1e-6 is a few percent of one
SOFTMAX_F32_TOL = dict(rtol=1e-6, atol=1e-6)
SOFTMAX_BF16_TOL = dict(rtol=1e-2, atol=1e-6)
DTYPES = [torch.float32, torch.bfloat16]
EDGE_N = [1, 2, 10, 33, 300, 1000, 1024, 30522, 70000]
EDGE_R = [1, 8, 16, 128, 4095]
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("rows,n,route,cluster", [
    (4096, 2, "rows", 1),        # the training step's classifier
    (4096, 10, "rows", 1),       # the kernel-tier graph's dense(10)
    (8, 30522, "cluster", 8),    # a decode iteration's LM head
    (16, 30522, "cluster", 8),   # a prefill chunk's LM head
    (128, 30522, "block", 1),    # the kernel table's shape
    (4095, 30522, "block", 1),
    (64, 30522, "cluster", 2),
    (1, 70000, "cluster", 8),
    (4095, 70000, "cluster", 4),  # more than one CTA's registers hold
    (1, 300000, "loop", 1),       # more than 8 CTAs' registers hold
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_plan_routes(rows, n, route, cluster, dtype):
    plan = norm.softmax_plan(rows, n, dtype)
    assert (plan.route, plan.cluster) == (route, cluster), plan


@pytest.mark.parametrize("rows,n,route", [
    (4096, 1024, "warp"),        # the kernel-tier graph's rms_norm
    (37, 300, "warp"), (1, 33, "warp"), (4095, 1000, "warp"),
    (1, 1, "warp"), (1, 2048, "warp"), (1, 2049, "block"),
    (8, 30522, "block"), (1, 58080, "block")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plan_routes(rows, n, route, dtype):
    assert norm.rmsnorm_plan(rows, n, dtype).route == route


def _softmax_plan_fits(plan, rows, n, dtype):
    """What csrc/norm.cu launch_softmax accepts for the plan."""
    w = 16 // torch.tensor([], dtype=dtype).element_size()
    if plan.route == "rows":
        assert plan.lanes in (1, 2, 4, 8, 16, 32)
        assert plan.per_thread in ((1,) if plan.lanes < 32
                                   else (1, 2, 4, 8, 16, 32))
        assert plan.lanes * plan.per_thread >= n
        assert plan.threads == norm.ROWS_THREADS and plan.blocks >= 1
    elif plan.route in ("block", "cluster"):
        assert 1 <= plan.per_thread and plan.per_thread * w <= 32
        assert 128 <= plan.threads <= 1024
        assert plan.blocks == rows * plan.cluster
        assert (plan.cluster == 1) == (plan.route == "block")
        assert plan.cluster in (1, 2, 4, 8)
        assert -(-(-(-n // w)) // plan.cluster) \
            <= plan.threads * plan.per_thread
    else:
        assert plan.route == "loop" and plan.blocks == rows
        assert n > 8 * 1024 * 32  # no cluster of 8 holds the row


@pytest.mark.parametrize("dtype", DTYPES)
def test_plans_are_pure_and_refuse_no_shape_the_parent_took(dtype):
    """The same answer twice, from ints alone; every softmax N and every
    RMSNorm N up to the parent's shared-memory limit (f32 58080) gets a
    kernel route inside what the launchers accept."""
    ns = sorted(set(EDGE_N + [3, 31, 32, 64, 65, 1023, 1025, 4096, 8192,
                              32768, 32769, 65536, 262144, 262145,
                              10 ** 6, 10 ** 7]))
    for rows in EDGE_R + [2, 100, 132, 1000, 10 ** 6]:
        for n in ns:
            plan = norm.softmax_plan(rows, n, dtype)
            assert plan == norm.softmax_plan(np.int64(rows), n, dtype)
            _softmax_plan_fits(plan, rows, n, dtype)
        w = 16 // torch.tensor([], dtype=dtype).element_size()
        for n in [n for n in ns if n <= 58080] + [58080]:
            plan = norm.rmsnorm_plan(rows, n, dtype)
            assert plan == norm.rmsnorm_plan(rows, n, dtype)
            if plan.route == "warp":
                assert plan.vecs in (1, 2, 4, 8, 16)
                assert plan.vecs * w <= 64 and 32 * plan.vecs * w >= n
                assert plan.blocks == min(-(-rows // 8),
                                          132 * norm.RMS_BLOCKS_PER_SM)
            else:
                assert (plan.route, plan.blocks) == ("block", rows)
    # the parent's f32 RMSNorm staged 4N bytes beside 128: N <= 58080
    with pytest.raises(ValueError, match="58080"):
        norm.rmsnorm_plan(1, 58081, torch.float32)
    assert norm.rmsnorm_plan(1, 116160, torch.bfloat16).route == "block"
    with pytest.raises(ValueError, match=">= 1"):
        norm.softmax_plan(0, 5, dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm.rmsnorm_plan(4, 5, torch.float16)


def test_plans_follow_the_card_size():
    """On a card of fewer SMs the persistent grids shrink; the routes do
    not change."""
    small = norm.softmax_plan(4096, 10, torch.bfloat16, sms=16)
    assert small.route == "rows"
    assert small.blocks == 16 * norm.ROWS_BLOCKS_PER_SM
    rms = norm.rmsnorm_plan(4096, 1024, torch.bfloat16, sms=16)
    assert (rms.route, rms.blocks) == ("warp", 16 * norm.RMS_BLOCKS_PER_SM)


def test_rows_of_a_vocabulary_start_at_four_phases():
    """A bf16 row of 30522 is 61044 bytes, 4 mod 16: the heads the
    kernels peel cycle through 0, 6, 4, 2 elements (and N = 1 takes at
    most its one element)."""
    heads = norm._row_heads(8, 30522, 2, 0).tolist()
    assert heads == [0, 6, 4, 2, 0, 6, 4, 2]
    assert norm._row_heads(3, 1, 2, 2).tolist() == [1, 1, 1]
    assert norm._row_heads(4, 1024, 4, 0).tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("phase", [0, 2, 6, 14])
def test_output_is_allocated_at_the_input_phase(phase):
    buf = torch.zeros(64 + 16, dtype=torch.bfloat16)
    start = (phase - buf.data_ptr() % 16) % 16 // 2
    x = buf[start:start + 64].view(4, 16)
    assert x.data_ptr() % 16 == phase
    y = norm._empty_in_phase(x)
    assert y.data_ptr() % 16 == phase
    assert y.shape == x.shape and y.is_contiguous()


def _softmax_pair(x, dtype, splits, phase):
    ref = fused_softmax(jnp.asarray(x, dtype), block_rows=8, interpret=True)
    got = norm.softmax_split_plain(torch.from_numpy(x).to(TDT[dtype]),
                                   splits, phase)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == x.shape
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("splits", [2, 4, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_softmax_split_plain_matches_pallas(rows, splits, dtype):
    """The cluster route's split (head and tail on rank 0, the rows'
    16-byte phases) and its rank-order merge against `fused_softmax`."""
    rng = np.random.RandomState(rows * 10 + splits)
    x = rng.randn(rows, 30522).astype(np.float32) * 4
    # put the row's max in another CTA's slice on every row
    for r in range(rows):
        x[r, (r * 3797) % 30522] = 20.0
    got, ref = _softmax_pair(x, dtype, splits, 0)
    np.testing.assert_allclose(got, ref, **(
        SOFTMAX_F32_TOL if dtype == jnp.float32 else SOFTMAX_BF16_TOL))


@pytest.mark.parametrize("phase", [2, 4, 12])
def test_softmax_split_plain_at_every_row_phase(phase):
    rng = np.random.RandomState(phase)
    x = rng.randn(5, 30522).astype(np.float32) * 3
    got, ref = _softmax_pair(x, jnp.bfloat16, 8, phase)
    np.testing.assert_allclose(got, ref, **SOFTMAX_BF16_TOL)


def test_softmax_split_is_the_same_bits_every_call():
    """The merge runs in rank order, so a split gives the same bits on
    every call, and any split agrees with another to f32 rounding."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(64, 30522).astype(np.float32) * 4)
    a = norm.softmax_split_plain(x, 8)
    b = norm.softmax_split_plain(x, 8)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, norm.softmax_split_plain(x, 2),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("rows,n", [(4096, 1024), (37, 300), (1, 33),
                                    (4095, 1000), (3, 1), (2, 2048)])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_warp_plain_matches_pallas(rows, n, affine, dtype):
    """The warp route's fixed-order sum of x^2 (per lane, then a
    butterfly) against `_rms_fwd` in interpret mode, y and rstd."""
    rng = np.random.RandomState(rows + n)
    x = rng.randn(rows, n).astype(np.float32) * 2 + 1
    gamma = rng.rand(n).astype(np.float32) + 0.5
    jg = jnp.asarray(gamma) if affine else None
    jy, jrstd = _rms_fwd(jnp.asarray(x, dtype), jg, 1e-6, 128, True, affine)
    tx = torch.from_numpy(x).to(TDT[dtype])
    y, rstd = norm.rmsnorm_warp_plain(
        tx, torch.from_numpy(gamma) if affine else None, 1e-6)
    assert y.dtype == TDT[dtype] and rstd.shape == (rows, 1)
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), **F32_TOL)
    if rows == 4096:  # the public entry too
        fy = fused_rmsnorm(jnp.asarray(x, dtype), jg, interpret=True)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(fy, np.float32), **tol)


@pytest.mark.parametrize("phase", [2, 6, 10])
def test_rmsnorm_warp_plain_at_every_row_phase(phase):
    """bf16 rows of 300 (8 mod 16 bytes) and 33 (2 mod 16): heads and
    tails on the lanes the kernel gives them, against the plain version
    (the same terms, in torch's order)."""
    rng = np.random.RandomState(phase)
    for n in (300, 33):
        x = torch.from_numpy(rng.randn(37, n).astype(np.float32) * 2 + 1)
        x = x.bfloat16()
        gamma = torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5)
        y, rstd = norm.rmsnorm_warp_plain(x, gamma, 1e-6, phase)
        ry, rrstd = norm.rmsnorm_fwd_plain(x, gamma, 1e-6)
        torch.testing.assert_close(rstd, rrstd, **F32_TOL)
        torch.testing.assert_close(y.float(), ry.float(), **BF16_TOL)


def test_cpu_tensors_plan_nothing_and_count_no_route():
    before = launch_counts()
    x = torch.randn(8, 30522)
    norm.softmax_fwd(x)
    norm.rmsnorm_fwd(x[:, :1024].contiguous(), torch.ones(1024))
    assert launch_counts() == before
    assert "softmax_fwd/cluster" in before and "rmsnorm_fwd/warp" in before


# LayerNorm forward against the Pallas kernel: y within the f32 and bf16
# tolerances (atol, rtol); mean and rstd (f32 in both) at the f32 one
LN_TOL = {jnp.float32: dict(atol=1e-5, rtol=1e-4),
          jnp.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.mark.parametrize("rows,n,route", [
    (4096, 1024, "warp"),        # a training step's 24 launches
    (8, 1024, "warp"),           # a decode iteration's 24
    (16, 1024, "warp"),          # a prefill chunk's 24
    (128, 1024, "warp"),         # the kernel table's shape
    (37, 300, "warp"), (1, 1, "warp"), (4095, 2048, "warp"),
    (1, 2049, "block"), (4095, 58080, "block")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_fwd_plan_routes(rows, n, route, dtype):
    assert norm.layernorm_fwd_plan(rows, n, dtype).route == route


def test_layernorm_fwd_plan_at_the_path_shapes():
    """N = 1024: a lane holds 32 values (4 bf16 vectors, 8 f32); the
    training step's 4096 rows take CTAs of 8 warps, at most
    LN_FWD_BLOCKS_PER_SM an SM; 8, 16 and 128 rows (serving, the kernel
    table) one warp a CTA, a row an SM."""
    for dtype, vecs in ((torch.bfloat16, 4), (torch.float32, 8)):
        assert norm.layernorm_fwd_plan(4096, 1024, dtype) == norm.LnFwdPlan(
            "warp", 256, min(512, 132 * norm.LN_FWD_BLOCKS_PER_SM), vecs)
        for rows in (8, 16, 128):
            assert norm.layernorm_fwd_plan(rows, 1024, dtype) == \
                norm.LnFwdPlan("warp", 32, rows, vecs)
    # 133 rows: two warps a CTA; a smaller card spreads them the same way
    assert norm.layernorm_fwd_plan(133, 1024, torch.bfloat16)[1:3] == (64,
                                                                      67)
    small = norm.layernorm_fwd_plan(4096, 1024, torch.bfloat16, sms=16)
    assert small == norm.LnFwdPlan("warp", 256,
                                   16 * norm.LN_FWD_BLOCKS_PER_SM, 4)
    assert norm.layernorm_fwd_plan(64, 1024, torch.bfloat16, sms=16)[1:3] \
        == (128, 16)


def _ln_fwd_plan_fits(plan, rows, n, dtype):
    """What csrc/norm.cu launch_layernorm accepts for the plan."""
    w = 16 // torch.tensor([], dtype=dtype).element_size()
    if plan.route == "warp":
        assert plan.vecs in (1, 2, 4, 8, 16)
        assert plan.vecs * w <= 64 and 32 * plan.vecs * w >= n
        assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
        assert 1 <= plan.blocks <= 132 * norm.LN_FWD_BLOCKS_PER_SM
        # every row has a warp, and no CTA is without a row
        warps = plan.threads // 32
        assert plan.blocks * warps >= min(rows, plan.blocks * warps)
        assert (plan.blocks - 1) * warps < rows
    else:
        assert plan.route == "block" and plan.vecs == 0
        assert (plan.threads, plan.blocks) == (256, rows)
        assert 4 * n + 32 * 4 <= norm.SMEM_BYTES


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_fwd_plan_is_pure_and_refuses_no_shape_the_parent_took(
        dtype):
    """The same answer twice, from ints alone; every N up to the parent's
    shared-memory limit (58080: its f32 row beside 32 floats of scratch)
    gets a kernel route inside what the launcher accepts; wider raises a
    ValueError that names the limit, where the parent's launch failed."""
    ns = sorted(set([1, 2, 3, 31, 32, 33, 64, 65, 300, 1000, 1023, 1024,
                     1025, 2047, 2048, 2049, 4096, 30522, 58079, 58080]))
    for rows in [1, 2, 7, 8, 9, 16, 100, 128, 132, 133, 1000, 1056, 1057,
                 4095, 4096, 10 ** 6]:
        for n in ns:
            plan = norm.layernorm_fwd_plan(rows, n, dtype)
            assert plan == norm.layernorm_fwd_plan(np.int64(rows), n, dtype)
            assert (plan.route == "warp") == (n <= 2048)
            _ln_fwd_plan_fits(plan, rows, n, dtype)
    assert norm.layernorm_max_n(dtype) == 58080
    with pytest.raises(ValueError, match="58080"):
        norm.layernorm_fwd_plan(1, 58081, dtype)
    with pytest.raises(ValueError, match=">= 1"):
        norm.layernorm_fwd_plan(4, 0, dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm.layernorm_fwd_plan(4, 5, torch.float16)


def _ln_fwd_pair(x, gamma, beta, dtype, phase=0):
    """(the warp emulation, `_ln_fwd` in interpret mode): (y, mean, rstd)
    each as f32 numpy."""
    affine = gamma is not None
    jy, jmean, jrstd = _ln_fwd(jnp.asarray(x, dtype),
                               jnp.asarray(gamma) if affine else None,
                               jnp.asarray(beta) if affine else None, 1e-5,
                               128, True, affine)
    got = norm.layernorm_fwd_warp_plain(
        torch.from_numpy(x).to(TDT[dtype]),
        torch.from_numpy(gamma) if affine else None,
        torch.from_numpy(beta) if affine else None, 1e-5, phase)
    assert got[0].dtype == TDT[dtype] and tuple(got[0].shape) == x.shape
    assert got[1].shape == got[2].shape == (x.shape[0], 1)
    return ([t.float().numpy() for t in got],
            [np.asarray(t, np.float32) for t in (jy, jmean, jrstd)])


def _ln_fwd_close(got, want, dtype):
    np.testing.assert_allclose(got[0], want[0], **LN_TOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **LN_TOL[jnp.float32])


@pytest.mark.parametrize("rows,n", [(4096, 1024), (8, 1024), (37, 300),
                                    (1, 33), (3, 1), (2, 2048)])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_fwd_warp_plain_matches_pallas(rows, n, affine, dtype):
    """The warp route's two fixed-order sums (per lane, then a butterfly)
    against `_ln_fwd` in interpret mode: y, mean and rstd; at the
    training shape also against the public `fused_layernorm`."""
    rng = np.random.RandomState(rows + 3 * n)
    x = rng.randn(rows, n).astype(np.float32) * 2 + 1
    gamma = rng.rand(n).astype(np.float32) + 0.5 if affine else None
    beta = rng.randn(n).astype(np.float32) if affine else None
    got, want = _ln_fwd_pair(x, gamma, beta, dtype)
    _ln_fwd_close(got, want, dtype)
    if rows == 4096:  # the public entry too
        fy = fused_layernorm(jnp.asarray(x, dtype),
                             jnp.asarray(gamma) if affine else None,
                             jnp.asarray(beta) if affine else None,
                             interpret=True)
        np.testing.assert_allclose(got[0], np.asarray(fy, np.float32),
                                   **LN_TOL[dtype])


@pytest.mark.parametrize("phase", [2, 4, 6, 8, 10, 12, 14])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_fwd_warp_plain_at_every_row_phase(phase, dtype):
    """Rows of 300 (8 mod 16 bytes in bf16) and 33 (2 mod 16 in bf16, 4
    mod 16 in f32) from x's first row `phase` bytes past a 16-byte
    boundary (f32 rows start only at multiples of 4): heads and tails on
    the lanes the kernel gives them, against `_ln_fwd`."""
    if dtype == jnp.float32 and phase % 4:
        phase = phase - 2
    rng = np.random.RandomState(phase + 40)
    for n in (300, 33):
        x = rng.randn(9, n).astype(np.float32) * 3 - 2
        gamma = rng.rand(n).astype(np.float32) + 0.5
        beta = rng.randn(n).astype(np.float32)
        got, want = _ln_fwd_pair(x, gamma, beta, dtype, phase)
        _ln_fwd_close(got, want, dtype)


def test_layernorm_fwd_warp_plain_is_two_pass():
    """Rows far from 0 (mean 1e4, spread 1e-2): var = sum((x - mean)^2) /
    N keeps rstd to f32 rounding, where E[x^2] - mean^2 in f32 would lose
    every digit (1e8 +- 1e-4 is below an f32 ulp of 1e8)."""
    rng = np.random.RandomState(9)
    x = (1e4 + rng.randn(16, 1024) * 1e-2).astype(np.float32)
    _, mean, rstd = norm.layernorm_fwd_warp_plain(torch.from_numpy(x), None,
                                                  None, 1e-5)
    x64 = x.astype(np.float64)
    var = ((x64 - x64.mean(1, keepdims=True)) ** 2).mean(1, keepdims=True)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(var + 1e-5),
                               rtol=2e-3)
    np.testing.assert_allclose(mean.numpy(), x64.mean(1, keepdims=True),
                               rtol=1e-7)
    e2 = (x * x).mean(1, keepdims=True) - mean.numpy() ** 2
    assert not np.allclose(e2, var, rtol=0.5)


def test_layernorm_fwd_warp_plain_is_the_same_bits_every_call():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(50, 300).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.rand(300).astype(np.float32))
    b = torch.from_numpy(rng.randn(300).astype(np.float32))
    a = norm.layernorm_fwd_warp_plain(x, g, b, 1e-5, 6)
    c = norm.layernorm_fwd_warp_plain(x, g, b, 1e-5, 6)
    assert all(torch.equal(u, v) for u, v in zip(a, c))


def test_cpu_layernorm_fwd_plans_nothing_and_counts_no_route():
    before = launch_counts()
    norm.layernorm_fwd(torch.randn(8, 1024), torch.ones(1024),
                       torch.zeros(1024))
    assert launch_counts() == before
    assert {"layernorm_fwd/warp", "layernorm_fwd/block"} <= set(before)
