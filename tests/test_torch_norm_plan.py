"""The softmax and RMSNorm forward kernels' plans and arithmetic, on the CPU.

`softmax_plan` / `rmsnorm_plan` (flexflow_tpu_torch/kernels/norm.py) pick
each call's route and launch from the shape and dtype alone; these tests
hold the routes at the paths' shapes and at edge shapes, and hold every
plan inside what the CUDA launchers of csrc/norm.cu accept. The cluster
route's split of a row (`softmax_split_plain`) and the warp route's
fixed-order sum of x^2 (`rmsnorm_warp_plain`) are held against the JAX
package's Pallas kernels in interpret mode, as tests/test_torch_kernels.py
runs them. The kernels themselves are held against these on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.pallas.norm import (_rms_fwd, fused_rmsnorm,
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
