"""The softmax backward kernel's plan and arithmetic, on the CPU.

`softmax_bwd_plan` (flexflow_tpu_torch/kernels/norm.py) picks each call's
route and launch from the shape and dtype alone; these tests hold the
routes at the paths', the kernel table's and edge shapes, and every plan
inside what csrc/norm.cu `launch_softmax_bwd` accepts. Every route sums
y * dy in a fixed order that `softmax_bwd_split_plain` repeats in torch;
the emulation is held against the plain version and both against the
JAX package's `fused_softmax` VJP through its Pallas kernel in interpret
mode, as tests/test_torch_kernels.py runs it. The kernels themselves are
held against the emulation, bit for bit, on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.pallas.norm import fused_softmax
from flexflow_tpu_torch.kernels import launch_counts, norm

DTYPES = [torch.float32, torch.bfloat16]
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# dx = y * (dy - sum(y * dy)): f32 sums of the same terms in another
# order; bf16 dx rounded once to bf16 (2^-8 relative) from nearly the
# same f32 value (chip_smoke.py's softmax_bwd tolerances)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-6),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}


@pytest.mark.parametrize("rows,n,route,cluster", [
    (4096, 2, "rows", 1),          # the training and tp steps' classifier
    (4096, 10, "rows", 1),         # the kernel-tier graph's dense(10)
    (8, 30522, "cluster", 8),      # an LM-training decode-sized batch
    (16, 30522, "cluster", 4),
    (128, 30522, "block", 1),      # the kernel table's shape
    (2048, 32000, "block", 1),     # the NMT projection at rnn.py widths
    (4096, 1024, "block", 1),      # a bytes-bound mid width
    (1, 512, "rows", 1), (1, 513, "cluster", 8), (32, 30522, "cluster", 2),
    (64, 30522, "block", 1),
    (1, 300000, "loop", 1)])
def test_softmax_bwd_plan_routes(rows, n, route, cluster):
    plan = norm.softmax_bwd_plan(rows, n, torch.bfloat16)
    assert (plan.route, plan.cluster) == (route, cluster), plan


@pytest.mark.parametrize("rows,n,route,cluster", [
    (4096, 2, "rows", 1), (4096, 10, "rows", 1), (8, 30522, "cluster", 8),
    (128, 30522, "cluster", 2),    # f32: 30522 is 2 CTAs' registers
    (2048, 32000, "cluster", 2), (4096, 1024, "block", 1),
    (1, 131072, "cluster", 8), (1, 131073, "loop", 1)])
def test_softmax_bwd_plan_routes_f32(rows, n, route, cluster):
    plan = norm.softmax_bwd_plan(rows, n, torch.float32)
    assert (plan.route, plan.cluster) == (route, cluster), plan


def test_softmax_bwd_plan_at_the_path_shapes():
    """The classifier's (4096, 2): two lanes a row, 16 rows a warp, 64
    CTAs; the tier's (4096, 10): 4 lanes of 4 values, 8 rows a warp; a
    vocabulary row of bf16 30522 on one CTA of 1024 threads, 4 vector
    pairs each."""
    p = norm.softmax_bwd_plan(4096, 2, torch.bfloat16)
    assert (p.lanes, p.per_thread, p.threads, p.blocks) == (2, 1, 128, 64)
    p = norm.softmax_bwd_plan(4096, 10, torch.float32)
    assert (p.lanes, p.per_thread, p.blocks) == (4, 4, 128)
    p = norm.softmax_bwd_plan(128, 30522, torch.bfloat16)
    assert (p.threads, p.per_thread, p.blocks) == (1024, 4, 128)
    p = norm.softmax_bwd_plan(8, 30522, torch.bfloat16)
    assert (p.threads, p.per_thread, p.blocks, p.cluster) == (128, 4, 64, 8)


def _fits(plan, rows, n, dtype):
    """What csrc/norm.cu launch_softmax_bwd accepts for the plan."""
    w = 16 // torch.tensor([], dtype=dtype).element_size()
    if plan.route == "rows":
        assert plan.lanes in (1, 2, 4, 8, 16, 32)
        assert plan.per_thread in (1, 2, 4, 8, 16, 32)
        assert plan.lanes * plan.per_thread >= n
        assert plan.threads == norm.ROWS_THREADS and plan.blocks >= 1
    elif plan.route in ("block", "cluster"):
        assert 1 <= plan.per_thread <= 4
        assert 128 <= plan.threads <= 1024
        assert plan.threads & (plan.threads - 1) == 0
        assert plan.blocks == rows * plan.cluster
        assert (plan.cluster == 1) == (plan.route == "block")
        assert plan.cluster in (1, 2, 4, 8)
        assert -(-(-(-n // w)) // plan.cluster) \
            <= plan.threads * plan.per_thread
    else:
        assert plan.route == "loop" and plan.blocks == rows
        assert plan.threads == 1024
        assert -(-n // w) > 8 * 1024 * 4  # no cluster of 8 holds the row


@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_bwd_plan_is_pure_and_takes_every_shape(dtype):
    """The same answer twice, from ints alone; every N from 1 to 10^7 at
    every row count gets a route inside what the launcher accepts."""
    ns = [1, 2, 3, 10, 31, 32, 33, 64, 65, 255, 256, 257, 512, 513, 1000,
          1023,
          1024, 1025, 4096, 8192, 30522, 32000, 32768, 32769, 65536,
          131072, 131073, 262144, 262145, 10 ** 6, 10 ** 7]
    for rows in [1, 2, 7, 8, 9, 16, 100, 128, 132, 1000, 4095, 4096,
                 10 ** 6]:
        for n in ns:
            plan = norm.softmax_bwd_plan(rows, n, dtype)
            assert plan == norm.softmax_bwd_plan(np.int64(rows), n, dtype)
            _fits(plan, rows, n, dtype)


def test_softmax_bwd_plan_raises():
    with pytest.raises(ValueError, match=">= 1"):
        norm.softmax_bwd_plan(0, 5, torch.float32)
    with pytest.raises(ValueError, match=">= 1"):
        norm.softmax_bwd_plan(3, 0, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm.softmax_bwd_plan(4, 5, torch.float16)
    # the kernels index a row with 32-bit ints, the grid is 2^31 - 1 CTAs
    with pytest.raises(ValueError, match="2\\^31"):
        norm.softmax_bwd_plan(1, 2 ** 31, torch.bfloat16)
    with pytest.raises(ValueError, match="2\\^31"):
        norm.softmax_bwd_plan(2 ** 30, 70000, torch.bfloat16)


def test_softmax_bwd_plan_follows_the_card_size():
    small = norm.softmax_bwd_plan(4096, 10, torch.bfloat16, sms=16)
    assert small.route == "rows"
    assert small.blocks == 16 * norm.SOFTMAX_BWD_ROWS_BLOCKS_PER_SM
    wide = norm.softmax_bwd_plan(128, 30522, torch.bfloat16, sms=16)
    assert wide == norm.softmax_bwd_plan(128, 30522, torch.bfloat16)


def _inputs(rng, rows, n, dtype):
    x = rng.randn(rows, n).astype(np.float32) * 3
    y = torch.softmax(torch.from_numpy(x), -1).to(dtype)
    dy = torch.from_numpy(rng.randn(rows, n).astype(np.float32)).to(dtype)
    return y, dy


@pytest.mark.parametrize("rows,n,splits", [
    (7, 1, 1), (7, 2, 1), (7, 10, 1), (5, 33, 1), (5, 512, 1),
    (5, 513, 1), (5, 513, 8), (3, 1000, 1), (3, 1024, 4), (4, 30522, 1),
    (4, 30522, 2), (4, 30522, 8), (2, 70000, 8), (1, 300000, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_bwd_split_plain_matches_plain(rows, n, splits, dtype):
    """Each route's order (the rows route's lanes, the register routes'
    threads, head and tail, cluster ranks, the loop route's 1024 threads)
    gives dx within tolerance of the plain version."""
    rng = np.random.RandomState(rows * 31 + n + splits)
    y, dy = _inputs(rng, rows, n, dtype)
    got = norm.softmax_bwd_split_plain(y, dy, splits)
    assert got.dtype == dtype and got.shape == y.shape
    torch.testing.assert_close(got.float(),
                               norm.softmax_bwd_plain(y, dy).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("phase", [2, 4, 6, 8, 10, 12, 14])
def test_softmax_bwd_split_plain_at_every_row_phase(phase):
    """bf16 rows of 30522 (4 mod 16 bytes) starting `phase` bytes past a
    16-byte boundary: heads and tails on rank 0's threads, any split."""
    rng = np.random.RandomState(phase)
    y, dy = _inputs(rng, 5, 30522, torch.bfloat16)
    for splits in (1, 8):
        got = norm.softmax_bwd_split_plain(y, dy, splits, phase)
        torch.testing.assert_close(got.float(),
                                   norm.softmax_bwd_plain(y, dy).float(),
                                   **TOL[torch.bfloat16])


def test_softmax_bwd_split_plain_takes_the_routes_splits_only():
    y = torch.softmax(torch.randn(2, 10), -1)
    with pytest.raises(ValueError, match="rows route"):
        norm.softmax_bwd_split_plain(y, y, 2)
    y = torch.softmax(torch.randn(1, 131073), -1)
    with pytest.raises(ValueError, match="loop route"):
        norm.softmax_bwd_split_plain(y, y, 2)


def test_softmax_bwd_split_plain_is_the_same_bits_every_call():
    """Every sum runs in a fixed order, so a route gives the same bits on
    every call; two splits agree to f32 rounding."""
    rng = np.random.RandomState(3)
    y, dy = _inputs(rng, 16, 30522, torch.float32)
    a = norm.softmax_bwd_split_plain(y, dy, 8)
    assert torch.equal(a, norm.softmax_bwd_split_plain(y, dy, 8))
    torch.testing.assert_close(a, norm.softmax_bwd_split_plain(y, dy, 2),
                               rtol=1e-5, atol=1e-8)


def test_softmax_bwd_rows_route_sums_lanes_in_a_butterfly():
    """At N = 5 the rows route's 2 lanes hold p0, p2, p4 and p1, p3, 0,
    add them in order and meet in a butterfly: (p0 + p2 + p4) + (p1 +
    p3), not torch's left-to-right sum."""
    y = torch.tensor([[1.0, 2.0 ** -24, 1.0, 0.0, 0.0]])
    dy = torch.tensor([[1.0, 1.0, -1.0, 0.0, 0.0]])
    # (1 + -1 + 0) + (2^-24 + 0) = 2^-24; left to right (1 + 2^-24) rounds
    # to 1 and S = 0; dx_0 = 1 * (1 - 2^-24) = 1 - 2^-24
    got = norm.softmax_bwd_split_plain(y, dy)
    assert float(got[0, 0]) == 1.0 - 2.0 ** -24


@pytest.mark.parametrize("rows,n,splits", [(6, 2, 1), (6, 10, 1),
                                           (3, 300, 1), (3, 600, 4),
                                           (2, 30522, 8)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_and_emulation_match_pallas_vjp(rows, n, splits, dtype):
    """`fused_softmax`'s VJP through `_softmax_bwd_kernel` in interpret
    mode against the port's plain version, the route emulation and the
    autograd Function, on the same y and cotangent."""
    rng = np.random.RandomState(rows + n + splits)
    x = rng.randn(rows, n).astype(np.float32) * 3
    g = rng.randn(rows, n).astype(np.float32)
    y, vjp = jax.vjp(lambda a: fused_softmax(a, block_rows=8,
                                             interpret=True),
                     jnp.asarray(x, dtype))
    (want,) = vjp(jnp.asarray(g, dtype))
    want = np.asarray(want, np.float32)
    tdt = TDT[dtype]
    ty = torch.from_numpy(np.array(y, np.float32)).to(tdt)
    tg = torch.from_numpy(g).to(tdt)
    for got in (norm.softmax_bwd_plain(ty, tg),
                norm.softmax_bwd_split_plain(ty, tg, splits)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[tdt])
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    (dx,) = torch.autograd.grad(norm.softmax(tx), tx, tg)
    np.testing.assert_allclose(dx.float().numpy(), want, **TOL[tdt])


def test_cpu_softmax_bwd_plans_nothing_and_counts_no_route():
    before = launch_counts()
    y = torch.softmax(torch.randn(8, 30522), -1)
    norm.softmax_bwd(y, y)
    assert launch_counts() == before
    assert all(f"softmax_bwd/{r}" in before
               for r in ("rows", "block", "cluster", "loop"))
