"""The scan's plan and arithmetic, on the CPU.

`cumsum_plan` (flexflow_tpu_torch/kernels/reduction.py) picks each call's
route from the shape and dtype alone: "row" (one block a row) or "split"
(each row cut into chunks of whole tiles over many blocks, a launch of
chunk totals, then a programmatically dependent scan of each chunk from
the sum of the totals before it). These tests hold the routes at the
kernel table's and edge shapes, every plan inside what csrc/reduction.cu
`launch_cumsum` accepts, and `cumsum_split_plain` (both routes' adds, to
the bit) against the plain version and the JAX package's `fused_cumsum`,
forward and gradient, through its Pallas kernel in interpret mode. The
kernels are held against the emulation, bit for bit, on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.pallas.reduction import fused_cumsum
from flexflow_tpu_torch.kernels import launch_counts, reduction

DTYPES = [torch.float32, torch.bfloat16]
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("rows,n,route,chunk,chunks", [
    (4096, 1024, "row", 1024, 1),        # the kernel table's shape
    (37, 300, "row", 300, 1),
    (1, 1, "row", 1, 1),
    (1, 4096, "row", 4096, 1),           # at most 4 tiles: short
    (1056, 5000, "row", 5000, 1),        # 8 blocks an SM from the rows
    (1, 4097, "split", 2048, 3),
    (1055, 5000, "split", 3072, 2),
    (3, 1000003, "split", 3072, 326),    # D7
    (1, 1000003, "split", 2048, 489),  # chunks of 2 tiles at least
    (1, 2 ** 24, "split", 16384, 1024),  # capped at 1024 chunks
    (132, 100000, "split", 13312, 8)])
def test_cumsum_plan_routes(rows, n, route, chunk, chunks):
    for dtype in DTYPES:
        plan = reduction.cumsum_plan(rows, n, dtype)
        assert tuple(plan) == (route, chunk, chunks), plan


def _fits(plan, rows, n):
    """What csrc/reduction.cu launch_cumsum accepts for the plan."""
    if plan.route == "row":
        assert (plan.chunk, plan.chunks) == (n, 1)
        return
    assert plan.route == "split"
    assert plan.chunk % 1024 == 0 and plan.chunk >= 2048
    assert 2 <= plan.chunks <= 1024
    assert (plan.chunks - 1) * plan.chunk < n <= plan.chunks * plan.chunk
    assert rows * plan.chunks <= 2 ** 31 - 1


def test_cumsum_plan_is_pure_and_takes_every_shape():
    ns = [1, 2, 1023, 1024, 1025, 4096, 4097, 8192, 10 ** 5, 1000003,
          2 ** 24, 10 ** 8, 2 ** 31 + 5]
    for rows in [1, 2, 3, 7, 131, 132, 133, 1055, 1056, 4096, 10 ** 6]:
        for n in ns:
            plan = reduction.cumsum_plan(rows, n, torch.float32)
            assert plan == reduction.cumsum_plan(np.int64(rows), n,
                                                 torch.bfloat16)
            _fits(plan, rows, n)
            # a split cuts a row into at most the chunks that fill the
            # card at 8 blocks an SM, 1024 at most
            if plan.route == "split":
                assert plan.chunks <= min(1024, -(-132 * 8 // rows))


def test_cumsum_plan_raises_and_follows_the_card_size():
    with pytest.raises(ValueError, match=">= 1"):
        reduction.cumsum_plan(0, 5, torch.float32)
    with pytest.raises(ValueError, match=">= 1"):
        reduction.cumsum_plan(3, 0, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        reduction.cumsum_plan(3, 5000, torch.float16)
    # 16 SMs: 128 blocks wanted, so 43 chunks of each of the 3 rows
    small = reduction.cumsum_plan(3, 1000003, torch.float32, sms=16)
    assert (small.route, small.chunks) == ("split", 43)
    assert reduction.cumsum_plan(128, 5000, torch.float32,
                                 sms=16).route == "row"


def _tol(ref, x, reverse, dtype):
    """chip_smoke.py's cumsum tolerance: 1e-5 cumsum(|x|) + 1e-6, plus
    2^-7 |plain| in bf16 (one more rounding of the output)."""
    lim = 1e-5 * reduction.cumsum_plain(x.float().abs(), reverse) + 1e-6
    if dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.float().abs()
    return lim


@pytest.mark.parametrize("rows,n,chunk", [
    (5, 37, None), (3, 1030, None), (2, 5000, None), (1, 4097, 1024),
    (3, 10000, 2048), (2, 3 * 1024 * 7 + 1, 3072), (1, 100000, 1024),
    (3, 1000003, 3072)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_cumsum_split_plain_matches_plain(rows, n, chunk, dtype, reverse):
    rng = np.random.RandomState(rows + n)
    x = torch.from_numpy(rng.randn(rows, n).astype(np.float32)).to(dtype)
    got = reduction.cumsum_split_plain(x, chunk, reverse)
    ref = reduction.cumsum_plain(x, reverse)
    assert got.dtype == dtype and got.shape == x.shape
    assert bool(((got.float() - ref.float()).abs()
                 <= _tol(ref, x, reverse, dtype)).all())


def test_cumsum_split_plain_is_the_scan_of_its_chunks():
    """The split emulation of a row is the row emulation of each chunk
    from the carry of the totals before it: a chunk of a whole row is the
    row route, and any two chunkings agree to f32 rounding."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(3, 9000).astype(np.float32))
    row = reduction.cumsum_split_plain(x)
    assert torch.equal(row, reduction.cumsum_split_plain(x, 9000))
    assert torch.equal(row, reduction.cumsum_split_plain(x, 9216))
    a = reduction.cumsum_split_plain(x, 1024)
    assert torch.equal(a, reduction.cumsum_split_plain(x, 1024))
    # chunk 0 has no carry: its values are the row route's
    assert torch.equal(a[:, :1024], row[:, :1024])
    torch.testing.assert_close(a, reduction.cumsum_split_plain(x, 3072),
                               rtol=1e-5, atol=1e-4)


def test_cumsum_split_plain_keeps_the_kernels_order():
    """Within a tile a thread scans its 4 elements in order and the warp
    scans the thread totals as a tree: near 2^24, where an f32 add of 1
    rounds to even, the two orders give different bits."""
    x = torch.zeros(1, 2048)
    x[0, 0] = 2.0 ** 24
    x[0, 1] = 1.0
    x[0, 2] = 1.0
    got = reduction.cumsum_split_plain(x)
    # 2^24 + 1 rounds to 2^24 (even), and so does the next add
    assert float(got[0, 1]) == 2.0 ** 24 and float(got[0, 2]) == 2.0 ** 24
    y = torch.zeros(1, 2048)
    y[0, 0] = 2.0 ** 24
    y[0, 4] = 1.0
    y[0, 8] = 1.0
    # threads 0, 1, 2 hold 2^24, 1, 1: the warp's Hillis-Steele scan adds
    # the two ones first (1 + 1, then + 2^24), so thread 3's prefix is
    # 2^24 + 2 exactly, where element 8 (2^24 + 1, then + 1) and a
    # sequential f32 scan stay at 2^24
    got = reduction.cumsum_split_plain(y)
    assert float(got[0, 8]) == 2.0 ** 24
    assert float(got[0, 12]) == 2.0 ** 24 + 2


@pytest.mark.parametrize("shape,chunk", [((5, 37), None),
                                         ((3, 4, 300), None),
                                         ((2, 1030), None),
                                         ((2, 5000), 1024),
                                         ((1, 9000), 2048)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_and_emulation_match_pallas_and_its_vjp(shape, chunk, dtype):
    """`fused_cumsum` and its VJP (the reversed scan) through
    `_cumsum_kernel` in interpret mode against the port's plain version,
    the route emulation (forward and reverse) and the autograd
    Function."""
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a: fused_cumsum(a, interpret=True),
                        jnp.asarray(x, dtype))
    (want_dx,) = vjp(jnp.asarray(g, dtype))
    tdt = TDT[dtype]
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    # f32: another summation order, a few ulps of the running sum; bf16:
    # one rounding of the output apart where the orders straddle it
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == jnp.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    for got, ref in ((reduction.cumsum_plain(tx), want),
                     (reduction.cumsum_split_plain(tx, chunk), want),
                     (reduction.cumsum_plain(tg, True), want_dx),
                     (reduction.cumsum_split_plain(tg, chunk, True),
                      want_dx)):
        assert got.dtype == tdt and tuple(got.shape) == shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **tol)
    txg = tx.clone().requires_grad_()
    (dx,) = torch.autograd.grad(reduction.fused_cumsum(txg), txg, tg)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(want_dx, np.float32), **tol)


def test_cpu_cumsum_plans_nothing_and_counts_no_route():
    before = launch_counts()
    reduction.cumsum(torch.randn(3, 10000), reverse=True)
    assert launch_counts() == before
    assert "cumsum/row" in before and "cumsum/split" in before
