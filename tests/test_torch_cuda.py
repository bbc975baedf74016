"""flexflow_tpu_torch on the card: each CUDA kernel against its plain
version, and the continuous batcher on the card against the port on the
CPU. Every test is marked `cuda` and skips without a GPU. This file
imports no jax, so it also runs where only the port's dependencies are
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import decode, launch_counts, norm, \
    reset_launch_counts

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


@pytest.mark.parametrize("c", [1, 3, 17])
@pytest.mark.parametrize("block_k", [8, 64])
@pytest.mark.parametrize("qdt,kvdt", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("d", [12, 16, 64])  # 12 x bf16: no 16-byte rows
def test_decode_kernel_matches_plain(dev, c, block_k, qdt, kvdt, d):
    g = torch.Generator(device=dev).manual_seed(c * 100 + block_k + d)
    b, m, h = 4, 40, 3
    q = torch.randn((b, c, h, d), generator=g, device=dev).to(qdt)
    kc = torch.randn((b, m, h, d), generator=g, device=dev).to(kvdt)
    vc = torch.randn((b, m, h, d), generator=g, device=dev).to(kvdt)
    # ragged: the first row only, mid-cache, the window ending at the edge
    pos = torch.tensor([0, 5, 21, m - c], dtype=torch.int32, device=dev)
    fn = decode.decode_attention if c == 1 \
        else decode.multiquery_decode_attention
    out = fn(q, kc, vc, pos, scale=d ** -0.5, block_k=block_k)
    ref = decode.decode_attention_plain(q, kc, vc, pos, d ** -0.5)
    assert out.dtype == qdt and out.shape == q.shape
    _close(out, ref, BF16_TOL if torch.bfloat16 in (qdt, kvdt) else F32_TOL)


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
    assert all(v > 0 for v in launch_counts().values()), launch_counts()
    assert on_card == run(cpu)
