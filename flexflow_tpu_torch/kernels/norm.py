"""LayerNorm, RMSNorm and softmax, forward and backward: CUDA kernels,
plain versions and the autograd Functions.

`layernorm_fwd` / `layernorm_bwd` replace flexflow_tpu/kernels/pallas/
norm.py `_ln_fwd` / `_ln_bwd` (`fused_layernorm`); `rmsnorm_fwd` /
`rmsnorm_bwd` replace `_rms_fwd` / `_rms_bwd` (`fused_rmsnorm`);
`softmax_fwd` / `softmax_bwd` replace `_softmax_call` with
`_softmax_fwd_kernel` / `_softmax_bwd_kernel` (`fused_softmax`);
`layernorm`, `rmsnorm` and `softmax` are the differentiable ops, saving
what the JAX custom VJPs save. All normalize
the trailing axis with leading dims flattened into rows, compute in f32
and store in x's dtype. The kernels are csrc/norm.cu. On the card all
are bound by bytes (one read and one write per element, a few operations
each); the forward kernels give each row a block, reduced with warp
shuffles in f32, LayerNorm holding its row in shared memory, softmax
looping over the 30522-wide vocabulary row and leaving the re-reads to
L2. LayerNorm backward gives each block a few rows and sums dgamma and
dbeta per block, then over blocks in a second launch in a fixed order;
softmax backward gives each row a warp. RMSNorm follows LayerNorm's two
designs without the mean.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build

# kernel launches per wrapper (layernorm_bwd's two launches count once), a
# plain count the serving and training paths are read by
LAUNCHES: Dict[str, int] = {"layernorm_fwd": 0, "layernorm_bwd": 0,
                            "rmsnorm_fwd": 0, "rmsnorm_bwd": 0,
                            "softmax_fwd": 0, "softmax_bwd": 0}
# f32 floats of shared memory a layernorm_bwd block stages per column
# (xhat, g, and the dgamma / dbeta partial sums): N <= 227 KB / 16 B;
# rmsnorm_bwd stages one sum fewer, the same bound keeps one rule
MAX_BWD_COLS = 232448 // 16


def layernorm_fwd_plain(x, gamma, beta, eps: float):
    """(y, mean, rstd): f32 statistics over the trailing axis, y in
    x.dtype, mean and rstd (R, 1) f32 — `_ln_fwd_kernel`'s outputs."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    mean = xf.mean(dim=1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(x.shape), mean, rstd


def softmax_fwd_plain(x):
    """softmax over the trailing axis in f32, result in x.dtype."""
    return torch.softmax(x.float(), dim=-1).to(x.dtype)


def layernorm_bwd_plain(x, gamma, mean, rstd, dy):
    """(dx, dgamma, dbeta), `_ln_bwd_kernel`'s math: with xhat =
    (x - mean) * rstd and g = dy * gamma, dx = (g - mean(g) -
    xhat * mean(g * xhat)) * rstd in x.dtype; dgamma = sum(dy * xhat) and
    dbeta = sum(dy) over rows in f32, cast to gamma's dtype (None without
    affine)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    d = dy.reshape(-1, n).float()
    xhat = (xf - mean) * rstd
    g = d * gamma.float() if gamma is not None else d
    m1 = g.mean(dim=1, keepdim=True)
    m2 = (g * xhat).mean(dim=1, keepdim=True)
    dx = ((g - m1 - xhat * m2) * rstd).to(x.dtype).reshape(x.shape)
    if gamma is None:
        return dx, None, None
    return (dx, (d * xhat).sum(dim=0).to(gamma.dtype),
            d.sum(dim=0).to(gamma.dtype))


def rmsnorm_fwd_plain(x, gamma, eps: float):
    """(y, rstd): rstd = 1 / sqrt(mean(x^2) + eps) over the trailing axis
    in f32, (R, 1); y = x * rstd [* gamma] in x.dtype — `_rms_fwd_kernel`'s
    outputs."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    rstd = torch.rsqrt(torch.square(xf).mean(dim=1, keepdim=True) + eps)
    y = xf * rstd
    if gamma is not None:
        y = y * gamma.float()
    return y.to(x.dtype).reshape(x.shape), rstd


def rmsnorm_bwd_plain(x, gamma, rstd, dy):
    """(dx, dgamma), `_rms_bwd_kernel`'s math: with xhat = x * rstd and
    g = dy * gamma, dx = (g - xhat * mean(g * xhat)) * rstd in x.dtype;
    dgamma = sum(dy * xhat) over rows in f32, cast to gamma's dtype (None
    without affine)."""
    n = x.shape[-1]
    xf = x.reshape(-1, n).float()
    d = dy.reshape(-1, n).float()
    xhat = xf * rstd
    g = d * gamma.float() if gamma is not None else d
    m2 = (g * xhat).mean(dim=1, keepdim=True)
    dx = ((g - xhat * m2) * rstd).to(x.dtype).reshape(x.shape)
    if gamma is None:
        return dx, None
    return dx, (d * xhat).sum(dim=0).to(gamma.dtype)


def softmax_bwd_plain(y, dy):
    """dx = y * (dy - sum(y * dy)) over the trailing axis in f32, result
    in y.dtype."""
    yf, d = y.float(), dy.float()
    return (yf * (d - (yf * d).sum(dim=-1, keepdim=True))).to(y.dtype)


def _check_x(name, x):
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"{name}: need a non-empty (..., N) input, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")


def _on_card(name, *tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands on several devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    return True


def layernorm_fwd(x, gamma=None, beta=None, *, eps: float = 1e-5):
    """LayerNorm over the trailing axis: (y, mean, rstd). gamma/beta (N,)
    f32, or both None for no affine."""
    _check_x("layernorm_fwd", x)
    n = x.shape[-1]
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta must be given together")
    affine = [] if gamma is None else [gamma, beta]
    for t in affine:
        if tuple(t.shape) != (n,):
            raise ValueError(f"layernorm_fwd: gamma/beta must be ({n},), "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"layernorm_fwd: gamma/beta must be float32, "
                            f"got {t.dtype}")
    if not _on_card("layernorm_fwd", x, *affine):
        return layernorm_fwd_plain(x, gamma, beta, eps)
    r = x.numel() // n
    y = torch.empty_like(x)
    mean = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ff_layernorm_fwd(
            x.data_ptr(), gamma.data_ptr() if affine else None,
            beta.data_ptr() if affine else None, y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), r, n, float(eps), _build.DTYPE_CODES[x.dtype],
            _build.stream_ptr(x.device))
    _build.check(err, "layernorm_fwd")
    LAUNCHES["layernorm_fwd"] += 1
    return y, mean, rstd


def _check_gamma(name, gamma, n):
    if gamma is not None and (tuple(gamma.shape) != (n,)
                              or gamma.dtype != torch.float32):
        raise ValueError(f"{name}: gamma must be ({n},) float32, got "
                         f"{tuple(gamma.shape)} {gamma.dtype}")


def rmsnorm_fwd(x, gamma=None, *, eps: float = 1e-6):
    """RMSNorm over the trailing axis: (y, rstd). gamma (N,) f32, or None
    for no affine."""
    _check_x("rmsnorm_fwd", x)
    n = x.shape[-1]
    _check_gamma("rmsnorm_fwd", gamma, n)
    affine = [] if gamma is None else [gamma]
    if not _on_card("rmsnorm_fwd", x, *affine):
        return rmsnorm_fwd_plain(x, gamma, eps)
    r = x.numel() // n
    y = torch.empty_like(x)
    rstd = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ff_rmsnorm_fwd(
            x.data_ptr(), gamma.data_ptr() if affine else None, y.data_ptr(),
            rstd.data_ptr(), r, n, float(eps), _build.DTYPE_CODES[x.dtype],
            _build.stream_ptr(x.device))
    _build.check(err, "rmsnorm_fwd")
    LAUNCHES["rmsnorm_fwd"] += 1
    return y, rstd


def rmsnorm_bwd(x, gamma, rstd, dy):
    """(dx, dgamma) of `rmsnorm_fwd(x, gamma)` for the cotangent dy; rstd
    is the forward's (R, 1) f32 statistic. gamma None: no affine, dgamma
    None."""
    _check_x("rmsnorm_bwd", x)
    n = x.shape[-1]
    r = x.numel() // n
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match x {tuple(x.shape)} {x.dtype}")
    if tuple(rstd.shape) != (r, 1) or rstd.dtype != torch.float32:
        raise ValueError(f"rmsnorm_bwd: rstd must be ({r}, 1) float32, got "
                         f"{tuple(rstd.shape)} {rstd.dtype}")
    _check_gamma("rmsnorm_bwd", gamma, n)
    affine = [] if gamma is None else [gamma]
    if not _on_card("rmsnorm_bwd", x, rstd, dy, *affine):
        return rmsnorm_bwd_plain(x, gamma, rstd, dy)
    if n > MAX_BWD_COLS:
        raise ValueError(f"rmsnorm_bwd: N={n} > {MAX_BWD_COLS}, the most "
                         "a block stages in shared memory")
    dx = torch.empty_like(x)
    lib = _build.library()
    dg = part = None
    if affine:
        blocks = -(-r // lib.ff_layernorm_bwd_rows_per_block())
        part = torch.empty((blocks, n), dtype=torch.float32, device=x.device)
        dg = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ff_rmsnorm_bwd(
            x.data_ptr(), gamma.data_ptr() if affine else None,
            rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            part.data_ptr() if affine else None,
            dg.data_ptr() if affine else None, r, n,
            _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "rmsnorm_bwd")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dg


def softmax_fwd(x):
    """softmax over the trailing axis (f32 max/exp/sum, result in x's
    dtype)."""
    _check_x("softmax_fwd", x)
    if not _on_card("softmax_fwd", x):
        return softmax_fwd_plain(x)
    n = x.shape[-1]
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.ff_softmax_fwd(x.data_ptr(), y.data_ptr(), x.numel() // n, n,
                                 _build.DTYPE_CODES[x.dtype],
                                 _build.stream_ptr(x.device))
    _build.check(err, "softmax_fwd")
    LAUNCHES["softmax_fwd"] += 1
    return y


def layernorm_bwd(x, gamma, mean, rstd, dy):
    """(dx, dgamma, dbeta) of `layernorm_fwd(x, gamma, beta)` for the
    cotangent dy; mean and rstd are the forward's (R, 1) f32 statistics.
    gamma None: no affine, dgamma and dbeta None."""
    _check_x("layernorm_bwd", x)
    n = x.shape[-1]
    r = x.numel() // n
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"layernorm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match x {tuple(x.shape)} {x.dtype}")
    for tname, t in (("mean", mean), ("rstd", rstd)):
        if tuple(t.shape) != (r, 1) or t.dtype != torch.float32:
            raise ValueError(f"layernorm_bwd: {tname} must be ({r}, 1) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    _check_gamma("layernorm_bwd", gamma, n)
    affine = [] if gamma is None else [gamma]
    if not _on_card("layernorm_bwd", x, mean, rstd, dy, *affine):
        return layernorm_bwd_plain(x, gamma, mean, rstd, dy)
    if n > MAX_BWD_COLS:
        raise ValueError(f"layernorm_bwd: N={n} > {MAX_BWD_COLS}, the most "
                         "a block stages in shared memory")
    dx = torch.empty_like(x)
    lib = _build.library()
    dg = db = part = None
    if affine:
        blocks = -(-r // lib.ff_layernorm_bwd_rows_per_block())
        part = torch.empty((2, blocks, n), dtype=torch.float32,
                           device=x.device)
        dg = torch.empty((n,), dtype=torch.float32, device=x.device)
        db = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ff_layernorm_bwd(
            x.data_ptr(), gamma.data_ptr() if affine else None,
            mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            part[0].data_ptr() if affine else None,
            part[1].data_ptr() if affine else None,
            dg.data_ptr() if affine else None,
            db.data_ptr() if affine else None, r, n,
            _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, "layernorm_bwd")
    LAUNCHES["layernorm_bwd"] += 1
    return dx, dg, db


def softmax_bwd(y, dy):
    """dx of `y = softmax_fwd(x)` for the cotangent dy."""
    _check_x("softmax_bwd", y)
    if dy.shape != y.shape or dy.dtype != y.dtype:
        raise ValueError(f"softmax_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match y {tuple(y.shape)} {y.dtype}")
    if not _on_card("softmax_bwd", y, dy):
        return softmax_bwd_plain(y, dy)
    n = y.shape[-1]
    dx = torch.empty_like(y)
    lib = _build.library()
    with torch.cuda.device(y.device):
        err = lib.ff_softmax_bwd(y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                 y.numel() // n, n,
                                 _build.DTYPE_CODES[y.dtype],
                                 _build.stream_ptr(y.device))
    _build.check(err, "softmax_bwd")
    LAUNCHES["softmax_bwd"] += 1
    return dx


class _LayerNorm(torch.autograd.Function):
    """Saves (x, gamma, mean, rstd), as `_fused_ln_affine_fwd`; gamma is
    None without affine, as `_fused_ln_plain_fwd` saves (x, mean, rstd)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layernorm_fwd(x, gamma, beta, eps=eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layernorm_bwd(x, gamma, mean, rstd, g.contiguous())
        return dx, dg, db, None


class _RMSNorm(torch.autograd.Function):
    """Saves (x, gamma, rstd), as `_fused_rms_affine_fwd`; gamma is None
    without affine, as `_fused_rms_plain_fwd` saves (x, rstd)."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        y, rstd = rmsnorm_fwd(x, gamma, eps=eps)
        ctx.save_for_backward(x, gamma, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, rstd = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(x, gamma, rstd, g.contiguous())
        return dx, dg, None


class _Softmax(torch.autograd.Function):
    """Saves y, as `_fused_softmax_fwd`."""

    @staticmethod
    def forward(ctx, x):
        y = softmax_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return softmax_bwd(y, g.contiguous())


def layernorm(x, gamma=None, beta=None, *, eps: float = 1e-5):
    """Differentiable LayerNorm over the trailing axis through
    layernorm_fwd / layernorm_bwd."""
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta must be given together")
    return _LayerNorm.apply(x, gamma, beta, float(eps))


def rmsnorm(x, gamma=None, eps: float = 1e-6):
    """Differentiable RMSNorm over the trailing axis through rmsnorm_fwd /
    rmsnorm_bwd."""
    return _RMSNorm.apply(x, gamma, float(eps))


def softmax(x):
    """Differentiable softmax over the trailing axis through softmax_fwd /
    softmax_bwd."""
    return _Softmax.apply(x)
