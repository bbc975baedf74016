"""LayerNorm forward and softmax forward: CUDA kernels and plain versions.

`layernorm_fwd` replaces flexflow_tpu/kernels/pallas/norm.py `_ln_fwd`
(`fused_layernorm`), `softmax_fwd` replaces `_softmax_call` with
`_softmax_fwd_kernel` (`fused_softmax`). Both normalize the trailing axis
with leading dims flattened into rows, compute in f32 and store in x's
dtype. The kernels are csrc/norm.cu. On the card both are bound by bytes
(one read and one write per element, a few operations each); their
design is one block per row, reduced with warp shuffles in f32,
LayerNorm holding its row in shared memory, softmax looping over the
30522-wide vocabulary row and leaving the re-reads to L2.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _build

# kernel launches per wrapper, a plain count the serving path is read by
LAUNCHES: Dict[str, int] = {"layernorm_fwd": 0, "softmax_fwd": 0}


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
