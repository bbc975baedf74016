"""The optimizer update over a list of weight tensors: Adam and SGD, the
CUDA kernel (csrc/optimizer.cu) and its plain version.

The kernel is the card's counterpart of the JAX package's update
(flexflow_tpu/runtime/optimizers.py `AdamOptimizer.update`,
`SGDOptimizer.update`), which XLA fuses into a few HBM passes over the
weight tree; it has no Pallas kernel. One launch covers up to
`max_tensors()` tensors, their pointers passed by value, so the launch
can be captured in a CUDA graph. `step` (int32) and `lr` (f32) are
device scalars the kernel reads: a captured update follows the step
count and a new lr. Neither wrapper advances `step`: the caller does,
after the update (runtime/optimizers.py).

Math is f32 in the order of the plain version below, every operation
rounded on its own, m and v stored round-to-nearest in their dtype:
Adam's alpha_t = lr * sqrt(1 - b2^t) / (1 - b1^t) at t = step + 1, eps
added to sqrt(v) itself, weight decay added to g. The plain version is
the per-tensor loop of torch ops the port ran before the kernel; on the
card it gives the kernel's bits.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from . import _build

# kernel launches of each wrapper (a list longer than max_tensors() takes
# one launch a slice)
LAUNCHES: Dict[str, int] = {"optimizer_adam": 0, "optimizer_sgd": 0}

_MAX_TENSORS: List[int] = []


def max_tensors() -> int:
    """Tensors one launch takes (256: CUDA 12.1's 32 KB kernel
    parameters)."""
    if not _MAX_TENSORS:
        _MAX_TENSORS.append(int(_build.library().ff_optimizer_max_tensors()))
    return _MAX_TENSORS[0]


def adam_alpha_t(step: torch.Tensor, lr: torch.Tensor, beta1: float,
                 beta2: float) -> torch.Tensor:
    """alpha_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t), t = step + 1, an
    f32 device scalar, as the JAX package computes it."""
    t = (step + 1).float()
    # the betas as device scalars: a Python number as pow's base would be
    # copied from host memory, which waits for the stream
    b1, b2 = (torch.full((), b, dtype=torch.float32, device=t.device)
              for b in (beta1, beta2))
    return lr * torch.sqrt(1 - torch.pow(b2, t)) / (1 - torch.pow(b1, t))


def adam_plain(ws, gs, ms, vs, step, lr, beta1, beta2, eps,
               weight_decay) -> None:
    """The per-tensor loop: w, m, v updated in place."""
    a_t = adam_alpha_t(step, lr, beta1, beta2)
    for w, g, m, v in zip(ws, gs, ms, vs):
        g32 = g.float()
        if weight_decay:
            g32 = g32 + weight_decay * w.float()
        m32 = beta1 * m.float() + (1 - beta1) * g32
        v32 = beta2 * v.float() + (1 - beta2) * g32 * g32
        w.copy_(w.float() - a_t * m32 / (torch.sqrt(v32) + eps))
        m.copy_(m32)
        v.copy_(v32)


def sgd_plain(ws, gs, bufs, lr, momentum, nesterov, weight_decay) -> None:
    """The per-tensor loop: w and the momentum buffers updated in place."""
    for i, (w, g) in enumerate(zip(ws, gs)):
        gt = g + weight_decay * w if weight_decay else g
        if momentum == 0.0:
            w.sub_(lr * gt)
            continue
        v = bufs[i]
        v.mul_(momentum).add_(gt)
        w.sub_(lr * (gt + momentum * v if nesterov else v))


def _device(ws: Sequence[torch.Tensor], what: str) -> str:
    kinds = {w.device.type for w in ws}
    if len(kinds) != 1:
        raise ValueError(f"{what}: tensors on several devices {kinds}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {kind}")
    return kind


def _check(what, ws, gs, extra, moment_dtypes) -> None:
    for i, (w, g) in enumerate(zip(ws, gs)):
        if w.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError(f"{what}: tensor {i}: w and g must be float32, "
                            f"got {w.dtype}, {g.dtype}")
        if g.shape != w.shape:
            raise ValueError(f"{what}: tensor {i}: g {tuple(g.shape)} vs w "
                             f"{tuple(w.shape)}")
        for t in (w, *(e[i] for e in extra)):
            if not t.is_contiguous():
                raise ValueError(f"{what}: tensor {i}: the updated tensors "
                                 "must be contiguous")
        for e in extra:
            if e[i].shape != w.shape or e[i].dtype not in moment_dtypes:
                raise TypeError(f"{what}: tensor {i}: state {e[i].dtype} "
                                f"{tuple(e[i].shape)} for w "
                                f"{tuple(w.shape)}")


def _launch(name: str, fn, ws, lists, written, *args) -> None:
    """`fn` (a C entry) over the non-empty tensors, one launch a slice of
    max_tensors(): the pointer arrays of `lists` (None for an absent
    list), the sizes and the count, `args`, the stream. The kernel writes
    `written` through raw pointers, so their version counters are bumped
    as an in-place op would bump them: a cache keyed on a weight's
    version (core/op.py `Op.w`) sees the update."""
    keep = [i for i, w in enumerate(ws) if w.numel()]
    per = max_tensors()
    for lo in range(0, len(keep), per):
        idx = keep[lo:lo + per]
        ptrs = [None if ts is None else (ctypes.c_void_p * len(idx))(
            *[ts[i].data_ptr() for i in idx]) for ts in lists]
        sizes = (ctypes.c_longlong * len(idx))(*[ws[i].numel() for i in idx])
        with torch.cuda.device(ws[0].device):
            err = fn(*ptrs, sizes, len(idx), *args,
                     _build.stream_ptr(ws[0].device))
        _build.check(err, name)
        LAUNCHES[f"optimizer_{name}"] += 1
    torch.autograd.graph.increment_version(
        [t for ts in written for t in ts])


def adam(ws, gs, ms, vs, step: torch.Tensor, lr: torch.Tensor, *,
         beta1: float, beta2: float, eps: float,
         weight_decay: float = 0.0) -> None:
    """One Adam update of every (w, g, m, v), in place. w and g float32;
    m and v float32 or bfloat16 (one dtype); step an int32 and lr an f32
    device scalar, read, not advanced."""
    ws, gs, ms, vs = list(ws), list(gs), list(ms), list(vs)
    if not ws:
        return
    if _device(ws, "adam") == "cpu":
        adam_plain(ws, gs, ms, vs, step, lr, beta1, beta2, eps,
                   weight_decay)
        return
    mdt = ms[0].dtype
    _check("adam", ws, gs, (ms, vs), (mdt,))
    if mdt not in _build.DTYPE_CODES:
        raise TypeError(f"adam: moments must be float32 or bfloat16, got "
                        f"{mdt}")
    if step.dtype != torch.int32 or lr.dtype != torch.float32 or \
            step.device != ws[0].device or lr.device != ws[0].device:
        raise TypeError("adam: step and lr must be int32 and float32 "
                        "scalars on the weights' device")
    gs = [g.contiguous() for g in gs]
    _launch("adam", _build.library().ff_adam, ws, (ws, gs, ms, vs),
            (ws, ms, vs), step.data_ptr(), lr.data_ptr(), beta1, beta2, 1 - beta1,
            1 - beta2, eps, weight_decay, _build.DTYPE_CODES[mdt])


def sgd(ws, gs, bufs: Optional[Sequence[torch.Tensor]], lr: torch.Tensor,
        *, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> None:
    """One SGD update of every w (and its momentum buffer, when momentum
    != 0), in place; all float32; lr an f32 device scalar."""
    ws, gs = list(ws), list(gs)
    bufs = list(bufs) if momentum != 0.0 else []
    if not ws:
        return
    if _device(ws, "sgd") == "cpu":
        sgd_plain(ws, gs, bufs, lr, momentum, nesterov, weight_decay)
        return
    _check("sgd", ws, gs, (bufs,) if bufs else (), (torch.float32,))
    if lr.dtype != torch.float32 or lr.device != ws[0].device:
        raise TypeError("sgd: lr must be a float32 scalar on the weights' "
                        "device")
    gs = [g.contiguous() for g in gs]
    _launch("sgd", _build.library().ff_sgd, ws, (ws, gs, bufs or None),
            (ws, bufs), lr.data_ptr(), momentum, int(bool(nesterov)), weight_decay)
