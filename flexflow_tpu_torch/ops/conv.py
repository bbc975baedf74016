"""Conv2D, Pool2D, Flat and BatchNorm (counterpart of
flexflow_tpu/ops/conv.py).

NCHW activations and OIHW kernels, as in the JAX package. The
convolution runs in the compute dtype (bf16 under mixed precision) as a
cuDNN convolution on the card, which the JAX package leaves to XLA; the
result is cast to the boundary dtype, then the bias is added in that
dtype. An f32 convolution runs in true f32: cuDNN may use TF32 for f32
convolutions (`torch.backends.cudnn.allow_tf32`, on by default), which
would put an f32 model ~1e-3 from its CPU run. And every convolution
takes one of cuDNN's deterministic algorithms (some weight-gradient
algorithms sum with atomics), so a training step repeats to the bit and
a CUDA graph of steps gives the eager steps' bits. The forward and both
backward products set the two flags through `torch.backends.cudnn.flags`
for their own call, which restores the caller's settings after it
(`_Conv2d`). The flags are process-global: for the duration of the call
another thread's convolution sees them too.

Pooling: max pooling pads with -inf; an average window divides its sum
by kh * kw, the padding included (`count_include_pad=True`), as JAX's
`reduce_window` sum over kh * kw does.

BatchNorm normalises over (0, 2, 3) with f32 statistics. Training uses
the batch's mean and biased variance and updates the running statistics,
op state (core/op.py), in place: (1 - m) * running + m * batch, m = 0.1,
the biased variance in both places (`F.batch_norm(training=True)` would
update with the unbiased one, so it is not used). Inference reads the
running statistics.

On a mesh with an `attr` axis (JAX `model.py:1094-1101`, where GSPMD
inserts the exchanges) a convolution or pool the plan cuts over it
(`Op.attr_local`, FFModel._assign_strategy) computes this rank's H/ap
output rows from the input rows its windows need: its own H/ap input
rows (runtime/executor.py) and a halo of the neighbours' edge rows
(runtime/collectives.py `halo`: `padding_h` rows before, kernel_h -
stride_h - padding_h after, from the kernel, stride and padding), with
the padding value (0, or -inf for a max pool) past the image's edges, so
H is never gathered whole; from a whole input it slices those rows
itself. The op then runs with no H padding. Batch norm's statistics are
the global batch's, as JAX computes under GSPMD: the sums are all-reduced
over `data` where the batch is cut and over `attr` where H is
(collectives `psum`, whose backward sums the gradients too), two passes
as on one device.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.op import Op, WeightSpec, register_op
from ..ffconst import ActiMode, CompMode, OpType, PoolType
from ..runtime.collectives import halo, psum
from ..runtime.initializers import (ConstantInitializer, DefaultInitializer,
                                    ZeroInitializer)
from .common import apply_activation, emit_dtype, matmul_dtype


def _out_size(size, pad, kernel, stride):
    return (size + 2 * pad - kernel) // stride + 1


def _cudnn_flags(dtype: torch.dtype):
    """cuDNN's deterministic algorithms, and true f32 for an f32
    convolution, for the duration of the call (torch restores the
    caller's flags after it); enabled and benchmark stay as the caller
    set them."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       benchmark_limit=None, deterministic=True,
                       allow_tf32=cudnn.allow_tf32
                       and dtype != torch.float32)


def attr_halo(op: Op, ap: int):
    """(before, after) input rows around a rank's H / ap rows that its
    H_out / ap output rows need (`after` < 0: fewer than its own), or None
    where the op's rows do not cut evenly over `ap` ranks: H_out and H
    must divide, H must be stride_h x H_out (every rank's window then
    starts padding_h rows before its own first row), and each halo must
    fit in a neighbour's rows."""
    h_in, h_out = op.inputs[0].dims[2], op.outputs[0].dims[2]
    p = op.params
    k, st, pad = p["kernel_h"], p["stride_h"], p["padding_h"]
    if h_out % ap or h_in % ap or h_in != st * h_out:
        return None
    before, after = pad, k - st - pad
    if max(before, after) > h_in // ap:
        return None
    return before, after


def _attr_rows(op: Op, ctx, x: torch.Tensor, fill: float) -> torch.Tensor:
    """The input rows this rank's output rows read (see the module
    docstring), the H padding in place."""
    mesh = ctx.mesh
    before, after = attr_halo(op, mesh.size("attr"))
    if "attr" in ctx.in_cuts[0]:
        slab = halo(x, mesh, "attr", 2, before, max(after, 0), fill)
        return slab if after >= 0 else slab.narrow(2, 0,
                                                   slab.shape[2] + after)
    h = x.shape[2] // mesh.size("attr")
    lo = mesh.index("attr") * h - before
    hi = lo + before + h + after
    slab = x[:, :, max(lo, 0):min(hi, x.shape[2])]
    return F.pad(slab, (0, 0, max(-lo, 0), max(hi - x.shape[2], 0)),
                 value=fill)


class _Conv2d(torch.autograd.Function):
    """F.conv2d without bias, whose forward and backward each run under
    `_cudnn_flags` (the backward reads the flags when it runs, after the
    forward's call has returned)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        with _cudnn_flags(x.dtype):
            return F.conv2d(x, w, None, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        with _cudnn_flags(x.dtype):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, list(stride), list(padding), [1, 1], False,
                [0, 0], groups, [ctx.needs_input_grad[0],
                                 ctx.needs_input_grad[1], False])
        return dx, dw, None, None, None


@register_op
class Conv2DOp(Op):
    op_type = OpType.CONV2D

    def output_shapes(self):
        (x,) = self.inputs
        n, c, h, w = x.dims
        p = self.params
        oh = _out_size(h, p["padding_h"], p["kernel_h"], p["stride_h"])
        ow = _out_size(w, p["padding_w"], p["kernel_w"], p["stride_w"])
        return [(n, p["out_channels"], oh, ow)], [x.dtype]

    def weight_specs(self) -> List[WeightSpec]:
        (x,) = self.inputs
        p = self.params
        in_c = x.dims[1] // p.get("groups", 1)
        rf = p["kernel_h"] * p["kernel_w"]
        specs = [WeightSpec(
            "kernel", (p["out_channels"], in_c, p["kernel_h"], p["kernel_w"]),
            x.dtype, p.get("kernel_initializer") or DefaultInitializer(
                fan_in=in_c * rf, fan_out=p["out_channels"] * rf))]
        if p.get("use_bias", True):
            specs.append(WeightSpec(
                "bias", (p["out_channels"],), x.dtype,
                p.get("bias_initializer") or ZeroInitializer()))
        return specs

    def lower(self, ctx, inputs):
        x = inputs[0]
        p = self.params
        cdt = matmul_dtype(ctx.config, x.dtype)
        pad_h = p["padding_h"]
        if self.attr_local:
            x, pad_h = _attr_rows(self, ctx, x, 0.0), 0
        y = _Conv2d.apply(x.to(cdt), self.w("kernel", cdt),
                          (p["stride_h"], p["stride_w"]),
                          (pad_h, p["padding_w"]), p.get("groups", 1))
        y = y.to(emit_dtype(ctx.config, self.outputs[0].dtype))
        if self.has_weight("bias"):
            y = y + self.w("bias", y.dtype)[None, :, None, None]
        return [apply_activation(y, p.get("activation",
                                          ActiMode.AC_MODE_NONE))]

    def flops(self) -> float:
        n, oc, oh, ow = self.outputs[0].dims
        p = self.params
        in_c = self.inputs[0].dims[1] // p.get("groups", 1)
        return 2.0 * n * oc * oh * ow * in_c * p["kernel_h"] * p["kernel_w"]


@register_op
class Pool2DOp(Op):
    op_type = OpType.POOL2D

    def output_shapes(self):
        (x,) = self.inputs
        n, c, h, w = x.dims
        p = self.params
        oh = _out_size(h, p["padding_h"], p["kernel_h"], p["stride_h"])
        ow = _out_size(w, p["padding_w"], p["kernel_w"], p["stride_w"])
        return [(n, c, oh, ow)], [x.dtype]

    def lower(self, ctx, inputs):
        x = inputs[0]
        p = self.params
        window = (p["kernel_h"], p["kernel_w"])
        stride = (p["stride_h"], p["stride_w"])
        pad = (p["padding_h"], p["padding_w"])
        is_max = p.get("pool_type", PoolType.POOL_MAX) == PoolType.POOL_MAX
        if self.attr_local:
            x = _attr_rows(self, ctx, x, -math.inf if is_max else 0.0)
            pad = (0, p["padding_w"])
        if is_max:
            y = F.max_pool2d(x, window, stride, pad)
        else:
            y = F.avg_pool2d(x, window, stride, pad, count_include_pad=True)
        return [apply_activation(y, p.get("activation",
                                          ActiMode.AC_MODE_NONE))]


@register_op
class FlatOp(Op):
    """(N, C, H, W) -> (N, C * H * W), N the walk's own batch: `predict`'s
    tail batch is smaller than the declared one (the JAX op reshapes to
    the declared dims, so its predict stops at such a tail)."""

    op_type = OpType.FLAT

    def output_shapes(self):
        (x,) = self.inputs
        return [(x.dims[0], int(np.prod(x.dims[1:])))], [x.dtype]

    def lower(self, ctx, inputs):
        return [inputs[0].reshape(inputs[0].shape[0], -1)]


@register_op
class BatchNormOp(Op):
    """BatchNorm over the channels of NCHW (see the module docstring)."""

    op_type = OpType.BATCHNORM

    def output_shapes(self):
        (x,) = self.inputs
        return [x.dims], [x.dtype]

    def weight_specs(self):
        c, dt = self.inputs[0].dims[1], self.inputs[0].dtype
        return [WeightSpec("gamma", (c,), dt, ConstantInitializer(1.0)),
                WeightSpec("beta", (c,), dt, ZeroInitializer())]

    def state_specs(self):
        c, dt = self.inputs[0].dims[1], self.inputs[0].dtype
        return [WeightSpec("running_mean", (c,), dt, ZeroInitializer()),
                WeightSpec("running_var", (c,), dt, ConstantInitializer(1.0))]

    def lower(self, ctx, inputs):
        x = inputs[0]
        eps = self.params.get("eps", 1e-5)
        m = self.params.get("momentum", 0.1)
        xf = x.float()
        rm, rv = self.running_mean, self.running_var
        if ctx.mode == CompMode.COMP_MODE_TRAINING:
            groups = [ctx.mesh.group(a) for a in ("data", "attr")
                      if ctx.in_cuts and a in ctx.in_cuts[0]]
            if groups:  # the global batch's (the module docstring)
                n = xf.numel() // xf.shape[1]
                for a in ("data", "attr"):
                    if a in ctx.in_cuts[0]:
                        n *= ctx.mesh.size(a)
                mean = xf.sum(dim=(0, 2, 3))
                for g in groups:
                    mean = psum(mean, g)
                mean = mean / n
                var = torch.square(xf - mean[None, :, None, None]).sum(
                    dim=(0, 2, 3))
                for g in groups:
                    var = psum(var, g)
                var = var / n
            else:
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.square(xf - mean[None, :, None, None]).mean(
                    dim=(0, 2, 3))
            if self.writes_state(ctx):
                with torch.no_grad():
                    rm.copy_(((1 - m) * rm + m * mean).to(rm.dtype))
                    rv.copy_(((1 - m) * rv + m * var).to(rv.dtype))
        else:
            mean, var = rm.float(), rv.float()
        inv = torch.rsqrt(var + eps)
        y = (xf - mean[None, :, None, None]) * inv[None, :, None, None]
        y = (y * self.w("gamma").float()[None, :, None, None]
             + self.w("beta").float()[None, :, None, None])
        if self.params.get("relu", False):
            y = torch.relu(y)
        return [y.to(x.dtype)]
