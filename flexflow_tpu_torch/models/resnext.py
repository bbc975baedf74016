"""Counterpart of flexflow_tpu/models/resnext.py, the same graph, op names
and defaults. ResNeXt-50 32x4d (reference: examples/cpp/resnext50/resnext.cc:17-86) —
exercises grouped convolution."""
from __future__ import annotations

from ..ffconst import ActiMode, PoolType


def _resnext_block(ff, input, out_channels: int, stride: int, groups: int, name: str):
    relu = ActiMode.AC_MODE_RELU
    t = ff.conv2d(input, out_channels, 1, 1, 1, 1, 0, 0, relu, name=f"{name}_a")
    t = ff.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1, relu,
                  groups=groups, name=f"{name}_b")
    t = ff.conv2d(t, 2 * out_channels, 1, 1, 1, 1, 0, 0, name=f"{name}_c")
    if stride > 1 or input.dims[1] != 2 * out_channels:
        input = ff.conv2d(input, 2 * out_channels, 1, 1, stride, stride, 0, 0,
                          relu, name=f"{name}_proj")
    return ff.relu(ff.add(input, t))


def build_resnext50(model, input, num_classes: int = 1000, groups: int = 32):
    """conv7x7 → pool → stages (3,4,6,3) of grouped bottlenecks → avgpool → fc
    (resnext.cc:58-86)."""
    ff = model
    t = ff.conv2d(input, 64, 7, 7, 2, 2, 3, 3, ActiMode.AC_MODE_RELU, name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, PoolType.POOL_MAX)
    channels = 128
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            t = _resnext_block(ff, t, channels, stride, groups, f"s{stage}b{block}")
        channels *= 2
    h, w = t.dims[2], t.dims[3]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return ff.softmax(t)
