"""Counterpart of flexflow_tpu/models/resnet.py, the same graph, op names
and defaults. ResNet bottleneck nets (reference: examples/cpp/ResNet/resnet.cc:40-112)."""
from __future__ import annotations

from typing import Sequence

from ..ffconst import ActiMode, PoolType


def _bottleneck(ff, input, out_channels: int, stride: int, name: str):
    """1x1 → 3x3(stride) → 1x1(4x) with projection shortcut when shape
    changes (resnet.cc:40-58)."""
    none = ActiMode.AC_MODE_NONE
    t = ff.conv2d(input, out_channels, 1, 1, 1, 1, 0, 0, none, name=f"{name}_a")
    t = ff.relu(t)
    t = ff.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1, none, name=f"{name}_b")
    t = ff.relu(t)
    t = ff.conv2d(t, 4 * out_channels, 1, 1, 1, 1, 0, 0, name=f"{name}_c")
    if stride > 1 or input.dims[1] != 4 * out_channels:
        input = ff.conv2d(
            input, 4 * out_channels, 1, 1, stride, stride, 0, 0,
            ActiMode.AC_MODE_RELU, name=f"{name}_proj",
        )
    return ff.relu(ff.add(input, t))


def build_resnet(model, input, num_classes: int = 10,
                 stages: Sequence[int] = (3, 4, 6, 3)):
    """ResNet with configurable stage depths on NCHW input
    (resnet.cc:91-112: conv7x7s2 → pool → 4 bottleneck stages → avgpool)."""
    ff = model
    t = ff.conv2d(input, 64, 7, 7, 2, 2, 3, 3, name="conv1")
    t = ff.relu(t)
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, PoolType.POOL_MAX)
    channels = 64
    for stage, blocks in enumerate(stages):
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            t = _bottleneck(ff, t, channels, stride, f"s{stage}b{block}")
        channels *= 2
    h, w = t.dims[2], t.dims[3]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes, name="fc")
    return ff.softmax(t)


def build_resnet50(model, input, num_classes: int = 10):
    return build_resnet(model, input, num_classes, stages=(3, 4, 6, 3))
