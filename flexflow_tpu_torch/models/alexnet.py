"""Counterpart of flexflow_tpu/models/alexnet.py, the same graph, op names
and defaults. AlexNet (reference: examples/cpp/AlexNet/alexnet.cc:68-90,
bootcamp_demo/ff_alexnet_cifar10.py)."""
from __future__ import annotations

from ..ffconst import ActiMode, PoolType


def build_alexnet(model, input, num_classes: int = 10):
    """AlexNet trunk on an NCHW image tensor; returns softmax logits.

    Matches the layer sequence of examples/cpp/AlexNet/alexnet.cc:70-84
    (conv 64/11x11s4p2 → pool → conv 192/5x5p2 → pool → conv 384 → conv 256
    → conv 256 → pool → flat → fc4096 → fc4096 → fc classes).
    """
    ff = model
    relu = ActiMode.AC_MODE_RELU
    t = ff.conv2d(input, 64, 11, 11, 4, 4, 2, 2, relu, name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, PoolType.POOL_MAX, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, relu, name="conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, PoolType.POOL_MAX, name="pool2")
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, relu, name="conv3")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, relu, name="conv4")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, relu, name="conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, PoolType.POOL_MAX, name="pool5")
    t = ff.flat(t)
    t = ff.dense(t, 4096, relu, name="fc6")
    t = ff.dense(t, 4096, relu, name="fc7")
    t = ff.dense(t, num_classes, name="fc8")
    return ff.softmax(t)
