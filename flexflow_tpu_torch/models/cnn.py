"""Counterpart of flexflow_tpu/models/cnn.py, the same graph, op names
and defaults. Small MNIST/CIFAR nets (reference: examples/python/native/mnist_mlp.py,
mnist_cnn.py, cifar10_cnn.py) — the accuracy-gated CI models
(examples/python/native/accuracy.py:19-24)."""
from __future__ import annotations

from ..ffconst import ActiMode, PoolType


def build_mnist_mlp(model, input, num_classes: int = 10):
    """784 → 512 → 512 → 10 MLP (mnist_mlp.py)."""
    relu = ActiMode.AC_MODE_RELU
    t = model.dense(input, 512, relu, name="mlp1")
    t = model.dense(t, 512, relu, name="mlp2")
    t = model.dense(t, num_classes, name="mlp3")
    return model.softmax(t)


def build_mnist_cnn(model, input, num_classes: int = 10):
    """conv32-conv64-pool-fc128 CNN on 1x28x28 (mnist_cnn.py)."""
    relu = ActiMode.AC_MODE_RELU
    t = model.conv2d(input, 32, 3, 3, 1, 1, 1, 1, relu, name="c1")
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, relu, name="c2")
    t = model.pool2d(t, 2, 2, 2, 2, 0, 0, PoolType.POOL_MAX)
    t = model.flat(t)
    t = model.dense(t, 128, relu, name="fc1")
    t = model.dense(t, num_classes, name="fc2")
    return model.softmax(t)


def build_cifar10_cnn(model, input, num_classes: int = 10):
    """Two conv-conv-pool stages then fc512 on 3x32x32 (cifar10_cnn.py)."""
    relu = ActiMode.AC_MODE_RELU
    t = model.conv2d(input, 32, 3, 3, 1, 1, 1, 1, relu, name="c1")
    t = model.conv2d(t, 32, 3, 3, 1, 1, 1, 1, relu, name="c2")
    t = model.pool2d(t, 2, 2, 2, 2, 0, 0, PoolType.POOL_MAX)
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, relu, name="c3")
    t = model.conv2d(t, 64, 3, 3, 1, 1, 1, 1, relu, name="c4")
    t = model.pool2d(t, 2, 2, 2, 2, 0, 0, PoolType.POOL_MAX)
    t = model.flat(t)
    t = model.dense(t, 512, relu, name="fc1")
    t = model.dense(t, num_classes, name="fc2")
    return model.softmax(t)
