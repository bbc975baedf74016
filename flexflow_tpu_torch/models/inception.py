"""Counterpart of flexflow_tpu/models/inception.py, the same graph, op names
and defaults. InceptionV3 (reference: examples/cpp/InceptionV3/inception.cc:26-175)."""
from __future__ import annotations

from ..ffconst import ActiMode, PoolType

RELU = ActiMode.AC_MODE_RELU


def _inception_a(ff, x, pool_features: int):
    """Four-branch 35x35 module (inception.cc:26-48)."""
    b1 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, RELU)
    b2 = ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0, RELU)
    b2 = ff.conv2d(b2, 64, 5, 5, 1, 1, 2, 2, RELU)
    b3 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, RELU)
    b3 = ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, RELU)
    b3 = ff.conv2d(b3, 96, 3, 3, 1, 1, 1, 1, RELU)
    b4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = ff.conv2d(b4, pool_features, 1, 1, 1, 1, 0, 0, RELU)
    return ff.concat([b1, b2, b3, b4], axis=1)


def _inception_b(ff, x):
    """Grid-size reduction 35→17 (inception.cc:50-62)."""
    b1 = ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0)
    b2 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2, 96, 3, 3, 1, 1, 1, 1)
    b2 = ff.conv2d(b2, 96, 3, 3, 2, 2, 0, 0)
    b3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0, PoolType.POOL_MAX)
    return ff.concat([b1, b2, b3], axis=1)


def _inception_c(ff, x, channels: int):
    """Factorized 7x7 module at 17x17 (inception.cc:64-83)."""
    b1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2, channels, 1, 7, 1, 1, 0, 3)
    b2 = ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0)
    b3 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    b3 = ff.conv2d(b3, channels, 7, 1, 1, 1, 3, 0)
    b3 = ff.conv2d(b3, channels, 1, 7, 1, 1, 0, 3)
    b3 = ff.conv2d(b3, channels, 7, 1, 1, 1, 3, 0)
    b3 = ff.conv2d(b3, 192, 1, 7, 1, 1, 0, 3)
    b4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = ff.conv2d(b4, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([b1, b2, b3, b4], axis=1)


def _inception_d(ff, x):
    """Grid-size reduction 17→8 (inception.cc:85-99)."""
    b1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    b1 = ff.conv2d(b1, 320, 3, 3, 2, 2, 0, 0)
    b2 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2, 192, 1, 7, 1, 1, 0, 3)
    b2 = ff.conv2d(b2, 192, 7, 1, 1, 1, 3, 0)
    b2 = ff.conv2d(b2, 192, 3, 3, 2, 2, 0, 0)
    b3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0, PoolType.POOL_MAX)
    return ff.concat([b1, b2, b3], axis=1)


def _inception_e(ff, x):
    """Expanded-filter-bank module at 8x8 (inception.cc:101-121)."""
    b1 = ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0)
    b2i = ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0)
    b2 = ff.conv2d(b2i, 384, 1, 3, 1, 1, 0, 1)
    b3 = ff.conv2d(b2i, 384, 3, 1, 1, 1, 1, 0)
    b4i = ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0)
    b4i = ff.conv2d(b4i, 384, 3, 3, 1, 1, 1, 1)
    b4 = ff.conv2d(b4i, 384, 1, 3, 1, 1, 0, 1)
    b5 = ff.conv2d(b4i, 384, 3, 1, 1, 1, 1, 0)
    b6 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b6 = ff.conv2d(b6, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([b1, b2, b3, b4, b5, b6], axis=1)


def build_inception_v3(model, input, num_classes: int = 10):
    """Full InceptionV3 on NCHW 3x299x299 input (inception.cc:152-175)."""
    ff = model
    t = ff.conv2d(input, 32, 3, 3, 2, 2, 0, 0, RELU)
    t = ff.conv2d(t, 32, 3, 3, 1, 1, 0, 0, RELU)
    t = ff.conv2d(t, 64, 3, 3, 1, 1, 1, 1, RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, PoolType.POOL_MAX)
    t = ff.conv2d(t, 80, 1, 1, 1, 1, 0, 0, RELU)
    t = ff.conv2d(t, 192, 3, 3, 1, 1, 1, 1, RELU)
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0, PoolType.POOL_MAX)
    t = _inception_a(ff, t, 32)
    t = _inception_a(ff, t, 64)
    t = _inception_a(ff, t, 64)
    t = _inception_b(ff, t)
    t = _inception_c(ff, t, 128)
    t = _inception_c(ff, t, 160)
    t = _inception_c(ff, t, 160)
    t = _inception_c(ff, t, 192)
    t = _inception_d(ff, t)
    t = _inception_e(ff, t)
    t = _inception_e(ff, t)
    h, w = t.dims[2], t.dims[3]
    t = ff.pool2d(t, h, w, 1, 1, 0, 0, PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, num_classes)
    return ff.softmax(t)
