"""Conv2D (NCHW, as in the reference keras frontend).

reference parity: python/flexflow/keras/layers/convolutional.py:25.
"""
from __future__ import annotations

from .base_layer import Layer
from .core import parse_activation


def _pair(v):
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _padding(padding, kernel, strides=(1, 1)):
    """keras 'same'/'valid' or explicit (ph, pw). 'same' uses the
    stride-aware static formula (reference convolutional.py:140-149)."""
    if padding == "same":
        return (
            max(kernel[0] - strides[0], 0) // 2,
            max(kernel[1] - strides[1], 0) // 2,
        )
    if padding == "valid":
        return 0, 0
    return _pair(padding)


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, groups: int = 1,
                 use_bias: bool = True, kernel_initializer=None,
                 bias_initializer=None, kernel_regularizer=None, **kwargs):
        super().__init__(**kwargs)
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _padding(padding, self.kernel_size, self.strides)
        self.activation, self.post_activation = parse_activation(activation)
        self.groups = groups
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer

    def compute_output_shape(self, input_shapes):
        b, c, h, w = input_shapes[0]
        kh, kw = self.kernel_size
        sh, sw = self.strides
        ph, pw = self.padding
        oh = (h + 2 * ph - kh) // sh + 1
        ow = (w + 2 * pw - kw) // sw + 1
        return (b, self.filters, oh, ow)

    def _build(self, ffmodel, ff_inputs):
        from ..initializers import to_ff_initializer

        in_c = ff_inputs[0].dims[1]
        kh, kw = self.kernel_size
        self._nparams = self.filters * (in_c // self.groups) * kh * kw + (
            self.filters if self.use_bias else 0
        )
        t = ffmodel.conv2d(
            ff_inputs[0], self.filters, kh, kw,
            self.strides[0], self.strides[1],
            self.padding[0], self.padding[1],
            activation=self.activation, groups=self.groups,
            use_bias=self.use_bias,
            kernel_initializer=to_ff_initializer(self.kernel_initializer),
            bias_initializer=to_ff_initializer(self.bias_initializer),
            name=self.name,
        )
        if self.kernel_regularizer is not None:
            ffmodel.add_weight_regularizer(self.name, "kernel", self.kernel_regularizer)
        if self.post_activation == "softmax":
            t = ffmodel.softmax(t, name=f"{self.name}_softmax")
        elif self.post_activation == "elu":
            t = ffmodel.elu(t, name=f"{self.name}_elu")
        return t
