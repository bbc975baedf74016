"""Core keras layers: Dense, Flatten, Embedding, Activation, Dropout,
Reshape, Permute.

reference parity: python/flexflow/keras/layers/core.py:26-340.
"""
from __future__ import annotations

from ...ffconst import ActiMode, AggrMode, DataType
from .base_layer import Layer

ACTIVATIONS = {
    None: ActiMode.AC_MODE_NONE,
    "relu": ActiMode.AC_MODE_RELU,
    "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "tanh": ActiMode.AC_MODE_TANH,
    "gelu": ActiMode.AC_MODE_GELU,
}
# activations that are separate ops rather than fused epilogues
UNFUSED_ACTIVATIONS = ("softmax", "elu")


def parse_activation(activation):
    if isinstance(activation, ActiMode):
        return activation, None
    if activation in ACTIVATIONS:
        return ACTIVATIONS[activation], None
    if activation in UNFUSED_ACTIVATIONS:
        return ActiMode.AC_MODE_NONE, activation
    raise ValueError(f"unknown activation {activation!r}")


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer=None, bias_initializer=None,
                 kernel_regularizer=None, **kwargs):
        super().__init__(**kwargs)
        self.units = int(units)
        self.activation, self.post_activation = parse_activation(activation)
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer

    def compute_output_shape(self, input_shapes):
        s = input_shapes[0]
        return s[:-1] + (self.units,)

    def _build(self, ffmodel, ff_inputs):
        from ..initializers import to_ff_initializer

        t = ffmodel.dense(
            ff_inputs[0], self.units, self.activation, self.use_bias,
            kernel_initializer=to_ff_initializer(self.kernel_initializer),
            bias_initializer=to_ff_initializer(self.bias_initializer),
            name=self.name,
        )
        if self.kernel_regularizer is not None:
            ffmodel.add_weight_regularizer(
                self.name, "kernel", self.kernel_regularizer
            )
        in_dim = ff_inputs[0].dims[-1]
        self._nparams = in_dim * self.units + (self.units if self.use_bias else 0)
        if self.post_activation == "softmax":
            t = ffmodel.softmax(t, name=f"{self.name}_softmax")
        elif self.post_activation == "elu":
            t = ffmodel.elu(t, name=f"{self.name}_elu")
        return t


class Flatten(Layer):
    def compute_output_shape(self, input_shapes):
        s = input_shapes[0]
        n = 1
        for d in s[1:]:
            n *= d
        return (s[0], n)

    def _build(self, ffmodel, ff_inputs):
        return ffmodel.flat(ff_inputs[0], name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, input_length=None,
                 embeddings_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.input_length = input_length
        self.embeddings_initializer = embeddings_initializer

    def compute_output_shape(self, input_shapes):
        s = input_shapes[0]
        return s + (self.output_dim,)

    def output_dtype(self, inputs):
        return DataType.DT_FLOAT

    def _build(self, ffmodel, ff_inputs):
        from ..initializers import to_ff_initializer

        self._nparams = self.input_dim * self.output_dim
        return ffmodel.embedding(
            ff_inputs[0], self.input_dim, self.output_dim,
            AggrMode.AGGR_MODE_NONE,
            kernel_initializer=to_ff_initializer(self.embeddings_initializer),
            name=self.name,
        )


class Activation(Layer):
    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self.activation = activation

    def compute_output_shape(self, input_shapes):
        return input_shapes[0]

    def _build(self, ffmodel, ff_inputs):
        x = ff_inputs[0]
        fn = {
            "relu": ffmodel.relu,
            "sigmoid": ffmodel.sigmoid,
            "tanh": ffmodel.tanh,
            "gelu": ffmodel.gelu,
            "elu": ffmodel.elu,
            "softmax": ffmodel.softmax,
            "linear": ffmodel.identity,
            None: ffmodel.identity,
        }[self.activation]
        return fn(x, name=self.name)


class Dropout(Layer):
    def __init__(self, rate: float, seed: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.rate = float(rate)
        self.seed = seed

    def compute_output_shape(self, input_shapes):
        return input_shapes[0]

    def _build(self, ffmodel, ff_inputs):
        return ffmodel.dropout(ff_inputs[0], self.rate, self.seed, name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape, **kwargs):
        super().__init__(**kwargs)
        self.target_shape = tuple(int(d) for d in target_shape)

    def compute_output_shape(self, input_shapes):
        return (input_shapes[0][0],) + self.target_shape

    def _build(self, ffmodel, ff_inputs):
        batch = ff_inputs[0].dims[0]
        return ffmodel.reshape(
            ff_inputs[0], (batch,) + self.target_shape, name=self.name
        )


class Permute(Layer):
    """Permutes the non-batch dims; dims are 1-indexed as in keras."""

    def __init__(self, dims, **kwargs):
        super().__init__(**kwargs)
        self.dims = tuple(int(d) for d in dims)

    def compute_output_shape(self, input_shapes):
        s = input_shapes[0]
        return (s[0],) + tuple(s[d] for d in self.dims)

    def _build(self, ffmodel, ff_inputs):
        perm = (0,) + self.dims
        return ffmodel.transpose(ff_inputs[0], perm, name=self.name)
