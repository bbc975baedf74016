"""flexflow_tpu_torch.keras: the tf.keras-compatible frontend over the
port's FFModel (counterpart of flexflow_tpu/keras, with its module layout
and names).

reference parity: python/flexflow/keras/ — Sequential and functional
Model, the layer, optimizer, loss, metric, initializer, regularizer and
callback surface, datasets, preprocessing. compile() builds an FFModel
and compiles it (the plan, the executor, the kernel tier) on
`FFConfig.device`, "cuda" unless the caller passes "cpu"; fit() drives
FFModel.fit one epoch a call. Nothing here imports tensorflow.
"""
from . import (
    callbacks,
    datasets,
    initializers,
    layers,
    losses,
    metrics,
    models,
    optimizers,
    preprocessing,
    regularizers,
    utils,
)
from .models import Model, Sequential

__all__ = [
    "models", "layers", "optimizers", "losses", "metrics", "callbacks",
    "initializers", "regularizers", "datasets", "preprocessing", "utils",
    "Model", "Sequential",
]
