from .base_layer import Layer
from .input_layer import Input, InputLayer
from .core import Activation, Dense, Dropout, Embedding, Flatten, Permute, Reshape
from .convolutional import Conv2D
from .pool import AveragePooling2D, MaxPooling2D, Pooling2D
from .merge import (
    Add,
    Concatenate,
    Maximum,
    Minimum,
    Multiply,
    Subtract,
    add,
    concatenate,
    multiply,
    subtract,
)
from .normalization import BatchNormalization, LayerNormalization

__all__ = [
    "Layer", "Input", "InputLayer", "Dense", "Flatten", "Embedding",
    "Activation", "Dropout", "Reshape", "Permute", "Conv2D", "Pooling2D",
    "MaxPooling2D", "AveragePooling2D", "Concatenate", "concatenate", "Add",
    "add", "Subtract", "subtract", "Multiply", "multiply", "Maximum",
    "Minimum", "BatchNormalization", "LayerNormalization",
]
