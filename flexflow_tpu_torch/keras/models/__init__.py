from .base_model import BaseModel
from .model import Model
from .sequential import Sequential
from .tensor import KerasTensor

__all__ = ["BaseModel", "Model", "Sequential", "KerasTensor"]
