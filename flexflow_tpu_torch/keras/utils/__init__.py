from .np_utils import to_categorical

__all__ = ["to_categorical"]
