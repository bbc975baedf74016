from . import sequence, text

__all__ = ["sequence", "text"]
