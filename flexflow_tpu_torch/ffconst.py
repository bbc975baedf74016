"""Framework-wide enums, the subset the serving slice uses.

Mirrors flexflow_tpu/ffconst.py: the same member names and values, so a
graph built in either package names its ops and dtypes the same way. The
DataType map resolves to torch dtypes instead of jnp dtypes.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class DataType(enum.Enum):
    DT_INT32 = "int32"
    DT_FLOAT = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def np_dtype(self):
        return np.dtype(self.value)


class ActiMode(enum.Enum):
    AC_MODE_NONE = 0
    AC_MODE_GELU = 4


class AggrMode(enum.Enum):
    AGGR_MODE_NONE = 0


class CompMode(enum.Enum):
    COMP_MODE_TRAINING = 0
    COMP_MODE_INFERENCE = 1


class OpType(enum.Enum):
    INPUT = "input"
    LINEAR = "linear"
    SOFTMAX = "softmax"
    LAYERNORM = "layernorm"
    EMBEDDING = "embedding"
    EW_ADD = "ew_add"
    MULTIHEAD_ATTENTION = "multihead_attention"
