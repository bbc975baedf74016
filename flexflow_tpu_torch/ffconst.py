"""Framework-wide enums, the subset the ported slices use.

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


class LossType(enum.Enum):
    LOSS_CATEGORICAL_CROSSENTROPY = 0
    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = 1
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE = 2
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE = 3
    LOSS_IDENTITY = 4


class MetricsType(enum.Enum):
    METRICS_ACCURACY = 0
    METRICS_CATEGORICAL_CROSSENTROPY = 1
    METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = 2
    METRICS_MEAN_SQUARED_ERROR = 3
    METRICS_ROOT_MEAN_SQUARED_ERROR = 4
    METRICS_MEAN_ABSOLUTE_ERROR = 5


class CompMode(enum.Enum):
    COMP_MODE_TRAINING = 0
    COMP_MODE_INFERENCE = 1


class OpType(enum.Enum):
    INPUT = "input"
    LINEAR = "linear"
    SOFTMAX = "softmax"
    LAYERNORM = "layernorm"
    RMSNORM = "rmsnorm"
    EMBEDDING = "embedding"
    EW_ADD = "ew_add"
    MULTIHEAD_ATTENTION = "multihead_attention"
    # not ported yet (ROADMAP A6); named by the TP tables of search/
    BATCHMATMUL = "batch_matmul"
