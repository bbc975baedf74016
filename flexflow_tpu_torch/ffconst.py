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
    DT_BOOLEAN = "bool"
    DT_INT32 = "int32"
    DT_INT64 = "int64"
    DT_HALF = "float16"
    DT_BFLOAT16 = "bfloat16"
    DT_FLOAT = "float32"
    DT_DOUBLE = "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def np_dtype(self):
        """numpy has no bfloat16 without jax's ml_dtypes, which the port
        does not need: a bf16 value is staged as f32 on the host and cast
        on the device (`host_np_dtype`)."""
        if self is DataType.DT_BFLOAT16:
            raise TypeError("DT_BFLOAT16 has no numpy dtype here; stage it "
                            "as float32 (DataType.host_np_dtype)")
        return np.dtype(self.value)

    @property
    def itemsize(self) -> int:
        """Bytes an element (JAX `dtype.np_dtype.itemsize`; bf16 is 2)."""
        return torch.empty((), dtype=self.torch_dtype).element_size()

    @property
    def host_np_dtype(self):
        """The numpy dtype a host array of this type is staged in: its own,
        float32 for bf16."""
        if self is DataType.DT_BFLOAT16:
            return np.dtype(np.float32)
        return self.np_dtype

    @classmethod
    def from_numpy(cls, dt) -> "DataType":
        return cls(np.dtype(dt).name)


class ActiMode(enum.Enum):
    AC_MODE_NONE = 0
    AC_MODE_RELU = 1
    AC_MODE_SIGMOID = 2
    AC_MODE_TANH = 3
    AC_MODE_GELU = 4


class PoolType(enum.Enum):
    POOL_MAX = 0
    POOL_AVG = 1


class AggrMode(enum.Enum):
    AGGR_MODE_NONE = 0
    AGGR_MODE_SUM = 1
    AGGR_MODE_AVG = 2


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


class ParameterSyncType(enum.Enum):
    """The reference's parameter-server vs NCCL gradient sync
    (flexflow_tpu/ffconst.py ParameterSyncType). The port syncs gradients
    with torch.distributed all-reduces over the mesh's data groups
    (runtime/collectives.py) whatever the value; the enum is kept for
    the API."""

    NONE = 0
    PS = 1
    NCCL = 2


class OpType(enum.Enum):
    NOOP = "noop"
    INPUT = "input"
    WEIGHT = "weight"
    CONV2D = "conv2d"
    DROPOUT = "dropout"
    LINEAR = "linear"
    BATCHMATMUL = "batch_matmul"
    POOL2D = "pool2d"
    SCALAR_MULTIPLY = "scalar_multiply"
    SCALAR_ADD = "scalar_add"
    SCALAR_SUB = "scalar_sub"
    SCALAR_TRUE_DIV = "scalar_true_div"
    RELU = "relu"
    IDENTITY = "identity"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    ELU = "elu"
    GELU = "gelu"
    RSQRT = "rsqrt"
    POW = "pow"
    EXP = "exp"
    SIN = "sin"
    COS = "cos"
    FLAT = "flat"
    SOFTMAX = "softmax"
    BATCHNORM = "batchnorm"
    LAYERNORM = "layernorm"
    RMSNORM = "rmsnorm"
    CONCAT = "concat"
    SPLIT = "split"
    EMBEDDING = "embedding"
    GATHER = "gather"
    RESHAPE = "reshape"
    REVERSE = "reverse"
    TRANSPOSE = "transpose"
    EW_ADD = "ew_add"
    EW_MUL = "ew_mul"
    EW_SUB = "ew_sub"
    EW_DIV = "ew_div"
    EW_MAX = "ew_max"
    EW_MIN = "ew_min"
    REDUCE_SUM = "reduce_sum"
    MEAN = "mean"
    CAST = "cast"
    MULTIHEAD_ATTENTION = "multihead_attention"
    TOPK = "topk"
    LSTM = "lstm"
    CACHE = "cache"
    AGGREGATE = "aggregate"
    AGGREGATE_SPEC = "aggregate_spec"
    GROUP_BY = "group_by"
    EXPERTS = "experts"
    # parallel-op and fused types: named by the rule loader, the
    # substitutions and the cost model, as in the JAX package; the
    # parallel ops are registered by parallel/parallel_ops.py
    FUSED = "fused"
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"
    ALLREDUCE = "allreduce"
    FUSED_PARALLEL = "fused_parallel"
    PIPELINE = "pipeline"
    RING_ATTENTION = "ring_attention"


class ParallelDimKind(enum.Enum):
    """Parallel-dimension kinds of the strategy layer and the search
    (flexflow_tpu/ffconst.py ParallelDimKind)."""

    SAMPLE = "sample"  # batch dim (data parallelism)
    CHANNEL = "channel"  # feature dims (tensor/"parameter" parallelism)
    ATTRIBUTE = "attribute"  # spatial/attribute dims
    SEQUENCE = "sequence"  # sequence dim (context parallelism)
    REPLICA = "replica"  # replication dim
    EXPERT = "expert"  # expert dim (MoE)
