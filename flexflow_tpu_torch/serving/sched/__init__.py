"""Continuous-batching serving: the paged KV pool, admission control and
the ContinuousBatcher (counterpart of flexflow_tpu/serving/sched/)."""
from .admission import (AdmissionController, AdmissionError, PoolSaturated,
                        QueueFull, RequestTooLarge)
from .continuous import (BatcherStopped, ContinuousBatcher, GenRequest,
                         RequestState)
from .kvpool import PagedKVPool, PoolExhausted, kv_bytes_per_token, kv_cache_spec

__all__ = ["AdmissionController", "AdmissionError", "BatcherStopped",
           "ContinuousBatcher", "GenRequest", "PagedKVPool", "PoolExhausted",
           "PoolSaturated", "QueueFull", "RequestState", "RequestTooLarge",
           "kv_bytes_per_token", "kv_cache_spec"]
