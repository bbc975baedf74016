"""Inference serving (counterpart of flexflow_tpu/serving/): the
InferenceModel (one CUDA graph per batch bucket on the card), the
DynamicBatcher that coalesces requests into its buckets, the serving-time
batch-norm fold (`fold_batchnorm`), the HTTP / Prometheus
InferenceServer, the lockstep GenerativeSession and the
continuous-batching scheduler of sched/. The model repository is ROADMAP
A5.10c; the fleet is A10."""
from .batcher import BatcherStopped, DynamicBatcher
from .generate import GenerativeSession
from .model import InferenceModel
from .optimize import fold_batchnorm
from .sched import (AdmissionController, AdmissionError, ContinuousBatcher,
                    GenRequest, PagedKVPool, PoolSaturated, PrefixCache,
                    QueueFull, RequestCancelled, RequestState,
                    RequestTooLarge, prefix_route_chain, prefix_route_key)
from .server import InferenceServer, ModelMetrics

__all__ = ["AdmissionController", "AdmissionError", "BatcherStopped",
           "ContinuousBatcher", "DynamicBatcher", "GenRequest",
           "GenerativeSession", "InferenceModel", "InferenceServer",
           "ModelMetrics", "PagedKVPool", "PoolSaturated", "PrefixCache",
           "QueueFull", "RequestCancelled", "RequestState",
           "RequestTooLarge", "fold_batchnorm", "prefix_route_chain",
           "prefix_route_key"]
