"""Inference serving (counterpart of flexflow_tpu/serving/): the
InferenceModel (one CUDA graph per batch bucket on the card), the
DynamicBatcher that coalesces requests into its buckets, the serving-time
batch-norm fold (`fold_batchnorm`), the HTTP / Prometheus
InferenceServer, the lockstep GenerativeSession, the
continuous-batching scheduler of sched/ and the serving fleet of fleet/
(replicas behind a router, health, chaos, the autoscaler and the
disaggregated KV handoff), and the model repository (repository.py: a
directory of ONNX and C-spec entries, fleet and disaggregated entries,
loaded onto an InferenceServer)."""
from .batcher import BatcherStopped, DynamicBatcher
from .generate import GenerativeSession
from .model import InferenceModel
from .optimize import fold_batchnorm
from .sched import (AdmissionController, AdmissionError, ContinuousBatcher,
                    GenRequest, PagedKVPool, PoolSaturated, PrefixCache,
                    QueueFull, RequestCancelled, RequestState,
                    RequestTooLarge, SLOExceeded, prefix_route_chain,
                    prefix_route_key)
from .fleet import (Autoscaler, FleetRequest, FleetUnavailable, Replica,
                    ReplicaState, Router)
from .server import InferenceServer, ModelMetrics
from .repository import ModelRepository

__all__ = ["AdmissionController", "AdmissionError", "Autoscaler",
           "BatcherStopped", "ContinuousBatcher", "DynamicBatcher",
           "FleetRequest", "FleetUnavailable", "GenRequest",
           "GenerativeSession", "InferenceModel", "InferenceServer",
           "ModelMetrics", "ModelRepository", "PagedKVPool",
           "PoolSaturated", "PrefixCache",
           "QueueFull", "Replica", "ReplicaState", "RequestCancelled",
           "RequestState", "RequestTooLarge", "Router", "SLOExceeded",
           "fold_batchnorm", "prefix_route_chain", "prefix_route_key"]
