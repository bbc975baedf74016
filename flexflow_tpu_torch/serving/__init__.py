"""Inference serving (counterpart of flexflow_tpu/serving/): the lockstep
GenerativeSession and the continuous-batching scheduler of sched/. The
dynamic batcher, the server and the fleet are not ported yet (ROADMAP
A5, A10)."""
from .generate import GenerativeSession
from .sched import (AdmissionController, AdmissionError, BatcherStopped,
                    ContinuousBatcher, GenRequest, PagedKVPool,
                    PoolSaturated, PrefixCache, QueueFull, RequestCancelled,
                    RequestState, RequestTooLarge, prefix_route_chain,
                    prefix_route_key)

__all__ = ["AdmissionController", "AdmissionError", "BatcherStopped",
           "ContinuousBatcher", "GenRequest", "GenerativeSession",
           "PagedKVPool", "PoolSaturated", "PrefixCache", "QueueFull",
           "RequestCancelled", "RequestState", "RequestTooLarge",
           "prefix_route_chain", "prefix_route_key"]
