"""Continuous-batching serving: the paged KV pool and its prefix cache,
admission control, the ContinuousBatcher and the shared-prefix workload
and the disaggregated handoff's pieces (counterpart of
flexflow_tpu/serving/sched/)."""
from .admission import (AdmissionController, AdmissionError, PoolSaturated,
                        QueueFull, RequestTooLarge, SLOExceeded)
from .bench import (make_shared_prefix_workload, make_workload,
                    run_speculative_once)
from .continuous import (BatcherStopped, ContinuousBatcher, GenRequest,
                         HandoffTicket, RequestCancelled, RequestState,
                         ResizeTicket)
from .kvpool import (KVGeometryMismatch, PagedKVPool, PoolExhausted,
                     PrefixCache,
                     kv_bytes_per_token, kv_cache_spec, local_kv_cache_spec,
                     local_rows, prefix_route_chain, prefix_route_key)

__all__ = ["AdmissionController", "AdmissionError", "BatcherStopped",
           "ContinuousBatcher", "GenRequest", "HandoffTicket",
           "KVGeometryMismatch", "PagedKVPool", "PoolExhausted",
           "PoolSaturated", "PrefixCache", "QueueFull", "RequestCancelled",
           "RequestState", "RequestTooLarge", "ResizeTicket", "SLOExceeded",
           "kv_bytes_per_token", "kv_cache_spec", "local_kv_cache_spec",
           "local_rows", "make_shared_prefix_workload", "make_workload",
           "prefix_route_chain", "prefix_route_key", "run_speculative_once"]
