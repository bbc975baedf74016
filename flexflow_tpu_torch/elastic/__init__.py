"""Elastic runtime (counterpart of flexflow_tpu/elastic/): fault injection,
failure detection, retry, automatic strategy re-planning when ranks are
lost, and durability — a training watchdog plus verified-fallback
checkpoints.

The headline path: a `FaultPlan` scripts chip-loss/slow-link/transient/
nan-step/corrupt-checkpoint/poison-live-state events, the
`FailureDetector` guards every train-step dispatch (retrying transients
via `RetryPolicy`), the `TrainingWatchdog` health-checks every committed
loss (skipping bad batches and rolling back to the last-good checkpoint
on sustained blow-ups), and the `ElasticCoordinator` answers a lost rank
by shrinking the rank list and the topology spec, re-running the Unity
search on the survivors, restoring the live state (redistributed among
the survivors) or the newest VERIFIED checkpoint (runtime/durability.py)
onto the new mesh, and resuming the same fit() call. `drill.py` runs the
scripted fail-and-recover scenarios
(`python -m flexflow_tpu_torch.elastic.drill`).
"""
from .coordinator import (ElasticCoordinator, RecoveryFailed,
                          reshard_params, ring_topology_spec,
                          shrink_topology_spec)
from .detector import FailureDetector
from .events import ElasticEvent, EventLog
from .faults import (Fault, FaultInjector, FaultPlan, TopologyLoss,
                     TransientFault, classify_error)
from .retry import RetriesExhausted, RetryPolicy, call_with_retry
from .watchdog import (NumericBlowup, TrainingWatchdog, WatchdogPolicy,
                       reset_watchdog_counters, watchdog_counters)

__all__ = [
    "ElasticCoordinator", "ElasticEvent", "EventLog", "FailureDetector",
    "Fault", "FaultInjector", "FaultPlan", "NumericBlowup",
    "RecoveryFailed", "RetriesExhausted", "RetryPolicy", "TopologyLoss",
    "TrainingWatchdog", "TransientFault", "WatchdogPolicy",
    "call_with_retry", "classify_error", "reset_watchdog_counters",
    "reshard_params", "ring_topology_spec", "shrink_topology_spec",
    "watchdog_counters",
]
