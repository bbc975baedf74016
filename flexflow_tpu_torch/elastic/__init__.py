"""The elastic runtime's host-only pieces (counterpart of
flexflow_tpu/elastic/): the event log and the training watchdog that
`FFModel.fit(watchdog=)` runs. Fault injection, the failure detector,
retries and the coordinator's re-planning and rollback come with ROADMAP
A9.2."""
from .events import ElasticEvent, EventLog
from .watchdog import (NumericBlowup, TrainingWatchdog, WatchdogPolicy,
                       reset_watchdog_counters, watchdog_counters)

__all__ = ["ElasticEvent", "EventLog", "NumericBlowup", "TrainingWatchdog",
           "WatchdogPolicy", "reset_watchdog_counters", "watchdog_counters"]
