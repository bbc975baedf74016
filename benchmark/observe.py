"""What a run hands to the metric readers (`metrics/<name>.py`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .trace import DeviceTrace


@dataclass(eq=False)
class RequestRecord:
    """One request of a serving window, on the host's monotonic clock."""
    rid: int                      # the batcher's request id (-1: refused)
    prompt: np.ndarray            # (L,) int32 token ids
    max_new: int
    due: float                    # when it was due to be sent
    first: Optional[float] = None          # its first token
    token_times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    queue_wait_s: Optional[float] = None
    error: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def finished(self) -> bool:
        return self.error is None and len(self.tokens) == self.max_new


@dataclass
class Observations:
    config: dict
    traffic: dict
    dims: dict                    # reference/<config>.py dims(config)
    seed: int
    seconds: float
    setup_s: float = 0.0
    window: Tuple[float, float] = (0.0, 0.0)   # monotonic open and close
    # training
    steps: int = 0                # optimizer steps completed in the window
    trace_steps: int = 0          # of them, inside the traced slice
    # serving
    requests: List[RequestRecord] = field(default_factory=list)
    # with --trace 1: the program's spans (obs/tracing.py events) that
    # started inside the window, and the profiled slice
    spans: Optional[List[dict]] = None
    device: Optional[DeviceTrace] = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def spans_named(self, name: str) -> List[dict]:
        return [e for e in (self.spans or []) if e.get("name") == name]


@dataclass
class Outcome:
    """A runner's run: the observations, the compared numbers as
    {name: (value, limit)}, what else makes the run incorrect, and the
    result's `attempted`, `failed` and `device`."""
    obs: Observations
    checks: Dict[str, Tuple[float, float]]
    problems: List[str]
    attempted: int
    failed: int
    device: dict
    notes: Dict[str, object] = field(default_factory=dict)
