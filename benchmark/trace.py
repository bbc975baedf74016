"""A slice of a run's window under torch.profiler, and what the
benchmark reads from it.

The runner opens the profiler once the window has closed (its start
takes seconds and turns CUPTI on, which slows every launch, so the window
runs without it), starts recording PAD_S before the slice
and stops PAD_S after it (torch.profiler drops device records that fall
at the edges of its session, so the slice keeps clear of them), and
marks the slice itself with a user annotation, MARKER, on the host.
Only what falls inside the marker counts:
the device's busy time is the union of its kernels' and copies'
intervals clipped to the marker, so operations that overlap (two streams)
count once; the window is the marker's length.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .stats import clip, covered, gaps

MARKER = "bench.window"
PAD_S = 0.05
TOP = 10


@dataclass
class DeviceTrace:
    """The device's operations and the host's operations inside the
    marked slice, in seconds on the profiler's clock."""
    start: float
    end: float
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return covered((s, e) for _, s, e in self.device_ops)

    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or not self.device_ops:
            return None
        return 1.0 - self.busy_s / self.window_s

    def time_of(self, patterns) -> Tuple[float, int]:
        """Seconds of device operations whose names hold any pattern, and
        how many there were."""
        hit = [(s, e) for n, s, e in self.device_ops
               if any(p in n for p in patterns)]
        return sum(e - s for s, e in hit), len(hit)

    def breakdown(self) -> dict:
        """The device operations that took the most time, and the longest
        stretches in which the device was idle, each named by the host
        operation that overlapped it most."""
        per = defaultdict(float)
        for n, s, e in self.device_ops:
            per[_short(n)] += e - s
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(gaps([(s, e) for _, s, e in self.device_ops],
                           self.start, self.end),
                      key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for s, e in idle:
            best, most = "host idle", 0.0
            for n, hs, he in self.host_ops:
                over = min(e, he) - max(s, hs)
                if over > most:
                    best, most = n, over
            named.append([_short(best), e - s])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list, at
    most 120 letters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


class Slice:
    """torch.profiler over one slice of a window, in four steps the
    caller's loop times: `open()` (the profiler's start and warm-up),
    `record()` (PAD_S before the slice), `begin()` and `end()` (the
    marker), `close()` (PAD_S after it). `result()` reads it once the
    window has closed; `seconds` keeps how long each step took."""

    def __init__(self):
        self.prof = None
        self.mark = None
        self.seconds = {}

    def _timed(self, step, fn) -> None:
        t = time.monotonic()
        fn()
        self.seconds[step] = time.monotonic() - t

    def open(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self._timed("open", self.prof.start)

    def record(self) -> None:
        self._timed("record", self.prof.step)

    def begin(self) -> None:
        import torch

        self.mark = torch.autograd.profiler.record_function(MARKER)
        self.mark.__enter__()

    def end(self) -> None:
        self.mark.__exit__(None, None, None)

    def close(self) -> None:
        def stop():
            self.prof.step()
            self.prof.stop()
        self._timed("close", stop)

    def result(self) -> Optional[DeviceTrace]:
        if self.prof is None or self.mark is None:
            return None
        return parse(self.prof)


def parse(prof) -> Optional[DeviceTrace]:
    """The marked slice of a finished profile: device operations (kernels,
    copies, sets) and host operations clipped to the marker; None when
    the marker is missing."""
    from torch.autograd import DeviceType

    events = []
    try:
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e9
            events.append((e.name(), e.device_type(), s,
                           s + e.duration_ns() / 1e9))
    except AttributeError:  # an older profiler: FunctionEvents, in us
        for e in prof.events():
            events.append((e.name, e.device_type, e.time_range.start / 1e6,
                           e.time_range.end / 1e6))
    marks = [(s, e) for n, kind, s, e in events
             if n == MARKER and kind != DeviceType.CUDA]
    if not marks:
        return None
    lo, hi = marks[0]
    dev, host = [], []
    for n, kind, s, e in events:
        if n == MARKER or n.startswith("ProfilerStep") or e <= lo \
                or s >= hi:
            continue
        (cs, ce), = clip([(s, e)], lo, hi)
        (dev if kind == DeviceType.CUDA else host).append((n, cs, ce))
    return DeviceTrace(lo, hi, dev, host)
