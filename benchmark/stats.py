"""The benchmark's own arithmetic on samples and time intervals."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default); None for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """Each interval cut to [lo, hi]; those outside it dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length the union of the intervals covers."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
