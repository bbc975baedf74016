"""Labelled counters: a host-only copy of the parts of
flexflow_tpu/obs/registry.py that a counter needs (`_Family`, `Counter`,
`MetricsRegistry.counter`), so the port's metric families keep the JAX
package's names and labels. Gauges, histograms and the Prometheus
renderer come with the rest of obs/ (ROADMAP A9).

A metric family is (name, kind, label names); asking again for an
existing family returns the same object, and a kind or label mismatch
raises.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Family:
    """One metric family: shared name/help/label schema, per-labelset
    values. Thread-safe: the serving thread bumps while others read."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"family declares {sorted(self.label_names)}")
        return tuple(str(labels[ln]) for ln in self.label_names)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Counter(_Family):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n


class MetricsRegistry:
    """A namespace of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = Counter(name, help, labels)
            elif not isinstance(fam, Counter) or \
                    fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.label_names}")
            return fam


# the process-wide registry
REGISTRY = MetricsRegistry()
