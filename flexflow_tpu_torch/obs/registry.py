"""Labelled metrics: a host-only copy of flexflow_tpu/obs/registry.py's
primitives (`Counter`, `Gauge`, `Histogram` with quantiles) and its
Prometheus exposition renderer, so the port's metric families keep the
JAX package's names, labels and text, `counters_with_prefix`, behind
runtime/durability.py's `checkpoint_counters()` and elastic/watchdog.py's
`watchdog_counters()`, and the exposition parser and checker
(`parse_exposition`, `validate_exposition`, `iter_samples`) that the
tests and `chip_smoke.py` run over `/metrics`, and the merged render of
many registries (`render_labeled`, `render_merged`): the fleet's
`/metrics`, each replica's samples under a `replica` label.

Design rules (the JAX module's):
 - a metric family is (name, kind, label names); asking again for an
   existing family returns the same object, and a kind, label or bucket
   mismatch raises;
 - `reset_all()` zeroes values but keeps the families, so handles
   cached at import time stay live;
 - rendering escapes help text and label values per the exposition
   format.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)


def escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


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

    def items(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._values.items())

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def remove(self, **labels) -> None:
        """Drop one labelset's series so it stops rendering; the family
        stays registered."""
        with self._lock:
            self._values.pop(self._key(labels), None)

    # -- rendering --------------------------------------------------------
    def _sample_lines(self, extra: Sequence[Tuple[str, str]] = ()
                      ) -> List[str]:
        """Sample lines, with the `extra` (name, value) label pairs put
        before each series' own (how `render_merged` stamps a replica's
        samples)."""
        items = self.items()
        if not items and not self.label_names:
            # an unlabelled family is born at 0, so a reset family renders
            # 0, not nothing
            items = [((), 0.0)]
        names = tuple(n for n, _ in extra) + self.label_names
        vals = tuple(v for _, v in extra)
        return [self._line(self.name, names, vals + key, v)
                for key, v in items]

    @staticmethod
    def _line(name: str, label_names: Sequence[str],
              label_values: Sequence[str], v: float) -> str:
        if label_names:
            lbl = ",".join(
                f'{ln}="{escape_label_value(lv)}"'
                for ln, lv in zip(label_names, label_values))
            return f"{name}{{{lbl}}} {_fmt(v)}"
        return f"{name} {_fmt(v)}"

    def render(self) -> str:
        lines = [f"# HELP {self.name} {escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        lines += self._sample_lines()
        return "\n".join(lines) + "\n"


class Counter(_Family):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (n={n})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def set_total(self, value: float, **labels) -> None:
        """Mirror a monotonic total accumulated elsewhere into the
        exposition (`inc` is the counter contract)."""
        with self._lock:
            self._values[self._key(labels)] = float(value)


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)


def _norm_buckets(buckets: Sequence[float]) -> Tuple[float, ...]:
    b = sorted(float(x) for x in buckets)
    if not b or b[-1] != math.inf:
        b.append(math.inf)
    return tuple(b)


class Histogram(_Family):
    """Cumulative-bucket histogram (`_bucket{le=}` / `_sum` / `_count`).
    `observe(v, exemplar=id)` pins the latest exemplar onto the landing
    bucket, rendered as an OpenMetrics exemplar suffix."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS):
        super().__init__(name, help, labels)
        self.buckets: Tuple[float, ...] = _norm_buckets(buckets)
        # per labelset: [bucket counts..., sum, count]
        self._hist: Dict[Tuple[str, ...], List[float]] = {}
        # (labelset, landing bucket index) -> (exemplar id, observed value)
        self._exemplars: Dict[Tuple[Tuple[str, ...], int],
                              Tuple[str, float]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            ent = self._hist.get(key)
            if ent is None:
                ent = self._hist[key] = [0.0] * (len(self.buckets) + 2)
            landing = None
            for i, le in enumerate(self.buckets):
                if v <= le:
                    if landing is None:
                        landing = i
                    ent[i] += 1
            ent[-2] += v
            ent[-1] += 1
            if exemplar is not None and landing is not None:
                self._exemplars[(key, landing)] = (str(exemplar), v)

    def exemplar(self, bucket_le: float, **labels
                 ) -> Optional[Tuple[str, float]]:
        """The (exemplar id, observed value) pinned on one bucket, or
        None."""
        key = self._key(labels)
        try:
            idx = self.buckets.index(float(bucket_le))
        except ValueError:
            return None
        with self._lock:
            return self._exemplars.get((key, idx))

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            ent = self._hist.get(key)
            return int(ent[-1]) if ent else 0

    def snapshot(self, **labels) -> Tuple[float, ...]:
        """A copy of one labelset's cumulative row ([bucket counts...,
        sum, count]; all zeros when never observed): the baseline of a
        windowed `quantile(since=)`."""
        key = self._key(labels)
        with self._lock:
            ent = self._hist.get(key)
            if ent is None:
                return (0.0,) * (len(self.buckets) + 2)
            return tuple(ent)

    def quantile(self, q: float, since: Optional[Sequence[float]] = None,
                 **labels) -> float:
        """Approximate q-quantile (q in [0, 1]) from the cumulative
        buckets, linearly interpolated inside the landing bucket; the +Inf
        bucket clamps to the last finite boundary; 0.0 with nothing
        observed. `since`: a `snapshot()` subtracted first, so only later
        observations count."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q}: want [0, 1]")
        key = self._key(labels)
        with self._lock:
            ent = self._hist.get(key)
            if ent is None or ent[-1] <= 0:
                return 0.0
            if since is not None and len(since) == len(ent):
                ent = [max(0.0, a - b) for a, b in zip(ent, since)]
                if ent[-1] <= 0:
                    return 0.0
            rank = q * ent[-1]
            prev_le, prev_cum = 0.0, 0.0
            for i, le in enumerate(self.buckets):
                cum = ent[i]
                if cum >= rank:
                    if math.isinf(le):
                        return prev_le
                    if cum == prev_cum:
                        return le
                    frac = (rank - prev_cum) / (cum - prev_cum)
                    return prev_le + frac * (le - prev_le)
                prev_le, prev_cum = (0.0 if math.isinf(le) else le), cum
            return prev_le

    def sum(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            ent = self._hist.get(key)
            return float(ent[-2]) if ent else 0.0

    def reset(self) -> None:
        with self._lock:
            self._hist.clear()
            self._exemplars.clear()

    def remove(self, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            self._hist.pop(key, None)
            for k in [k for k in self._exemplars if k[0] == key]:
                del self._exemplars[k]

    def _sample_lines(self, extra: Sequence[Tuple[str, str]] = ()
                      ) -> List[str]:
        """Sample lines, with the `extra` (name, value) label pairs put
        before each series' own (how `render_merged` stamps a replica's
        samples)."""
        out = []
        with self._lock:
            # copy inside the lock: a concurrent observe() must not tear a
            # rendered histogram (bucket{+Inf} != count)
            items = sorted((k, list(v)) for k, v in self._hist.items())
            exemplars = dict(self._exemplars)
        ex_names = tuple(n for n, _ in extra)
        ex_vals = tuple(v for _, v in extra)
        for key, ent in items:
            names = ex_names + self.label_names + ("le",)
            for i, le in enumerate(self.buckets):
                line = self._line(f"{self.name}_bucket", names,
                                  ex_vals + tuple(key) + (_fmt(le),),
                                  ent[i])
                ex = exemplars.get((key, i))
                if ex is not None:
                    line += (f' # {{trace_id="{escape_label_value(ex[0])}"}}'
                             f" {_fmt(ex[1])}")
                out.append(line)
            out.append(self._line(f"{self.name}_sum",
                                  ex_names + self.label_names,
                                  ex_vals + key, ent[-2]))
            out.append(self._line(f"{self.name}_count",
                                  ex_names + self.label_names,
                                  ex_vals + key, ent[-1]))
        return out


class MetricsRegistry:
    """A namespace of metric families with one exposition renderer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_make(self, cls, name: str, help: str,
                     labels: Sequence[str], **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}")
                if "buckets" in kw:
                    want = _norm_buckets(kw["buckets"])
                    if fam.buckets != want:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {fam.buckets}, requested {want}")
                return fam
            fam = cls(name, help, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """buckets=None fetches or creates with the default boundaries
        and never conflicts; explicit buckets must match an existing
        family."""
        kw = {} if buckets is None else {"buckets": buckets}
        return self._get_or_make(Histogram, name, help, labels, **kw)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def counters_with_prefix(self, prefix: str,
                             suffix: str = "_total") -> Dict[str, int]:
        """{middle: value} of the nonzero unlabeled counters named
        <prefix><middle><suffix> (JAX `counters_with_prefix`, behind
        `checkpoint_counters()`)."""
        out: Dict[str, int] = {}
        for fam in self.families():
            if (isinstance(fam, Counter) and not fam.label_names
                    and fam.name.startswith(prefix)
                    and fam.name.endswith(suffix)):
                v = fam.value()
                if v:
                    out[fam.name[len(prefix):-len(suffix)]] = int(v)
        return out

    def reset_all(self, prefix: Optional[str] = None) -> None:
        """Zero every family's values (the families stay registered);
        `prefix` limits the reset to one group."""
        for fam in self.families():
            if prefix is None or fam.name.startswith(prefix):
                fam.reset()

    def render(self) -> str:
        """Prometheus exposition text of every family, sorted by name."""
        return "".join(fam.render() for fam in self.families())


def render_labeled(
        members: List[Tuple[Tuple[Tuple[str, str], ...],
                            "MetricsRegistry"]]) -> str:
    """One exposition document over many registries, each member's
    samples with its (possibly empty) extra label pairs put first, and
    ONE # HELP / # TYPE header a family name across all members (a
    server whose default registry and whose fleet replicas carry the
    same families renders one document, not two with duplicate headers).
    Families of one name must agree on kind, labels and buckets, and may
    not already carry a stamp label: else ValueError."""
    merged: Dict[str, Tuple[_Family, List[Tuple[Tuple[Tuple[str, str],
                                                       ...], _Family]]]] = {}
    for pairs, reg in members:
        for ln, _ in pairs:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid merge label name {ln!r}")
        for fam in reg.families():
            for ln, _ in pairs:
                if ln in fam.label_names:
                    raise ValueError(
                        f"metric {fam.name!r} already carries a {ln!r}"
                        f" label; merging under {ln!r} would be"
                        " ambiguous")
            proto_entry = merged.get(fam.name)
            if proto_entry is None:
                merged[fam.name] = (fam, [(pairs, fam)])
                continue
            proto = proto_entry[0]
            if (proto.kind != fam.kind
                    or proto.label_names != fam.label_names
                    or getattr(proto, "buckets", None)
                    != getattr(fam, "buckets", None)):
                raise ValueError(
                    f"metric-name collision on {fam.name!r}: registered as"
                    f" {proto.kind}{proto.label_names} and"
                    f" {fam.kind}{fam.label_names} in different"
                    " registries; refusing to merge")
            proto_entry[1].append((pairs, fam))
    out = []
    for name in sorted(merged):
        proto, fams = merged[name]
        out.append(f"# HELP {name} {escape_help(proto.help)}\n")
        out.append(f"# TYPE {name} {proto.kind}\n")
        for pairs, fam in fams:
            for line in fam._sample_lines(extra=pairs):
                out.append(line + "\n")
    return "".join(out)


def render_merged(registries: Dict[str, "MetricsRegistry"],
                  label: str = "replica") -> str:
    """One exposition document over many registries, every sample of
    `registries[key]` stamped `label`="key" (the fleet's `/metrics`:
    each replica keeps a registry of its own); `render_labeled`'s
    collision rules."""
    if not _LABEL_RE.match(label):
        raise ValueError(f"invalid merge label name {label!r}")
    return render_labeled([(((label, key),), registries[key])
                           for key in sorted(registries)])


# the process-wide registry
REGISTRY = MetricsRegistry()


# -- exposition-format checking -------------------------------------------
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                          # optional label block
    r" ([-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    r"(?: [0-9]+)?$")                         # optional timestamp
# OpenMetrics exemplar suffix, split off a sample line before _SAMPLE_RE
# runs (the greedy label-block match must never see it)
_EXEMPLAR_RE = re.compile(
    r"^\{(.*)\} ([-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    r"(?: [0-9.]+)?$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label_value(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_exposition(text: str) -> Dict[str, Dict]:
    """Strict-enough parser for the exposition subset we emit. Returns
    {family name: {"type": ..., "help": ..., "samples":
    [(name, {label: value}, float)], "exemplars":
    [(name, {label: value}, {exemplar label: value}, float)]}}. Raises
    ValueError on any line that does not parse — the checker the tests
    run over `/metrics` output."""
    families: Dict[str, Dict] = {}

    def fam(name: str) -> Dict:
        return families.setdefault(
            name, {"type": None, "help": None, "samples": [],
                   "exemplars": []})

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {lineno}: bad HELP: {line!r}")
            fam(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if (len(parts) != 4 or not _NAME_RE.match(parts[2])
                    or parts[3] not in ("counter", "gauge", "histogram",
                                        "summary", "untyped")):
                raise ValueError(f"line {lineno}: bad TYPE: {line!r}")
            if families.get(parts[2], {}).get("type") is not None:
                raise ValueError(
                    f"line {lineno}: duplicate TYPE for {parts[2]}")
            fam(parts[2])["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        exemplar = None
        if " # " in line:  # OpenMetrics exemplar suffix on a sample line
            head, _, ex_part = line.rpartition(" # ")
            em = _EXEMPLAR_RE.match(ex_part)
            if em:  # else: " # " inside a label value — leave the line be
                line = head
                ex_labels = {pm.group(1): _unescape_label_value(pm.group(2))
                             for pm in _LABEL_PAIR_RE.finditer(em.group(1))}
                exemplar = (ex_labels,
                            float(em.group(2).replace("Inf", "inf")
                                  .replace("NaN", "nan")))
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: unparseable sample: {line!r}")
        name, label_block, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if label_block:
            consumed = 0
            for pm in _LABEL_PAIR_RE.finditer(label_block):
                labels[pm.group(1)] = _unescape_label_value(pm.group(2))
                consumed = pm.end()
                if (consumed < len(label_block)
                        and label_block[consumed] == ","):
                    consumed += 1
            if consumed != len(label_block):
                raise ValueError(
                    f"line {lineno}: bad label block: {label_block!r}")
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        entry = fam(base if base in families else name)
        entry["samples"].append(
            (name, labels, float(value.replace("Inf", "inf")
                                 .replace("NaN", "nan"))))
        if exemplar is not None:
            entry["exemplars"].append(
                (name, labels, exemplar[0], exemplar[1]))
    return families


def validate_exposition(text: str) -> Dict[str, Dict]:
    """parse_exposition + structural checks: every sample belongs to a
    family with a TYPE header, and histogram families carry their
    _bucket/_sum/_count series."""
    families = parse_exposition(text)
    for name, f in families.items():
        if f["samples"] and f["type"] is None:
            raise ValueError(f"samples for {name} without a # TYPE header")
        if f["type"] == "histogram":
            kinds = {n.rsplit("_", 1)[-1] for n, _, _ in f["samples"]
                     if n != name}
            if f["samples"] and not {"sum", "count"} <= kinds:
                raise ValueError(f"histogram {name} missing _sum/_count")
    return families


def iter_samples(text: str) -> Iterable[Tuple[str, Dict[str, str], float]]:
    for f in parse_exposition(text).values():
        yield from f["samples"]
