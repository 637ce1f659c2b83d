"""Run-scoped metrics registry: labeled counters, gauges, histograms, and
StatCounter-compatible summaries, plus a Prometheus-style text exposition.

The JAX package's ``obs/metrics.py``, copied: the same operations render the
same Prometheus text in both packages. The reference shipped typed telemetry
(PhotonOptimizationLogEvent carrying per-coordinate StatCounters); this
registry is that machine-readable layer. Everything here is plain host
Python state: recording a metric never touches a device tensor. Callers
that want to record DEVICE values must fetch them first and should gate
that fetch on ``obs.active()``: the fetch, not the recording, waits for the
card.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")

# Prometheus default buckets, in seconds — most of our histograms are times
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
)


def sanitize_metric_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _format_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_LABEL_RE.sub("_", k)}="{_escape_label_value(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class _Child:
    """One labeled series of a family; all mutation goes through the
    registry-wide lock (metrics are recorded from the training thread and
    read from sinks/summaries, possibly on other threads)."""

    def __init__(self, lock: threading.RLock, labels: Dict[str, str]):
        self._lock = lock
        self.labels_dict = labels


class Counter(_Child):
    def __init__(self, lock, labels):
        super().__init__(lock, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += float(amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    def __init__(self, lock, labels):
        super().__init__(lock, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += float(amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    def __init__(self, lock, labels, buckets: Tuple[float, ...]):
        super().__init__(lock, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            # store per-bucket counts; snapshot() cumulates for exposition
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self._counts[i] += 1
                    break

    def snapshot(self) -> Dict:
        with self._lock:
            cum, total = [], 0
            for le, c in zip(self.buckets, self._counts):
                total += c
                cum.append([le, total])
            return {"count": self._count, "sum": self._sum, "buckets": cum}


class Summary(_Child):
    """StatCounter-compatible moments: count/mean/stdev(population)/max/min.
    Accepts both raw observations and pre-aggregated StatCounter merges (the
    random-effect trackers aggregate [E] entity solves on device; merging
    their StatCounter avoids re-fetching the raw array)."""

    def __init__(self, lock, labels):
        super().__init__(lock, labels)
        self._count = 0
        self._sum = 0.0
        self._sumsq = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        self.merge_stat(1, float(value), 0.0, float(value), float(value))

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(float(v))

    def merge_stat(
        self, count: int, mean: float, stdev: float, max_v: float, min_v: float
    ) -> None:
        if count <= 0:
            return
        with self._lock:
            self._count += int(count)
            self._sum += count * mean
            # population variance: E[x^2] = stdev^2 + mean^2
            self._sumsq += count * (stdev * stdev + mean * mean)
            self._min = min(self._min, float(min_v))
            self._max = max(self._max, float(max_v))

    def stat(self) -> Dict[str, float]:
        """StatCounter-shaped dict (count/mean/stdev/max/min)."""
        with self._lock:
            if self._count == 0:
                return {"count": 0, "mean": 0.0, "stdev": 0.0, "max": 0.0, "min": 0.0}
            mean = self._sum / self._count
            var = max(self._sumsq / self._count - mean * mean, 0.0)
            return {
                "count": self._count,
                "mean": mean,
                "stdev": math.sqrt(var),
                "max": self._max,
                "min": self._min,
            }


class _Family:
    kind = "untyped"
    child_cls = _Child

    def __init__(self, lock: threading.RLock, name: str, help: str):
        self._lock = lock
        self.name = name
        self.help = help
        self._children: Dict[Tuple[Tuple[str, str], ...], _Child] = {}

    def labels(self, **labels) -> _Child:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child(dict(key))
                self._children[key] = child
            return child

    def _new_child(self, labels: Dict[str, str]) -> _Child:
        return self.child_cls(self._lock, labels)

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())


class CounterFamily(_Family):
    kind = "counter"
    child_cls = Counter

    # an unlabelled family acts as its default (no-label) child, matching the
    # prometheus-client convention
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)


class GaugeFamily(_Family):
    kind = "gauge"
    child_cls = Gauge

    def set(self, value: float) -> None:
        self.labels().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)


class HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, lock, name, help, buckets: Tuple[float, ...]):
        super().__init__(lock, name, help)
        self.buckets = buckets

    def _new_child(self, labels):
        return Histogram(self._lock, labels, self.buckets)

    def observe(self, value: float) -> None:
        self.labels().observe(value)


class SummaryFamily(_Family):
    kind = "summary"
    child_cls = Summary

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def observe_many(self, values: Iterable[float]) -> None:
        self.labels().observe_many(values)

    def merge_stat(
        self, count: int, mean: float, stdev: float, max_v: float, min_v: float
    ) -> None:
        self.labels().merge_stat(count, mean, stdev, max_v, min_v)

    def stat(self) -> Dict[str, float]:
        return self.labels().stat()


class MetricsRegistry:
    """Thread-safe family registry. Families are created on first use and
    keyed by (sanitized) name; re-requesting a name with a different kind is
    an error (the registry is the schema)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name, help, cls, **kwargs) -> _Family:
        name = sanitize_metric_name(name)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (
                    cls(self._lock, name, help, **kwargs)
                    if kwargs
                    else cls(self._lock, name, help)
                )
                self._families[name] = fam
            elif not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {cls.kind}"
                )
            return fam

    def counter(self, name: str, help: str = "") -> CounterFamily:
        return self._family(name, help, CounterFamily)

    def gauge(self, name: str, help: str = "") -> GaugeFamily:
        return self._family(name, help, GaugeFamily)

    def histogram(
        self, name: str, help: str = "", buckets: Tuple[float, ...] = DEFAULT_BUCKETS
    ) -> HistogramFamily:
        return self._family(name, help, HistogramFamily, buckets=tuple(buckets))

    def summary(self, name: str, help: str = "") -> SummaryFamily:
        return self._family(name, help, SummaryFamily)

    def snapshot(self) -> List[Dict]:
        """Point-in-time view of every series as JSON-ready dicts."""
        out: List[Dict] = []
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            for child in fam.children():
                entry = {
                    "name": fam.name,
                    "kind": fam.kind,
                    "help": fam.help,
                    "labels": child.labels_dict,
                }
                if isinstance(child, (Counter, Gauge)):
                    entry["value"] = child.value
                elif isinstance(child, Histogram):
                    entry.update(child.snapshot())
                elif isinstance(child, Summary):
                    st = child.stat()
                    entry["stat"] = st
                    entry["sum"] = st["count"] * st["mean"]
                out.append(entry)
        return out

    def to_prometheus(self) -> str:
        return render_prometheus(self.snapshot())


QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


def histogram_quantile(
    buckets: List, count: int, q: float
) -> float:
    """Estimate the ``q``-quantile from cumulative histogram buckets, the
    way PromQL's ``histogram_quantile`` does: find the bucket holding the
    target rank and interpolate linearly inside it (lower bound of the first
    bucket is 0.0). A target landing in the +Inf bucket clamps to the
    highest finite ``le`` — quantiles beyond the ladder are unknowable."""
    if count <= 0 or not buckets:
        return 0.0
    target = q * count
    lo = 0.0
    lo_cum = 0
    for le, cum in buckets:
        if target <= cum:
            in_bucket = cum - lo_cum
            if in_bucket <= 0:
                return float(le)
            frac = (target - lo_cum) / in_bucket
            return float(lo + (le - lo) * frac)
        lo, lo_cum = le, cum
    return float(buckets[-1][0])


def _escape_help(text: str) -> str:
    # HELP text escaping per the exposition format: backslash, then newline
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(snapshot: List[Dict]) -> str:
    """Prometheus text exposition of a registry snapshot. Summaries render
    their moments as suffixed gauges (_mean/_stdev/_min/_max) alongside the
    standard _count/_sum — there are no quantiles to expose. Every histogram
    additionally renders estimated _p50/_p95/_p99 gauges (serving latency,
    stream staging, checkpoint timings) so latency/duration SLOs are readable
    without a PromQL evaluator in front of the textfile."""
    by_name: Dict[str, List[Dict]] = {}
    for entry in snapshot:
        by_name.setdefault(entry["name"], []).append(entry)
    lines: List[str] = []
    for name in sorted(by_name):
        entries = by_name[name]
        kind = entries[0]["kind"]
        help_text = entries[0].get("help", "")
        if help_text:
            lines.append(f"# HELP {name} {_escape_help(help_text)}")
        if kind in ("counter", "gauge"):
            lines.append(f"# TYPE {name} {kind}")
            for e in entries:
                lines.append(f"{name}{_format_labels(e['labels'])} {e['value']:.10g}")
        elif kind == "histogram":
            lines.append(f"# TYPE {name} histogram")
            for e in entries:
                for le, cum in e["buckets"]:
                    labels = dict(e["labels"], le=f"{le:g}")
                    lines.append(f"{name}_bucket{_format_labels(labels)} {cum}")
                inf_labels = dict(e["labels"], le="+Inf")
                lines.append(f"{name}_bucket{_format_labels(inf_labels)} {e['count']}")
                lines.append(f"{name}_sum{_format_labels(e['labels'])} {e['sum']:.10g}")
                lines.append(f"{name}_count{_format_labels(e['labels'])} {e['count']}")
            for q in QUANTILES:
                suffix = f"p{int(q * 100)}"
                lines.append(f"# TYPE {name}_{suffix} gauge")
                for e in entries:
                    v = histogram_quantile(e["buckets"], e["count"], q)
                    lab = _format_labels(e["labels"])
                    lines.append(f"{name}_{suffix}{lab} {v:.10g}")
        elif kind == "summary":
            lines.append(f"# TYPE {name} summary")
            for e in entries:
                st = e["stat"]
                lab = _format_labels(e["labels"])
                lines.append(f"{name}_sum{lab} {e['sum']:.10g}")
                lines.append(f"{name}_count{lab} {st['count']}")
            for suffix in ("mean", "stdev", "min", "max"):
                lines.append(f"# TYPE {name}_{suffix} gauge")
                for e in entries:
                    lab = _format_labels(e["labels"])
                    lines.append(f"{name}_{suffix}{lab} {e['stat'][suffix]:.10g}")
    return "\n".join(lines) + ("\n" if lines else "")
