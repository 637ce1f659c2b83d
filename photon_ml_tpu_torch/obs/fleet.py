"""Fleet observability plane: cross-process metric aggregation and
multi-process trace stitching.

Every layer below this one is single-process: each training process or
serving replica writes its own ``metrics.jsonl`` and serves its own
``/metrics``. This module is the fleet view — the counterpart of the
Spark UI's executor-aggregated page the reference system leaned on. It is
the JAX package's ``obs/fleet.py`` on the port, copied, so the same inputs
merge to the same documents in both packages:

- :func:`parse_prometheus` — inverse of ``metrics.render_prometheus``:
  reconstructs a registry snapshot from a text exposition, folding the
  derived ``_mean/_stdev/_min/_max`` gauges back into their summary and
  dropping the derived ``_p50/_p95/_p99`` histogram gauges (they are
  re-estimated from the merged buckets);
- :func:`merge_snapshots` — the one merge rule-set: counters summed per
  label-set, gauges kept per-process with ``process=``/``replica=`` labels,
  histograms bucket-merged (de-cumulate, sum, re-cumulate), summaries
  combined through the same population-moment math as
  ``Summary.merge_stat``;
- :func:`load_metrics_jsonl` / :func:`discover_streams` — read per-process
  JSONL streams (final metrics snapshot + every closed span, with the
  per-line process/replica/host header);
- :func:`stitch_spans` — one Chrome-trace/Perfetto document from K
  processes' span streams, aligned on the shared wall clock
  (``start_unix``; per-process ``start_perf`` origins are incomparable),
  one ``pid`` lane per process;
- :class:`FleetAggregator` / :class:`FleetServer` — live-scrape K
  ``/metrics`` endpoints (the per-replica ``IntrospectionServer``\\ s) and
  serve the merged exposition from a small aggregator front the open-loop
  harness can scrape.

Everything here is host Python that touches no card: fleet aggregation
runs in a process with no accelerator runtime at all.
"""

from __future__ import annotations

import dataclasses
import glob
import http.server
import json
import math
import os
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import MetricsRegistry, histogram_quantile, render_prometheus

# suffix gauge families derived by render_prometheus; folded or dropped on
# parse, never merged as first-class series
_HIST_DERIVED = ("_p50", "_p95", "_p99")
_SUMMARY_DERIVED = ("_mean", "_stdev", "_min", "_max")

IDENTITY_METRIC = "photon_build_info"


# -- Prometheus text exposition parsing --------------------------------------


def _unescape_label_value(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ("\\", '"'):
                out.append(nxt)
            else:
                out.append(c)
                out.append(nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_sample(line: str) -> Optional[Tuple[str, Dict[str, str], float]]:
    """One exposition sample line -> (name, labels, value); None if malformed."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    brace = line.find("{")
    labels: Dict[str, str] = {}
    if brace >= 0:
        name = line[:brace]
        i = brace + 1
        while i < len(line) and line[i] != "}":
            eq = line.find("=", i)
            if eq < 0 or eq + 1 >= len(line) or line[eq + 1] != '"':
                return None
            key = line[i:eq].strip().lstrip(",").strip()
            # scan the quoted value, honouring backslash escapes
            j = eq + 2
            raw: List[str] = []
            while j < len(line):
                c = line[j]
                if c == "\\" and j + 1 < len(line):
                    raw.append(line[j : j + 2])
                    j += 2
                    continue
                if c == '"':
                    break
                raw.append(c)
                j += 1
            if j >= len(line):
                return None
            labels[key] = _unescape_label_value("".join(raw))
            i = j + 1
        close = line.find("}", i - 1)
        if close < 0:
            return None
        rest = line[close + 1 :].strip()
    else:
        parts = line.split(None, 1)
        if len(parts) != 2:
            return None
        name, rest = parts
    value_str = rest.split()[0] if rest.split() else None
    if value_str is None:
        return None
    try:
        value = float(value_str)
    except ValueError:
        return None
    return name, labels, value


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def parse_prometheus(text: str) -> List[Dict]:
    """Parse a Prometheus text exposition back into a registry snapshot
    (the ``MetricsRegistry.snapshot()`` schema), so a scraped ``/metrics``
    page merges exactly like a ``metrics.jsonl`` snapshot.

    Histogram ``_bucket/_sum/_count`` series are re-assembled into one
    histogram entry per label-set; the derived quantile gauges a photon
    exposition appends (``_p50/_p95/_p99``) are dropped (recomputed from
    merged buckets) and the summary moment gauges
    (``_mean/_stdev/_min/_max``) are folded back into the summary's stat."""
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("# TYPE "):
            parts = stripped.split()
            if len(parts) >= 4:
                kinds[parts[2]] = parts[3]
            continue
        if stripped.startswith("# HELP "):
            parts = stripped.split(None, 3)
            if len(parts) >= 4:
                helps[parts[2]] = parts[3]
            continue
        parsed = _parse_sample(stripped)
        if parsed is not None:
            samples.append(parsed)

    hist_names = {n for n, k in kinds.items() if k == "histogram"}
    summary_names = {n for n, k in kinds.items() if k == "summary"}
    # derived gauge families render_prometheus appends after a histogram /
    # summary; consumed below, never surfaced as independent gauges
    derived_hist = {f"{n}{s}" for n in hist_names for s in _HIST_DERIVED}
    derived_summary = {f"{n}{s}" for n in summary_names for s in _SUMMARY_DERIVED}

    # sample-name -> owning base family for multi-sample kinds
    hist_parts: Dict[str, Dict[Tuple, Dict]] = {n: {} for n in hist_names}
    summary_parts: Dict[str, Dict[Tuple, Dict]] = {n: {} for n in summary_names}
    scalars: List[Tuple[str, Dict[str, str], float]] = []

    def _owner(name: str, names: set, suffixes: Tuple[str, ...]) -> Optional[str]:
        for suffix in suffixes:
            if name.endswith(suffix) and name[: -len(suffix)] in names:
                return name[: -len(suffix)]
        return None

    for name, labels, value in samples:
        h = _owner(name, hist_names, ("_bucket", "_sum", "_count"))
        if h is not None:
            key = _label_key({k: v for k, v in labels.items() if k != "le"})
            part = hist_parts[h].setdefault(
                key,
                {"labels": {k: v for k, v in labels.items() if k != "le"},
                 "buckets": {}, "count": 0, "sum": 0.0},
            )
            if name.endswith("_bucket"):
                le = labels.get("le", "")
                if le != "+Inf":
                    part["buckets"][float(le)] = value
            elif name.endswith("_sum"):
                part["sum"] = value
            else:
                part["count"] = int(value)
            continue
        s = _owner(name, summary_names, ("_sum", "_count"))
        if s is not None:
            key = _label_key(labels)
            part = summary_parts[s].setdefault(
                key, {"labels": dict(labels), "sum": 0.0, "count": 0, "stat": {}}
            )
            if name.endswith("_sum"):
                part["sum"] = value
            else:
                part["count"] = int(value)
            continue
        m = _owner(name, summary_names, _SUMMARY_DERIVED)
        if m is not None and name in derived_summary:
            key = _label_key(labels)
            part = summary_parts[m].setdefault(
                key, {"labels": dict(labels), "sum": 0.0, "count": 0, "stat": {}}
            )
            part["stat"][name[len(m) + 1 :]] = value
            continue
        if name in derived_hist:
            continue
        scalars.append((name, labels, value))

    out: List[Dict] = []
    for name, labels, value in scalars:
        kind = kinds.get(name, "gauge")
        if kind not in ("counter", "gauge"):
            continue
        out.append(
            {"name": name, "kind": kind, "help": helps.get(name, ""),
             "labels": labels, "value": value}
        )
    for name, parts in hist_parts.items():
        for part in parts.values():
            buckets = [
                [le, int(cum)] for le, cum in sorted(part["buckets"].items())
            ]
            out.append(
                {"name": name, "kind": "histogram", "help": helps.get(name, ""),
                 "labels": part["labels"], "count": part["count"],
                 "sum": part["sum"], "buckets": buckets}
            )
    for name, parts in summary_parts.items():
        for part in parts.values():
            st = part["stat"]
            out.append(
                {"name": name, "kind": "summary", "help": helps.get(name, ""),
                 "labels": part["labels"],
                 "stat": {
                     "count": part["count"],
                     "mean": st.get("mean", (part["sum"] / part["count"]) if part["count"] else 0.0),
                     "stdev": st.get("stdev", 0.0),
                     "max": st.get("max", 0.0),
                     "min": st.get("min", 0.0),
                 },
                 "sum": part["sum"]}
            )
    return out


# -- snapshot merging ---------------------------------------------------------


def identity_labels(snapshot: Sequence[Dict], fallback_process: str) -> Dict[str, str]:
    """Process/replica identity of one snapshot, read from its
    ``photon_build_info`` gauge; ``fallback_process`` covers streams from
    builds that predate the gauge."""
    for e in snapshot:
        if e.get("name") == IDENTITY_METRIC and e.get("kind") == "gauge":
            labels = e.get("labels", {})
            out = {"process": str(labels.get("process", fallback_process))}
            if labels.get("replica"):
                out["replica"] = str(labels["replica"])
            return out
    return {"process": str(fallback_process)}


def merge_snapshots(
    sources: Sequence[Tuple[Dict[str, str], Sequence[Dict]]]
) -> List[Dict]:
    """Merge K per-process registry snapshots into one fleet snapshot.

    ``sources`` is ``[(identity, snapshot), ...]`` where identity is the
    label set stamped onto per-process series (``process=``, ``replica=``).
    Counters are summed per (name, label-set) — the fleet total of a counter
    is exactly the sum of its per-process values. Gauges are NOT summed
    (a queue depth or RSS watermark summed across processes is a lie): each
    keeps its value under its identity labels. Histograms merge bucket-wise
    (same family => same ladder; disjoint ladders union cleanly because the
    per-bucket counts are de-cumulated first). Summaries merge through the
    same population-moment identity as ``Summary.merge_stat``:
    ``E[x^2] = stdev^2 + mean^2``."""
    counters: Dict[Tuple, Dict] = {}
    gauges: Dict[Tuple, Dict] = {}
    hists: Dict[Tuple, Dict] = {}
    summaries: Dict[Tuple, Dict] = {}
    for identity, snapshot in sources:
        extra = {str(k): str(v) for k, v in (identity or {}).items() if v}
        for e in snapshot:
            kind = e.get("kind")
            name = e["name"]
            labels = dict(e.get("labels", {}))
            if kind == "counter":
                key = (name, _label_key(labels))
                cur = counters.get(key)
                if cur is None:
                    counters[key] = {
                        "name": name, "kind": "counter",
                        "help": e.get("help", ""), "labels": labels,
                        "value": float(e["value"]),
                    }
                else:
                    cur["value"] += float(e["value"])
            elif kind == "gauge":
                labels.update(extra)
                key = (name, _label_key(labels))
                gauges[key] = {
                    "name": name, "kind": "gauge", "help": e.get("help", ""),
                    "labels": labels, "value": float(e["value"]),
                }
            elif kind == "histogram":
                key = (name, _label_key(labels))
                per: Dict[float, int] = {}
                prev = 0
                for le, cum in e.get("buckets", []):
                    per[float(le)] = int(cum) - prev
                    prev = int(cum)
                cur = hists.get(key)
                if cur is None:
                    hists[key] = {
                        "name": name, "help": e.get("help", ""),
                        "labels": labels, "count": int(e.get("count", 0)),
                        "sum": float(e.get("sum", 0.0)), "per": per,
                    }
                else:
                    cur["count"] += int(e.get("count", 0))
                    cur["sum"] += float(e.get("sum", 0.0))
                    for le, c in per.items():
                        cur["per"][le] = cur["per"].get(le, 0) + c
            elif kind == "summary":
                st = e.get("stat", {})
                count = int(st.get("count", 0))
                mean = float(st.get("mean", 0.0))
                stdev = float(st.get("stdev", 0.0))
                key = (name, _label_key(labels))
                cur = summaries.get(key)
                if cur is None:
                    cur = summaries[key] = {
                        "name": name, "help": e.get("help", ""),
                        "labels": labels, "count": 0, "sum": 0.0,
                        "sumsq": 0.0, "min": math.inf, "max": -math.inf,
                    }
                if count > 0:
                    cur["count"] += count
                    cur["sum"] += count * mean
                    cur["sumsq"] += count * (stdev * stdev + mean * mean)
                    cur["min"] = min(cur["min"], float(st.get("min", mean)))
                    cur["max"] = max(cur["max"], float(st.get("max", mean)))

    out: List[Dict] = list(counters.values()) + list(gauges.values())
    for h in hists.values():
        cum_total = 0
        buckets: List[List] = []
        for le in sorted(h["per"]):
            cum_total += h["per"][le]
            buckets.append([le, cum_total])
        out.append(
            {"name": h["name"], "kind": "histogram", "help": h["help"],
             "labels": h["labels"], "count": h["count"], "sum": h["sum"],
             "buckets": buckets}
        )
    for s in summaries.values():
        if s["count"] > 0:
            mean = s["sum"] / s["count"]
            var = max(s["sumsq"] / s["count"] - mean * mean, 0.0)
            stat = {"count": s["count"], "mean": mean,
                    "stdev": math.sqrt(var), "max": s["max"], "min": s["min"]}
        else:
            stat = {"count": 0, "mean": 0.0, "stdev": 0.0, "max": 0.0, "min": 0.0}
        out.append(
            {"name": s["name"], "kind": "summary", "help": s["help"],
             "labels": s["labels"], "stat": stat, "sum": s["sum"]}
        )
    return out


# -- per-process JSONL stream loading ----------------------------------------


@dataclasses.dataclass
class ProcessStream:
    """One process's telemetry stream: its final metrics snapshot plus every
    span line, with the per-line identity header."""

    source: str
    process_index: int = 0
    replica: Optional[str] = None
    host: Optional[str] = None
    snapshot: List[Dict] = dataclasses.field(default_factory=list)
    spans: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def identity(self) -> Dict[str, str]:
        out = {"process": str(self.process_index)}
        if self.replica:
            out["replica"] = str(self.replica)
        return out


def load_metrics_jsonl(path: str) -> ProcessStream:
    """Read one ``metrics.jsonl`` stream: the LAST metrics snapshot (each
    flush supersedes the previous — registry snapshots are cumulative) and
    every span line. Torn trailing lines (crash mid-write) are skipped."""
    stream = ProcessStream(source=path)
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                continue  # torn tail of a crashed writer: by design loses
                # at most the line in flight
            if not isinstance(doc, dict):
                continue
            if "process_index" in doc:
                stream.process_index = int(doc["process_index"])
            if doc.get("replica"):
                stream.replica = str(doc["replica"])
            if doc.get("host"):
                stream.host = str(doc["host"])
            if doc.get("type") == "metrics":
                stream.snapshot = list(doc.get("metrics", []))
            elif doc.get("type") == "span":
                stream.spans.append(doc)
    return stream


def discover_streams(paths: Sequence[str]) -> List[ProcessStream]:
    """Resolve CLI path arguments into streams: a ``.jsonl`` file loads
    directly; a directory contributes every ``metrics*.jsonl`` inside it
    (the per-process file layout ``cli train`` writes)."""
    streams: List[ProcessStream] = []
    for path in paths:
        if os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "metrics*.jsonl")))
        else:
            files = [path]
        for f in files:
            streams.append(load_metrics_jsonl(f))
    return streams


# -- trace stitching ----------------------------------------------------------


def stitch_spans(streams: Sequence[ProcessStream]) -> dict:
    """One Chrome-trace document from K processes' span streams.

    Per-process chrome traces align on ``start_perf`` — a monotonic clock
    whose origin differs per process, so it CANNOT order events across
    processes. Stitching therefore aligns on ``start_unix`` (one shared wall
    clock per host), rebased to the earliest span so Perfetto renders from
    t=0. One ``pid`` lane per process index, ``tid`` sub-lanes per OS
    thread, every span's identity/attrs preserved under ``args``."""
    all_spans: List[Tuple[ProcessStream, Dict]] = [
        (stream, s) for stream in streams for s in stream.spans
    ]
    t0 = min(
        (float(s.get("start_unix", 0.0)) for _, s in all_spans), default=0.0
    )
    events: List[dict] = []
    lanes: Dict[int, Dict[str, object]] = {}
    for stream, s in all_spans:
        pid = int(s.get("process_index", stream.process_index))
        tid = int(s.get("thread_id", 0))
        events.append(
            {
                "name": s.get("name", "?"),
                "ph": "X",
                "ts": (float(s.get("start_unix", t0)) - t0) * 1e6,
                "dur": float(s.get("duration_s") or 0.0) * 1e6,
                "pid": pid,
                "tid": tid,
                "cat": "photon",
                "args": {
                    "span_id": s.get("span_id"),
                    "parent_id": s.get("parent_id"),
                    **(s.get("attrs") or {}),
                },
            }
        )
        lane = lanes.setdefault(pid, {"tids": set(), "stream": stream})
        lane["tids"].add(tid)
    events.sort(key=lambda e: e["ts"])
    meta: List[dict] = []
    for pid in sorted(lanes):
        stream = lanes[pid]["stream"]
        label = f"photon process {pid}"
        if stream.replica:
            label += f" replica={stream.replica}"
        if stream.host:
            label += f" ({stream.host})"
        meta.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": label}}
        )
        for tid in sorted(lanes[pid]["tids"]):
            meta.append(
                {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                 "args": {"name": f"thread {tid}"}}
            )
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "epoch_unix": t0,
            "processes": sorted(lanes),
            "sources": [s.source for s in streams],
        },
    }


# -- live aggregation front ---------------------------------------------------


def _sum_counter(snapshot: Sequence[Dict], name: str) -> float:
    return sum(
        float(m["value"])
        for m in snapshot
        if m.get("name") == name and m.get("kind") == "counter"
    )


class FleetAggregator:
    """Merge K sources (live ``/metrics`` scrapes and/or loaded JSONL
    streams) into one fleet snapshot, with its own ``photon_fleet_*``
    meta-metrics appended so the aggregator is observable too."""

    def __init__(self, targets: Sequence[str] = (), timeout_s: float = 2.0):
        self.targets = [t.rstrip("/") for t in targets]
        self.timeout_s = float(timeout_s)
        self.registry = MetricsRegistry()
        # guards the source list: scrapes land from the front's HTTP
        # threads while merged_snapshot() reads on the caller's
        self._lock = threading.Lock()
        self._scraped: List[Tuple[Dict[str, str], List[Dict]]] = []
        self._files: List[Tuple[Dict[str, str], List[Dict]]] = []
        self.registry.gauge(
            "photon_fleet_targets", "scrape targets configured"
        ).set(len(self.targets))

    def add_streams(self, streams: Sequence[ProcessStream]) -> None:
        """Attach loaded JSONL streams as merge sources (file mode)."""
        sources = [(s.identity, s.snapshot) for s in streams if s.snapshot]
        with self._lock:
            self._files.extend(sources)

    def scrape_once(self) -> int:
        """Scrape every target's ``/metrics`` once; returns how many were
        up. A down replica is counted (``photon_fleet_scrape_errors_total``)
        and skipped — fleet aggregation degrades, never fails."""
        scraped: List[Tuple[Dict[str, str], List[Dict]]] = []
        for i, target in enumerate(self.targets):
            url = target if target.endswith("/metrics") else target + "/metrics"
            try:
                with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                    text = resp.read().decode("utf-8")
            # photon: ignore[R4] — a down replica must not take down the
            # fleet view; the miss is counted per-target below
            except Exception:
                self.registry.counter(
                    "photon_fleet_scrape_errors_total",
                    "failed /metrics scrapes, by target",
                ).labels(target=target).inc()
                continue
            snapshot = parse_prometheus(text)
            scraped.append((identity_labels(snapshot, str(i)), snapshot))
            self.registry.counter(
                "photon_fleet_scrapes_total",
                "successful /metrics scrapes, by target",
            ).labels(target=target).inc()
        with self._lock:
            self._scraped = scraped
        self.registry.gauge(
            "photon_fleet_processes_up",
            "targets that answered the most recent scrape",
        ).set(len(scraped))
        return len(scraped)

    def sources(self) -> List[Tuple[Dict[str, str], List[Dict]]]:
        with self._lock:
            return list(self._files) + list(self._scraped)

    def merged_snapshot(self) -> List[Dict]:
        sources = self.sources()
        merged = merge_snapshots(sources)
        self.registry.gauge(
            "photon_fleet_processes", "processes contributing to the merge"
        ).set(len(sources))
        self.registry.gauge(
            "photon_fleet_merged_series", "series in the merged exposition"
        ).set(len(merged))
        return merged + self.registry.snapshot()

    def render(self) -> str:
        return render_prometheus(self.merged_snapshot())

    def statusz(self) -> dict:
        """The fleet section of /statusz: who is contributing, and the
        fleet-level serving/training totals derived from the merge."""
        sources = self.sources()
        merged = merge_snapshots(sources)
        doc: dict = {
            "status": "ok",
            "unix_time": time.time(),
            "fleet": {
                "targets": list(self.targets),
                "processes": [identity for identity, _ in sources],
                "processes_up": len(sources),
            },
        }
        serving: dict = {}
        offered = _sum_counter(merged, "photon_serving_offered_total")
        if offered:
            serving["offered_total"] = int(offered)
            serving["requests_total"] = int(
                _sum_counter(merged, "photon_serving_requests_total")
            )
            serving["shed_total"] = int(
                _sum_counter(merged, "photon_serving_shed_total")
            )
        for m in merged:
            if (
                m["name"] == "photon_serving_request_latency_seconds"
                and m["kind"] == "histogram"
            ):
                for q in (0.5, 0.95, 0.99):
                    serving[f"latency_p{int(q * 100)}_seconds"] = (
                        histogram_quantile(m["buckets"], m["count"], q)
                    )
                break
        if serving:
            doc["fleet"]["serving"] = serving
        slices = _sum_counter(merged, "photon_stream_slices_total")
        if slices:
            doc["fleet"]["stream"] = {"slices_staged": int(slices)}
        return doc


class FleetServer:
    """Threaded HTTP front for a :class:`FleetAggregator`: ``/metrics``
    re-scrapes the targets and serves the merged exposition, ``/statusz``
    the fleet JSON, ``/healthz`` liveness with the up-count. ``port=0``
    binds an ephemeral port (``.port``). Mirrors ``IntrospectionServer``."""

    def __init__(
        self,
        aggregator: FleetAggregator,
        port: int = 0,
        host: str = "127.0.0.1",
        scrape_on_get: bool = True,
    ) -> None:
        self.aggregator = aggregator
        self.scrape_on_get = bool(scrape_on_get)
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = server._render_metrics().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/statusz":
                    if server.scrape_on_get and server.aggregator.targets:
                        server.aggregator.scrape_once()
                    body = json.dumps(
                        server.aggregator.statusz(), default=str, sort_keys=True
                    ).encode("utf-8")
                    ctype = "application/json"
                elif path == "/healthz":
                    up = (
                        server.aggregator.scrape_once()
                        if server.aggregator.targets
                        else len(server.aggregator.sources())
                    )
                    body = json.dumps(
                        {"status": "ok", "processes_up": up}
                    ).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404, "unknown endpoint")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args) -> None:  # quiet by design
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"photon-fleet-{self.port}",
            daemon=True,
        )
        self._thread.start()

    def _render_metrics(self) -> str:
        if self.scrape_on_get and self.aggregator.targets:
            self.aggregator.scrape_once()
        return self.aggregator.render()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
