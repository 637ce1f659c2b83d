"""Telemetry sinks, implemented as `EventListener`s so the existing
`EventEmitter` error-swallowing semantics protect training: a sink that
raises is logged and ignored, never propagated into the training loop.

- ``JsonlSink``: one JSON line per event (span close, metrics flush,
  estimator lifecycle event), appended line-buffered and explicitly flushed
  per line so a crash loses at most the line in flight; ``fsync=True``
  additionally fsyncs on every metrics flush (durable at MetricsSnapshot
  granularity — per-line fsync would throttle span-heavy runs).
- ``PrometheusSink``: rewrites a text-exposition file atomically on every
  metrics flush (robust.atomic); the file always holds the latest complete
  snapshot.

A sink whose write raises counts the event in
``photon_sink_dropped_events_total{sink=}`` before the error propagates to
the emitter's swallow layer, so silently-lossy telemetry shows up in the run
summary instead of nowhere.

Serialization is fetch-free by construction: event payloads are walked
shallowly (no ``dataclasses.asdict`` recursion, which would deep-copy the
device tensors inside tracker/solver results) and any non-JSON value renders
as a ``<TypeName>`` placeholder instead of ``str(value)``.

The JAX package's ``obs/sinks.py`` on the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
from typing import Optional

from ..robust.atomic import atomic_write
from ..utils.events import EventListener
from .metrics import render_prometheus
from .run import MetricsSnapshotEvent
from .tracing import SpanEvent, get_process_index, get_replica_id

_HOSTNAME = socket.gethostname()


def _json_placeholder(obj) -> str:
    return f"<{type(obj).__name__}>"


def _count_dropped(sink: str) -> None:
    # lazy import (obs.run imports this module's siblings); never raises —
    # the original write error is the one the caller should see
    try:
        from . import current_run

        current_run().registry.counter(
            "photon_sink_dropped_events_total",
            "telemetry events a sink failed to write, by sink",
        ).labels(sink=sink).inc()
    # counting must not mask the original write error, and routing through
    # obs.swallowed_error here could recurse into the very registry lookup
    # that failed
    except Exception:  # pragma: no cover
        pass


class JsonlSink(EventListener):
    """Crash-safe JSONL event/metric writer (line-buffered append +
    explicit per-line flush, optional fsync at metrics-flush granularity)."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        # buffering=1: line-buffered, so even a write the explicit flush
        # below never reaches (e.g. an exception between write and flush)
        # hits the OS at the newline
        # append-only JSONL stream: atomic-rename semantics would overwrite
        # earlier lines of the same run, so a direct open() is correct here
        self._f: Optional[object] = open(path, "a", buffering=1, encoding="utf-8")

    def handle(self, event) -> None:
        payload = self._payload(event)
        line = json.dumps(payload, default=_json_placeholder)
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(line + "\n")
                self._f.flush()
                if self.fsync and isinstance(event, MetricsSnapshotEvent):
                    os.fsync(self._f.fileno())
            except OSError:
                _count_dropped("jsonl")
                raise

    @staticmethod
    def _payload(event) -> dict:
        # every line carries host/process identity so JSONL streams from a
        # multi-process run can be merged and stay attributable; read at
        # write time
        header = {"process_index": get_process_index(), "host": _HOSTNAME}
        replica = get_replica_id()
        if replica is not None:
            header["replica"] = replica
        if isinstance(event, SpanEvent):
            s = event.span
            return {
                "type": "span",
                **header,
                "name": s.name,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "start_unix": s.start_unix,
                "duration_s": s.duration_s,
                "thread_id": s.thread_id,
                "attrs": s.attrs,
            }
        if isinstance(event, MetricsSnapshotEvent):
            return {"type": "metrics", **header, "metrics": event.metrics}
        body = {}
        if dataclasses.is_dataclass(event):
            # shallow on purpose: OptimizationLogEvent holds trackers whose
            # solver results are device tensors — recursing would fetch them
            for f in dataclasses.fields(event):
                body[f.name] = getattr(event, f.name)
        return {"type": "event", **header, "event": type(event).__name__, **body}

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class PrometheusSink(EventListener):
    """Prometheus text-exposition dump, atomically rewritten per flush."""

    def __init__(self, path: str):
        self.path = path

    def handle(self, event) -> None:
        if not isinstance(event, MetricsSnapshotEvent):
            return
        text = render_prometheus(event.metrics)
        try:
            # temp + fsync + rename (robust.atomic): scrapers never see a
            # partially-rewritten exposition file
            with atomic_write(self.path, "w", encoding="utf-8") as f:
                f.write(text)
        except OSError:
            _count_dropped("prometheus")
            raise

    def close(self) -> None:
        pass
