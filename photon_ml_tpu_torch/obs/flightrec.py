"""Anomaly-triggered flight recorder: a bounded ring of recent telemetry
that dumps a postmortem JSON when something goes wrong.

The JAX package's ``obs/flightrec.py`` on the port, copied.

Counters tell you *that* a shed storm or solver divergence happened;
reconstructing *what the process was doing around it* from a full JSONL
stream means keeping (and later grepping) everything. The flight recorder
keeps only a bounded ring of recent span/metric events — O(max_events)
memory, no disk traffic in the happy path — and writes one bounded
postmortem file the moment a trigger fires:

- ``shed_spike`` — the scrape-delta shed rate crossed the overload
  threshold (the same sheds/second contract as ``/healthz``'s 503);
- ``solver_divergence`` — ``photon_solver_diverged_lanes_total`` moved;
- ``coordinate_rejection`` — ``photon_coordinate_rejections_total`` moved;
- ``crash`` (or any other name) — an explicit
  :meth:`FlightRecorder.trigger` from a driver's failure path.

Each trigger kind is latched with a cooldown: a sustained storm produces
exactly ONE dump (the postmortem of its onset), not a dump per request.
Dumps are atomic writes (a crash mid-dump never leaves a torn postmortem)
and are counted in ``photon_flightrec_dumps_total{trigger=}``.

The recorder is an :class:`~photon_ml_tpu_torch.utils.events.EventListener`: it
rides the run's event stream (span closes, metric flushes), polls its
trigger conditions at a throttled cadence inside ``handle``, and therefore
needs no thread of its own. Drivers with no event traffic at the moment of
interest call :meth:`poll` or :meth:`trigger` directly.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time
from typing import Deque, Dict, List, Optional

from ..utils.events import EventListener
from .run import MetricsSnapshotEvent, RunTelemetry, current_run
from .tracing import SpanEvent, get_process_index, get_replica_id

_SHED_COUNTER = "photon_serving_shed_total"
_DIVERGED_COUNTER = "photon_solver_diverged_lanes_total"
_REJECTION_COUNTER = "photon_coordinate_rejections_total"


def _counter_total(snapshot: List[dict], name: str) -> float:
    return sum(
        float(m["value"])
        for m in snapshot
        if m.get("name") == name and m.get("kind") == "counter"
    )


class FlightRecorder(EventListener):
    """Bounded ring buffer + trigger latch + postmortem writer.

    ``shed_rate_threshold`` (sheds/second) defaults to the run's
    ``overload_shed_threshold`` StatusBoard entry, so ``cli serve`` wires
    one flag into admission control, the /healthz probe and the recorder
    alike. ``window_s`` bounds the postmortem to the last N seconds of
    events; ``cooldown_s`` is the exactly-one-dump-per-storm latch."""

    def __init__(
        self,
        out_dir: str,
        run: Optional[RunTelemetry] = None,
        window_s: float = 30.0,
        max_events: int = 4096,
        shed_rate_threshold: Optional[float] = None,
        poll_interval_s: float = 0.25,
        cooldown_s: float = 60.0,
    ) -> None:
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._run = run
        self.window_s = float(window_s)
        self.shed_rate_threshold = shed_rate_threshold
        self.poll_interval_s = float(poll_interval_s)
        self.cooldown_s = float(cooldown_s)
        # one lock for ring + trigger state: events arrive from any thread
        # (training thread, batcher worker, HTTP scrape handlers)
        self._lock = threading.Lock()
        self._ring: Deque[dict] = collections.deque(maxlen=int(max_events))
        self._last_poll = 0.0
        # per-kind scrape-delta state and dump latch
        self._counter_state: Dict[str, tuple] = {}
        self._last_dump: Dict[str, float] = {}
        self.dump_paths: List[str] = []

    # -- event ingestion -------------------------------------------------------

    def handle(self, event) -> None:
        rec: Optional[dict] = None
        if isinstance(event, SpanEvent):
            s = event.span
            rec = {
                "type": "span",
                "unix": s.start_unix + (s.duration_s or 0.0),
                "name": s.name,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "duration_s": s.duration_s,
                "thread_id": s.thread_id,
                "attrs": dict(s.attrs),
            }
        elif isinstance(event, MetricsSnapshotEvent):
            rec = {
                "type": "metrics_flush",
                "unix": time.time(),
                "series": len(event.metrics),
            }
        else:
            rec = {
                "type": "event",
                "unix": time.time(),
                "event": type(event).__name__,
            }
        with self._lock:
            self._ring.append(rec)
        self.poll()

    def close(self) -> None:  # ring is memory-only; dumps are already flushed
        pass

    # -- trigger evaluation ----------------------------------------------------

    def _registry(self):
        run = self._run if self._run is not None else current_run()
        return run, run.registry

    def poll(self, force: bool = False) -> Optional[str]:
        """Evaluate trigger conditions against the live registry (throttled
        to ``poll_interval_s`` unless ``force``). Returns the dump path if a
        trigger fired."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_poll < self.poll_interval_s:
                return None
            self._last_poll = now
        run, registry = self._registry()
        snapshot = registry.snapshot()

        shed = _counter_total(snapshot, _SHED_COUNTER)
        threshold = self.shed_rate_threshold
        if threshold is None:
            board = run.status.snapshot().get("overload_shed_threshold")
            threshold = float(board) if board is not None else None
        path = None
        if threshold is not None:
            rate = self._delta_rate("shed", shed, now)
            if rate is not None and rate > threshold:
                path = self.trigger(
                    "shed_spike",
                    f"shed rate {rate:.1f}/s > threshold {threshold:.1f}/s",
                )
        diverged = _counter_total(snapshot, _DIVERGED_COUNTER)
        if self._delta_positive("diverged", diverged):
            path = self.trigger(
                "solver_divergence", f"{int(diverged)} diverged lanes total"
            ) or path
        rejections = _counter_total(snapshot, _REJECTION_COUNTER)
        if self._delta_positive("rejections", rejections):
            path = self.trigger(
                "coordinate_rejection", f"{int(rejections)} rejections total"
            ) or path
        return path

    def _delta_rate(self, key: str, total: float, now: float) -> Optional[float]:
        with self._lock:
            prev = self._counter_state.get(key)
            self._counter_state[key] = (now, total)
        if prev is None or now <= prev[0]:
            return None
        return max(0.0, (total - prev[1]) / (now - prev[0]))

    def _delta_positive(self, key: str, total: float) -> bool:
        with self._lock:
            prev = self._counter_state.get(key)
            self._counter_state[key] = (0.0, total)
        return prev is not None and total > prev[1]

    # -- dumping ---------------------------------------------------------------

    def trigger(self, kind: str, detail: str = "") -> Optional[str]:
        """Fire a trigger by name (the crash-flush path calls this
        directly). Latched per kind: within ``cooldown_s`` of that kind's
        previous dump this is a no-op, so one storm yields one postmortem."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(kind)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_dump[kind] = now
        return self._dump(kind, detail)

    def _dump(self, kind: str, detail: str) -> str:
        from ..robust.atomic import atomic_write_json

        _, registry = self._registry()
        trigger_unix = time.time()
        with self._lock:
            events = [
                dict(r)
                for r in self._ring
                if r.get("unix", 0.0) >= trigger_unix - self.window_s
            ]
            seq = len(self.dump_paths) + 1
        doc = {
            "trigger": {"kind": kind, "detail": detail, "unix_time": trigger_unix},
            "window_seconds": self.window_s,
            "identity": {
                "process_index": get_process_index(),
                "replica": get_replica_id(),
                "host": socket.gethostname(),
            },
            "events": events,
            "metrics": registry.snapshot(),
        }
        path = os.path.join(self.out_dir, f"flight-{kind}-{seq}.json")
        atomic_write_json(path, doc, default=str)
        with self._lock:
            self.dump_paths.append(path)
        registry.counter(
            "photon_flightrec_dumps_total",
            "flight-recorder postmortem dumps written, by trigger",
        ).labels(trigger=kind).inc()
        return path
