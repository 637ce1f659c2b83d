"""Run-scoped telemetry: one ``RunTelemetry`` per training run, owning the
metrics registry and the sink listeners.

The JAX package's ``obs/run.py`` on the port. A module-global "current run"
gives instrumentation sites (descent loop, solvers, readers) something to
record into without threading a handle through every call. The default
current run is PASSIVE (a registry, no listeners), so instrumented code can
always record cheap host-known numbers, while anything that needs a device
fetch gates on ``active()``: with no sink registered the coordinate-descent
loop makes no fetch for telemetry. The run's ``StatusBoard`` feeds the
``/statusz`` endpoint of ``obs/http.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

from ..utils.events import Event, EventEmitter
from .metrics import MetricsRegistry


class StatusBoard:
    """Thread-safe key/value board holding the run's *current position*
    (the live snapshot, a refresh in flight, the overload threshold, ...)
    for the ``/statusz`` endpoint.

    Updates are cheap host-only dict writes, so instrumentation sites update
    it unconditionally (passive runs too), and a scrape thread can snapshot
    it while the serving threads move on."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._state: Dict[str, object] = {}

    def update(self, **kv) -> None:
        with self._lock:
            self._state.update(kv)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._state)


@dataclasses.dataclass(frozen=True)
class MetricsSnapshotEvent(Event):
    """A point-in-time registry snapshot (list of JSON-ready series dicts),
    emitted on every ``flush_metrics`` (per CD sweep and at close)."""

    metrics: List[dict]


class RunTelemetry(EventEmitter):
    """EventEmitter + MetricsRegistry for one training run. Sinks register
    as listeners; ``send_event`` inherits EventEmitter's error swallowing,
    so a raising sink can never fail training."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        super().__init__()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.status = StatusBoard()

    def flush_metrics(self) -> List[dict]:
        snap = self.registry.snapshot()
        self.send_event(MetricsSnapshotEvent(metrics=snap))
        return snap

    def close(self) -> None:
        if self.has_listeners():
            self.flush_metrics()
        self.clear_listeners()


# guards _current: worker threads (a reader's pool, the refresh watcher,
# batcher workers, HTTP scrape handlers) record into it while use_run swaps
# it on the driving thread
_current_lock = threading.Lock()
_current = RunTelemetry()


def current_run() -> RunTelemetry:
    with _current_lock:
        return _current


def set_current_run(run: Optional[RunTelemetry]) -> RunTelemetry:
    """Install ``run`` as the current telemetry scope (None installs a fresh
    passive one) and return the previous scope so callers can restore it."""
    global _current
    with _current_lock:
        prev = _current
        _current = run if run is not None else RunTelemetry()
    return prev


@contextlib.contextmanager
def use_run(run: RunTelemetry):
    prev = set_current_run(run)
    try:
        yield run
    finally:
        set_current_run(prev)


def active() -> bool:
    """True when some sink is listening, i.e. when it is worth paying for
    device fetches to feed the telemetry."""
    return current_run().has_listeners()


def swallowed_error(site: str) -> None:
    """Count a deliberately swallowed exception so degraded-mode operation
    is visible in the metrics (``photon_swallowed_errors_total{site=}``).
    Cheap host-only registry work, safe in any handler."""
    current_run().registry.counter(
        "photon_swallowed_errors_total",
        "exceptions swallowed by degrade-and-continue handlers",
    ).labels(site=site).inc()


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def record_solver_metrics(solver: str, result) -> None:
    """Record iterations / convergence reasons / line-search failures /
    final gradient norms of a one-problem solve (the fixed effect's).

    No-op when no sink is registered: the fetch below would wait for the
    card for nothing. The JAX package also skips solves whose results are
    traced values (its random-effect solves run inside ``jit``); the port
    traces nothing, and its solvers call this for one-problem solves only,
    the random effect's being covered by the trackers."""
    run = current_run()
    if not run.has_listeners():
        return
    from ..optimize.common import ConvergenceReason
    from .tracing import add_device_fetch_bytes

    iters = _host(result.iterations)
    reasons = _host(result.reason)
    grad = _host(result.gradient).astype(np.float64)
    add_device_fetch_bytes(f"solver.{solver}", iters.nbytes + reasons.nbytes + grad.nbytes)

    reg = run.registry
    reg.summary(
        "photon_solver_iterations", "iterations per host-level solve"
    ).labels(solver=solver).observe_many(iters.ravel().tolist())
    reason_counter = reg.counter(
        "photon_solver_convergence_reason_total",
        "host-level solves by termination reason",
    )
    uniq, counts = np.unique(reasons.ravel(), return_counts=True)
    for u, c in zip(uniq.tolist(), counts.tolist()):
        reason_counter.labels(solver=solver, reason=ConvergenceReason(int(u)).name).inc(c)
        if int(u) == int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING):
            # the objective stops improving only when the line search /
            # trust-region step finds no descent
            reg.counter(
                "photon_solver_line_search_failures_total",
                "solves terminated because no improving step was found",
            ).labels(solver=solver).inc(c)
        elif int(u) == int(ConvergenceReason.NUMERICAL_DIVERGENCE):
            reg.counter(
                "photon_solver_diverged_lanes_total",
                "solver lanes frozen at their last good iterate after a "
                "non-finite loss/gradient",
            ).labels(solver=solver).inc(c)
    gn = np.sqrt((grad * grad).sum(axis=0)).ravel()
    reg.summary(
        "photon_solver_final_grad_norm", "final gradient norm per host-level solve"
    ).labels(solver=solver).observe_many(gn.tolist())


def collect_build_info() -> Dict[str, str]:
    """Build/runtime identity of this process: package version, torch and
    CUDA versions, the card's name (``none`` without one), the process index
    and the serving replica (empty outside a fleet)."""
    import torch

    from .. import __version__
    from .tracing import get_process_index, get_replica_id

    return {
        "version": str(__version__),
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda or "none"),
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none",
        "process": str(get_process_index()),
        "replica": get_replica_id() or "",
    }


def record_build_info(registry: Optional[MetricsRegistry] = None) -> Dict[str, str]:
    """Stamp the ``photon_build_info`` gauge (value 1, identity in labels)
    into ``registry`` (default: the current run's)."""
    reg = registry if registry is not None else current_run().registry
    info = collect_build_info()
    reg.gauge(
        "photon_build_info",
        "build/runtime identity of this process; value is always 1",
    ).labels(**info).set(1)
    return info


def build_run_summary(registry: MetricsRegistry, total_wall_seconds: float) -> dict:
    """The ``run_summary.json`` document: total wall time, per-coordinate
    iteration StatCounters, convergence-reason histograms and rejections,
    memory watermarks (when the run sampled any) and the full final metrics
    snapshot."""
    from .memory import memory_block

    snap = registry.snapshot()
    coordinates: dict = {}
    for m in snap:
        coord = m.get("labels", {}).get("coordinate")
        if not coord:
            continue
        if m["name"] == "photon_cd_iterations":
            coordinates.setdefault(coord, {})["iterations"] = m["stat"]
        elif m["name"] == "photon_cd_convergence_reason_total":
            coordinates.setdefault(coord, {}).setdefault("convergence_reasons", {})[
                m["labels"].get("reason", "?")
            ] = int(m["value"])
        elif m["name"] == "photon_coordinate_rejections_total":
            coordinates.setdefault(coord, {})["rejections"] = int(m["value"])
    doc = {
        "total_wall_seconds": float(total_wall_seconds),
        "build": collect_build_info(),
        "coordinates": coordinates,
        "metrics": snap,
    }
    mem = memory_block(snap)
    if mem:
        doc["memory"] = mem
    return doc
