"""Event hook system: typed training events to pluggable listeners.

The JAX package's ``utils/events.py``, copied. Reference: photon-client .../event/EventEmitter.scala:23-72 (lock-guarded
listener registry whose ``sendEvent`` swallows listener errors — a failing
telemetry hook must never fail training) and Event.scala:44-61 (the typed
event vocabulary the legacy driver emits: setup, training start/finish, and
per-model optimization log events).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Dict, List, Optional

logger = logging.getLogger("photon_ml_tpu_torch")


def _swallowed_error(site: str) -> None:
    """Lazy obs.swallowed_error: utils.events sits BELOW obs in the import
    graph (obs.run imports EventEmitter from here), so the counter import
    must happen at call time; by then obs is always importable. Registry
    increments emit no events, so counting inside event-dispatch error
    handling cannot recurse."""
    from .. import obs

    obs.swallowed_error(site)


class Event:
    """Base class of all emitted events."""


@dataclasses.dataclass(frozen=True)
class SetupEvent(Event):
    """Job configured (PhotonSetupEvent minus the SparkContext)."""

    params: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainingStartEvent(Event):
    time: float  # unix seconds


@dataclasses.dataclass(frozen=True)
class TrainingFinishEvent(Event):
    time: float


@dataclasses.dataclass(frozen=True)
class OptimizationLogEvent(Event):
    """One trained configuration (PhotonOptimizationLogEvent): reg weights,
    per-coordinate optimization trackers, validation metrics."""

    reg_weights: Dict[str, float]
    trackers: Dict[str, Any]
    metrics: Optional[Dict[str, float]] = None


class EventListener:
    """Consumer interface (EventListener.scala)."""

    def handle(self, event: Event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class EventEmitter:
    """Thread-safe listener registry; listener errors are logged, never
    raised (EventEmitter.scala's Try(...) semantics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._listeners: List[EventListener] = []

    def register_listener(self, listener: EventListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def has_listeners(self) -> bool:
        with self._lock:
            return bool(self._listeners)

    def listeners(self) -> List[EventListener]:
        with self._lock:
            return list(self._listeners)

    def clear_listeners(self) -> None:
        with self._lock:
            for l in self._listeners:
                try:
                    l.close()
                except Exception:
                    _swallowed_error("events.listener_close")
                    logger.exception("event listener close failed")
            self._listeners = []

    def send_event(self, event: Event) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for l in listeners:
            try:
                l.handle(event)
            except Exception:
                # per-listener-type site: a run summary showing 40 swallowed
                # JsonlSink errors vs 40 anonymous ones is the difference
                # between "disk full" and a shrug
                _swallowed_error(f"events.listener_handle.{type(l).__name__}")
                logger.exception(
                    "event listener %r failed on %s", l, type(event).__name__
                )
