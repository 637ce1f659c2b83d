"""Hierarchical span tracing.

The JAX package's ``obs/tracing.py`` on the port. Spans nest through a
contextvar (so the tree survives generators and is isolated per thread /
async context), carry wall time on the host clock, and pick up the
device-to-host byte counters (``add_device_fetch_bytes``) that the port's
counted fetches feed (the divergence guard's, the validation scores', the
batch scorer's). The JAX package's compile-second attribution, fed by JAX's
compilation monitor, has no counterpart here: the port compiles its kernels
once with nvcc, outside any span.

Span exit emits a ``SpanEvent`` through the current run's EventEmitter, so a
raising sink cannot fail the traced code path; with no sinks the span is
pure host bookkeeping (a perf_counter pair and a dict).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Dict, Optional

from ..utils.events import Event
from . import run as _run

_ctx: contextvars.ContextVar = contextvars.ContextVar("photon_torch_obs_span", default=None)
_ids = itertools.count(1)

# Lane identity for multi-process timelines: pushed in from outside
# (``cli serve --replica-id 3`` stamps it); a single process keeps 0.
_process_index = 0

# Serving-fleet identity: which replica of an N-replica fleet this process
# is. ``cli serve --replica-id`` pushes it in; spans and JSONL lines stamp it.
_replica_id: Optional[str] = None


def set_process_index(index: int) -> None:
    global _process_index
    # set once at startup, before any sink, server or recorder thread
    # exists; a reference assignment is atomic, so a late reader sees the
    # old or the new index, never a torn value
    _process_index = int(index)


def get_process_index() -> int:
    return _process_index


def set_replica_id(replica: Optional[str]) -> None:
    global _replica_id
    # the same set-once-at-startup discipline as set_process_index
    _replica_id = None if replica is None else str(replica)


def get_replica_id() -> Optional[str]:
    return _replica_id


@dataclasses.dataclass
class Span:
    name: str
    span_id: str
    parent_id: Optional[str]
    start_unix: float
    attrs: Dict[str, object]
    duration_s: Optional[float] = None
    # lane identity: which OS thread and which process ran this span
    thread_id: int = 0
    thread_name: str = ""
    process_index: int = 0
    # monotonic start (same clock as duration_s); start_unix is for humans
    start_perf: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpanEvent(Event):
    span: Span


def current_span() -> Optional[Span]:
    return _ctx.get()


@contextlib.contextmanager
def span(name: str, parent: Optional[Span] = None, **attrs):
    """Open a span named ``name``; nests under the current span if any.

    ``parent`` overrides the contextvar nesting: spans opened on worker
    threads (the ingest pool's decodes) have no ancestry there, so their
    owner passes the anchor span explicitly."""
    if parent is None:
        parent = _ctx.get()
    s = Span(
        name=name,
        span_id=f"s{next(_ids)}",
        parent_id=parent.span_id if parent is not None else None,
        start_unix=time.time(),
        attrs=dict(attrs),
        thread_id=threading.get_ident(),
        thread_name=threading.current_thread().name,
        process_index=_process_index,
    )
    token = _ctx.set(s)
    t0 = time.perf_counter()
    s.start_perf = t0
    try:
        yield s
    finally:
        s.duration_s = time.perf_counter() - t0
        if _replica_id is not None:
            s.attrs.setdefault("replica", _replica_id)
        _ctx.reset(token)
        run = _run.current_run()
        if run.has_listeners():
            run.send_event(SpanEvent(span=s))


def record_span(
    name: str,
    start_perf: float,
    end_perf: float,
    parent: Optional[Span] = None,
    **attrs,
) -> Optional[Span]:
    """Emit an already-closed span from explicit ``perf_counter`` stamps
    (stages measured across threads, which no context manager can
    bracket). Free when no sink is listening. ``start_unix`` is
    back-derived from the wall clock."""
    run = _run.current_run()
    if not run.has_listeners():
        return None
    now_perf = time.perf_counter()
    s = Span(
        name=name,
        span_id=f"s{next(_ids)}",
        parent_id=parent.span_id if parent is not None else None,
        start_unix=time.time() - (now_perf - start_perf),
        attrs=dict(attrs),
        duration_s=max(0.0, float(end_perf) - float(start_perf)),
        thread_id=threading.get_ident(),
        thread_name=threading.current_thread().name,
        process_index=_process_index,
        start_perf=float(start_perf),
    )
    if _replica_id is not None:
        s.attrs.setdefault("replica", _replica_id)
    run.send_event(SpanEvent(span=s))
    return s


def add_device_fetch_bytes(site: str, nbytes: int) -> None:
    """Count a device->host fetch of ``nbytes`` (host-known: no extra
    sync) at ``site``, in ``photon_device_fetch_bytes_total{site=}`` and in
    the current span's ``fetch_bytes``."""
    nbytes = int(nbytes)
    _run.current_run().registry.counter(
        "photon_device_fetch_bytes_total",
        "bytes transferred at instrumented device-fetch sites",
    ).labels(site=site).inc(nbytes)
    s = _ctx.get()
    if s is not None:
        s.attrs["fetch_bytes"] = int(s.attrs.get("fetch_bytes", 0)) + nbytes
