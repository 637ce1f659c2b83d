"""Run telemetry for the port: metrics registry, hierarchical span tracing,
and JSONL / Prometheus sinks (the JAX package's ``obs``, in part).

Quick tour::

    from photon_ml_tpu_torch import obs

    run = obs.RunTelemetry()
    run.register_listener(obs.JsonlSink("metrics.jsonl"))
    with obs.use_run(run):
        with obs.span("train"):
            ...  # spans opened here nest under "train"
        run.flush_metrics()
    run.close()

With no sinks registered (``obs.active()`` is False) instrumentation is
passive: cheap host-known numbers still land in the default registry, but
nothing that would need a device fetch runs. ``cli.train --metrics-out DIR``
and ``cli.serve --metrics-out DIR`` wire this up end to end; ``cli.serve
--status-port`` mounts the live ``/metrics``, ``/healthz`` and ``/statusz``
endpoints (``http``), ``memory`` samples host and device memory, and
``flightrec`` dumps a postmortem when the shed rate spikes, a solver
diverges, an update is rejected or a run crashes. ``cli.train --trace-out``
writes the run's Chrome trace and per-sweep phase attribution
(``timeline``); ``report`` and ``diagnostics`` build the training report
from the artifacts on disk (``cli.train --report-out``, ``cli.report``);
``fleet`` merges K processes' metrics and span streams (``cli.fleetz``).
"""

from . import fleet
from .flightrec import FlightRecorder
from .http import IntrospectionServer, compose_statusz
from .memory import memory_block, read_host_memory, sample_memory
from .metrics import DEFAULT_BUCKETS, MetricsRegistry, histogram_quantile, render_prometheus
from .run import (
    MetricsSnapshotEvent,
    RunTelemetry,
    StatusBoard,
    active,
    build_run_summary,
    collect_build_info,
    current_run,
    record_build_info,
    record_solver_metrics,
    set_current_run,
    swallowed_error,
    use_run,
)
from .sinks import JsonlSink, PrometheusSink
from .timeline import TimelineRecorder, interval_overlap_seconds, overlap_ratio
from .tracing import (
    Span,
    SpanEvent,
    add_device_fetch_bytes,
    add_device_put_bytes,
    current_span,
    get_process_index,
    get_replica_id,
    record_span,
    set_process_index,
    set_replica_id,
    span,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "FlightRecorder",
    "IntrospectionServer",
    "JsonlSink",
    "MetricsRegistry",
    "MetricsSnapshotEvent",
    "PrometheusSink",
    "RunTelemetry",
    "Span",
    "StatusBoard",
    "SpanEvent",
    "TimelineRecorder",
    "active",
    "add_device_fetch_bytes",
    "add_device_put_bytes",
    "build_run_summary",
    "collect_build_info",
    "compose_statusz",
    "current_run",
    "current_span",
    "fleet",
    "get_process_index",
    "get_replica_id",
    "histogram_quantile",
    "interval_overlap_seconds",
    "memory_block",
    "overlap_ratio",
    "read_host_memory",
    "record_build_info",
    "record_solver_metrics",
    "record_span",
    "render_prometheus",
    "sample_memory",
    "set_current_run",
    "set_process_index",
    "set_replica_id",
    "span",
    "swallowed_error",
    "use_run",
]
