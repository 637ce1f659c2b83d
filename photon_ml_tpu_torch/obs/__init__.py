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
``flightrec`` dumps a postmortem when the shed rate spikes. The timeline
profiler, diagnostics, fleet aggregation and the report are ROADMAP A13.
"""

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
from .tracing import (
    Span,
    SpanEvent,
    add_device_fetch_bytes,
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
    "active",
    "add_device_fetch_bytes",
    "build_run_summary",
    "collect_build_info",
    "compose_statusz",
    "current_run",
    "current_span",
    "get_process_index",
    "get_replica_id",
    "histogram_quantile",
    "memory_block",
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
