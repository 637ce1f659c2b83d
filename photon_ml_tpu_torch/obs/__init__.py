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
wires this up end to end. The flight recorder, the HTTP introspection
endpoints, the timeline profiler, memory accounting, diagnostics, fleet
aggregation and the report are ROADMAP A13.
"""

from .metrics import DEFAULT_BUCKETS, MetricsRegistry, histogram_quantile, render_prometheus
from .run import (
    MetricsSnapshotEvent,
    RunTelemetry,
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
    record_span,
    span,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "JsonlSink",
    "MetricsRegistry",
    "MetricsSnapshotEvent",
    "PrometheusSink",
    "RunTelemetry",
    "Span",
    "SpanEvent",
    "active",
    "add_device_fetch_bytes",
    "build_run_summary",
    "collect_build_info",
    "current_run",
    "current_span",
    "get_process_index",
    "histogram_quantile",
    "record_build_info",
    "record_solver_metrics",
    "record_span",
    "render_prometheus",
    "set_current_run",
    "span",
    "swallowed_error",
    "use_run",
]
