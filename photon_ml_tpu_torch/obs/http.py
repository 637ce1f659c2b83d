"""Live introspection endpoints: /metrics, /healthz, /statusz.

The JAX package's ``obs/http.py`` on the port, the same endpoints and the
same documents.

``IntrospectionServer`` is a stdlib-only threaded HTTP server bound to a
``RunTelemetry``. Training (``cli train --status-port``) and serving
(``cli serve --status-port``) both mount it, so a run can be scraped *while
it is happening* instead of reading metric files after the fact:

- ``/metrics``  — Prometheus text exposition rendered from the live registry
- ``/healthz``  — liveness probe, ``{"status": "ok"}``; returns 503
  ``{"status": "refreshing"}`` while the StatusBoard's
  ``refresh_in_progress`` flag is set (the serving side raises it around a
  snapshot-refresh engine flip so load balancers drain traffic for exactly
  the flip window), and 503 ``{"status": "overloaded"}`` while the
  scrape-delta shed rate exceeds the board's ``overload_shed_threshold``
  (sheds/second; set by ``ScoringServer(overload_shed_threshold=...)``) —
  admission control keeps refusing locally, this tells the balancer to
  route around the replica
- ``/statusz``  — JSON runtime status: current sweep / coordinate and
  accepted losses (from the run's StatusBoard), rejection / divergence
  counters and stream-slice progress (derived from the registry), a
  ``memory`` section (live host RSS and the recorded device-memory
  watermarks), and — when serving metrics exist —
  offered vs served vs shed request QPS (scrape-delta), latency quantiles,
  and the live admission-queue depth / drain estimate. Multi-model
  residency adds a per-model ``serving.models`` breakdown (one entry per
  bulkhead: offered/shed/queue-depth/latency quantiles from the ``model=``
  label), and a replica front adds ``serving_front`` (per-replica routing
  counts, failover resubmits, liveness).

All handlers read snapshots under the registry/board locks, never the live
structures, so a scrape can never block or torn-read the threads it observes.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Dict, Optional

from .memory import memory_block, read_host_memory
from .metrics import histogram_quantile
from .run import RunTelemetry, current_run
from .tracing import get_process_index, get_replica_id

_QUANTILES = (0.5, 0.95, 0.99)


def _sum_counter(snapshot, name: str, label: Optional[str] = None):
    """Sum a counter family; with ``label``, return {label_value: sum}."""
    if label is None:
        total = 0.0
        for m in snapshot:
            if m["name"] == name and m["kind"] == "counter":
                total += m["value"]
        return total
    out: Dict[str, float] = {}
    for m in snapshot:
        if m["name"] == name and m["kind"] == "counter":
            key = str(m.get("labels", {}).get(label, ""))
            out[key] = out.get(key, 0.0) + m["value"]
    return out


def _gauge_value(snapshot, name: str) -> Optional[float]:
    for m in snapshot:
        if m["name"] == name and m["kind"] == "gauge":
            return m["value"]
    return None


def compose_statusz(
    run: RunTelemetry,
    qps: Optional[float] = None,
    rates: Optional[Dict[str, float]] = None,
) -> dict:
    """Build the /statusz JSON document from a run's board + registry.
    ``rates`` carries the caller's scrape-delta rates (offered_qps /
    served_qps / shed_qps); ``qps`` is the legacy served-rate argument."""
    snap = run.registry.snapshot()
    doc: dict = {"status": "ok", "unix_time": time.time()}
    # fleet identity: which process/replica this statusz page belongs to —
    # the aggregator and humans reading N replicas' pages both need it
    doc["process_index"] = get_process_index()
    replica = get_replica_id()
    if replica is not None:
        doc["replica"] = replica
    doc.update(run.status.snapshot())

    # the resolved execution plan (per-coordinate routing) when a cli entry point
    # attached one — the live counterpart of run_summary.json's "plan" block
    plan = getattr(run, "execution_plan", None)
    if plan:
        doc["plan"] = plan

    rejections = _sum_counter(snap, "photon_coordinate_rejections_total", "coordinate")
    if rejections:
        doc["coordinate_rejections"] = {k: int(v) for k, v in rejections.items()}
    diverged = _sum_counter(snap, "photon_solver_diverged_lanes_total")
    if diverged:
        doc["diverged_lanes"] = int(diverged)
    swallowed = _sum_counter(snap, "photon_swallowed_errors_total")
    if swallowed:
        doc["swallowed_errors"] = int(swallowed)

    # live host reading + recorded device/stream watermarks: a scrape shows
    # where memory stands NOW even between sweep-boundary samples
    memory = memory_block(snap)
    host_now = read_host_memory()
    if host_now:
        memory.setdefault("host", {}).update(host_now)
    if memory:
        doc["memory"] = memory

    stream: dict = {}
    slices = _sum_counter(snap, "photon_stream_slices_total")
    if slices:
        stream["slices_staged"] = int(slices)
        stream["staged_bytes"] = int(
            _sum_counter(snap, "photon_stream_staged_bytes_total")
        )
    if stream:
        doc["stream"] = stream

    retrain: dict = {}
    days_by_outcome = _sum_counter(snap, "photon_retrain_days_total", "outcome")
    if days_by_outcome:
        retrain["days_total"] = int(sum(days_by_outcome.values()))
        retrain["days_by_outcome"] = {
            k: int(v) for k, v in days_by_outcome.items()
        }
        rejected = _sum_counter(snap, "photon_retrain_rejected_total", "reason")
        if rejected:
            retrain["rejected_by_reason"] = {
                k: int(v) for k, v in rejected.items()
            }
        published = _sum_counter(snap, "photon_retrain_published_total")
        retrain["published_total"] = int(published)
        day_index = _gauge_value(snap, "photon_retrain_day_index")
        if day_index is not None:
            retrain["day_index"] = int(day_index)
    if retrain:
        doc["retrain"] = retrain

    serving: dict = {}
    requests = _sum_counter(snap, "photon_serving_requests_total")
    offered = _sum_counter(snap, "photon_serving_offered_total")
    if requests or offered:
        serving["requests_total"] = int(requests)
        serving["errors_total"] = int(
            _sum_counter(snap, "photon_serving_request_errors_total")
        )
        if qps is not None:
            serving["qps"] = qps
    if offered:
        serving["offered_total"] = int(offered)
        shed_by_reason = _sum_counter(snap, "photon_serving_shed_total", "reason")
        serving["shed_total"] = int(sum(shed_by_reason.values()))
        if shed_by_reason:
            serving["shed_by_reason"] = {
                k: int(v) for k, v in shed_by_reason.items()
            }
    bad = _sum_counter(snap, "photon_serving_bad_request_total", "kind")
    if bad:
        serving["bad_requests"] = {k: int(v) for k, v in bad.items()}
    for key, value in (rates or {}).items():
        serving[key] = value
    queue_depth = _gauge_value(snap, "photon_serving_queue_depth")
    if queue_depth is not None:
        serving["admission"] = {
            "queue_depth": int(queue_depth),
            "drain_estimate_seconds": _gauge_value(
                snap, "photon_serving_drain_estimate_seconds"
            ),
        }
    for m in snap:
        if m["name"] == "photon_serving_request_latency_seconds" and m["kind"] == "histogram":
            for q in _QUANTILES:
                serving[f"latency_p{int(q * 100)}_seconds"] = histogram_quantile(
                    m["buckets"], m["count"], q
                )
            break

    # per-model bulkhead view (multi-model residency, serving.fleet): the
    # model= label splits every serving family, so one glance shows WHICH
    # resident model is shedding / slow while its neighbours stay healthy
    models: Dict[str, dict] = {}
    for m in snap:
        labels = m.get("labels", {})
        model = labels.get("model")
        if model is None:
            continue
        name = m["name"]
        entry = models.setdefault(str(model), {})
        if name == "photon_serving_offered_total":
            entry["offered_total"] = int(
                entry.get("offered_total", 0) + m["value"]
            )
        elif name == "photon_serving_requests_total":
            entry["requests_total"] = int(
                entry.get("requests_total", 0) + m["value"]
            )
        elif name == "photon_serving_shed_total":
            by = entry.setdefault("shed_by_reason", {})
            reason = str(labels.get("reason", ""))
            by[reason] = int(by.get(reason, 0) + m["value"])
        elif name == "photon_serving_queue_depth" and m["kind"] == "gauge":
            entry["queue_depth"] = int(m["value"])
        elif (
            name == "photon_serving_request_latency_seconds"
            and m["kind"] == "histogram"
        ):
            for q in _QUANTILES:
                entry[f"latency_p{int(q * 100)}_seconds"] = histogram_quantile(
                    m["buckets"], m["count"], q
                )
    for entry in models.values():
        if "shed_by_reason" in entry:
            entry["shed_total"] = sum(entry["shed_by_reason"].values())
    if models:
        serving["models"] = models
    if serving:
        doc["serving"] = serving

    # the replica front's routing view (serving.front), when this process
    # IS the front: where requests went, what failed over, who is up
    front: dict = {}
    routed = _sum_counter(snap, "photon_serving_route_total", "replica")
    if routed:
        front["routed_by_replica"] = {k: int(v) for k, v in routed.items()}
        front["failover_resubmits_total"] = int(
            _sum_counter(snap, "photon_serving_failover_resubmits_total")
        )
        front_sheds = _sum_counter(
            snap, "photon_serving_front_sheds_total", "reason"
        )
        if front_sheds:
            front["sheds_by_reason"] = {
                k: int(v) for k, v in front_sheds.items()
            }
    for m in snap:
        if m["name"] == "photon_serving_replica_up" and m["kind"] == "gauge":
            front.setdefault("replica_up", {})[
                str(m.get("labels", {}).get("replica", ""))
            ] = int(m["value"])
    if front:
        doc["serving_front"] = front
    return doc


class IntrospectionServer:
    """Threaded HTTP server exposing /metrics, /healthz and /statusz for one
    ``RunTelemetry``. ``port=0`` binds an ephemeral port; the bound port is
    available as ``.port`` (tests and log lines use it)."""

    def __init__(
        self,
        run: Optional[RunTelemetry] = None,
        port: int = 0,
        host: str = "127.0.0.1",
    ) -> None:
        self._run = run
        self._qps_lock = threading.Lock()
        # scrape-delta states: (monotonic, totals...) per consumer — statusz
        # and healthz scrape on independent cadences, so each keeps its own
        self._qps_state: Optional[tuple] = None  # (t, requests, offered, shed)
        self._health_state: Optional[tuple] = None  # (t, shed_total)
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = server._render_metrics().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    # 503 while a serving snapshot-refresh flip is
                    # mid-publish: the board flag brackets exactly the
                    # build+warm+swap window (serving/server.py _install)
                    unhealthy = None
                    board = server.run().status.snapshot()
                    if board.get("refresh_in_progress"):
                        unhealthy = "refreshing"
                    else:
                        # 503 while admission control is shedding faster
                        # than the configured threshold (sheds/second,
                        # scrape-delta): the replica still answers every
                        # request it admits, this tells the balancer to
                        # back off until the shed rate drops
                        threshold = board.get("overload_shed_threshold")
                        if threshold is not None:
                            rate = server._shed_rate(server.run())
                            if rate is not None and rate > float(threshold):
                                unhealthy = "overloaded"
                    if unhealthy is not None:
                        body = json.dumps({"status": unhealthy}).encode(
                            "utf-8"
                        )
                        self.send_response(503)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    body = json.dumps({"status": "ok"}).encode("utf-8")
                    ctype = "application/json"
                elif path == "/statusz":
                    body = json.dumps(
                        server.statusz(), default=str, sort_keys=True
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
            name=f"photon-introspection-{self.port}",
            daemon=True,
        )
        self._thread.start()

    def run(self) -> RunTelemetry:
        return self._run if self._run is not None else current_run()

    def _render_metrics(self) -> str:
        return self.run().registry.to_prometheus()

    def statusz(self) -> dict:
        run = self.run()
        return compose_statusz(run, rates=self._update_rates(run))

    def _update_rates(self, run: RunTelemetry) -> Optional[Dict[str, float]]:
        """Serving rates (served ``qps``, plus ``offered_qps`` / ``shed_qps``
        when admission control is in play) from counter deltas between
        scrapes. None on the first scrape — a rate needs two samples."""
        snap = run.registry.snapshot()
        served = _sum_counter(snap, "photon_serving_requests_total")
        offered = _sum_counter(snap, "photon_serving_offered_total")
        shed = _sum_counter(snap, "photon_serving_shed_total")
        now = time.monotonic()
        with self._qps_lock:
            prev = self._qps_state
            self._qps_state = (now, served, offered, shed)
        if prev is None or now <= prev[0]:
            return None
        if not (served or offered):
            return None  # no serving traffic: keep /statusz free of a
            # zero-rate serving section on training runs
        dt = now - prev[0]
        rates = {"qps": max(0.0, (served - prev[1]) / dt)}
        if offered or prev[2]:
            rates["offered_qps"] = max(0.0, (offered - prev[2]) / dt)
            rates["shed_qps"] = max(0.0, (shed - prev[3]) / dt)
        return rates

    def _shed_rate(self, run: RunTelemetry) -> Optional[float]:
        """Scrape-delta shed rate (sheds/second) for the /healthz overload
        probe; keeps its own state so health and statusz cadences don't
        perturb each other's deltas."""
        total = _sum_counter(
            run.registry.snapshot(), "photon_serving_shed_total"
        )
        now = time.monotonic()
        with self._qps_lock:
            prev = self._health_state
            self._health_state = (now, total)
        if prev is None or now <= prev[0]:
            return None
        return max(0.0, (total - prev[1]) / (now - prev[0]))

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
