"""Resident GLMix scoring service driver (the JAX package's ``cli/serve.py``
on the port, with its flags, plus ``--device``).

The serving-side complement of the batch scorer (``cli/score.py``): open a
published mmap snapshot (or publish one first from an Avro GAME model dir),
stage it on the card and warm the score kernels, microbatch requests, and
flip to newly published snapshots without dropping traffic (see
``serving/``). ``--device cpu`` serves through the kernels' plain versions.

Typical flow::

    # one-time (and per retrain): flatten the Avro model into a snapshot
    python -m photon_ml_tpu_torch.cli.serve --serving-root out/serving \
        --publish-model out/models/best --feature-index-dir out/index \
        --snapshot-name v1 --publish-only

    # resident server over an AF_UNIX socket
    python -m photon_ml_tpu_torch.cli.serve --serving-root out/serving \
        --socket /tmp/photon-serve.sock --metrics-out out/serving-metrics

    # ... or a TCP listener, with a 50ms deadline budget on every request
    python -m photon_ml_tpu_torch.cli.serve --serving-root out/serving \
        --listen 127.0.0.1:8473 --default-deadline-ms 50

    # multi-model residency: one process, one bulkhead per model, routed
    # by the request protocol's model= field (per-market GAME model sets)
    python -m photon_ml_tpu_torch.cli.serve --models jobs-us=out/serving-us \
        --models jobs-emea=out/serving-emea --default-model jobs-us \
        --listen 127.0.0.1:8473

    # ... or discover the resident set from one fleet root (each subdir a
    # serving root or bare store): --fleet-root out/fleet

    # the replica front: N `cli serve --listen` replicas behind one address,
    # least-loaded routing + /healthz draining + mid-request failover
    python -m photon_ml_tpu_torch.cli.serve --front 127.0.0.1:8473 \
        --front 127.0.0.1:8474 --listen 127.0.0.1:9000

Overload posture: the admission controller sheds requests that cannot meet
their deadline budget (``--default-deadline-ms``, or per-request
``deadline_ms`` on the socket) or that meet a full pending queue
(``--max-pending``); ``--overload-shed-threshold`` wires the shed rate into
``/healthz`` so a balancer can route around a saturated replica — the
``--front`` process polls exactly that endpoint (``--front-healthz``).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
from typing import List, Optional

from ..io.index_map import load_partitioned
from ..utils.logging import setup_logging

logger = logging.getLogger("photon_ml_tpu_torch")


def check_socket_front(socket_path, listen) -> None:
    """One socket front per server process: AF_UNIX or TCP, not both."""
    if socket_path and listen:
        raise ValueError(
            "pass at most one of --socket / --listen (one socket front per "
            "server process)"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch resident scoring service")
    p.add_argument(
        "--serving-root",
        default=None,
        help="published-snapshot root (CURRENT + snapshots/); enables "
        "zero-downtime refresh when new snapshots are published",
    )
    p.add_argument(
        "--store-dir",
        default=None,
        help="serve one fixed mmap store directly (no refresh watching)",
    )
    p.add_argument(
        "--models",
        action="append",
        default=None,
        metavar="NAME=PATH",
        help="resident model NAME served from PATH (a serving root or a "
        "bare store dir); repeat for multi-model residency — each model "
        "gets its own bulkhead (batcher + refresh watcher) and requests "
        "route by the protocol's model= field",
    )
    p.add_argument(
        "--fleet-root",
        default=None,
        help="directory whose subdirectories are the resident models "
        "(each a serving root or bare store dir) — shorthand for one "
        "--models entry per subdir",
    )
    p.add_argument(
        "--default-model",
        default=None,
        help="model served to requests that carry no model= field "
        "(default: the single resident model, or 'default')",
    )
    p.add_argument(
        "--front",
        action="append",
        default=None,
        metavar="HOST:PORT",
        help="run as the least-loaded replica front instead of a scoring "
        "server: repeat once per replica --listen address; requests route "
        "to the live replica with the fewest in flight and fail over "
        "(same trace_id) when a replica dies mid-request",
    )
    p.add_argument(
        "--front-healthz",
        action="append",
        default=None,
        metavar="HOST:PORT",
        help="per-replica introspection address (parallel to --front): the "
        "front drains a replica whose /healthz answers 503",
    )
    p.add_argument(
        "--front-connections",
        type=int,
        default=1,
        metavar="K",
        help="connections the front opens to each replica (default 1): the "
        "JSON-lines protocol answers in order per connection, so K is the "
        "front's concurrency into one replica — raise it so the replica's "
        "microbatcher sees enough in-flight requests to fill batches",
    )
    p.add_argument(
        "--publish-model",
        default=None,
        help="Avro GAME model dir to flatten + publish into --serving-root "
        "before serving (requires --feature-index-dir)",
    )
    p.add_argument("--feature-index-dir", default=None)
    p.add_argument("--snapshot-name", default="v1")
    p.add_argument("--task", default=None, help="override model task type")
    p.add_argument(
        "--publish-only",
        action="store_true",
        help="publish the snapshot and exit without serving",
    )
    p.add_argument("--socket", default=None, help="AF_UNIX socket path to serve on")
    p.add_argument(
        "--listen",
        default=None,
        help="TCP host:port to serve on (same JSON-lines protocol as "
        "--socket; port 0 binds ephemeral)",
    )
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--max-latency-ms", type=float, default=2.0)
    p.add_argument(
        "--max-pending",
        type=int,
        default=1024,
        help="admission queue bound; submits against a full queue are shed "
        "with reason queue_full",
    )
    p.add_argument(
        "--default-deadline-ms",
        type=float,
        default=None,
        help="deadline budget applied to requests that don't carry their own "
        "deadline_ms; requests that cannot meet it are shed immediately",
    )
    p.add_argument(
        "--overload-shed-threshold",
        type=float,
        default=None,
        help="sheds/second above which /healthz answers 503 "
        '{"status": "overloaded"} (needs --status-port)',
    )
    p.add_argument("--poll-seconds", type=float, default=0.2)
    p.add_argument(
        "--replica-id",
        default=None,
        help="this replica's identity in an N-replica serving fleet; stamped "
        "on every metric line, span and response trace, and used as the "
        "process lane in fleet-merged timelines (an integer id also sets "
        "the obs process index)",
    )
    p.add_argument(
        "--slow-request-ms",
        type=float,
        default=None,
        help="log a warning (with trace_id and per-stage breakdown) and "
        "count photon_serving_slow_requests_total for completed requests "
        "slower than this threshold",
    )
    p.add_argument(
        "--metrics-out",
        default=None,
        help="directory for telemetry: the Prometheus exposition and the "
        "metrics.jsonl span/metric stream (the JAX package's cli fleetz merges it), "
        "plus flight-recorder postmortems under flight/",
    )
    p.add_argument(
        "--status-port",
        type=int,
        default=None,
        help="serve live /metrics, /healthz and /statusz (request QPS, "
        "latency p50/p95/p99, live snapshot name) on this port while "
        "resident (0 = ephemeral port)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--log-file", default=None)
    p.add_argument("--log-level", default="INFO")
    return p


def run(argv: Optional[List[str]] = None, stop_event=None):
    args = build_parser().parse_args(argv)
    check_socket_front(args.socket, args.listen)
    setup_logging(args.log_level, args.log_file)

    from .. import obs, serving
    from ..robust import faults

    # PHOTON_FAULTS reaches the serving sites (serving.score /
    # serving.refresh) the same way it reaches training: the chaos drills
    # run against the real CLI entrypoint
    faults.install_from_env()

    if args.publish_model:
        if not args.serving_root:
            raise SystemExit("--publish-model requires --serving-root")
        if not args.feature_index_dir:
            raise SystemExit("--publish-model requires --feature-index-dir")
        shards = serving.discover_shards(args.publish_model)
        index_maps = {
            s: load_partitioned(args.feature_index_dir, s) for s in shards
        }
        path = serving.publish_snapshot(
            args.serving_root,
            args.snapshot_name,
            model_dir=args.publish_model,
            index_maps=index_maps,
            task=args.task,
        )
        logger.info("published snapshot %s", path)
        if args.publish_only:
            return None

    modes = (
        args.serving_root,
        args.store_dir,
        args.models,
        args.fleet_root,
        args.front,
    )
    if sum(bool(m) for m in modes) != 1:
        raise SystemExit(
            "pass exactly one of --serving-root / --store-dir / --models / "
            "--fleet-root / --front"
        )
    if args.front and not (args.socket or args.listen):
        raise SystemExit(
            "--front needs --socket or --listen (the fleet's one client "
            "address)"
        )
    if args.front_healthz and (
        not args.front or len(args.front_healthz) != len(args.front)
    ):
        raise SystemExit("--front-healthz entries must parallel --front")
    model_pairs = None
    if args.models:
        # kept as (name, path) PAIRS, not a dict: a duplicate NAME must
        # reach plan.check_fleet_composition's typed refusal, not be
        # silently last-writer-wins'd by dict construction
        model_pairs = []
        for spec in args.models:
            name, sep, path = spec.partition("=")
            if not sep or not name or not path:
                raise SystemExit(f"--models takes NAME=PATH (got {spec!r})")
            model_pairs.append((name, path))

    # fleet identity BEFORE any sink/span exists, so every line carries it
    if args.replica_id is not None:
        obs.set_replica_id(args.replica_id)
        try:
            # an integer replica id doubles as the trace/JSONL process lane
            obs.set_process_index(int(args.replica_id))
        except ValueError:
            pass  # non-numeric replica names keep lane 0; the replica
            # label still disambiguates fleet-merged series

    run_ctx = obs.RunTelemetry()
    obs.record_build_info(run_ctx.registry)
    flight = None
    if args.metrics_out:
        os.makedirs(args.metrics_out, exist_ok=True)
        run_ctx.register_listener(
            obs.PrometheusSink(os.path.join(args.metrics_out, "metrics.prom"))
        )
        # the JSONL stream (the JAX package's cli fleetz merges and stitches
        # it): every span (serving.request + per-stage) and the final
        # metrics snapshot
        run_ctx.register_listener(
            obs.JsonlSink(os.path.join(args.metrics_out, "metrics.jsonl"))
        )
        # anomaly-triggered postmortems: a shed-rate spike past
        # --overload-shed-threshold dumps the last window of spans/metrics
        flight = obs.FlightRecorder(
            os.path.join(args.metrics_out, "flight"),
            run=run_ctx,
            shed_rate_threshold=args.overload_shed_threshold,
        )
        run_ctx.register_listener(flight)
    with obs.use_run(run_ctx):
        if args.front:
            front = serving.LeastLoadedFront(
                args.front,
                healthz=args.front_healthz,
                connections_per_replica=args.front_connections,
            )
            logger.info(
                "replica front over %s (socket=%s listen=%s)",
                args.front, args.socket, args.listen,
            )
            try:
                serving.serve_front_socket(
                    front,
                    path=args.socket,
                    listen=args.listen,
                    stop_event=stop_event,
                    on_bound=lambda b: logger.info("front bound: %s", b),
                )
            finally:
                front.close()
                run_ctx.close()
            return None
        admission = dict(
            device=args.device,
            max_pending=args.max_pending,
            default_deadline_ms=args.default_deadline_ms,
            overload_shed_threshold=args.overload_shed_threshold,
            slow_request_ms=args.slow_request_ms,
        )
        if args.serving_root:
            server = serving.ScoringServer(
                serving_root=args.serving_root,
                max_batch=args.max_batch,
                max_latency_ms=args.max_latency_ms,
                poll_seconds=args.poll_seconds,
                status_port=args.status_port,
                **admission,
            )
        elif args.store_dir:
            server = serving.ScoringServer(
                store=serving.ModelStore.open(args.store_dir),
                max_batch=args.max_batch,
                max_latency_ms=args.max_latency_ms,
                status_port=args.status_port,
                **admission,
            )
        else:
            server = serving.ScoringServer(
                models=model_pairs,
                fleet_root=args.fleet_root,
                default_model=args.default_model,
                max_batch=args.max_batch,
                max_latency_ms=args.max_latency_ms,
                poll_seconds=args.poll_seconds,
                status_port=args.status_port,
                **admission,
            )
        logger.info(
            "serving snapshots %s (socket=%s listen=%s)",
            server.snapshot_names, args.socket, args.listen,
        )
        if server.status_port is not None:
            logger.info(
                "introspection endpoints -> http://127.0.0.1:%d/{metrics,"
                "healthz,statusz}", server.status_port,
            )
        try:
            if args.socket or args.listen:
                serving.serve_socket(
                    server,
                    path=args.socket,
                    listen=args.listen,
                    stop_event=stop_event,
                    on_bound=lambda b: logger.info("socket front bound: %s", b),
                )
            elif stop_event is not None:
                stop_event.wait()
            else:
                threading.Event().wait()  # resident until killed
        finally:
            server.close()
            run_ctx.close()  # final flush: the p50/p95/p99 exposition
    return None


def main():
    # SIGTERM / SIGINT stop the server the way a stop event does: listeners
    # close, connections are shut down, and the metrics take their last flush
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    run(sys.argv[1:], stop_event=stop)


if __name__ == "__main__":
    main()
