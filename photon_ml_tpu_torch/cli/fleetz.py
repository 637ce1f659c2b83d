"""Fleet observability front: merge per-process telemetry into one view.

A training run's processes (or an N-replica serving fleet) leave K
per-process ``metrics*.jsonl`` streams on disk and/or K live ``/metrics``
endpoints. This driver folds them into ONE exposition — counters summed,
gauges kept per process under ``process=``/``replica=`` labels, histogram
buckets merged, summaries recombined exactly — and stitches the K span
streams into a single Chrome-trace timeline aligned on the shared wall
clock (see ``obs.fleet``).

One-shot merge (prints the fleet exposition)::

    python -m photon_ml_tpu_torch.cli.fleetz out/metrics

Artifact mode (fleet.prom + fleet_trace.json + fleet_summary.json)::

    python -m photon_ml_tpu_torch.cli.fleetz out/metrics --out out/fleet

Live aggregator front over running processes (the harness scrapes this one
endpoint instead of K)::

    python -m photon_ml_tpu_torch.cli.fleetz \
        --scrape http://127.0.0.1:9601 --scrape http://127.0.0.1:9602 \
        --serve-port 9700

The JAX package's ``cli/fleetz.py`` on the port. It touches no card: the
aggregator runs on a host with no accelerator runtime — a monitoring
sidecar, a laptop reading artifacts off a finished run.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
from typing import List, Optional

from ..obs import fleet
from ..robust.atomic import atomic_write_json, atomic_write_text
from ..utils.logging import setup_logging

logger = logging.getLogger("photon_ml_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch fleet telemetry aggregator")
    p.add_argument(
        "paths",
        nargs="*",
        help="metrics.jsonl files and/or telemetry directories (a directory "
        "contributes every metrics*.jsonl inside it — the per-process "
        "layout cli train writes)",
    )
    p.add_argument(
        "--scrape",
        action="append",
        default=[],
        metavar="URL",
        help="live /metrics endpoint to scrape and merge (repeatable; one "
        "per process or serving replica)",
    )
    p.add_argument(
        "--out",
        default=None,
        help="write fleet.prom (merged exposition), fleet_trace.json "
        "(stitched Chrome trace) and fleet_summary.json (fleet statusz "
        "document) into this directory",
    )
    p.add_argument(
        "--serve-port",
        type=int,
        default=None,
        help="stay resident and serve the merged /metrics, /statusz and "
        "/healthz on this port (0 = ephemeral); live targets are "
        "re-scraped on every GET",
    )
    p.add_argument(
        "--scrape-timeout",
        type=float,
        default=2.0,
        help="per-target scrape timeout in seconds",
    )
    p.add_argument("--log-file", default=None)
    p.add_argument("--log-level", default="INFO")
    return p


def run(argv: Optional[List[str]] = None, stop_event=None):
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level, args.log_file)
    if not args.paths and not args.scrape:
        raise SystemExit(
            "nothing to aggregate: pass metrics.jsonl paths/directories "
            "and/or --scrape URLs"
        )

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        raise SystemExit(f"no such file or directory: {', '.join(missing)}")

    agg = fleet.FleetAggregator(
        targets=args.scrape, timeout_s=args.scrape_timeout
    )
    streams = fleet.discover_streams(args.paths)
    if args.paths and not streams:
        raise SystemExit(
            f"no metrics*.jsonl streams found under: {', '.join(args.paths)}"
        )
    agg.add_streams(streams)
    if args.scrape:
        n = agg.scrape_once()
        logger.info("scraped %d/%d live targets", n, len(args.scrape))

    doc = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        atomic_write_text(os.path.join(args.out, "fleet.prom"), agg.render())
        trace = fleet.stitch_spans(streams)
        atomic_write_json(
            os.path.join(args.out, "fleet_trace.json"), trace, default=str
        )
        doc = agg.statusz()
        atomic_write_json(
            os.path.join(args.out, "fleet_summary.json"),
            doc, indent=2, default=str,
        )
        n_spans = sum(len(s.spans) for s in streams)
        logger.info(
            "fleet artifacts -> %s (%d stream(s), %d span(s) stitched)",
            args.out, len(streams), n_spans,
        )

    if args.serve_port is not None:
        front = fleet.FleetServer(agg, port=args.serve_port)
        logger.info(
            "fleet aggregator front -> http://127.0.0.1:%d/{metrics,"
            "statusz,healthz}", front.port,
        )
        try:
            if stop_event is not None:
                stop_event.wait()
            else:
                threading.Event().wait()  # resident until killed
        finally:
            front.stop()
        return front.port

    if not args.out:
        # one-shot mode: the merged exposition on stdout, exactly what a
        # scrape of the resident front would return
        sys.stdout.write(agg.render())
        return None
    return doc


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
