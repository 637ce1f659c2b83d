"""Post-hoc run-report builder.

Rebuilds the training report (report.json + self-contained report.html) from
a directory of run artifacts — run_summary.json, metrics.jsonl,
training-summary.json, saved models, feature-index metadata, boundary
checkpoint MANIFESTs, bench --progress-out JSONL, flight-recorder
postmortems (flight-<kind>-<seq>.json). The JAX package's ``cli/report.py``
on the port: the path imports neither torch's CUDA runtime nor JAX, so it
runs on a host with no card against artifacts copied off a training host,
and it reads the artifacts of either package.

Usage:
  python -m photon_ml_tpu_torch.cli.report ARTIFACTS_DIR [--out DIR]
      [--bench-baseline OLD.json --bench-candidate NEW.json] [--top-k N]

``cli train --report-out`` emits the same report at end of run through the
same discover/build code path, which is what makes the rebuild identical.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from ..obs import report as report_mod
from ..utils.logging import setup_logging

logger = logging.getLogger("photon_ml_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch run-report builder")
    p.add_argument(
        "artifacts_dir",
        help="directory walked for run artifacts (run_summary.json, "
        "metrics.jsonl, saved models, checkpoint manifests, ...)",
    )
    p.add_argument(
        "--out",
        default=None,
        help="output directory for report.json + report.html "
        "(default: <artifacts-dir>/report)",
    )
    p.add_argument(
        "--top-k",
        type=int,
        default=20,
        help="features per coordinate in the top-|weight| table",
    )
    p.add_argument(
        "--bench-baseline",
        default=None,
        help="BENCH json record to diff --bench-candidate against "
        "(per-series deltas land in the report's bench section)",
    )
    p.add_argument(
        "--bench-candidate",
        default=None,
        help="BENCH json record measured by this run (requires "
        "--bench-baseline)",
    )
    p.add_argument("--log-level", default="INFO")
    return p


def run(argv: Optional[List[str]] = None) -> dict:
    import os

    args = build_parser().parse_args(argv)
    setup_logging(args.log_level, None)
    if bool(args.bench_baseline) != bool(args.bench_candidate):
        raise SystemExit(
            "--bench-baseline and --bench-candidate must be given together"
        )

    inputs = report_mod.discover(args.artifacts_dir)
    if (
        inputs.run_summary is None
        and inputs.training_summary is None
        and not inputs.model_dirs
    ):
        raise SystemExit(
            f"no run artifacts found under {args.artifacts_dir} (expected at "
            "least one of run_summary.json / training-summary.json / a saved "
            "model directory)"
        )
    doc = report_mod.build_report(inputs, top_k=args.top_k)
    if args.bench_baseline:
        with open(args.bench_baseline, encoding="utf-8") as f:
            old = json.load(f)
        with open(args.bench_candidate, encoding="utf-8") as f:
            new = json.load(f)
        doc["bench"]["diff"] = report_mod.bench_diff(old, new)

    out_dir = args.out or os.path.join(args.artifacts_dir, "report")
    paths = report_mod.write_report(doc, out_dir)
    logger.info("report -> %s (html: %s)", paths["json"], paths["html"])
    return doc


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
