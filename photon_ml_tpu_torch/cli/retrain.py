"""Continuous-training driver: the day-chained incremental retrain loop.

The JAX package's ``cli/retrain.py`` on the port. Walks a time-partitioned
feed (``<input-data>/yyyy/MM/dd`` day directories, DateRange.scala
semantics) one day at a time, warm-starting each day from the last ACCEPTED
model with prior-centred L2, gating every candidate behind the no-degrade
promotion check, and publishing accepted models into a serving root
(``game/incremental.py`` holds the chain; this driver feeds it).

Usage:
  python -m photon_ml_tpu_torch.cli.retrain \\
    --input-data feed/ --input-data-date-range 20260101-20260107 \\
    --validation-data val.avro --feature-index-dir index/ \\
    --task logistic_regression \\
    --feature-shard name=globalShard,bags=features \\
    --coordinate name=global,shard=globalShard,reg.type=L2,reg.weights=1 \\
    --evaluators AUC,AUC:userId \\
    --output-dir chain/ --serving-root serving/ [--device cpu] [--dtype float64]

The chain is durable: rerunning the same command resumes. Decided days are
skipped through the ledger in ``<output-dir>/chain-state.json``, a day
killed in its descent resumes from its newest boundary checkpoint
(``--checkpoint-every``, under ``<output-dir>/checkpoints``), and a torn
publish is repaired before any new work. ``PHOTON_FAULTS`` drills:
``retrain.day:kill:N`` (a crash between days), ``retrain.publish:io:N`` (a
torn publish), plus every site the day's training carries.

The feature index is pinned for the whole chain (``--feature-index-dir`` is
required): a per-day index would re-map day k's priors under day k+1.

Training runs on ``--device`` (the card by default; ``--device cpu`` runs
the kernels' plain versions) in ``--dtype``. ``--normalization`` is the
port's addition (the JAX package's retrain driver trains unnormalized): each
day's fixed effects are normalized from that day's feature statistics, as
``cli.train`` does for its input; models, priors and warm starts stay in the
original space. ``--status-port`` parses and raises (ROADMAP A13);
``--distributed`` and ``--trial-lanes`` above 1 are refused by
``plan.check_retrain_composition``, in the JAX package's words.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional

from .. import obs
from ..device import resolve_device
from ..estimators.game_estimator import GameEstimator
from ..game import incremental
from ..io.data import read_avro_dataset
from ..plan import PlanError
from ..robust import atomic_write_json, faults
from ..utils.logging import setup_logging
from .params import (
    add_common_io_args,
    build_shard_configs,
    check_retrain_composition,
    parse_coordinate,
    parse_input_columns,
)
from .train import DEFAULT_COORDINATE, DTYPES, NORMALIZATIONS, normalize_fixed_effects

logger = logging.getLogger("photon_ml_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch continuous-training driver")
    add_common_io_args(p)
    p.add_argument("--validation-data", required=True,
                   help="held-out validation Avro; the no-degrade gate scores candidate AND live on it")
    p.add_argument("--task", default="logistic_regression")
    p.add_argument("--coordinate", action="append", default=[],
                   help="coordinate configuration spec (repeatable, ordered)")
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--evaluators", default="",
                   help="comma-separated evaluator specs the promotion gate checks (e.g. AUC,AUC:userId: "
                        "per-group specs gate per-cohort quality)")
    p.add_argument("--gate-margin", type=float, default=0.0,
                   help="tolerated per-metric degradation before the gate refuses (in each metric's own "
                        "direction; 0 = strict no-degrade)")
    p.add_argument("--validate-data", default="disabled", choices=["full", "sample", "quarantine", "disabled"],
                   help="per-day input validation; 'quarantine' zero-weights offending rows so a poisoned "
                        "day costs its update, not the chain")
    p.add_argument("--normalization", default="NONE", choices=NORMALIZATIONS,
                   help="normalize each day's fixed effects from that day's feature statistics")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", required=True,
                   help="chain directory: chain-state.json ledger, models/day-*, checkpoints/")
    p.add_argument("--serving-root", default=None,
                   help="publish accepted models here (serving.refresh layout)")
    p.add_argument("--snapshot-prefix", default="retrain",
                   help="published snapshots are named <prefix>-<yyyyMMdd>")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="snapshot each day's coordinate-descent state every N coordinate-update boundaries "
                        "under <output-dir>/checkpoints/day-*; a day killed in its descent resumes from the "
                        "newest valid one. 0 disables")
    p.add_argument("--checkpoint-keep", type=int, default=3)
    p.add_argument("--distributed", default=None,
                   help="UNSUPPORTED with retrain: refused up front (the day chain is a host-local control "
                        "loop)")
    p.add_argument("--trial-lanes", type=int, default=1,
                   help="UNSUPPORTED with retrain: refused up front (regularize-by-prior has no per-lane "
                        "prior operand)")
    p.add_argument("--log-file", default=None)
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--metrics-out", default=None,
                   help="directory for run telemetry (metrics.jsonl + metrics.prom): "
                        "photon_retrain_days_total{outcome}, photon_retrain_rejected_total{reason}, "
                        "photon_retrain_published_total, photon_retrain_stage_seconds{stage}")
    p.add_argument("--status-port", type=int, default=None, help="ROADMAP A13")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    return p


def _day_range(args):
    from ..utils.dates import DateRange, DaysRange

    if args.input_data_date_range and args.input_data_days_ago:
        raise SystemExit("--input-data-date-range and --input-data-days-ago are exclusive")
    if args.input_data_date_range:
        return DateRange.from_string(args.input_data_date_range)
    if args.input_data_days_ago:
        return DaysRange.from_string(args.input_data_days_ago).to_date_range()
    raise SystemExit(
        "retrain walks a day-partitioned feed: pass --input-data-date-range "
        "yyyyMMdd-yyyyMMdd (or --input-data-days-ago) over "
        "<input-data>/yyyy/MM/dd day directories"
    )


def run(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level, args.log_file)
    faults.install_from_env()
    if args.status_port is not None:
        raise PlanError("--status-port is not ported yet (ROADMAP A13)")

    coords = [parse_coordinate(s) for s in (args.coordinate or [DEFAULT_COORDINATE])]
    # the illegal compositions are refused before any expensive set-up
    check_retrain_composition(bool(args.distributed), args.trial_lanes,
                              [cc.name for cc in coords if cc.hbm_budget_mb])
    if not args.feature_index_dir:
        # day k+1's prior must live in the feature space day k's model was
        # saved in
        raise SystemExit(
            "retrain requires --feature-index-dir: the feature index is "
            "pinned for the whole chain (a per-day index would re-map day "
            "k's priors under day k+1)"
        )
    rng = _day_range(args)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]

    shards = build_shard_configs(args)
    id_tags = [t for t in args.id_tags.split(",") if t]
    for cc in coords:
        if cc.is_random_effect and cc.random_effect_type not in id_tags:
            id_tags.append(cc.random_effect_type)
    input_columns = parse_input_columns(args)

    from ..io.index_map import load_partitioned
    from ..utils.dates import DateRange, input_paths_within_date_range

    index_maps = {s: load_partitioned(args.feature_index_dir, s) for s in shards}

    def _read_day(day):
        paths = input_paths_within_date_range(args.input_data, DateRange(day, day))
        raw, _ = read_avro_dataset(
            paths, shards, index_maps=index_maps, id_tag_columns=id_tags,
            response_column=args.response_column, columns=input_columns,
        )
        if args.validate_data != "disabled":
            from ..io import validators

            mode = {
                "full": validators.VALIDATE_FULL,
                "sample": validators.VALIDATE_SAMPLE,
                "quarantine": validators.VALIDATE_QUARANTINE,
            }[args.validate_data]
            validators.validate_dataset(raw, args.task, mode, rng_seed=args.seed)
        normalize_fixed_effects(args.normalization, coords, raw, index_maps, dtype, device)
        return raw

    # (label, thunk) pairs: a resume skips decided days WITHOUT reading them
    days = []
    for day in rng.days():
        label = day.strftime("%Y%m%d")
        try:
            input_paths_within_date_range(args.input_data, DateRange(day, day))
        except FileNotFoundError:
            logger.info("day %s: no data directory, skipping", label)
            continue
        days.append((label, lambda d=day: _read_day(d)))
    if not days:
        raise SystemExit(f"no day directories under {args.input_data} within {rng}")

    validation, _ = read_avro_dataset(
        args.validation_data, shards, index_maps=index_maps, id_tag_columns=id_tags,
        response_column=args.response_column, columns=input_columns,
    )

    evaluators = [e for e in args.evaluators.split(",") if e]
    estimator = GameEstimator(
        task=args.task,
        coordinate_configs=coords,
        n_cd_iterations=args.coordinate_descent_iterations,
        evaluator_specs=evaluators,
        dtype=dtype,
        device=device,
    )

    run_t = prev_run = None
    if args.metrics_out:
        run_t = obs.RunTelemetry()
        os.makedirs(args.metrics_out, exist_ok=True)
        for sink in (obs.JsonlSink(os.path.join(args.metrics_out, "metrics.jsonl")),
                     obs.PrometheusSink(os.path.join(args.metrics_out, "metrics.prom"))):
            run_t.register_listener(sink)
        prev_run = obs.set_current_run(run_t)
    try:
        result = incremental.run_chain(
            estimator,
            days,
            validation,
            chain_dir=args.output_dir,
            serving_root=args.serving_root,
            snapshot_prefix=args.snapshot_prefix,
            evaluator_specs=evaluators or None,
            gate_margin=args.gate_margin,
            checkpoint_every=args.checkpoint_every,
            checkpoint_keep=args.checkpoint_keep,
            index_maps=index_maps,
        )
    finally:
        if run_t is not None:
            run_t.close()
            obs.set_current_run(prev_run)

    summary = {
        "days": [
            {
                "day": r.day,
                "accepted": r.accepted,
                "reason": r.reason,
                "rows": r.rows,
                "published": r.published,
                "snapshot": r.snapshot,
                "metrics": r.metrics,
            }
            for r in result.ledger
        ],
        "accepted_days": sum(1 for r in result.ledger if r.accepted),
        "rejected_days": sum(1 for r in result.ledger if not r.accepted),
        "rows_touched": result.rows_touched,
        "rows_cumulative": result.rows_cumulative,
        "rows_touched_fraction": result.rows_touched_fraction,
        # the stage walls of the days this invocation ran (not of resumed ones)
        "day_seconds": result.day_seconds,
    }
    os.makedirs(args.output_dir, exist_ok=True)
    atomic_write_json(os.path.join(args.output_dir, "retrain-summary.json"), summary, indent=2, default=float)
    logger.info(
        "chain done: %d accepted / %d rejected day(s); touched %.0f%% of the rows a daily from-scratch "
        "retrain would have", summary["accepted_days"], summary["rejected_days"],
        100.0 * summary["rows_touched_fraction"],
    )
    return summary


def main() -> None:
    run()


if __name__ == "__main__":
    main()
