"""CLI parameter grammar shared by the drivers: the input and output part.

The JAX package's ``cli/params.py`` (reference: photon-client io/scopt/**,
the scopt parsers with their comma/pipe grammar for nested configs), of
which this copies what the IO of the drivers needs: ``parse_kv``,
``parse_feature_shard``, ``add_common_io_args``, ``parse_ingest_workers``,
``resolve_input_paths``, ``parse_input_columns`` and
``build_shard_configs``. The coordinate, retrain and pipeline parsers come
with the GAME driver (ROADMAP A12); the mesh parser and the multi-process
row split with A10.
"""

from __future__ import annotations

import argparse
from typing import Dict

from ..io.data import FeatureShardConfig


def parse_kv(spec: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        if not eq:
            raise ValueError(f"expected key=value in {spec!r}, got {part!r}")
        out[k.strip()] = v.strip()
    return out


def parse_feature_shard(spec: str) -> Dict[str, FeatureShardConfig]:
    """``name=globalShard,bags=features|userFeatures,intercept=true``"""
    kv = parse_kv(spec)
    name = kv.pop("name")
    bags = tuple(kv.pop("bags").split("|"))
    intercept = kv.pop("intercept", "true").lower() in ("true", "1", "yes")
    if kv:
        raise ValueError(f"unknown feature-shard keys: {sorted(kv)}")
    return {name: FeatureShardConfig(feature_bags=bags, has_intercept=intercept)}


def add_common_io_args(p: argparse.ArgumentParser):
    p.add_argument("--input-data", required=True, help="Avro file or directory")
    p.add_argument(
        "--feature-shard",
        action="append",
        default=[],
        required=False,
        help="name=SHARD,bags=BAG|BAG,intercept=true (repeatable)",
    )
    p.add_argument(
        "--id-tags",
        default="",
        help="comma-separated id columns to extract (random-effect types)",
    )
    p.add_argument("--response-column", default="label")
    p.add_argument(
        "--input-column-names",
        default="",
        help="remap reserved columns: 'response=label,weight=importance,...' "
        "(uid/response/offset/weight/metadataMap; InputColumnsNames.scala)",
    )
    p.add_argument(
        "--input-data-date-range",
        default=None,
        help="yyyyMMdd-yyyyMMdd: read '<input-data>/yyyy/MM/dd' day dirs "
        "within the range (DateRange.scala)",
    )
    p.add_argument(
        "--input-data-days-ago",
        default=None,
        help="START-END days before today, START >= END (DaysRange.scala)",
    )
    p.add_argument(
        "--feature-index-dir",
        default=None,
        help="directory of prebuilt index stores (FeatureIndexingDriver output)",
    )
    p.add_argument(
        "--ingest-workers",
        type=parse_ingest_workers,
        default=None,
        help="decode-pool size for ingest: 'auto' (default) = cpu_count - 2, "
        "min 1; an explicit N >= 1 pins the pool. Output is bit-identical at "
        "any worker count.",
    )


def parse_ingest_workers(value):
    """--ingest-workers: 'auto'/'' -> None (host-sized later, cpu_count - 2
    min 1, by io/data.resolve_ingest_workers); otherwise an int >= 1."""
    if value is None or value == "" or str(value).lower() == "auto":
        return None
    try:
        w = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--ingest-workers expects an integer >= 1 or 'auto', got {value!r}"
        )
    if w < 1:
        raise argparse.ArgumentTypeError(
            f"--ingest-workers must be >= 1: {w}"
        )
    return w


def resolve_input_paths(args):
    """--input-data plus optional date/days range -> list of day dirs (or the
    base path unchanged); IOUtils.getInputPathsWithinDateRange semantics."""
    from ..utils.dates import DateRange, DaysRange, input_paths_within_date_range

    if args.input_data_date_range and args.input_data_days_ago:
        raise SystemExit(
            "--input-data-date-range and --input-data-days-ago are exclusive"
        )
    if args.input_data_date_range:
        rng = DateRange.from_string(args.input_data_date_range)
    elif args.input_data_days_ago:
        rng = DaysRange.from_string(args.input_data_days_ago).to_date_range()
    else:
        return args.input_data
    return input_paths_within_date_range(args.input_data, rng)


def parse_input_columns(args):
    """--input-column-names spec -> InputColumnsNames (default when empty)."""
    from ..io.columns import InputColumnsNames

    if not getattr(args, "input_column_names", ""):
        return InputColumnsNames()
    return InputColumnsNames.from_spec(args.input_column_names)


def build_shard_configs(args) -> Dict[str, FeatureShardConfig]:
    shards: Dict[str, FeatureShardConfig] = {}
    for spec in args.feature_shard:
        shards.update(parse_feature_shard(spec))
    if not shards:
        shards["global"] = FeatureShardConfig(feature_bags=("features",))
    return shards
