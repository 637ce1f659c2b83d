"""CLI parameter grammar shared by the drivers.

The JAX package's ``cli/params.py`` on the port (reference: photon-client
io/scopt/**, the scopt parsers with their comma/pipe grammar for nested
configs, e.g. ``--coordinate name=global,shard=...,optimizer=LBFGS,
reg.weights=0.1|1|10``). ``parse_mesh_shape`` gives a mesh's axes (the
planner takes a data axis of the process count, one card a process) and
``plan_host_row_split`` each process's row range of the input.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from ..estimators.game_estimator import CoordinateConfig, world_size
from ..game.problem import GLMOptimizationConfig
from ..io.data import FeatureShardConfig
from ..ops.regularization import RegularizationContext
from ..optimize import OptimizerConfig, OptimizerType
from ..plan import PlanError, check_retrain_composition  # noqa: F401  (the drivers' import site)


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


def parse_coordinate(spec: str) -> CoordinateConfig:
    """``name=global,shard=globalShard[,re.type=userId],optimizer=LBFGS,
    tolerance=1e-7,max.iter=100,reg.type=L2,reg.alpha=0.5,reg.weights=0.1|1|10,
    down.sampling.rate=1.0,active.cap=256,active.lower.bound=1,variance=NONE,
    features.to.samples.ratio=0.5,layout=auto,feature.dtype=bfloat16,
    hbm.budget.mb=4096``

    ``feature.dtype=bfloat16``: narrow feature storage (fixed-effect batches
    and RE entity blocks; solver state stays wide). ``hbm.budget.mb``: the
    coordinate's device budget in MiB; it streams (out of core) when its
    device bytes exceed it."""
    kv = parse_kv(spec)
    name = kv.pop("name")
    shard = kv.pop("shard")
    re_type = kv.pop("re.type", None)
    opt = OptimizerConfig(
        optimizer_type=OptimizerType(kv.pop("optimizer", "LBFGS").upper()),
        tolerance=float(kv.pop("tolerance", 1e-7)),
        max_iterations=int(kv.pop("max.iter", 100)),
        num_corrections=int(kv.pop("num.corrections", 10)),
    )
    reg = RegularizationContext(
        reg_type=kv.pop("reg.type", "NONE"),
        elastic_net_alpha=float(kv.pop("reg.alpha", 1.0)),
    )
    weights = tuple(float(w) for w in kv.pop("reg.weights", "0").split("|"))
    cfg = GLMOptimizationConfig(
        optimizer=opt,
        regularization=reg,
        reg_weight=weights[0],
        down_sampling_rate=float(kv.pop("down.sampling.rate", 1.0)),
        variance_type=kv.pop("variance", "NONE").upper(),
    )
    layout = kv.pop("layout", "auto").lower()
    if layout not in ("auto", "dense", "ell", "sparse", "coo", "tiled"):
        raise ValueError(f"unknown layout {layout!r} in coordinate {name!r}")
    fdt_name = kv.pop("feature.dtype", "").lower()
    if fdt_name not in ("", "float32", "bfloat16"):
        raise ValueError(
            f"unknown feature.dtype {fdt_name!r} in coordinate {name!r} "
            "(expected float32|bfloat16)"
        )
    cc = CoordinateConfig(
        name=name,
        feature_shard=shard,
        config=cfg,
        random_effect_type=re_type,
        reg_weights=weights,
        active_cap=int(kv.pop("active.cap")) if "active.cap" in kv else None,
        active_lower_bound=int(kv.pop("active.lower.bound", 1)),
        features_to_samples_ratio=(
            float(kv.pop("features.to.samples.ratio")) if "features.to.samples.ratio" in kv else None
        ),
        layout=layout,
        feature_dtype=torch.bfloat16 if fdt_name == "bfloat16" else None,
        hbm_budget_mb=int(kv.pop("hbm.budget.mb")) if "hbm.budget.mb" in kv else None,
    )
    if kv:
        raise ValueError(f"unknown coordinate keys: {sorted(kv)}")
    return cc


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


def parse_mesh_shape(spec: Optional[str]):
    """``data=4,model=2`` -> the mesh's axes ``{"data": 4, "model": 2}``;
    ''/None is no mesh (one device a process). The port runs one card a
    process, so the planner takes a data axis of the process count and
    refuses a model axis (ROADMAP A10)."""
    if not spec:
        return None
    kv = parse_kv(spec)
    n_data = int(kv.pop("data", 1))
    n_model = int(kv.pop("model", 1))
    if kv:
        raise ValueError(f"unknown mesh keys: {sorted(kv)}")
    return {"data": n_data, "model": n_model}


def parse_pipeline_depth(value) -> int:
    """``--pipeline-depth N`` -> validated sweep pipelining depth (>= 1)."""
    depth = int(value)
    if depth < 1:
        raise ValueError(f"pipeline depth must be >= 1: {depth}")
    return depth


def plan_host_row_split(input_paths):
    """Multi-process input planning shared by ``cli.train`` and ``cli.score``:
    the rows of every part file counted once (block headers only) and the
    global row space split evenly across the processes. Returns
    ``(row_range, part_counts)``, or ``(None, None)`` for one process."""
    if world_size() <= 1:
        return None, None
    from ..io.avro import count_avro_rows, list_avro_parts
    from ..parallel import multihost

    paths = [input_paths] if isinstance(input_paths, str) else input_paths
    part_counts = {part: count_avro_rows(part) for p in paths for part in list_avro_parts(p)}
    return multihost.host_row_range(sum(part_counts.values())), part_counts
