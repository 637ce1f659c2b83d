"""Legacy single-GLM training driver.

Reference: photon-client .../Driver.scala:92-561 (§3.3) — the staged non-GAME
pipeline: INIT -> PREPROCESSED (read + validate + feature summary) ->
TRAINED (lambda grid with warm start) -> VALIDATED (metrics per lambda, best
model selection), with box-constrained optimization (GLMSuite constraint map)
and text + Avro model output (IOUtils.writeModelsInText).

The JAX package's ``cli/glm.py`` on the port: the batches, the
normalization and the box-constraint map live on ``--device`` (the card by
default; ``--device cpu`` runs the kernels' plain versions), and
``--dtype`` picks the solve's float type (float32 by default; the JAX
package takes its default float, float64 under x64). The summary also
records each stage's wall seconds (host clock, ending in a device
synchronize).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..estimators.model_training import TrainedModel, select_best_model, train_glm_grid
from ..evaluation.suite import build_suite
from ..game.problem import GLMOptimizationConfig
from ..device import resolve_device
from ..io.data import read_avro_dataset, read_libsvm
from ..io.model_io import save_glm
from ..io.validators import VALIDATE_FULL, validate_dataset
from ..ops.normalization import build_normalization
from ..ops.regularization import RegularizationContext
from ..optimize import OptimizerConfig, OptimizerType
from ..utils.logging import setup_logging
from ..utils.stats import compute_feature_statistics
from .params import (
    add_common_io_args,
    build_shard_configs,
    parse_input_columns,
    resolve_input_paths,
)

logger = logging.getLogger("photon_ml_tpu_torch")

STAGES = ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch legacy GLM training driver")
    add_common_io_args(p)
    p.add_argument("--validation-data", default=None)
    p.add_argument("--input-format", default="AVRO", choices=["AVRO", "LIBSVM"])
    p.add_argument("--task", default="logistic_regression")
    p.add_argument("--optimizer", default="LBFGS", choices=[t.value for t in OptimizerType])
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--regularization-type", default="NONE")
    p.add_argument("--elastic-net-alpha", type=float, default=1.0)
    p.add_argument("--regularization-weights", default="0", help="pipe-separated grid")
    p.add_argument(
        "--normalization",
        default="NONE",
        choices=["NONE", "STANDARDIZATION", "SCALE_WITH_STANDARD_DEVIATION", "SCALE_WITH_MAX_MAGNITUDE"],
    )
    p.add_argument("--evaluators", default="")
    p.add_argument(
        "--constraint-map",
        default=None,
        help='JSON map feature-key -> [lower, upper] box constraints',
    )
    p.add_argument(
        "--validate-data", default=VALIDATE_FULL,
        choices=[
            "VALIDATE_FULL", "VALIDATE_SAMPLE", "VALIDATE_QUARANTINE", "DISABLED",
        ],
    )
    p.add_argument(
        "--seed", type=int, default=0,
        help="run seed for seeded subsampling (VALIDATE_SAMPLE row draws)",
    )
    p.add_argument("--variance-type", default="NONE", choices=["NONE", "SIMPLE", "FULL"])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    return p


_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def run(argv: Optional[List[str]] = None) -> dict:
    """The staged driver; returns the summary it writes to summary.json."""
    return run_models(argv)[0]


def run_models(argv: Optional[List[str]] = None) -> Tuple[dict, List[TrainedModel]]:
    """``run``, returning the trained models of the grid beside the summary."""
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    stage = "INIT"
    stage_seconds = {}
    t0 = time.perf_counter()

    def stage_done(name):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        stage_seconds[name] = t1 - t0
        t0 = t1

    # ---- PREPROCESS ----------------------------------------------------------
    if args.input_format == "LIBSVM":
        raw = read_libsvm(args.input_data)
        index_maps = None
        shard = "global"
        validation = read_libsvm(args.validation_data, dim=raw.shard_dims["global"] - 1) if args.validation_data else None
    else:
        shards = build_shard_configs(args)
        shard = next(iter(shards))
        raw, index_maps = read_avro_dataset(
            resolve_input_paths(args), shards,
            response_column=args.response_column,
            columns=parse_input_columns(args),
        )
        validation = None
        if args.validation_data:
            validation, _ = read_avro_dataset(
                args.validation_data, shards, index_maps=index_maps,
                response_column=args.response_column,
                columns=parse_input_columns(args),
            )
    stage_done("read")
    validate_dataset(raw, args.task, args.validate_data, rng_seed=args.seed)
    stage_done("validate")
    stats = compute_feature_statistics(raw, shard)
    stage_done("statistics")
    stage = "PREPROCESSED"
    logger.info("stage %s: %d rows, %d features", stage, raw.n_rows, raw.shard_dims[shard])

    # ---- TRAIN ---------------------------------------------------------------
    batch = raw.to_batch(shard, dtype=dtype, device=device)
    norm = None
    if args.normalization != "NONE":
        intercept = None
        if index_maps is not None:
            intercept = index_maps[shard].intercept_index
        elif args.input_format == "LIBSVM":
            intercept = raw.shard_dims[shard] - 1  # read_libsvm appends intercept last
        norm = build_normalization(
            args.normalization, stats["mean"], stats["variance"],
            stats["max_magnitude"], intercept_index=intercept,
            dtype=batch.labels.dtype, device=device,
        )
    stage_done("batch_and_normalization")

    box = None
    if args.constraint_map and index_maps is not None:
        with open(args.constraint_map) as f:
            cmap = json.load(f)
        d = raw.shard_dims[shard]
        lower = np.full(d, -np.inf)
        upper = np.full(d, np.inf)
        imap = index_maps[shard]
        for key, (lo, hi) in cmap.items():
            idx = imap.get_index(key)
            if idx >= 0:
                lower[idx], upper[idx] = lo, hi
        box = (
            torch.as_tensor(lower, dtype=batch.labels.dtype, device=device),
            torch.as_tensor(upper, dtype=batch.labels.dtype, device=device),
        )

    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(
            optimizer_type=OptimizerType(args.optimizer),
            tolerance=args.tolerance,
            max_iterations=args.max_iterations,
            box_constraints=box,
        ),
        regularization=RegularizationContext(
            args.regularization_type, args.elastic_net_alpha
        ),
        variance_type=args.variance_type,
    )
    weights = [float(w) for w in args.regularization_weights.split("|")]
    trained = train_glm_grid(batch, args.task, cfg, weights, normalization=norm)
    stage_done("train")
    stage = "TRAINED"
    logger.info("stage %s: %d models", stage, len(trained))

    # ---- VALIDATE ------------------------------------------------------------
    best = trained[-1]
    if validation is not None:
        specs = [e for e in args.evaluators.split(",") if e] or _default_evaluators(args.task)
        suite = build_suite(specs, validation.labels, validation.weights)
        vbatch = validation.to_batch(shard, dtype=dtype, device=device)
        best, _ = select_best_model(trained, vbatch, suite)
        stage_done("validate_models")
        stage = "VALIDATED"
        logger.info("stage %s: best lambda=%s metrics=%s", stage, best.reg_weight, best.validation_metrics)

    # ---- OUTPUT --------------------------------------------------------------
    os.makedirs(args.output_dir, exist_ok=True)
    summary = {
        "stage": stage,
        "models": [
            {
                "reg_weight": t.reg_weight,
                "iterations": int(t.solver_result.iterations),
                "convergence_reason": int(t.solver_result.reason),
                "loss": float(t.solver_result.loss),
                "metrics": t.validation_metrics,
            }
            for t in trained
        ],
        "best_reg_weight": best.reg_weight,
        "stage_seconds": stage_seconds,
    }
    for t in trained:
        sub = os.path.join(args.output_dir, f"lambda-{t.reg_weight}")
        os.makedirs(sub, exist_ok=True)
        # text model output (IOUtils.writeModelsInText format: key\tvalue)
        means = t.model.coefficients.means.detach().cpu().numpy()
        with open(os.path.join(sub, "model.txt"), "w") as f:
            for i, v in enumerate(means):
                key = index_maps[shard].get_feature_name(i) if index_maps else str(i)
                f.write(f"{key}\t{v}\n")
        if index_maps is not None:
            save_glm(os.path.join(sub, "model.avro"), t.model, index_maps[shard])
    stage_done("write_models")
    with open(os.path.join(args.output_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    logger.info("wrote %d models to %s", len(trained), args.output_dir)
    return summary, trained


def _default_evaluators(task: str) -> List[str]:
    t = task.lower()
    if t in ("logistic_regression", "smoothed_hinge_loss_linear_svm"):
        return ["AUC"]
    if t == "poisson_regression":
        return ["POISSON_LOSS"]
    return ["RMSE"]


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
