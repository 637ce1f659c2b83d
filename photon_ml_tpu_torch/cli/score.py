"""GAME scoring driver.

The JAX package's ``cli/score.py`` on the port, single-process. Reference:
photon-client .../cli/game/scoring/GameScoringDriver.scala:25-284 (§3.2):
read data -> load GAME model -> score through the ``ScoreEngine`` (the same
assembly as ``GameTransformer.transform``, so the scores are equal bit for
bit) -> optional evaluation -> write ScoringResultAvro records.

The model loads onto ``--device`` (the card by default; ``--device cpu``
runs the plain versions) in ``--dtype``. ``--distributed`` (one row range
per process) is ROADMAP A10.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

import torch

from ..device import resolve_device
from ..estimators.game_estimator import GameTransformer
from ..io.avro import write_avro_file
from ..io.data import read_avro_dataset
from ..io.index_map import load_partitioned
from ..io.model_io import load_game_model
from ..io.schemas import SCORING_RESULT_AVRO
from ..plan import PlanError
from ..utils.logging import setup_logging
from .params import add_common_io_args, build_shard_configs, parse_input_columns, resolve_input_paths

logger = logging.getLogger("photon_ml_tpu_torch")

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("photon-ml-tpu-torch game scoring driver")
    add_common_io_args(p)
    p.add_argument("--model-input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task", default=None, help="override model task type")
    p.add_argument("--evaluators", default="")
    p.add_argument("--model-id", default="", help="modelId stamped on score records")
    p.add_argument("--distributed", default=None, help="ROADMAP A10")
    p.add_argument("--log-file", default=None)
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    return p


def run(argv: Optional[List[str]] = None):
    """Score; returns (scores float64[n], EvaluationResults or None)."""
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level, args.log_file)
    if args.distributed is not None:
        raise PlanError("--distributed is not ported yet (ROADMAP A10)")
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]

    shards = build_shard_configs(args)
    id_tags = [t for t in args.id_tags.split(",") if t]
    index_maps = None
    if args.feature_index_dir:
        index_maps = {s: load_partitioned(args.feature_index_dir, s) for s in shards}
    raw, index_maps = read_avro_dataset(
        resolve_input_paths(args), shards, index_maps=index_maps, id_tag_columns=id_tags,
        response_column=args.response_column, columns=parse_input_columns(args),
    )
    model = load_game_model(args.model_input_dir, index_maps, task=args.task, device=device, dtype=dtype)
    # random-effect types must be available as id tags
    missing = [
        m.random_effect_type
        for m in model.models.values()
        if hasattr(m, "random_effect_type") and m.random_effect_type not in raw.id_tags
    ]
    if missing:
        raise SystemExit(f"model needs id tags {missing}; pass --id-tags {','.join(missing)}")

    evaluators = [e for e in args.evaluators.split(",") if e]
    scores, evaluation = GameTransformer(model=model, dtype=dtype, device=device).transform(
        raw, evaluator_specs=evaluators
    )

    os.makedirs(args.output_dir, exist_ok=True)

    def records():
        for i in range(raw.n_rows):
            yield {
                "uid": None if raw.uids is None or raw.uids[i] is None else str(raw.uids[i]),
                "label": float(raw.labels[i]),
                "modelId": args.model_id,
                "predictionScore": float(scores[i]),
                "weight": float(raw.weights[i]),
                "metadataMap": None,
            }

    write_avro_file(os.path.join(args.output_dir, "scores.avro"), SCORING_RESULT_AVRO, records())
    if evaluation is not None:
        with open(os.path.join(args.output_dir, "evaluation.json"), "w") as f:
            json.dump(evaluation.metrics, f, indent=2, default=float)
        logger.info("evaluation: %s", evaluation.metrics)
    logger.info("wrote %d scores to %s", raw.n_rows, args.output_dir)
    return scores, evaluation


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
