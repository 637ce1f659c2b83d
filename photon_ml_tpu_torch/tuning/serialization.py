"""Hyperparameter config + prior-observation JSON (de)serialization.

Reference: photon-lib .../hyperparameter/HyperparameterSerialization.scala:27-136
— `configFromJson` parses a tuning config of the shape

    {"tuning_mode": "BAYESIAN",
     "variables": {"global.reg_weight": {"type": "DOUBLE", "min": -4, "max": 4,
                                         "transform": "LOG"},
                   "per-user.reg_weight": {"type": "INT", "min": 0, "max": 8}}}

(`type: INT` marks a discrete dimension; transform is LOG or SQRT), and
`priorFromJson` parses prior observations of the shape

    {"records": [{"global.reg_weight": "0.1", "evaluationValue": "0.734", ...}]}

where missing hyperparameters fall back to caller-supplied defaults. The
native-value vectors come back ordered by the config's parameter list.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .rescaling import (
    HyperparameterConfig,
    ParamRange,
    TRANSFORM_LOG,
    TRANSFORM_NONE,
    TRANSFORM_SQRT,
)

TUNING_MODE_NONE = "NONE"
TUNING_MODE_RANDOM = "RANDOM"
TUNING_MODE_BAYESIAN = "BAYESIAN"

_VALID_TRANSFORMS = {TRANSFORM_LOG, TRANSFORM_SQRT}


def config_from_json(text: str) -> Tuple[str, HyperparameterConfig]:
    """Parse a tuning config JSON -> (tuning_mode, HyperparameterConfig).

    HyperparameterSerialization.configFromJson semantics: mode strings other
    than BAYESIAN/RANDOM map to NONE; INT-typed variables become discrete
    dimensions; an unknown transform is an error.
    """
    obj = json.loads(text)
    if not isinstance(obj, dict) or "variables" not in obj:
        raise ValueError("hyperparameter config JSON must be a map with 'variables'")

    mode = str(obj.get("tuning_mode", TUNING_MODE_NONE)).upper()
    if mode not in (TUNING_MODE_BAYESIAN, TUNING_MODE_RANDOM):
        mode = TUNING_MODE_NONE

    variables = obj["variables"]
    if not isinstance(variables, dict):
        raise ValueError("'variables' must be a map of name -> {type,min,max}")

    params: List[ParamRange] = []
    for name, spec in variables.items():
        if not isinstance(spec, dict):
            raise ValueError(f"variable {name!r} spec must be a map")
        var_type = str(spec.get("type", "DOUBLE")).upper()
        transform = spec.get("transform")
        if transform is not None:
            transform = str(transform).upper()
            if transform not in _VALID_TRANSFORMS:
                raise ValueError(f"invalid transform {transform!r} for {name!r}")
        try:
            lo, hi = float(spec["min"]), float(spec["max"])
        except KeyError as e:
            raise ValueError(f"variable {name!r} is missing required key {e}") from e
        if transform == TRANSFORM_LOG and lo <= 0:
            raise ValueError(f"LOG transform requires min > 0 for {name!r}, got {lo}")
        if transform == TRANSFORM_SQRT and lo < 0:
            raise ValueError(f"SQRT transform requires min >= 0 for {name!r}, got {lo}")
        params.append(
            ParamRange(
                name=name,
                min=lo,
                max=hi,
                transform=transform or TRANSFORM_NONE,
                discrete=var_type == "INT",
            )
        )
    return mode, HyperparameterConfig(params=params)


def prior_from_json(
    text: str,
    prior_default: Dict[str, float],
    param_names: Sequence[str],
) -> List[Tuple[np.ndarray, float]]:
    """Parse prior observations -> [(native_values[d], evaluation_value)].

    Values are stored as strings in the reference wire format
    (HyperparameterSerialization.priorFromJson); both strings and numbers are
    accepted here. Missing parameters take `prior_default[name]`.
    """
    obj = json.loads(text)
    if not isinstance(obj, dict) or "records" not in obj:
        raise ValueError("prior JSON must be a map with 'records'")
    out: List[Tuple[np.ndarray, float]] = []
    for rec in obj["records"]:
        if not isinstance(rec, dict):
            raise ValueError("each prior record must be a map")
        value = float(rec["evaluationValue"])
        natives = []
        for name in param_names:
            if name in rec:
                natives.append(float(rec[name]))
            elif name in prior_default:
                natives.append(float(prior_default[name]))
            else:
                raise KeyError(
                    f"prior record missing {name!r} and no default provided"
                )
        out.append((np.asarray(natives, dtype=np.float64), value))
    return out


def prior_to_json(
    param_names: Sequence[str],
    priors: Sequence[Tuple[np.ndarray, float]],
) -> str:
    """Serialize [(native_values, evaluation_value)] to the records wire shape
    (string-valued fields, matching the reference's reader)."""
    records = []
    for natives, value in priors:
        rec = {n: repr(float(v)) for n, v in zip(param_names, np.asarray(natives))}
        rec["evaluationValue"] = repr(float(value))
        records.append(rec)
    return json.dumps({"records": records})
