"""Carry parameters between the JAX package and this one, as numpy arrays.

The functions take the JAX package's parameters as numpy arrays (for
example ``np.asarray(jax_model.coefficients.means)``) and build this
package's objects, or return numpy arrays from them, so that both packages
compute on identical parameters. Nothing here imports the JAX package.

A GAME model travels as a plain dict, the same both ways:

    {"task": str, "models": {coordinate: part}}
    part = {"kind": "fixed", "feature_shard", "task", "means", "variances"}
         | {"kind": "random", "random_effect_type", "feature_shard", "task",
            "entity_ids", "coef_indices", "coef_values", "variances"}

The lambda-lane sweeps carry lane-stacked coefficients (``[d, L]`` for a
fixed effect, ``[E, S, L]`` for a random effect: ``lanes_from_numpy`` /
``lanes_to_numpy``) and the tuner's observations (``observations_to_numpy``
/ ``observations_from_numpy``: ``(candidate, value)`` pairs, which either
package's ``tuning.Observation`` takes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.coefficients import Coefficients
from .models.game import FixedEffectModel, GameModel, RandomEffectModel
from .models.glm import GeneralizedLinearModel, model_for_task
from .ops.normalization import NormalizationContext


def _tensor(a: Optional[np.ndarray], dtype, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.array(a), device=device).to(dtype)


def _numpy(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().to("cpu").numpy()


def coefficients_from_numpy(
    means: np.ndarray,
    variances: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> Coefficients:
    dev = resolve_device(device)
    return Coefficients(means=_tensor(means, dtype, dev), variances=_tensor(variances, dtype, dev))


def coefficients_to_numpy(c: Coefficients) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    return _numpy(c.means), _numpy(c.variances)


def normalization_from_numpy(
    factors: Optional[np.ndarray],
    shifts: Optional[np.ndarray],
    intercept_index: Optional[int],
    dtype=torch.float32,
    device: DeviceLike = None,
) -> NormalizationContext:
    dev = resolve_device(device)
    return NormalizationContext(
        factors=_tensor(factors, dtype, dev),
        shifts=_tensor(shifts, dtype, dev),
        intercept_index=None if intercept_index is None else int(intercept_index),
    )


def normalization_to_numpy(
    norm: NormalizationContext,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[int]]:
    return _numpy(norm.factors), _numpy(norm.shifts), norm.intercept_index


def model_from_numpy(
    task: str,
    means: np.ndarray,
    variances: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> GeneralizedLinearModel:
    return model_for_task(task, coefficients_from_numpy(means, variances, dtype, device))


def model_to_numpy(
    model: GeneralizedLinearModel,
) -> Tuple[str, np.ndarray, Optional[np.ndarray]]:
    means, variances = coefficients_to_numpy(model.coefficients)
    return model.task, means, variances


def random_effect_model_from_numpy(
    random_effect_type: str,
    feature_shard: str,
    task: str,
    entity_ids: np.ndarray,
    coef_indices: np.ndarray,
    coef_values: np.ndarray,
    variances: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> RandomEffectModel:
    dev = resolve_device(device)
    return RandomEffectModel(
        random_effect_type=random_effect_type,
        feature_shard=feature_shard,
        task=task,
        entity_ids=np.asarray(entity_ids, dtype=object),
        coef_indices=_tensor(coef_indices, torch.int32, dev),
        coef_values=_tensor(coef_values, dtype, dev),
        variances=_tensor(variances, dtype, dev),
    )


def random_effect_model_to_numpy(model: RandomEffectModel) -> Dict[str, object]:
    return {
        "kind": "random",
        "random_effect_type": model.random_effect_type,
        "feature_shard": model.feature_shard,
        "task": model.task,
        "entity_ids": np.asarray(model.entity_ids, dtype=object),
        "coef_indices": _numpy(model.coef_indices),
        "coef_values": _numpy(model.coef_values),
        "variances": _numpy(model.variances),
    }


def game_model_from_numpy(
    parts: Dict[str, object], dtype=torch.float32, device: DeviceLike = None
) -> GameModel:
    """Build a GameModel from the dict described at the top of the module."""
    models = {}
    for name, p in parts["models"].items():
        if p["kind"] == "fixed":
            glm = model_from_numpy(p["task"], p["means"], p.get("variances"), dtype, device)
            models[name] = FixedEffectModel(model=glm, feature_shard=p["feature_shard"])
        elif p["kind"] == "random":
            models[name] = random_effect_model_from_numpy(
                p["random_effect_type"], p["feature_shard"], p["task"], p["entity_ids"],
                p["coef_indices"], p["coef_values"], p.get("variances"), dtype, device,
            )
        else:
            raise ValueError(f"unknown model kind {p['kind']!r} for coordinate {name!r}")
    return GameModel(models=models, task=parts["task"])


def game_model_to_numpy(model: GameModel) -> Dict[str, object]:
    """The dict described at the top of the module."""
    out = {}
    for name, m in model.models.items():
        if isinstance(m, FixedEffectModel):
            task, means, variances = model_to_numpy(m.model)
            out[name] = {
                "kind": "fixed", "feature_shard": m.feature_shard, "task": task,
                "means": means, "variances": variances,
            }
        else:
            out[name] = random_effect_model_to_numpy(m)
    return {"task": model.task, "models": out}


def lanes_from_numpy(coeffs: np.ndarray, dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Lane-stacked coefficients (``[d, L]`` or ``[E, S, L]``) as a tensor
    on ``device``."""
    a = np.asarray(coeffs)
    if a.ndim not in (2, 3):
        raise ValueError(f"lane-stacked coefficients are [d, L] or [E, S, L], got shape {a.shape}")
    return _tensor(a, dtype, resolve_device(device))


def lanes_to_numpy(coeffs: torch.Tensor) -> np.ndarray:
    return _numpy(coeffs)


def observations_to_numpy(observations: Sequence) -> List[Tuple[np.ndarray, float]]:
    """The tuner's observations (either package's ``tuning.Observation``)
    as ``(candidate float64 [dim], value)`` pairs; artifacts stay behind."""
    return [(np.asarray(o.candidate, dtype=np.float64), float(o.value)) for o in observations]


def observations_from_numpy(pairs: Sequence[Tuple[np.ndarray, float]]) -> List:
    """``(candidate, value)`` pairs as this package's ``tuning.Observation``."""
    from .tuning import Observation

    return [Observation(candidate=np.asarray(c, dtype=np.float64), value=float(v)) for c, v in pairs]
