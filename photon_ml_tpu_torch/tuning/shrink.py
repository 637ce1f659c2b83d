"""Search-range shrinking from prior observations.

Reference: photon-client .../hyperparameter/ShrinkSearchRange.scala:40-108 —
fit a Matern52 GP to prior (hyperparameters, evaluationValue) observations
rescaled to the unit cube, draw a Sobol candidate pool, pick the candidate
with the best predicted value, and return native-space bounds
`best ± radius` (in unit space), clipped to the original ranges, with
discrete dimensions snapped to their value grid.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import qmc

from .gp import GaussianProcessEstimator
from .kernels import Matern52
from .rescaling import HyperparameterConfig
from .search import _round_discrete
from .serialization import prior_from_json


def get_bounds(
    hyper_params: HyperparameterConfig,
    prior_json: str,
    prior_default: Optional[Dict[str, float]] = None,
    radius: float = 0.25,
    candidate_pool_size: int = 1000,
    seed: int = 0,
    higher_is_better: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (lower[d], upper[d]) native-space bounds for a shrunk search range.

    `higher_is_better` controls which predicted value counts as best at the
    candidate-selection step (the reference always takes the max,
    ShrinkSearchRange.selectBestCandidate).
    """
    names = [p.name for p in hyper_params.params]
    priors = prior_from_json(prior_json, prior_default or {}, names)
    if not priors:
        raise ValueError("no prior observations to shrink the range from")

    x = np.stack([hyper_params.scale_down(natives) for natives, _ in priors])
    y = np.asarray([v for _, v in priors], dtype=np.float64)
    # the GP machinery minimizes nothing by itself; center for conditioning
    y_centered = y - float(np.mean(y))

    posterior = GaussianProcessEstimator(kernel=Matern52(), seed=seed).fit(
        x, y_centered
    )
    # draw a power-of-two pool (Sobol balance), then trim
    pool = 1 << int(np.ceil(np.log2(max(candidate_pool_size, 2))))
    candidates = qmc.Sobol(d=hyper_params.dim, scramble=True, seed=seed).random(pool)[
        :candidate_pool_size
    ]
    mu, _ = posterior.predict(candidates)
    best = candidates[int(np.argmax(mu) if higher_is_better else np.argmin(mu))]

    discrete = hyper_params.discrete_dims()
    lower_unit = _round_discrete(np.clip(best - radius, 0.0, 1.0), discrete)
    upper_unit = _round_discrete(np.clip(best + radius, 0.0, 1.0), discrete)

    lower = hyper_params.scale_up(lower_unit)
    upper = hyper_params.scale_up(upper_unit)
    mins = np.asarray([p.min for p in hyper_params.params])
    maxs = np.asarray([p.max for p in hyper_params.params])
    return np.maximum(lower, mins), np.minimum(upper, maxs)
