"""Acquisition criteria for Bayesian search (minimization convention).

Reference: photon-lib .../hyperparameter/criteria/ —
ExpectedImprovement.scala:33-58, ConfidenceBound.scala:48.
"""

from __future__ import annotations

import numpy as np


def expected_improvement(best: float, mean: np.ndarray, var: np.ndarray) -> np.ndarray:
    """EI of improving BELOW ``best`` (we minimize the evaluation metric)."""
    from scipy.stats import norm  # here, not at import: scipy.stats takes seconds to import

    std = np.sqrt(var)
    gamma = (best - mean) / std
    return std * (gamma * norm.cdf(gamma) + norm.pdf(gamma))


def confidence_bound(mean: np.ndarray, var: np.ndarray, explore: float = 2.0) -> np.ndarray:
    """Lower confidence bound, negated so that HIGHER = more promising
    (uniform "pick argmax of acquisition" convention)."""
    return -(mean - explore * np.sqrt(var))


def constant_liar(values: np.ndarray, strategy: str = "min") -> float:
    """Fantasy value for a pending (not-yet-evaluated) batch candidate:
    the constant-liar heuristic behind greedy qEI (Ginsbourger et al. 2010).

    Under the minimization convention the "min" lie is the MOST OPTIMISTIC
    (pretend the pending point achieved the best value seen), which pushes
    subsequent proposals away from it hardest — the diversity-preserving
    choice for lane batches. "max" is the pessimistic lie, "mean" the
    neutral one."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        raise ValueError("constant_liar needs at least one observed value")
    if strategy == "min":
        return float(np.min(v))
    if strategy == "max":
        return float(np.max(v))
    if strategy == "mean":
        return float(np.mean(v))
    raise ValueError(f"constant_liar strategy must be min|max|mean: {strategy!r}")
