"""Slice sampling for kernel hyperparameter posteriors.

Reference: photon-lib .../hyperparameter/SliceSampler.scala:52-216 — standard
univariate slice sampling (Neal 2003) applied coordinate-wise with step-out
and shrink, used to integrate over GP kernel hyperparameters.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def slice_sample_one(
    logp: Callable[[np.ndarray], float],
    x0: np.ndarray,
    rng: np.random.Generator,
    step_size: float = 1.0,
    max_step_out: int = 1000,
) -> np.ndarray:
    """One full coordinate-wise slice-sampling sweep from x0."""
    x = x0.copy()
    for dim in range(len(x)):
        x = _sample_dim(logp, x, dim, rng, step_size, max_step_out)
    return x


def _sample_dim(
    logp: Callable,
    x: np.ndarray,
    dim: int,
    rng: np.random.Generator,
    step_size: float,
    max_step_out: int,
) -> np.ndarray:
    y = logp(x) + np.log(rng.uniform() + 1e-300)

    # step out
    u = rng.uniform()
    lower = x[dim] - u * step_size
    upper = lower + step_size
    for _ in range(max_step_out):
        xl = x.copy()
        xl[dim] = lower
        if logp(xl) <= y:
            break
        lower -= step_size
    for _ in range(max_step_out):
        xu = x.copy()
        xu[dim] = upper
        if logp(xu) <= y:
            break
        upper += step_size

    # shrink
    for _ in range(1000):
        cand = x.copy()
        cand[dim] = rng.uniform(lower, upper)
        if logp(cand) > y:
            return cand
        if cand[dim] < x[dim]:
            lower = cand[dim]
        else:
            upper = cand[dim]
    return x  # degenerate slice: keep current point


def slice_sample(
    logp: Callable[[np.ndarray], float],
    x0: np.ndarray,
    n_samples: int,
    rng: np.random.Generator,
    burn_in: int = 10,
    step_size: float = 1.0,
) -> np.ndarray:
    """Draw n_samples (after burn-in sweeps) -> array [n_samples, d]."""
    x = x0.copy()
    for _ in range(burn_in):
        x = slice_sample_one(logp, x, rng, step_size)
    out = np.empty((n_samples, len(x0)))
    for i in range(n_samples):
        x = slice_sample_one(logp, x, rng, step_size)
        out[i] = x
    return out
