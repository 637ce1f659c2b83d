"""Gaussian-process regression for Bayesian hyperparameter search.

Reference: photon-lib .../hyperparameter/estimators/ —
GaussianProcessModel.scala:34-118 (Cholesky predict: K = L L^T,
alpha = cholSolve(y); mean = K*^T alpha, var = k** - v^T v) and
GaussianProcessEstimator.scala:36-172 (fit = slice-sample kernel
hyperparameters from the log-likelihood posterior, average predictions over
the sampled models).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .kernels import Matern52, StationaryKernel
from .slice_sampler import slice_sample

_EPS = 1e-10


@dataclasses.dataclass
class GaussianProcessModel:
    kernel: StationaryKernel
    x_train: np.ndarray  # [n, d]
    y_train: np.ndarray  # [n]
    _L: np.ndarray = dataclasses.field(init=False, repr=False)
    _alpha: np.ndarray = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        n = self.x_train.shape[0]
        k = self.kernel.cov(self.x_train) + (self.kernel.noise + _EPS) * np.eye(n)
        self._L = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, self.y_train)
        )

    def predict(self, x: np.ndarray):
        """-> (mean[n*], var[n*])."""
        ks = self.kernel.cov(self.x_train, x)  # [n, n*]
        mean = ks.T @ self._alpha
        v = np.linalg.solve(self._L, ks)
        kss = np.diag(self.kernel.cov(x))
        var = np.maximum(kss - np.sum(v * v, axis=0), 1e-12)
        return mean, var


@dataclasses.dataclass
class GaussianProcessEstimator:
    """Fit = integrate over kernel hyperparameters by slice sampling."""

    kernel: StationaryKernel = dataclasses.field(default_factory=Matern52)
    n_hyper_samples: int = 5
    noisy_target: bool = True
    seed: int = 0

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GaussianProcessPosterior":
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64)
        d = x.shape[1]
        rng = np.random.default_rng(self.seed)

        base = self.kernel.with_params(
            np.concatenate([[0.0], [np.log(1e-3)], np.zeros(d)]), d
        )

        def logp(theta: np.ndarray) -> float:
            if np.any(np.abs(theta) > 20):
                return -np.inf
            k = self.kernel.with_params(theta, d)
            if not self.noisy_target:
                k = dataclasses.replace(k, noise=1e-6)
            return k.log_likelihood(x, y)

        theta0 = base.params()
        samples = slice_sample(logp, theta0, self.n_hyper_samples, rng, burn_in=5)
        models: List[GaussianProcessModel] = []
        for theta in samples:
            kern = self.kernel.with_params(theta, d)
            if not self.noisy_target:
                kern = dataclasses.replace(kern, noise=1e-6)
            try:
                models.append(GaussianProcessModel(kern, x, y))
            except np.linalg.LinAlgError:
                continue
        if not models:
            models = [GaussianProcessModel(base, x, y)]
        return GaussianProcessPosterior(models)


@dataclasses.dataclass
class GaussianProcessPosterior:
    models: Sequence[GaussianProcessModel]

    def predict(self, x: np.ndarray):
        means, variances = zip(*(m.predict(x) for m in self.models))
        mean = np.mean(means, axis=0)
        # law of total variance across hyperparameter samples
        var = np.mean(variances, axis=0) + np.var(means, axis=0)
        return mean, var
