"""Stationary covariance kernels for GP hyperparameter tuning.

Reference: photon-lib .../hyperparameter/estimators/kernels/ —
StationaryKernel (ARD lengthscales, amplitude, noise, log-likelihood),
RBF.scala:34-70, Matern52.scala:44-82. numpy implementation (GP tuning is a
driver-side loop over at most hundreds of observations).

Kernel parameterization (theta vector): [amplitude, noise, lengthscale...],
lengthscale either scalar or one-per-dimension (ARD).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_EPS = 1e-10


@dataclasses.dataclass
class StationaryKernel:
    amplitude: float = 1.0
    noise: float = 1e-4
    lengthscale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.asarray([1.0])
    )

    def _scaled_sq_dists(self, x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        ls = np.broadcast_to(self.lengthscale, (x1.shape[1],))
        a = x1 / ls
        b = x2 / ls
        return (
            np.sum(a * a, axis=1)[:, None]
            + np.sum(b * b, axis=1)[None, :]
            - 2.0 * a @ b.T
        ).clip(min=0.0)

    def cov(self, x1: np.ndarray, x2: Optional[np.ndarray] = None) -> np.ndarray:
        raise NotImplementedError

    def with_params(self, theta: np.ndarray, n_dims: int) -> "StationaryKernel":
        amp, noise = np.exp(theta[0]), np.exp(theta[1])
        ls = np.exp(theta[2:])
        if ls.size not in (1, n_dims):
            raise ValueError(f"lengthscale size {ls.size} vs dims {n_dims}")
        return dataclasses.replace(
            self, amplitude=float(amp), noise=float(noise), lengthscale=ls
        )

    def params(self) -> np.ndarray:
        return np.concatenate(
            [[np.log(self.amplitude)], [np.log(self.noise)], np.log(np.atleast_1d(self.lengthscale))]
        )

    def log_likelihood(self, x: np.ndarray, y: np.ndarray) -> float:
        """GP log marginal likelihood of observations under this kernel."""
        n = x.shape[0]
        k = self.cov(x) + (self.noise + _EPS) * np.eye(n)
        try:
            L = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            return -np.inf
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
        return float(
            -0.5 * y @ alpha - np.sum(np.log(np.diag(L))) - 0.5 * n * np.log(2 * np.pi)
        )


@dataclasses.dataclass
class RBF(StationaryKernel):
    def cov(self, x1: np.ndarray, x2: Optional[np.ndarray] = None) -> np.ndarray:
        x2 = x1 if x2 is None else x2
        d2 = self._scaled_sq_dists(x1, x2)
        return self.amplitude * np.exp(-0.5 * d2)


@dataclasses.dataclass
class Matern52(StationaryKernel):
    def cov(self, x1: np.ndarray, x2: Optional[np.ndarray] = None) -> np.ndarray:
        x2 = x1 if x2 is None else x2
        d2 = self._scaled_sq_dists(x1, x2)
        d = np.sqrt(5.0 * d2)
        return self.amplitude * (1.0 + d + 5.0 * d2 / 3.0) * np.exp(-d)


KERNELS = {"rbf": RBF, "matern52": Matern52}
