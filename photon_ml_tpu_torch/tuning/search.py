"""Hyperparameter search: Sobol random search + GP Bayesian search.

Reference: photon-lib .../hyperparameter/search/ — RandomSearch.scala:34-183
(Sobol quasi-random candidates, discrete rounding, find / findWithPriors) and
GaussianProcessSearch.scala:52-197 (fit GP on centered observations, pick the
argmax of expected improvement over a 250-candidate Sobol pool; minimization
convention: lower observed value is better).

The evaluation function runs a full train+validate (the reference's
GameEstimatorEvaluationFunction does a whole Spark fit per candidate; ours
does a whole TPU fit).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .criteria import confidence_bound, constant_liar, expected_improvement
from .gp import GaussianProcessEstimator
from .kernels import Matern52, StationaryKernel

# EvaluationFunction contract (EvaluationFunction.scala:31-58):
# candidate unit-vector -> (value_to_minimize, artifact)
EvaluationFn = Callable[[np.ndarray], Tuple[float, object]]

# Batched contract (lane-stacked sweeps, game/lanes.py): a [k, n_params]
# candidate block -> k (value, artifact) pairs, one per lane, in order.
BatchEvaluationFn = Callable[[np.ndarray], Sequence[Tuple[float, object]]]


@dataclasses.dataclass
class Observation:
    candidate: np.ndarray
    value: float
    artifact: object = None


def _round_discrete(x: np.ndarray, discrete_params: Dict[int, int]) -> np.ndarray:
    """Snap discrete dims of a unit vector onto their value grid
    (RandomSearch discreteParams semantics)."""
    out = x.copy()
    for dim, n_values in discrete_params.items():
        if n_values > 1:
            out[dim] = np.floor(out[dim] * n_values).clip(0, n_values - 1) / (
                n_values - 1
            )
    return out


class RandomSearch:
    """Sobol quasi-random search over the unit hypercube."""

    def __init__(
        self,
        n_params: int,
        evaluation_function: EvaluationFn,
        discrete_params: Optional[Dict[int, int]] = None,
        seed: int = 0,
    ):
        self.n_params = n_params
        self.evaluation_function = evaluation_function
        self.discrete_params = discrete_params or {}
        self.seed = seed
        from scipy.stats import qmc  # here, not at import: scipy.stats takes seconds to import

        self._sobol = qmc.Sobol(d=n_params, scramble=True, seed=seed)

    def draw_candidates(self, n: int) -> np.ndarray:
        return self._sobol.random(n)

    def next_candidate(
        self, observations: Sequence[Observation], prior_observations: Sequence[Observation]
    ) -> np.ndarray:
        return self.draw_candidates(1)[0]

    def find(
        self,
        n: int,
        observations: Optional[Sequence[Observation]] = None,
        prior_observations: Optional[Sequence[Observation]] = None,
    ) -> List[Observation]:
        """Evaluate n candidates sequentially (findWithPriors semantics:
        observations feed the model; priors are fixed external evidence)."""
        observations = list(observations or [])
        prior_observations = list(prior_observations or [])
        out: List[Observation] = []
        for _ in range(n):
            cand = _round_discrete(
                self.next_candidate(observations + out, prior_observations),
                self.discrete_params,
            )
            value, artifact = self.evaluation_function(cand)
            out.append(Observation(candidate=cand, value=float(value), artifact=artifact))
        return out

    def _distinct(
        self, cands: List[np.ndarray], cand: np.ndarray, tol: float = 1e-9
    ) -> np.ndarray:
        """Return ``cand``, replaced by fresh Sobol draws while it collides
        with an already-proposed batch member (within ``tol`` in every dim).
        Guarantees a batch of k proposals has k DISTINCT candidates — k
        identical lanes would burn k-1 trials of budget on one point."""
        for _ in range(100):
            if not any(np.all(np.abs(c - cand) <= tol) for c in cands):
                return cand
            cand = _round_discrete(self.draw_candidates(1)[0], self.discrete_params)
        return cand  # fully-saturated discrete grids: accept the collision

    def propose_batch(
        self,
        k: int,
        observations: Sequence[Observation],
        prior_observations: Sequence[Observation],
    ) -> np.ndarray:
        """Propose k distinct candidates for one lane batch. Sobol points are
        distinct by construction; dedup only guards discrete-rounded
        collisions."""
        out: List[np.ndarray] = []
        for _ in range(k):
            cand = _round_discrete(
                self.next_candidate(observations, prior_observations),
                self.discrete_params,
            )
            out.append(self._distinct(out, cand))
        return np.stack(out)

    def find_batched(
        self,
        n: int,
        batch_size: int,
        evaluate_batch: BatchEvaluationFn,
        observations: Optional[Sequence[Observation]] = None,
        prior_observations: Optional[Sequence[Observation]] = None,
    ) -> List[Observation]:
        """Evaluate n candidates in lane batches of ``batch_size``: propose a
        distinct batch, evaluate all its lanes in one call, fold the results
        back as ordinary observations, repeat. The final batch shrinks to the
        remaining budget."""
        observations = list(observations or [])
        prior_observations = list(prior_observations or [])
        out: List[Observation] = []
        while len(out) < n:
            k = min(batch_size, n - len(out))
            cands = self.propose_batch(k, observations + out, prior_observations)
            results = evaluate_batch(cands)
            if len(results) != len(cands):
                raise ValueError(
                    f"evaluate_batch returned {len(results)} results for "
                    f"{len(cands)} candidates"
                )
            for cand, (value, artifact) in zip(cands, results):
                out.append(
                    Observation(
                        candidate=cand, value=float(value), artifact=artifact
                    )
                )
        return out


class GaussianProcessSearch(RandomSearch):
    """Bayesian search: GP posterior + expected improvement."""

    def __init__(
        self,
        n_params: int,
        evaluation_function: EvaluationFn,
        discrete_params: Optional[Dict[int, int]] = None,
        kernel: Optional[StationaryKernel] = None,
        candidate_pool_size: int = 250,
        noisy_target: bool = True,
        seed: int = 0,
    ):
        super().__init__(n_params, evaluation_function, discrete_params, seed)
        self.kernel = kernel or Matern52()
        self.candidate_pool_size = candidate_pool_size
        self.noisy_target = noisy_target

    def next_candidate(
        self, observations: Sequence[Observation], prior_observations: Sequence[Observation]
    ) -> np.ndarray:
        all_obs = list(observations) + list(prior_observations)
        # cold start until we have more observations than dimensions
        # (GaussianProcessSearch.scala: points.rows > numParams)
        if len(observations) <= self.n_params:
            return self.draw_candidates(1)[0]

        x = np.stack([o.candidate for o in all_obs])
        y = np.asarray([o.value for o in all_obs])
        mean_y = float(np.mean(y))
        y_centered = y - mean_y
        best = float(np.min(y_centered))

        estimator = GaussianProcessEstimator(
            kernel=self.kernel, noisy_target=self.noisy_target, seed=self.seed
        )
        posterior = estimator.fit(x, y_centered)
        candidates = self.draw_candidates(self.candidate_pool_size)
        mu, var = posterior.predict(candidates)
        ei = expected_improvement(best, mu, var)
        return candidates[int(np.argmax(ei))]

    def propose_batch(
        self,
        k: int,
        observations: Sequence[Observation],
        prior_observations: Sequence[Observation],
    ) -> np.ndarray:
        """Greedy qEI via the constant-liar heuristic: propose the EI argmax,
        append a fantasy observation at the optimistic ("min") lie for it,
        refit, repeat — so the k lanes of a batch spread over the acquisition
        surface instead of piling onto one EI peak. Cold start (too few REAL
        observations to fit a non-degenerate GP — lies are not evidence)
        falls back to Sobol draws, which are distinct by construction."""
        real = list(observations)
        prior = list(prior_observations)
        out: List[np.ndarray] = []
        lies: List[Observation] = []
        lie_pool = [o.value for o in real] + [o.value for o in prior]
        for _ in range(k):
            if len(real) <= self.n_params:
                cand = self.draw_candidates(1)[0]
            else:
                cand = self.next_candidate(real + lies, prior)
            cand = self._distinct(out, _round_discrete(cand, self.discrete_params))
            out.append(cand)
            if lie_pool:
                lies.append(
                    Observation(
                        candidate=cand,
                        value=constant_liar(np.asarray(lie_pool), "min"),
                    )
                )
        return np.stack(out)
