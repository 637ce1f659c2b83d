"""Hyperparameter tuner plug-in surface.

Reference: photon-api .../hyperparameter/tuner/ — HyperparameterTuner.scala:39
(search(n, dimension, mode, evaluationFunction, observations)),
HyperparameterTunerFactory.scala:20-48 (DUMMY no-op default; the production
tuner resolved reflectively). Here the in-repo Bayesian tuner IS the
production path: mode RANDOM -> Sobol search, BAYESIAN -> GP search.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .search import (
    BatchEvaluationFn,
    EvaluationFn,
    GaussianProcessSearch,
    Observation,
    RandomSearch,
)

TUNER_DUMMY = "DUMMY"
TUNER_RANDOM = "RANDOM"
TUNER_BAYESIAN = "BAYESIAN"


class HyperparameterTuner:
    def search(
        self,
        n: int,
        dimension: int,
        evaluation_function: EvaluationFn,
        observations: Optional[Sequence[Observation]] = None,
        discrete_params=None,
        seed: int = 0,
        skip: int = 0,
    ) -> List[Observation]:
        """``skip``: candidates already consumed by a previous (checkpointed)
        run — the count comes from the checkpoint record (state file or
        boundary-checkpoint manifest ``tuner_trials``). Deterministic tuners
        burn that many draws so a resumed search continues the original
        candidate sequence instead of repeating its prefix; a resumed run
        with ``skip=k`` followed by ``n-k`` trials therefore evaluates
        exactly the candidates trials ``k..n-1`` of the uninterrupted run
        would have."""
        raise NotImplementedError

    def search_batched(
        self,
        n: int,
        dimension: int,
        evaluate_batch: BatchEvaluationFn,
        batch_size: int,
        observations: Optional[Sequence[Observation]] = None,
        discrete_params=None,
        seed: int = 0,
        skip: int = 0,
    ) -> List[Observation]:
        """Lane-batched :meth:`search`: candidates are proposed
        ``batch_size`` at a time (distinct per batch; GP tuners use the
        constant-liar heuristic) and ``evaluate_batch`` trains the whole
        batch as lambda lanes of one solve (game/lanes.py). ``skip``
        semantics match :meth:`search` — the candidate SEQUENCE is
        chunking-invariant for deterministic tuners (the Sobol stream yields
        the same points whether drawn 1 or k at a time), so a resumed run
        continues the original sequence regardless of lane count."""
        raise NotImplementedError

    @staticmethod
    def _check_skip(skip: int) -> int:
        if skip < 0:
            raise ValueError(
                f"skip must be >= 0 (got {skip}): it counts tuning trials a "
                "previous checkpointed run already consumed"
            )
        return int(skip)

    @staticmethod
    def _check_batch(batch_size: int) -> int:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1: {batch_size}")
        return int(batch_size)


class DummyTuner(HyperparameterTuner):
    """No-op tuner (DummyTuner.scala:39): returns no new observations."""

    def search(self, n, dimension, evaluation_function, observations=None, discrete_params=None, seed=0, skip=0):
        self._check_skip(skip)
        return []

    def search_batched(self, n, dimension, evaluate_batch, batch_size, observations=None, discrete_params=None, seed=0, skip=0):
        self._check_skip(skip)
        self._check_batch(batch_size)
        return []


class RandomTuner(HyperparameterTuner):
    def search(self, n, dimension, evaluation_function, observations=None, discrete_params=None, seed=0, skip=0):
        skip = self._check_skip(skip)
        search = RandomSearch(dimension, evaluation_function, discrete_params, seed)
        if skip:
            search.draw_candidates(skip)  # burn the consumed prefix
        return search.find(n, observations=observations)

    def search_batched(self, n, dimension, evaluate_batch, batch_size, observations=None, discrete_params=None, seed=0, skip=0):
        skip = self._check_skip(skip)
        search = RandomSearch(dimension, lambda c: (0.0, None), discrete_params, seed)
        if skip:
            search.draw_candidates(skip)  # burn the consumed prefix
        return search.find_batched(
            n, self._check_batch(batch_size), evaluate_batch,
            observations=observations,
        )


class BayesianTuner(HyperparameterTuner):
    def search(self, n, dimension, evaluation_function, observations=None, discrete_params=None, seed=0, skip=0):
        self._check_skip(skip)
        # GP candidates condition on the observation set (which includes any
        # replayed trials), so no draws are burned on resume
        return GaussianProcessSearch(
            dimension, evaluation_function, discrete_params, seed=seed
        ).find(n, observations=observations)

    def search_batched(self, n, dimension, evaluate_batch, batch_size, observations=None, discrete_params=None, seed=0, skip=0):
        self._check_skip(skip)
        return GaussianProcessSearch(
            dimension, lambda c: (0.0, None), discrete_params, seed=seed
        ).find_batched(
            n, self._check_batch(batch_size), evaluate_batch,
            observations=observations,
        )


def get_tuner(name: str) -> HyperparameterTuner:
    key = name.upper()
    if key == TUNER_DUMMY:
        return DummyTuner()
    if key == TUNER_RANDOM:
        return RandomTuner()
    if key in (TUNER_BAYESIAN, "ATLAS"):
        return BayesianTuner()
    raise ValueError(f"Unknown hyperparameter tuner: {name!r}")
