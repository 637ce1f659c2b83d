"""Coordinate descent over GAME coordinates with residual score exchange.

Counterpart of the JAX package's ``game/descent.py``: the outer loop trains
each coordinate against the residual of all others (``summed - own``),
keeps the summed scores up to date (summed - old + new), evaluates on
validation data after every coordinate update (or once per sweep), and
tracks the best complete model by the primary validation metric.

The divergence guard rejects an update whose new scores or total train loss
are non-finite (or, with ``rejection_tolerance``, whose loss regressed by
more than that): the previous model and scores stand. It costs one fetch of
(finite flag, loss sum) per update.

The result carries each coordinate's raw ``SolverResult`` where the JAX
package builds optimization trackers; ``optimize.trackers.build_tracker``
makes one from it (their metrics need the registry of ROADMAP A13).
Checkpoints, boundary callbacks, resume, pipelining, telemetry and the
distributed barrier are not ported.

Over coordinates sharded across a data-parallel group, every rank runs this
loop alike: scores, residuals, models and the guard's fetch are replicated
(the coordinates gather what they shard), so every rank takes the same
branch and calls the same collectives in the same order.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..evaluation.suite import EvaluationResults, EvaluationSuite
from ..models.game import GameModel
from ..optimize import SolverResult
from .coordinate import Coordinate

logger = logging.getLogger("photon_ml_tpu_torch")

Tensor = torch.Tensor


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    evaluations: List[Tuple[str, EvaluationResults]]  # (coordinate, results) per update
    best_evaluation: Optional[EvaluationResults]
    # coordinate -> the raw SolverResult of its last update
    solver_results: Dict[str, SolverResult]
    # coordinate -> device-to-host fetches of its updates: the solver's,
    # plus one divergence-guard fetch per update
    syncs: Dict[str, int] = dataclasses.field(default_factory=dict)
    # coordinate -> number of updates the divergence guard rejected
    rejections: Dict[str, int] = dataclasses.field(default_factory=dict)
    # coordinate -> host seconds of its updates (train, score and guard;
    # the guard's fetch waits for the device, so with the guard on this is
    # the device time of the update as well)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # coordinate -> this rank's collective calls of its updates and their
    # host seconds (DataParallelGroup's counters; 0 for unsharded ones)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ValidationContext:
    """Validation-side scoring: per-coordinate score fn over the validation set."""

    suite: EvaluationSuite
    score_fns: Mapping[str, object]  # coordinate -> (model -> scores f[n_val])
    offsets: np.ndarray  # base offsets of validation rows


class CoordinateDescent:
    """Train GAME coordinates by block coordinate descent."""

    def __init__(
        self,
        coordinates: Mapping[str, Coordinate],  # ordered
        n_iterations: int = 1,
        validation: Optional[ValidationContext] = None,
        validation_frequency: str = "COORDINATE",
        divergence_guard: bool = True,
        rejection_tolerance: Optional[float] = None,
    ):
        """``validation_frequency``: 'COORDINATE' evaluates after every
        coordinate update, 'SWEEP' once per full sweep (same best-model
        tracking). ``divergence_guard=False`` drops the guard and its fetch."""
        if not coordinates:
            raise ValueError("CoordinateDescent needs at least one coordinate")
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be >= 1: {n_iterations}")
        if validation_frequency not in ("COORDINATE", "SWEEP"):
            raise ValueError(
                f"validation_frequency must be COORDINATE or SWEEP: {validation_frequency!r}"
            )
        if rejection_tolerance is not None and rejection_tolerance < 0:
            raise ValueError(f"rejection_tolerance must be >= 0: {rejection_tolerance}")
        self.coordinates = dict(coordinates)
        self.order = list(coordinates)
        self.n_iterations = n_iterations
        self.validation = validation
        self.validation_frequency = validation_frequency
        self.divergence_guard = divergence_guard
        self.rejection_tolerance = rejection_tolerance
        if len(self.order) == 1 and n_iterations > 1:
            logger.warning("single-coordinate descent with %d iterations is wasteful", n_iterations)

    def run(self, initial_models: Optional[Mapping[str, object]] = None) -> CoordinateDescentResult:
        initial_models = dict(initial_models or {})
        coords = self.coordinates
        n = next(iter(coords.values())).n_rows
        for c in coords.values():
            if c.n_rows != n:
                raise ValueError(f"coordinate {c.coordinate_id} has {c.n_rows} rows, expected {n}")

        models: Dict[str, object] = {}
        results: Dict[str, SolverResult] = {}
        scores: Dict[str, Tensor] = {}
        train_losses: Dict[str, float] = {}
        syncs = {name: 0 for name in self.order}
        rejections = {name: 0 for name in self.order}
        seconds = {name: 0.0 for name in self.order}
        collectives = {name: 0 for name in self.order}
        collective_s = {name: 0.0 for name in self.order}
        for name in self.order:
            if name in initial_models:
                models[name] = initial_models[name]
                scores[name] = coords[name].score(initial_models[name])
        summed: Optional[Tensor] = None
        for s in scores.values():
            summed = s if summed is None else summed + s
        evaluations: List[Tuple[str, EvaluationResults]] = []
        best_eval: Optional[EvaluationResults] = None
        best_models = dict(models)

        for it in range(self.n_iterations):
            for name in self.order:
                coordinate = coords[name]
                own = scores.get(name)
                if summed is None:
                    residual = None
                else:
                    residual = summed - own if own is not None else summed
                group = getattr(coordinate, "group", None)
                c0 = (group.collectives, group.collective_seconds) if group is not None else None
                t0 = time.perf_counter()
                model, solver_result = coordinate.train(residual, initial_model=models.get(name))
                results[name] = solver_result
                syncs[name] += solver_result.syncs
                new_scores = coordinate.score(model)
                accepted, train_loss = True, None
                if self.divergence_guard:
                    syncs[name] += 1
                    accepted, train_loss = self._guard(name, new_scores, solver_result, train_losses)
                seconds[name] += time.perf_counter() - t0
                if c0 is not None:
                    collectives[name] += group.collectives - c0[0]
                    collective_s[name] += group.collective_seconds - c0[1]
                if accepted:
                    models[name] = model
                    # summedScores - oldScores + newScores
                    summed = new_scores if residual is None else residual + new_scores
                    scores[name] = new_scores
                    if train_loss is not None:
                        train_losses[name] = train_loss
                    if self.validation is not None and self.validation_frequency == "COORDINATE":
                        best_eval, best_models = self._track_best(
                            models, evaluations, best_eval, best_models, it, name
                        )
                else:
                    # the previous model, scores and summed scores stand
                    rejections[name] += 1
                    logger.warning(
                        "cd iter %d coordinate %s: update rejected (non-finite scores/loss "
                        "or objective regression); previous model stands", it, name,
                    )
            if self.validation is not None and self.validation_frequency == "SWEEP":
                best_eval, best_models = self._track_best(
                    models, evaluations, best_eval, best_models, it, self.order[-1]
                )

        final_models = best_models if best_eval is not None else models
        return CoordinateDescentResult(
            model=GameModel(models=final_models, task=self._infer_task()),
            evaluations=evaluations,
            best_evaluation=best_eval,
            solver_results=results,
            syncs=syncs,
            rejections=rejections,
            seconds=seconds,
            collectives=collectives,
            collective_seconds=collective_s,
        )

    def _guard(self, name, new_scores, solver_result, train_losses):
        """One fetch of (all new scores finite, total train loss): accepts
        unless either is non-finite or the loss regressed beyond
        ``rejection_tolerance``. Returns ``(accepted, train_loss)``."""
        finite_h, loss_h = (
            torch.stack([
                torch.all(torch.isfinite(new_scores)).to(torch.float64),
                torch.sum(solver_result.loss).to(torch.float64),
            ]).cpu().numpy()
        )
        if not bool(finite_h):
            return False, None
        loss = float(loss_h)
        if not np.isfinite(loss):
            return False, None
        prev = train_losses.get(name)
        tol = self.rejection_tolerance
        if tol is not None and prev is not None and loss > prev + tol:
            return False, None
        return True, loss

    def _track_best(self, models, evaluations, best_eval, best_models, it, name):
        res = self._evaluate(models)
        evaluations.append((name, res))
        primary = self.validation.suite.primary
        # only snapshots with every coordinate trained are candidates: a
        # mid-first-sweep partial model is not a valid GAME model
        complete = len(models) == len(self.order)
        if complete and (best_eval is None or primary.better(res.primary_metric, best_eval.primary_metric)):
            best_eval = res
            best_models = dict(models)
        logger.info("cd iter %d coordinate %s: %s", it, name, res.metrics)
        return best_eval, best_models

    def _infer_task(self) -> str:
        for c in self.coordinates.values():
            task = getattr(c, "task", None)
            if task:
                return task
        return "linear_regression"

    def _evaluate(self, models: Mapping[str, object]) -> EvaluationResults:
        """Sum the per-coordinate validation scores where they lie and, when
        every metric has a device implementation, evaluate there too (one
        fetch); grouped and ranking metrics take the host path."""
        v = self.validation
        acc = None
        for name, model in models.items():
            fn = v.score_fns.get(name)
            if fn is not None:
                s = fn(model)
                acc = s if acc is None else acc + s
        if acc is not None:
            total_dev = acc + torch.as_tensor(np.asarray(v.offsets), dtype=acc.dtype, device=acc.device)
            res = v.suite.evaluate_device(total_dev)
            if res is not None:
                return res
        total = np.asarray(v.offsets, dtype=np.float64)
        if acc is not None:
            total = total + acc.detach().cpu().double().numpy()
        return v.suite.evaluate(total)
