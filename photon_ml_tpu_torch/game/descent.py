"""Coordinate descent over GAME coordinates with residual score exchange.

Counterpart of the JAX package's ``game/descent.py``: the outer loop trains
each coordinate against the residual of all others (``summed - own``),
keeps the summed scores up to date (summed - old + new), evaluates on
validation data after every coordinate update (or once per sweep), and
tracks the best complete model by the primary validation metric.

The divergence guard rejects an update whose new scores or total train loss
are non-finite (or, with ``rejection_tolerance``, whose loss regressed by
more than that): the previous model and scores stand, counted in
``photon_coordinate_rejections_total{coordinate=}``. It costs one fetch of
(finite flag, loss sum) per update.

Crash safety: ``boundary_fn`` receives a :class:`CDBoundaryState` after
every coordinate update (``robust.CheckpointManager.on_boundary`` is the
intended callee), ``checkpoint_fn`` the models after every sweep, and
``resume_state`` (a ``robust.CheckpointSnapshot``) re-enters the loop at
the update after the snapshot, bit for bit: the models and summed scores
come back verbatim and each coordinate's scores are recomputed from its
model by the same operations. The fault site ``coordinate.scores`` corrupts
an update's fresh scores (``robust.faults``).

Telemetry: the ``cd.sweep``, ``cd.coordinate``, ``cd.eval`` and
``cd.checkpoint`` spans, the timed train and score sections, and, when a
sink listens (``obs.active()``), each update's tracker metrics and one
metrics flush per sweep. The result carries each coordinate's raw
``SolverResult`` and its tracker. Sweep pipelining (``pipeline_depth`` > 1)
is ROADMAP A7; the distributed sweep barrier and memory sampling are A10
and A13.

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

from .. import obs
from ..evaluation.suite import EvaluationResults, EvaluationSuite
from ..models.game import GameModel
from ..optimize import SolverResult
from ..optimize.trackers import build_tracker, record_tracker_metrics
from ..robust import faults
from ..utils.timed import timed
from .coordinate import Coordinate, ModelCoordinate

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
    # coordinate -> Fixed/RandomEffectOptimizationTracker of its last update
    trackers: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CDBoundaryState:
    """Everything the outer loop knows at a coordinate-update boundary: the
    unit a checkpoint persists (robust.checkpoint) and a resumed run
    restores. Between updates the whole algorithm state is these values."""

    iteration: int  # sweep index of the update just finished
    coordinate_index: int  # position in ``coordinate_order`` just finished
    coordinate: str
    coordinate_order: List[str]
    n_iterations: int
    models: Dict[str, object]
    summed_scores: Optional[Tensor]  # None until an update was accepted
    best_eval: Optional[EvaluationResults]
    best_models: Dict[str, object]
    evaluations: List[Tuple[str, EvaluationResults]]
    trackers: Dict[str, object]
    # last ACCEPTED total train loss per coordinate: the divergence guard's
    # regression baseline, persisted so a resumed run rejects exactly the
    # updates the uninterrupted run would have rejected
    train_losses: Dict[str, float] = dataclasses.field(default_factory=dict)


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
        checkpoint_fn: Optional[object] = None,
        validation_frequency: str = "COORDINATE",
        boundary_fn: Optional[object] = None,
        resume_state: Optional[object] = None,
        divergence_guard: bool = True,
        rejection_tolerance: Optional[float] = None,
        pipeline_depth: int = 1,
    ):
        """``checkpoint_fn(iteration, models)`` runs after each completed
        sweep; ``boundary_fn(state: CDBoundaryState)`` after EVERY
        coordinate update.

        ``resume_state``: a restored boundary state (duck type:
        robust.CheckpointSnapshot: iteration / coordinate_index / models /
        summed_scores / best_eval / best_models / evaluations /
        train_losses). ``run`` then continues from the update AFTER the
        snapshot; ``initial_models`` passed to :meth:`run` are ignored on
        resume (the snapshot embeds the warm-start lineage). Trackers
        restart empty.

        ``validation_frequency``: 'COORDINATE' evaluates after every
        coordinate update, 'SWEEP' once per full sweep (same best-model
        tracking). ``divergence_guard=False`` drops the guard and its fetch.
        ``pipeline_depth`` must be 1 (pipelining is ROADMAP A7)."""
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
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1: {pipeline_depth}")
        if pipeline_depth > 1:
            raise NotImplementedError("sweep pipelining (pipeline_depth > 1) is not ported yet (ROADMAP A7)")
        self.coordinates = dict(coordinates)
        self.order = list(coordinates)
        self.n_iterations = n_iterations
        self.validation = validation
        self.checkpoint_fn = checkpoint_fn
        self.validation_frequency = validation_frequency
        self.boundary_fn = boundary_fn
        self.resume_state = resume_state
        self.divergence_guard = divergence_guard
        self.rejection_tolerance = rejection_tolerance
        # locked coordinates (ModelCoordinate) score their pretrained model
        # and never train: at least one coordinate must train
        if all(isinstance(c, ModelCoordinate) for c in self.coordinates.values()):
            raise ValueError("all coordinates are locked; nothing to train")
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
        trackers: Dict[str, object] = {}
        scores: Dict[str, Tensor] = {}
        train_losses: Dict[str, float] = {}
        syncs = {name: 0 for name in self.order}
        rejections = {name: 0 for name in self.order}
        seconds = {name: 0.0 for name in self.order}
        collectives = {name: 0 for name in self.order}
        collective_s = {name: 0.0 for name in self.order}
        start_it = start_idx = 0
        summed: Optional[Tensor] = None
        resume = self.resume_state
        if resume is not None:
            # models come back verbatim, each coordinate's scores are
            # recomputed from its model (the same operations, so the same
            # bits the dead process held), and the summed scores restore
            # from the snapshot in their own dtype
            models = dict(resume.models)
            for name in self.order:
                if name in models:
                    scores[name] = coords[name].score(models[name])
            if resume.summed_scores is not None:
                dev = next(iter(scores.values())).device
                summed = torch.as_tensor(resume.summed_scores).to(dev)
            evaluations = list(resume.evaluations)
            best_eval = resume.best_eval
            best_models = dict(resume.best_models)
            train_losses = dict(getattr(resume, "train_losses", None) or {})
            start_it = int(resume.iteration)
            start_idx = int(resume.coordinate_index) + 1
            if start_idx >= len(self.order):
                start_it, start_idx = start_it + 1, 0
        else:
            for name in self.order:
                if name in initial_models:
                    models[name] = initial_models[name]
                    scores[name] = coords[name].score(initial_models[name])
            for s in scores.values():
                summed = s if summed is None else summed + s
            evaluations: List[Tuple[str, EvaluationResults]] = []
            best_eval: Optional[EvaluationResults] = None
            best_models = dict(models)

        registry = obs.current_run().registry
        for it in range(start_it, self.n_iterations):
            first = start_idx if it == start_it else 0
            with obs.span("cd.sweep", iteration=it):
                for idx in range(first, len(self.order)):
                    name = self.order[idx]
                    coordinate = coords[name]
                    own = scores.get(name)
                    if summed is None:
                        residual = None
                    else:
                        residual = summed - own if own is not None else summed
                    group = getattr(coordinate, "group", None)
                    c0 = (group.collectives, group.collective_seconds) if group is not None else None
                    t0 = time.perf_counter()
                    with obs.span("cd.coordinate", iteration=it, coordinate=name):
                        with timed(f"cd iter {it} coordinate {name}: train", phase="solve", coordinate=name):
                            model, solver_result = coordinate.train(residual, initial_model=models.get(name))
                        if solver_result is not None:  # None: a locked coordinate
                            results[name] = solver_result
                            syncs[name] += solver_result.syncs
                        tracker = build_tracker(coordinate, solver_result)
                        if tracker is not None:
                            trackers[name] = tracker
                            # both fetch from the device: gated so that a run
                            # with no sink and no INFO log makes no fetch here
                            if logger.isEnabledFor(logging.INFO):
                                logger.info("cd iter %d coordinate %s optimization summary:\n%s",
                                            it, name, tracker.to_summary_string())
                            if obs.active():
                                record_tracker_metrics(registry, name, tracker)
                        with timed(f"cd iter {it} coordinate {name}: score", phase="score", coordinate=name):
                            new_scores = coordinate.score(model)
                        if faults.active():
                            new_scores = faults.corrupt("coordinate.scores", new_scores)
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
                            registry.gauge(
                                "photon_cd_accepted_loss", "last accepted total train loss per coordinate"
                            ).labels(coordinate=name).set(train_loss)
                        if self.validation is not None and self.validation_frequency == "COORDINATE":
                            best_eval, best_models = self._track_best(
                                models, evaluations, best_eval, best_models, it, name
                            )
                    else:
                        # the previous model, scores and summed scores stand
                        rejections[name] += 1
                        self._reject(it, name)
                    if self.boundary_fn is not None:
                        with obs.span("cd.checkpoint", phase="checkpoint", coordinate=name):
                            self.boundary_fn(CDBoundaryState(
                                iteration=it,
                                coordinate_index=idx,
                                coordinate=name,
                                coordinate_order=list(self.order),
                                n_iterations=self.n_iterations,
                                models=dict(models),
                                summed_scores=summed,
                                best_eval=best_eval,
                                best_models=dict(best_models),
                                evaluations=list(evaluations),
                                trackers=dict(trackers),
                                train_losses=dict(train_losses),
                            ))
                if self.validation is not None and self.validation_frequency == "SWEEP":
                    best_eval, best_models = self._track_best(
                        models, evaluations, best_eval, best_models, it, self.order[-1]
                    )
                if self.checkpoint_fn is not None:
                    with obs.span("cd.checkpoint", phase="checkpoint"):
                        self.checkpoint_fn(it, dict(models))
            if obs.active():
                # one metrics line per sweep in the JSONL stream
                obs.current_run().flush_metrics()

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
            trackers=trackers,
        )

    def _guard(self, name, new_scores, solver_result, train_losses):
        """One fetch of (all new scores finite, total train loss): accepts
        unless either is non-finite or the loss regressed beyond
        ``rejection_tolerance``. Returns ``(accepted, train_loss)``; a
        locked coordinate (no solver result) fetches the finite flag alone
        and returns no loss, so the regression ledger keeps real solves
        only."""
        finite = torch.all(torch.isfinite(new_scores)).to(torch.float64)
        if solver_result is None:
            obs.add_device_fetch_bytes("cd.update_guard", 8)
            return bool(finite.item()), None
        finite_h, loss_h = (
            torch.stack([finite, torch.sum(solver_result.loss).to(torch.float64)]).cpu().numpy()
        )
        obs.add_device_fetch_bytes("cd.update_guard", 16)
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

    @staticmethod
    def _reject(it: int, name: str) -> None:
        # host-only registry work, recorded with or without a sink: a
        # rejection must show in run_summary.json of any run
        obs.current_run().registry.counter(
            "photon_coordinate_rejections_total",
            "coordinate updates rejected by the divergence guard",
        ).labels(coordinate=name).inc()
        logger.warning(
            "cd iter %d coordinate %s: update REJECTED (non-finite scores/loss "
            "or objective regression); previous model stands", it, name,
        )

    def _track_best(self, models, evaluations, best_eval, best_models, it, name):
        with obs.span("cd.eval", phase="eval", iteration=it, coordinate=name):
            res = self._evaluate(models)
        evaluations.append((name, res))
        primary = self.validation.suite.primary
        # only snapshots with every coordinate trained are candidates: a
        # mid-first-sweep partial model is not a valid GAME model
        complete = len(models) == len(self.order)
        if complete and (best_eval is None or primary.better(res.primary_metric, best_eval.primary_metric)):
            best_eval = res
            best_models = dict(models)
        if obs.active():
            gauge = obs.current_run().registry.gauge(
                "photon_validation_metric", "validation metric after an update"
            )
            for metric, value in res.metrics.items():
                gauge.labels(metric=metric, coordinate=name).set(float(value))
        logger.info("cd iter %d coordinate %s: %s", it, name, res.metrics)
        return best_eval, best_models

    def _infer_task(self) -> str:
        """The task from the coordinates (a locked coordinate's from its
        inner one)."""
        for c in self.coordinates.values():
            task = getattr(c.inner if isinstance(c, ModelCoordinate) else c, "task", None)
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
            obs.add_device_fetch_bytes("cd.validation_scores", acc.numel() * acc.element_size())
        return v.suite.evaluate(total)
