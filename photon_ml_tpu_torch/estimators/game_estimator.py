"""GameEstimator: the fit() API over GAME coordinate configurations.

The JAX package's ``estimators/game_estimator.py`` on the port. Reference:
photon-api .../estimators/GameEstimator.scala:53-705: fit(data,
validationData, optimizationConfigurations) prepares per-coordinate datasets
once, builds the validation evaluation suite, then runs coordinate descent
once per optimization configuration, warm-starting each run from the
previous configuration's model (:356-374), returning one GameResult per
configuration. Regularization-weight grids expand as a cartesian product
over coordinates (GameTrainingDriver.prepareGameOptConfigs:623-632).

Datasets and models live on ``device`` (the card unless asked otherwise).
Validation scoring puts each feature shard's validation rows in ELL layout
once: a fixed effect's validation margins are one S1 launch
(``serving.engine.EllRows``), a random effect's ``score_entity_ell``.

``fit_lanes`` trains several configurations as lambda lanes of one
coordinate-descent run (``game/lanes.py``).

Incremental training: a coordinate with ``regularize_by_prior`` centres
its L2 on the model it warm-starts from (``fit``'s ``initial_model``, then
each configuration's predecessor), and a coordinate named in
``partial_retrain_locked`` scores its pretrained model without retraining
(``ModelCoordinate``).

A coordinate with ``hbm_budget_mb`` builds streamed when its device bytes
exceed the budget (``game/fe_streaming.py``, ``game/streaming.py``), and
``pipeline_depth`` > 1 pipelines the sweeps (``game/pipeline.py``).

The composition checks are the execution planner's (``plan.resolve``; the
world comes from ``torch.distributed`` when it is initialised).

Across processes (a group joined through ``parallel.multihost.initialize``,
as ``cli.train --distributed`` does): ``raw`` holds this rank's rows, padded
to the share every rank holds, and ``prepare_datasets`` builds the fixed
effect as the rank's dense row shard and the random effect across the ranks
(``game/data_mp.py``), entity-sharded; every rank then runs the same
coordinate descent (B1-B3 on its rows, joined by B4) and holds the same
models. On a (data x model) grid of ranks (``mesh`` with a model axis, or
any mesh with a ``layout="tiled"`` fixed effect: ``parallel.mesh.make_mesh``
over the world, made on the first fit unless ``mesh`` is one already) a
tiled fixed effect solves on every rank of the grid, and everything else
runs over the grid's data axis: ``raw`` holds the rank's data row's rows
(or, in one process, the whole batch), a dense fixed effect is the rank's
row shard over its ``data`` subgroup, replicated over the model axis (each
model column runs B1-B3 through B4, the JAX package's
``shard_batch(ds.batch, mesh)``; the M replicas end bitwise alike), the
random effects are built across the data axis, and the ranks of a data
row hold the same models. A
coordinate with ``hbm_budget_mb`` streams over processes too: each rank
its own rows of the fixed effect (dense or ELL) and its own entity range of
the random effect, under the per-rank budget, and ``pipeline_depth`` > 1
pipelines each rank's staging. The planner refuses a resident ELL / COO
fixed effect over processes and trial lanes over processes, in the JAX
package's words.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import plan as execution_plan
from ..device import DeviceLike, resolve_device
from ..evaluation.suite import EvaluationResults, build_suite
from ..game.coordinate import Coordinate, FixedEffectCoordinate, ModelCoordinate, RandomEffectCoordinate
from ..game.data import _rows_to_ell, build_fixed_effect_dataset, build_random_effect_dataset
from ..game.data_mp import build_random_effect_dataset_global
from ..game.descent import CoordinateDescent, ValidationContext
from ..game.problem import GLMOptimizationConfig
from ..io.data import RawDataset
from ..models.game import GameModel
from ..parallel import multihost
from ..ops.normalization import NormalizationContext
from ..serving.engine import EllRows, ScoreEngine
from ..utils.events import EventEmitter, OptimizationLogEvent, TrainingFinishEvent, TrainingStartEvent
from ..utils.timed import timed

logger = logging.getLogger("photon_ml_tpu_torch")


@dataclasses.dataclass
class CoordinateConfig:
    """One coordinate's dataset + optimization definition (the reference's
    CoordinateConfiguration: dataset config + optimization config + reg grid)."""

    name: str
    feature_shard: str
    config: GLMOptimizationConfig
    random_effect_type: Optional[str] = None  # None => fixed effect
    reg_weights: Sequence[float] = ()  # grid; empty -> [config.reg_weight]
    active_cap: Optional[int] = None
    active_lower_bound: int = 1
    # Pearson feature selection: keep ceil(ratio * n_rows) features per entity
    features_to_samples_ratio: Optional[float] = None
    # fixed-effect batch layout: auto|dense|ell|sparse|coo|tiled (tiled:
    # the (data x model)-tiled batch; needs a mesh)
    layout: str = "auto"
    # narrower storage for the feature values only (torch.bfloat16)
    feature_dtype: Optional[torch.dtype] = None
    normalization: Optional[NormalizationContext] = None
    # incremental training: L2 centred on the warm-start model
    regularize_by_prior: bool = False
    # out-of-core streaming budget: the coordinate streams when its device
    # bytes exceed it
    hbm_budget_mb: Optional[int] = None

    @property
    def hbm_budget_bytes(self) -> Optional[int]:
        return None if self.hbm_budget_mb is None else int(self.hbm_budget_mb) * (1 << 20)

    @property
    def is_random_effect(self) -> bool:
        return self.random_effect_type is not None

    def grid(self) -> Sequence[float]:
        return tuple(self.reg_weights) or (self.config.reg_weight,)


@dataclasses.dataclass
class GameResult:
    model: GameModel
    config: Dict[str, float]  # coordinate -> reg weight
    evaluation: Optional[EvaluationResults]
    trackers: Dict[str, object]
    # coordinate -> updates the divergence guard rejected in this fit
    rejections: Dict[str, int] = dataclasses.field(default_factory=dict)


def world_size() -> int:
    """The process count: ``torch.distributed``'s world when it is
    initialised, else 1."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class GameEstimator(EventEmitter):
    """Emits TrainingStart/OptimizationLog/TrainingFinish events to registered
    listeners (EventEmitter.scala semantics; the reference's telemetry hook)."""

    def __init__(
        self,
        task: str,
        coordinate_configs: Sequence[CoordinateConfig],
        n_cd_iterations: int = 1,
        evaluator_specs: Sequence[str] = (),
        dtype: torch.dtype = torch.float32,
        partial_retrain_locked: Sequence[str] = (),
        entity_pad_multiple: int = 1,
        mesh=None,
        validation_frequency: str = "COORDINATE",
        divergence_guard: bool = True,
        rejection_tolerance: Optional[float] = None,
        pipeline_depth: int = 1,
        device: DeviceLike = None,
    ):
        super().__init__()
        if not coordinate_configs:
            raise ValueError("need at least one coordinate configuration")
        names = [c.name for c in coordinate_configs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate coordinate names: {names}")
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1: {pipeline_depth}")
        unknown = set(partial_retrain_locked) - set(names)
        if unknown:
            raise ValueError(f"locked coordinates not in configs: {sorted(unknown)}")
        self.task = task
        self.coordinate_configs = list(coordinate_configs)
        self.n_cd_iterations = n_cd_iterations
        self.evaluator_specs = list(evaluator_specs)
        self.dtype = dtype
        self.partial_retrain_locked = set(partial_retrain_locked)
        self.mesh = mesh
        self._grid_group = None
        self.validation_frequency = validation_frequency
        self.divergence_guard = divergence_guard
        self.rejection_tolerance = rejection_tolerance
        self.pipeline_depth = int(pipeline_depth)
        self.entity_pad_multiple = entity_pad_multiple
        self.device = resolve_device(device)
        # every composition check is the planner's, once, up front
        self.execution_plan = execution_plan.resolve(
            self.coordinate_configs,
            mesh=mesh,
            n_processes=world_size(),
            pipeline_depth=self.pipeline_depth,
            distributed=multihost.current_group() is not None,
            partial_retrain_locked=tuple(self.partial_retrain_locked),
        )

    # -- dataset preparation -------------------------------------------------

    def _prepare_datasets(self, raw: RawDataset):
        # re-checked here: the process group can be initialised between
        # construction and the first fit
        execution_plan.check_multiprocess_mesh(world_size(), self.mesh)
        grid = self.grid()
        group = multihost.current_group()
        if grid is not None and grid.world is not None:
            group = grid.data
        datasets = {}
        for cc in self.coordinate_configs:
            with timed(f"prepare dataset {cc.name}"):
                if group is not None and cc.is_random_effect:
                    # entity planning across the ranks and the shuffle of
                    # every row to its entity's owner
                    datasets[cc.name] = build_random_effect_dataset_global(
                        raw,
                        cc.name,
                        cc.feature_shard,
                        cc.random_effect_type,
                        group,
                        active_cap=cc.active_cap,
                        active_lower_bound=cc.active_lower_bound,
                        dtype=self.dtype,
                        pad_entities_to_multiple=self.entity_pad_multiple,
                        features_to_samples_ratio=cc.features_to_samples_ratio,
                        feature_dtype=cc.feature_dtype,
                        hbm_budget_bytes=cc.hbm_budget_bytes,
                        device=self.device,
                    )
                elif cc.is_random_effect:
                    datasets[cc.name] = build_random_effect_dataset(
                        raw,
                        cc.name,
                        cc.feature_shard,
                        cc.random_effect_type,
                        active_cap=cc.active_cap,
                        active_lower_bound=cc.active_lower_bound,
                        dtype=self.dtype,
                        pad_entities_to_multiple=self.entity_pad_multiple,
                        features_to_samples_ratio=cc.features_to_samples_ratio,
                        feature_dtype=cc.feature_dtype,
                        hbm_budget_bytes=cc.hbm_budget_bytes,
                        device=self.device,
                    )
                else:
                    datasets[cc.name] = build_fixed_effect_dataset(
                        raw,
                        cc.name,
                        cc.feature_shard,
                        dtype=self.dtype,
                        layout=cc.layout,
                        feature_dtype=cc.feature_dtype,
                        hbm_budget_bytes=cc.hbm_budget_bytes,
                        device=self.device,
                        group=group,
                        mesh=grid if cc.layout == "tiled" else None,
                    )
        return datasets

    def grid(self):
        """The (data x model) grid the estimator runs on
        (``parallel.mesh.MeshGroup``), or None: ``mesh`` when it is one,
        else made over the world from the plan's axes on first use when the
        mesh has a model axis or a fixed effect is tiled. A grid over
        ranks with a model axis becomes the process-level helpers' grid
        (``parallel.multihost.set_grid``)."""
        from ..parallel.mesh import MeshGroup, make_mesh

        if self._grid_group is None:
            axes = self.execution_plan.mesh_axes
            if isinstance(self.mesh, MeshGroup):
                self._grid_group = self.mesh
            elif axes is not None and (
                axes["model"] > 1 or any(c.layout == "tiled" for c in self.coordinate_configs)
            ):
                self._grid_group = make_mesh(axes["data"], axes["model"], device=self.device)
            else:
                return None
            if self._grid_group.n_model > 1:
                multihost.set_grid(self._grid_group)
        return self._grid_group

    def _validation_context(self, val_raw: RawDataset) -> Tuple[ValidationContext, Dict[str, object]]:
        suite = build_suite(
            self.evaluator_specs or ["RMSE"],
            val_raw.labels,
            val_raw.weights,
            id_tags=val_raw.id_tags,
        )
        rows: Dict[str, EllRows] = {}
        score_fns = {}
        for cc in self.coordinate_configs:
            ell = rows.get(cc.feature_shard)
            if ell is None:
                r, c, v = val_raw.shard_coo[cc.feature_shard]
                idx, val = _rows_to_ell(r, c, v, val_raw.n_rows)
                ell = rows[cc.feature_shard] = EllRows(idx, val, self.dtype, self.device)
            if cc.is_random_effect:
                ids = val_raw.id_tags[cc.random_effect_type]

                def fn(model, _ids=ids, _ell=ell):
                    erow = torch.as_tensor(model.rows_for(_ids).astype(np.int32), device=_ell.idx.device)
                    return model.score_ell_rows(erow, _ell.idx, _ell.val)

            else:

                def fn(model, _ell=ell):
                    return _ell.margins(model.model.coefficients.means)

            score_fns[cc.name] = fn
        return ValidationContext(suite=suite, score_fns=score_fns, offsets=val_raw.offsets), score_fns

    def _make_coordinates(
        self, datasets, reg_weights: Mapping[str, float], initial_models: Optional[Mapping[str, object]] = None,
    ) -> Dict[str, Coordinate]:
        """The coordinates of one configuration: a coordinate with
        ``regularize_by_prior`` takes its initial model as its prior, and a
        locked one wraps its initial model in a ``ModelCoordinate``."""
        initial_models = initial_models or {}
        coords: Dict[str, Coordinate] = {}
        for cc in self.coordinate_configs:
            cfg = cc.config.with_reg_weight(reg_weights[cc.name])
            prior = initial_models.get(cc.name) if cc.regularize_by_prior else None
            if cc.is_random_effect:
                inner: Coordinate = RandomEffectCoordinate(
                    dataset=datasets[cc.name], task=self.task, config=cfg, prior_model=prior,
                )
            else:
                inner = FixedEffectCoordinate(
                    dataset=datasets[cc.name], task=self.task, config=cfg, normalization=cc.normalization,
                    prior_model=prior,
                )
            if cc.name in self.partial_retrain_locked:
                locked = initial_models.get(cc.name)
                if locked is None:
                    raise ValueError(f"locked coordinate {cc.name} needs a pretrained model")
                coords[cc.name] = ModelCoordinate(inner=inner, locked_model=locked)
            else:
                coords[cc.name] = inner
        return coords

    # -- fit -------------------------------------------------------------------

    def prepare_datasets(self, raw: RawDataset):
        """Build per-coordinate datasets once; pass the result to ``fit`` via
        ``datasets=`` to train several configurations without rebuilding."""
        return self._prepare_datasets(raw)

    def fit(
        self,
        raw: RawDataset,
        validation: Optional[RawDataset] = None,
        initial_model: Optional[GameModel] = None,
        checkpoint_fn: Optional[object] = None,
        datasets: Optional[Dict[str, object]] = None,
        combos: Optional[Sequence[Mapping[str, float]]] = None,
        n_cd_iterations: Optional[int] = None,
        boundary_fn: Optional[object] = None,
        resume_state: Optional[object] = None,
    ) -> List[GameResult]:
        """``checkpoint_fn(reg_weights, iteration, game_model)`` runs after
        each completed coordinate-descent sweep of each configuration;
        ``boundary_fn(reg_weights, state)`` after EVERY coordinate update
        (``state`` is descent's CDBoundaryState). ``resume_state`` (a
        robust.CheckpointSnapshot) resumes the FIRST combo in ``combos``
        mid-run.

        ``datasets``: pre-built datasets from :meth:`prepare_datasets`.
        ``combos``: explicit list of per-coordinate reg-weight dicts to train
        instead of the full cartesian grid. ``n_cd_iterations`` overrides the
        estimator's sweep count for THIS call. ``validation`` may be a
        RawDataset, or a deferred one (a ``Future`` or a zero-arg callable),
        resolved only after the training datasets are built."""
        if datasets is None:
            datasets = self._prepare_datasets(raw)
        if validation is not None:
            if hasattr(validation, "result"):
                validation = validation.result()
            elif callable(validation):
                validation = validation()
        validation_ctx = None
        if validation is not None:
            validation_ctx, _ = self._validation_context(validation)

        names = [cc.name for cc in self.coordinate_configs]
        if combos is None:
            combos = [dict(zip(names, combo)) for combo in itertools.product(*[cc.grid() for cc in self.coordinate_configs])]
        n_iterations = self.n_cd_iterations if n_cd_iterations is None else n_cd_iterations
        results: List[GameResult] = []
        prev_models: Dict[str, object] = dict(initial_model.models if initial_model else {})
        self.send_event(TrainingStartEvent(time=time.time()))
        for combo_index, reg_weights in enumerate(combos):
            reg_weights = dict(reg_weights)
            coords = self._make_coordinates(datasets, reg_weights, prev_models)
            cd_ckpt = None
            if checkpoint_fn is not None:
                task = self.task
                cd_ckpt = lambda it, models, _w=reg_weights: checkpoint_fn(  # noqa: E731
                    _w, it, GameModel(models=models, task=task)
                )
            cd_boundary = None
            if boundary_fn is not None:
                cd_boundary = lambda st, _w=reg_weights: boundary_fn(_w, st)  # noqa: E731
            cd = CoordinateDescent(
                coords, n_iterations=n_iterations,
                validation=validation_ctx, checkpoint_fn=cd_ckpt,
                validation_frequency=self.validation_frequency,
                boundary_fn=cd_boundary,
                # a snapshot describes one in-flight configuration: the
                # first combo of a resumed call; later combos start fresh
                resume_state=resume_state if combo_index == 0 else None,
                divergence_guard=self.divergence_guard,
                rejection_tolerance=self.rejection_tolerance,
                pipeline_depth=self.pipeline_depth,
            )
            with timed(f"train config {reg_weights}", logging.INFO):
                out = cd.run(initial_models=prev_models)
            results.append(GameResult(
                model=out.model, config=reg_weights, evaluation=out.best_evaluation,
                trackers=out.trackers, rejections=dict(out.rejections),
            ))
            self.send_event(OptimizationLogEvent(
                reg_weights=reg_weights,
                trackers=out.trackers,
                metrics=None if out.best_evaluation is None else dict(out.best_evaluation.metrics),
            ))
            # warm start next config from this one (GameEstimator.scala:356-374)
            prev_models = dict(out.model.models)
        self.send_event(TrainingFinishEvent(time=time.time()))
        return results

    def fit_lanes(
        self,
        raw: RawDataset,
        combos: Sequence[Mapping[str, float]],
        validation: Optional[RawDataset] = None,
        datasets: Optional[Dict[str, object]] = None,
        n_cd_iterations: Optional[int] = None,
    ) -> List[GameResult]:
        """Train ``len(combos)`` reg-weight configurations as lambda lanes of
        one batched coordinate-descent run (``game/lanes.py``): every lane
        shares each coordinate's data residency and solve, the per-lane
        weight a tensor operand. Returns one GameResult per combo, in order;
        the batched counterpart of calling :meth:`fit` once per combo.
        ``game.lanes.check_lane_composition`` lists what it refuses."""
        from ..game.lanes import fit_lanes as _fit_lanes

        return _fit_lanes(
            self, raw, combos, validation=validation, datasets=datasets, n_cd_iterations=n_cd_iterations,
        )

    def select_best(self, results: Sequence[GameResult]) -> GameResult:
        """Best result by primary validation metric (falls back to the last)."""
        with_eval = [r for r in results if r.evaluation is not None]
        if not with_eval:
            return results[-1]
        primary = build_suite(self.evaluator_specs or ["RMSE"], np.zeros(1)).primary
        best = with_eval[0]
        for r in with_eval[1:]:
            if primary.better(r.evaluation.primary_metric, best.evaluation.primary_metric):
                best = r
        return best


@dataclasses.dataclass
class GameTransformer:
    """Scoring twin of the estimator (GameTransformer.scala:39-318):
    model + dataset -> summed per-coordinate scores (+offsets), optional
    evaluation, through the same ``ScoreEngine`` as ``cli.score``, so their
    scores are equal bit for bit."""

    model: GameModel
    dtype: torch.dtype = torch.float32
    device: DeviceLike = None

    def transform(
        self, raw: RawDataset, evaluator_specs: Sequence[str] = ()
    ) -> Tuple[np.ndarray, Optional[EvaluationResults]]:
        total = ScoreEngine.from_model(self.model, dtype=self.dtype, device=self.device).score_dataset(raw)
        evaluation = None
        if evaluator_specs:
            suite = build_suite(evaluator_specs, raw.labels, raw.weights, id_tags=raw.id_tags)
            evaluation = suite.evaluate(total)
        return total, evaluation
