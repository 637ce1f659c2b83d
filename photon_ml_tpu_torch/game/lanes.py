"""Lane-stacked hyperparameter sweeps: K lambda candidates per solve.

The JAX package's ``game/lanes.py`` on the port. The reference runs tuning
trials concurrently on a cluster; on one card the same concurrency is a
lane axis. Every trial of a batch shares each coordinate's data residency
and its solve: the per-lane regularization weight is a tensor operand
(``GLMProblem.run_lanes``, ``RandomEffectCoordinate.train_lanes``), and
the sparse products of all lanes are one launch of S2, the lane-wide
segment kernel (``ops/sparse.py``).

``fit_lanes`` follows the coordinate-descent loop of ``game/descent.py``
lane by lane: residual composition, warm starts across sweeps, the
divergence guard and best-model tracking keep the sequential semantics, so
lane k of a K-lane batch reproduces the sequential single-trial fit at its
lambda within the packed solve's bound (coefficients atol 5e-3). A lane's
bits depend on L: its reductions run inside stacks whose width is the lane
count, so they are held at that bound, not bitwise. Lane isolation comes
from the batched solvers' masked commit (a diverged lane freezes at its
last committed iterate without stalling or perturbing its neighbours);
this module adds a per-lane guard as defence in depth: one counted fetch
per coordinate update (``lanes.update_guard``) carries every lane's
finite flag and solver reasons, and a poisoned lane reverts to its previous
committed state.

Telemetry: the spans ``lanes.train`` and ``lanes.eval``, the gauge
``photon_tuning_lanes_in_flight`` and the counter
``photon_tuning_frozen_lanes_total``.
"""

from __future__ import annotations

import logging
import weakref
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..models.coefficients import Coefficients
from ..models.game import FixedEffectModel, GameModel, RandomEffectModel
from ..models.glm import model_for_task
from ..optimize import ConvergenceReason
from .coordinate import FixedEffectCoordinate, RandomEffectCoordinate, _layout

logger = logging.getLogger("photon_ml_tpu_torch")

Tensor = torch.Tensor

_DIVERGED = int(ConvergenceReason.NUMERICAL_DIVERGENCE.value)


def check_lane_composition(estimator, n_lanes: int, distributed: bool = False) -> None:
    """Refuse the compositions the lane path does not support; the
    execution planner (``plan/planner.py``) owns every message."""
    from ..estimators.game_estimator import world_size
    from ..plan import check_lane_composition as _check

    _check(
        estimator.coordinate_configs,
        n_lanes,
        mesh=estimator.mesh,
        n_processes=world_size(),
        distributed=distributed,
        pipeline_depth=estimator.pipeline_depth,
        partial_retrain_locked=tuple(estimator.partial_retrain_locked),
    )


def _lane_model(estimator, cc, coord, coeffs: Tensor, lane: int):
    """Lane ``lane`` of a coordinate's lane-stacked coefficients as an
    ordinary fixed- or random-effect model."""
    if cc.is_random_effect:
        ds = coord.dataset
        model = RandomEffectModel(
            random_effect_type=ds.random_effect_type,
            feature_shard=ds.feature_shard,
            task=estimator.task,
            entity_ids=ds.entity_ids,
            coef_indices=_layout(ds),
            coef_values=coeffs[:, :, lane],
        )
        # provenance mark: this model's support layout is the dataset's
        # block layout (the scoring fast path of RandomEffectCoordinate)
        object.__setattr__(model, "_support_layout_of", weakref.ref(ds))
        return model
    glm = model_for_task(estimator.task, Coefficients(means=coeffs[:, lane], variances=None))
    return FixedEffectModel(model=glm, feature_shard=cc.feature_shard)


def _summarize_reasons(reason_h: np.ndarray) -> np.ndarray:
    """Per-lane ConvergenceReason code from a solve's reasons: ``[L]``
    passes through; entity-stacked ``[E, L]`` summarizes each lane as
    DIVERGED if any entity diverged, else the modal code."""
    r = np.asarray(reason_h)
    if r.ndim == 1:
        return r.astype(np.int32)
    out = np.empty(r.shape[1], np.int32)
    for lane in range(r.shape[1]):
        col = r[:, lane]
        if np.any(col == _DIVERGED):
            out[lane] = _DIVERGED
        else:
            vals, cnt = np.unique(col, return_counts=True)
            out[lane] = vals[np.argmax(cnt)]
    return out


def _evaluate_lane(validation, models: Mapping[str, object]):
    """One lane's validation evaluation, as ``CoordinateDescent._evaluate``:
    on the device when every metric has a device implementation, else on
    the host."""
    acc = None
    for name, model in models.items():
        fn = validation.score_fns.get(name)
        if fn is not None:
            s = fn(model)
            acc = s if acc is None else acc + s
    if acc is not None:
        total_dev = acc + torch.as_tensor(np.asarray(validation.offsets), dtype=acc.dtype, device=acc.device)
        res = validation.suite.evaluate_device(total_dev)
        if res is not None:
            return res
    total = np.asarray(validation.offsets, dtype=np.float64)
    if acc is not None:
        total = total + acc.detach().cpu().double().numpy()
        obs.add_device_fetch_bytes("lanes.validation_scores", acc.numel() * acc.element_size())
    return validation.suite.evaluate(total)


def _guard_fetch(finite: Tensor, reason) -> tuple:
    """One fetch of every lane's finite flag and the solve's reasons."""
    reason_t = torch.as_tensor(reason, device=finite.device).to(torch.int32)
    packed = torch.cat([finite.to(torch.int32), reason_t.reshape(-1)]).cpu().numpy()
    obs.add_device_fetch_bytes("lanes.update_guard", packed.nbytes)
    L = finite.shape[0]
    return packed[:L].astype(bool), packed[L:].reshape(tuple(reason_t.shape))


def fit_lanes(
    estimator,
    raw,
    combos: Sequence[Mapping[str, float]],
    validation=None,
    datasets: Optional[Dict[str, object]] = None,
    n_cd_iterations: Optional[int] = None,
) -> List:
    """Train ``len(combos)`` reg-weight configurations as lanes of one
    coordinate-descent run; returns one GameResult per lane, in combo order.

    Each lane is an independent trial: zero-initialized, warm-started across
    its own sweeps, guarded and best-tracked on its own; only the data
    residency and the solves are shared. ``trackers['lane']`` carries the
    lane index and per-coordinate ConvergenceReason codes."""
    from ..estimators.game_estimator import GameResult

    L = len(combos)
    check_lane_composition(estimator, L)
    if datasets is None:
        datasets = estimator._prepare_datasets(raw)
    validation_ctx = None
    if validation is not None:
        if hasattr(validation, "result"):
            validation = validation.result()
        elif callable(validation):
            validation = validation()
        validation_ctx, _ = estimator._validation_context(validation)

    names = [cc.name for cc in estimator.coordinate_configs]
    ccs = {cc.name: cc for cc in estimator.coordinate_configs}
    coords = {}
    for cc in estimator.coordinate_configs:
        if cc.is_random_effect:
            coords[cc.name] = RandomEffectCoordinate(dataset=datasets[cc.name], task=estimator.task, config=cc.config)
        else:
            coords[cc.name] = FixedEffectCoordinate(
                dataset=datasets[cc.name], task=estimator.task, config=cc.config, normalization=cc.normalization,
            )
    # per-coordinate per-lane L2 weights: the lambda-lane operands, on the
    # device once
    l2_by_coord = {
        name: torch.tensor(
            [
                ccs[name].config.regularization.l2_weight(float(combo.get(name, ccs[name].config.reg_weight)))
                for combo in combos
            ],
            dtype=estimator.dtype,
            device=estimator.device,
        )
        for name in names
    }

    n = coords[names[0]].n_rows
    n_iterations = estimator.n_cd_iterations if n_cd_iterations is None else n_cd_iterations

    registry = obs.current_run().registry
    lanes_gauge = registry.gauge(
        "photon_tuning_lanes_in_flight", "lambda lanes currently training in a batched sweep"
    )
    frozen_counter = registry.counter(
        "photon_tuning_frozen_lanes_total",
        "lanes frozen by per-lane divergence containment during batched sweeps",
    )
    lanes_gauge.set(L)

    scores: Dict[str, Tensor] = {}  # name -> committed [n, L]
    coeffs: Dict[str, Tensor] = {}  # name -> committed lane-stacked weights
    reasons: Dict[str, np.ndarray] = {}  # name -> per-lane reason codes
    summed = torch.zeros((n, L), dtype=estimator.dtype, device=estimator.device)
    evaluations: List[list] = [[] for _ in range(L)]
    best_eval = [None] * L
    best_models: List[Optional[dict]] = [None] * L
    try:
        for it in range(n_iterations):
            for name in names:
                coord = coords[name]
                own = scores.get(name)
                residual = summed - own if own is not None else summed
                with obs.span("lanes.train", phase="solve", coordinate=name, iteration=it, lanes=L):
                    W, result = coord.train_lanes(residual, l2_by_coord[name], w0_lanes=coeffs.get(name))
                    new_scores = coord.score_lanes(W)
                # per-lane guard: finite scores and a finite per-lane loss;
                # one fetch carries the flags and the reason codes
                loss_l = result.loss
                if loss_l.dim() > 1:
                    loss_l = torch.sum(loss_l, dim=0)
                finite = torch.all(torch.isfinite(new_scores), dim=0) & torch.isfinite(loss_l)
                finite_h, reason_h = _guard_fetch(finite, result.reason)
                lane_reasons = _summarize_reasons(reason_h)
                n_bad = int(np.sum(lane_reasons == _DIVERGED)) + int(
                    np.sum(~finite_h & (lane_reasons != _DIVERGED))
                )
                if n_bad:
                    frozen_counter.inc(n_bad)
                if not bool(np.all(finite_h)):
                    # revert the poisoned lanes to their previous committed
                    # state; clean lanes commit untouched (bitwise)
                    ok = torch.as_tensor(finite_h, device=W.device)
                    prev_W = coeffs.get(name)
                    W = torch.where(ok, W, torch.zeros_like(W) if prev_W is None else prev_W)
                    new_scores = torch.where(
                        ok, new_scores, torch.zeros_like(new_scores) if own is None else own
                    )
                    logger.warning(
                        "lanes iter %d coordinate %s: %d lane(s) frozen (non-finite scores/loss); "
                        "previous state stands", it, name, int(np.sum(~finite_h)),
                    )
                summed = residual + new_scores
                scores[name] = new_scores
                coeffs[name] = W
                reasons[name] = lane_reasons
                if validation_ctx is not None and (
                    estimator.validation_frequency == "COORDINATE" or name == names[-1]
                ):
                    complete = len(coeffs) == len(names)
                    with obs.span("lanes.eval", phase="eval", iteration=it, coordinate=name):
                        for lane in range(L):
                            models_l = {
                                nm: _lane_model(estimator, ccs[nm], coords[nm], coeffs[nm], lane) for nm in coeffs
                            }
                            res = _evaluate_lane(validation_ctx, models_l)
                            evaluations[lane].append((name, res))
                            primary = validation_ctx.suite.primary
                            if complete and (
                                best_eval[lane] is None
                                or primary.better(res.primary_metric, best_eval[lane].primary_metric)
                            ):
                                best_eval[lane] = res
                                best_models[lane] = models_l
    finally:
        lanes_gauge.set(0)

    results = []
    for lane in range(L):
        if best_eval[lane] is not None:
            models_l = best_models[lane]
        else:
            models_l = {nm: _lane_model(estimator, ccs[nm], coords[nm], coeffs[nm], lane) for nm in names}
        results.append(
            GameResult(
                model=GameModel(models=models_l, task=estimator.task),
                config=dict(combos[lane]),
                evaluation=best_eval[lane],
                trackers={
                    "lane": {
                        "index": lane,
                        "n_lanes": L,
                        "reasons": {nm: int(reasons[nm][lane]) for nm in reasons},
                    }
                },
            )
        )
    return results
