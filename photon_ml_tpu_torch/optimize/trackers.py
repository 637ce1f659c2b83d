"""Optimization trackers: per-coordinate solve summaries for logging.

Counterpart of the JAX package's ``optimize/trackers.py``: a fixed-effect
tracker wraps one solve's result; a random-effect tracker aggregates the
per-entity lanes of one lockstep solve (a histogram of convergence reasons
and a StatCounter of iterations, over the entities with rows). The
aggregates are lazy: building a tracker fetches nothing from the device,
so the coordinate-descent loop can build one every sweep.
``record_tracker_metrics`` folds a tracker into the ``obs`` registry (it
fetches, so the loop calls it only when a sink listens).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .common import ConvergenceReason, SolverResult


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@dataclasses.dataclass(frozen=True)
class StatCounter:
    """count / mean / stdev / max / min of a sample."""

    count: int
    mean: float
    stdev: float
    max: float
    min: float

    @classmethod
    def of(cls, a) -> "StatCounter":
        a = np.asarray(a, dtype=np.float64).ravel()
        if a.size == 0:
            return cls(0, 0.0, 0.0, 0.0, 0.0)
        return cls(
            count=int(a.size),
            mean=float(a.mean()),
            stdev=float(a.std()),
            max=float(a.max()),
            min=float(a.min()),
        )

    def __str__(self) -> str:
        return (
            f"(count: {self.count}, mean: {self.mean:.6g}, "
            f"stdev: {self.stdev:.6g}, max: {self.max:.6g}, min: {self.min:.6g})"
        )


@dataclasses.dataclass(frozen=True)
class FixedEffectOptimizationTracker:
    """One whole-dataset solve."""

    result: SolverResult

    def to_summary_string(self) -> str:
        r = self.result
        reason = ConvergenceReason(int(_host(r.reason))).name
        losses = np.asarray(_host(r.loss_history), dtype=np.float64)
        losses = losses[np.isfinite(losses)]
        return (
            f"Convergence reason: {reason}\n"
            f"Iterations: {int(_host(r.iterations))}\n"
            f"Loss: {float(_host(r.loss)):.6g}"
            + (f" (initial {losses[0]:.6g})" if losses.size else "")
        )


@dataclasses.dataclass(frozen=True)
class RandomEffectOptimizationTracker:
    """The per-entity lanes of one random-effect solve: convergence-reason
    counts and iteration statistics, computed (one fetch) on first use."""

    result: SolverResult
    entity_mask: Optional[np.ndarray] = None

    def _aggregates(self):
        cached = self.__dict__.get("_agg")
        if cached is None:
            reasons = np.ravel(_host(self.result.reason))
            iters = np.ravel(_host(self.result.iterations))
            if self.entity_mask is not None:
                mask = np.asarray(self.entity_mask, dtype=bool).ravel()
                reasons, iters = reasons[mask], iters[mask]
            uniq, counts = np.unique(reasons, return_counts=True)
            hist = {ConvergenceReason(int(u)).name: int(c) for u, c in zip(uniq, counts)}
            cached = (hist, StatCounter.of(iters))
            object.__setattr__(self, "_agg", cached)
        return cached

    @property
    def convergence_reasons(self) -> Dict[str, int]:
        return self._aggregates()[0]

    @property
    def iterations_stats(self) -> StatCounter:
        return self._aggregates()[1]

    @classmethod
    def from_result(
        cls, result: SolverResult, entity_mask: Optional[np.ndarray] = None
    ) -> "RandomEffectOptimizationTracker":
        return cls(result=result, entity_mask=entity_mask)

    def to_summary_string(self) -> str:
        return (
            f"Convergence reasons stats: {self.convergence_reasons}\n"
            f"Number of iterations stats: {self.iterations_stats}"
        )


def build_tracker(coordinate, result: Optional[SolverResult]):
    """The tracker for a coordinate's result (None for no result). A
    per-lane reason (a tensor of one or more dimensions) marks a
    random-effect solve; a host int or a 0-d tensor a fixed-effect one.
    Nothing is fetched here."""
    if result is None:
        return None
    if getattr(result.reason, "ndim", 0) == 0:
        return FixedEffectOptimizationTracker(result=result)
    dataset = getattr(coordinate, "dataset", None)
    counts = getattr(dataset, "entity_counts", None)
    mask = None if counts is None else np.asarray(counts)[: result.reason.shape[0]] > 0
    return RandomEffectOptimizationTracker.from_result(result, entity_mask=mask)


def record_tracker_metrics(registry, coordinate_name: str, tracker) -> None:
    """Fold one coordinate update's tracker into the metrics registry:
    ``photon_cd_iterations`` (StatCounter-compatible summary),
    ``photon_cd_convergence_reason_total`` and the latest update's
    iterations (and, for a fixed effect, its final loss) per coordinate.
    Forces the tracker's lazy aggregates (one fetch), so callers in the CD
    loop gate this on ``obs.active()``."""
    if tracker is None:
        return
    iters = registry.summary(
        "photon_cd_iterations", "solver iterations per coordinate update"
    ).labels(coordinate=coordinate_name)
    reasons = registry.counter(
        "photon_cd_convergence_reason_total",
        "coordinate-update solves by termination reason",
    )
    latest = registry.gauge(
        "photon_cd_update_iterations",
        "solver iterations of the latest coordinate update (entity mean "
        "for random effects)",
    ).labels(coordinate=coordinate_name)
    if isinstance(tracker, RandomEffectOptimizationTracker):
        st = tracker.iterations_stats
        iters.merge_stat(st.count, st.mean, st.stdev, st.max, st.min)
        latest.set(st.mean)
        for reason, n in tracker.convergence_reasons.items():
            reasons.labels(coordinate=coordinate_name, reason=reason).inc(n)
    else:
        from ..obs import add_device_fetch_bytes

        r = tracker.result
        iters_v, reason_v, loss_v = int(_host(r.iterations)), int(_host(r.reason)), float(_host(r.loss))
        add_device_fetch_bytes("tracker_metrics", _host(r.loss).nbytes)
        iters.observe(iters_v)
        latest.set(iters_v)
        reasons.labels(
            coordinate=coordinate_name,
            reason=ConvergenceReason(reason_v).name,
        ).inc()
        registry.gauge(
            "photon_cd_final_loss", "final training loss of the latest update"
        ).labels(coordinate=coordinate_name).set(loss_v)
