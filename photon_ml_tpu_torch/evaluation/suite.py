"""EvaluationSuite: run a set of evaluators over (scores, labels, weights),
with one designated primary evaluator driving model selection.

Counterpart (a copy) of the JAX package's ``evaluation/suite.py``. Scores
are aligned with labels in fixed sample order; grouped evaluators pull their
id column from the id-tag map. ``evaluate_device`` computes every ungrouped
metric on the scores' device with one fetch (``evaluation/device.py``).
Each evaluation is an ``evaluate.device`` or ``evaluate.host`` span.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from ..obs.tracing import span
from .evaluators import Evaluator, build_evaluator, grouped_evaluate


@dataclasses.dataclass(frozen=True)
class EvaluationResults:
    """Metric values per evaluator, primary first (reference: EvaluationResults.scala)."""

    primary_name: str
    metrics: Dict[str, float]

    @property
    def primary_metric(self) -> float:
        return self.metrics[self.primary_name]


@dataclasses.dataclass
class EvaluationSuite:
    """A primary evaluator + extras, bound to validation labels/weights/id-tags."""

    evaluators: Sequence[Evaluator]
    labels: np.ndarray
    weights: Optional[np.ndarray] = None
    id_tags: Optional[Mapping[str, np.ndarray]] = None  # tag -> per-sample group id

    def __post_init__(self):
        if not self.evaluators:
            raise ValueError("EvaluationSuite requires at least one evaluator")
        names = [e.name for e in self.evaluators]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate evaluators: {names}")

    @property
    def primary(self) -> Evaluator:
        return self.evaluators[0]

    def evaluate_device(self, scores) -> Optional[EvaluationResults]:
        """Compute all metrics where the scores lie (one stacked fetch
        crosses to the host). Returns None when any evaluator needs the host
        path (grouped or ranking metrics): callers fall back to
        :meth:`evaluate`."""
        if not hasattr(self, "_device_eval"):
            from .device import build_device_evaluator

            self._device_eval = build_device_evaluator(
                self.evaluators, self.labels, self.weights
            )
        if self._device_eval is None:
            return None
        with span("evaluate.device"):
            return EvaluationResults(
                primary_name=self.primary.name, metrics=self._device_eval(scores)
            )

    def evaluate(self, scores) -> EvaluationResults:
        with span("evaluate.host"):
            return self._evaluate_host(scores)

    def _evaluate_host(self, scores) -> EvaluationResults:
        if hasattr(scores, "detach"):  # a torch tensor
            scores = scores.detach().cpu().double().numpy()
        scores = np.asarray(scores, dtype=np.float64)
        out: Dict[str, float] = {}
        for ev in self.evaluators:
            if ev.group_by is None:
                out[ev.name] = float(ev.evaluate(scores, self.labels, self.weights))
            else:
                if self.id_tags is None or ev.group_by not in self.id_tags:
                    raise KeyError(
                        f"Evaluator {ev.name} needs id tag {ev.group_by!r}, "
                        f"got {sorted(self.id_tags or {})}"
                    )
                out[ev.name] = grouped_evaluate(
                    ev.evaluate,
                    np.asarray(self.id_tags[ev.group_by]),
                    scores,
                    self.labels,
                    self.weights,
                )
        return EvaluationResults(primary_name=self.primary.name, metrics=out)


def build_suite(
    specs: Sequence[str],
    labels,
    weights=None,
    id_tags: Optional[Mapping[str, np.ndarray]] = None,
) -> EvaluationSuite:
    return EvaluationSuite(
        evaluators=[build_evaluator(s) for s in specs],
        labels=np.asarray(labels, dtype=np.float64),
        weights=None if weights is None else np.asarray(weights, dtype=np.float64),
        id_tags=id_tags,
    )
