"""Evaluation metrics: AUC, AUPR, RMSE, per-loss means, precision@k, and
grouped (Multi) evaluators.

Reference: photon-lib/.../evaluation + photon-api/.../evaluation — notably the
weighted, tie-aware AUC of AreaUnderROCCurveLocalEvaluator.scala:33-72 and the
group-average MultiEvaluator.scala:46-63 ("PRECISION@k:idTag"-style metrics).

Counterpart (a copy) of the JAX package's ``evaluation/evaluators.py``:
O(n log n) host-side numpy over the gathered score vector. Grouped metrics
use a single argsort + segment pass rather than a shuffle/groupByKey.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import numpy as np

POSITIVE_THRESHOLD = 0.5


def _as_np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def area_under_roc_curve(
    scores, labels, weights=None
) -> float:
    """Weighted AUROC with trapezoidal tie handling — exact parity with
    AreaUnderROCCurveLocalEvaluator.scala:33-72."""
    s, y = _as_np(scores), _as_np(labels)
    w = np.ones_like(s) if weights is None else _as_np(weights)
    order = np.argsort(-s, kind="stable")
    s, y, w = s[order], y[order], w[order]
    pos = np.where(y > POSITIVE_THRESHOLD, w, 0.0)
    neg = np.where(y > POSITIVE_THRESHOLD, 0.0, w)
    # group ties: boundaries where score changes
    boundary = np.concatenate([[True], s[1:] != s[:-1]])
    group_id = np.cumsum(boundary) - 1
    n_groups = group_id[-1] + 1 if len(s) else 0
    gp = np.bincount(group_id, weights=pos, minlength=n_groups)
    gn = np.bincount(group_id, weights=neg, minlength=n_groups)
    cum_pos_before = np.concatenate([[0.0], np.cumsum(gp)[:-1]])
    raw = np.sum(cum_pos_before * gn + gp * gn / 2.0)
    tp, tn = gp.sum(), gn.sum()
    if tp == 0 or tn == 0:
        return float("nan")
    return float(raw / (tp * tn))


def area_under_pr_curve(scores, labels, weights=None) -> float:
    """Weighted AUPR (average-precision-style, linear interpolation between
    PR points at distinct score thresholds; reference delegates to Spark
    mllib's BinaryClassificationMetrics)."""
    s, y = _as_np(scores), _as_np(labels)
    w = np.ones_like(s) if weights is None else _as_np(weights)
    order = np.argsort(-s, kind="stable")
    s, y, w = s[order], y[order], w[order]
    pos = np.where(y > POSITIVE_THRESHOLD, w, 0.0)
    neg = np.where(y > POSITIVE_THRESHOLD, 0.0, w)
    boundary = np.concatenate([[True], s[1:] != s[:-1]])
    group_id = np.cumsum(boundary) - 1
    n_groups = group_id[-1] + 1 if len(s) else 0
    gp = np.bincount(group_id, weights=pos, minlength=n_groups)
    gn = np.bincount(group_id, weights=neg, minlength=n_groups)
    tp = np.cumsum(gp)
    fp = np.cumsum(gn)
    total_pos = tp[-1] if len(tp) else 0.0
    if total_pos == 0:
        return float("nan")
    recall = tp / total_pos
    precision = np.where(tp + fp > 0, tp / (tp + fp), 1.0)
    # prepend (r=0, p=first precision)
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[precision[0] if len(precision) else 1.0], precision])
    return float(np.sum((r[1:] - r[:-1]) * (p[1:] + p[:-1]) / 2.0))


def rmse(scores, labels, weights=None) -> float:
    s, y = _as_np(scores), _as_np(labels)
    w = np.ones_like(s) if weights is None else _as_np(weights)
    return float(np.sqrt(np.sum(w * (s - y) ** 2) / np.sum(w)))


def _mean_loss(loss_fn) -> Callable:
    def evaluate(scores, labels, weights=None) -> float:
        s, y = _as_np(scores), _as_np(labels)
        w = np.ones_like(s) if weights is None else _as_np(weights)
        return float(np.sum(w * loss_fn(s, y)) / np.sum(w))

    return evaluate


def _logistic_loss_np(z, y):
    return np.log1p(np.exp(-np.abs(z))) + np.maximum(z, 0) - np.where(y > POSITIVE_THRESHOLD, 1.0, 0.0) * z


def _poisson_loss_np(z, y):
    return np.exp(z) - y * z


def _squared_loss_np(z, y):
    return 0.5 * (z - y) ** 2


def _smoothed_hinge_np(z, y):
    ymod = np.where(y > POSITIVE_THRESHOLD, 1.0, -1.0)
    m = ymod * z
    return np.where(m <= 0, 0.5 - m, np.where(m < 1, 0.5 * (1 - m) ** 2, 0.0))


logistic_loss_eval = _mean_loss(_logistic_loss_np)
poisson_loss_eval = _mean_loss(_poisson_loss_np)
squared_loss_eval = _mean_loss(_squared_loss_np)
smoothed_hinge_loss_eval = _mean_loss(_smoothed_hinge_np)


def precision_at_k(k: int, scores, labels, weights=None) -> float:
    """Fraction of the k highest-scored samples that are positive
    (PrecisionAtKLocalEvaluator.scala:39-76; weights unused, parity)."""
    s, y = _as_np(scores), _as_np(labels)
    order = np.argsort(-s, kind="stable")
    top = y[order][:k]
    return float(np.sum(top > POSITIVE_THRESHOLD) / k)


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """A named metric with its comparison direction.

    ``evaluate(scores, labels, weights)`` -> float.
    ``better(a, b)`` -> True if a is a better value than b
    (reference: EvaluatorType.scala:55-65 betterThan ops).
    """

    name: str
    evaluate: Callable
    higher_is_better: bool
    group_by: Optional[str] = None  # id-tag for Multi evaluators

    def better(self, a: float, b: float) -> bool:
        if np.isnan(a):
            return False
        if np.isnan(b):
            return True
        return a > b if self.higher_is_better else a < b


def grouped_evaluate(
    local_metric: Callable,
    group_ids: np.ndarray,
    scores,
    labels,
    weights=None,
) -> float:
    """Per-group metric, unweighted mean over groups, NaN/inf groups dropped
    (MultiEvaluator.scala:46-63)."""
    s, y = _as_np(scores), _as_np(labels)
    w = np.ones_like(s) if weights is None else _as_np(weights)
    gids = np.asarray(group_ids)
    if gids.size == 0:
        return float("nan")
    _, inv = np.unique(gids, return_inverse=True)
    # one stable sort by group: each group's rows are a contiguous slice in
    # their original order (what a boolean mask per group would select)
    order = np.argsort(inv, kind="stable")
    bounds = np.flatnonzero(np.diff(inv[order])) + 1
    vals = []
    for rows in np.split(order, bounds):
        v = local_metric(s[rows], y[rows], w[rows])
        if np.isfinite(v):
            vals.append(v)
    return float(np.mean(vals)) if vals else float("nan")


_MULTI_PRECISION_RE = re.compile(r"^PRECISION@(\d+):(.+)$", re.IGNORECASE)
_MULTI_AUC_RE = re.compile(r"^AUC:(.+)$", re.IGNORECASE)

_SINGLE_EVALUATORS = {
    "AUC": (area_under_roc_curve, True),
    "AUPR": (area_under_pr_curve, True),
    "RMSE": (rmse, False),
    "LOGISTIC_LOSS": (logistic_loss_eval, False),
    "POISSON_LOSS": (poisson_loss_eval, False),
    "SQUARED_LOSS": (squared_loss_eval, False),
    "SMOOTHED_HINGE_LOSS": (smoothed_hinge_loss_eval, False),
}


def build_evaluator(spec: str) -> Evaluator:
    """Parse an evaluator spec: plain names (``AUC``, ``RMSE``, ...) or grouped
    forms ``AUC:idTag`` / ``PRECISION@k:idTag``
    (reference: EvaluatorType.scala + MultiEvaluatorType.scala:24-75)."""
    key = spec.strip()
    upper = key.upper()
    if upper in _SINGLE_EVALUATORS:
        fn, hib = _SINGLE_EVALUATORS[upper]
        return Evaluator(name=upper, evaluate=fn, higher_is_better=hib)
    m = _MULTI_PRECISION_RE.match(key)
    if m:
        k, tag = int(m.group(1)), m.group(2)
        fn = lambda s, y, w=None, _k=k: precision_at_k(_k, s, y, w)
        return Evaluator(
            name=f"PRECISION@{k}:{tag}", evaluate=fn, higher_is_better=True, group_by=tag
        )
    m = _MULTI_AUC_RE.match(key)
    if m:
        tag = m.group(1)
        return Evaluator(
            name=f"AUC:{tag}", evaluate=area_under_roc_curve, higher_is_better=True,
            group_by=tag,
        )
    raise ValueError(f"Unrecognized evaluator spec: {spec!r}")
