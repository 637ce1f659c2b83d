from .device import DEVICE_METRICS, auc, build_device_evaluator
from .evaluators import (
    Evaluator,
    area_under_pr_curve,
    area_under_roc_curve,
    build_evaluator,
    grouped_evaluate,
    logistic_loss_eval,
    poisson_loss_eval,
    precision_at_k,
    rmse,
    smoothed_hinge_loss_eval,
    squared_loss_eval,
)
from .suite import EvaluationResults, EvaluationSuite, build_suite

__all__ = [
    "DEVICE_METRICS",
    "auc",
    "build_device_evaluator",
    "Evaluator",
    "EvaluationResults",
    "EvaluationSuite",
    "build_suite",
    "build_evaluator",
    "area_under_roc_curve",
    "area_under_pr_curve",
    "rmse",
    "precision_at_k",
    "grouped_evaluate",
    "logistic_loss_eval",
    "poisson_loss_eval",
    "squared_loss_eval",
    "smoothed_hinge_loss_eval",
]
