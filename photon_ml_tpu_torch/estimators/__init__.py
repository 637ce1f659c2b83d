"""Estimators: the GAME estimator and its scoring twin (``game_estimator``)
and the legacy GLM driver's grid training and model selection
(``model_training``)."""

from .game_estimator import CoordinateConfig, GameEstimator, GameResult, GameTransformer
from .model_training import TrainedModel, select_best_model, train_glm_grid

__all__ = [
    "CoordinateConfig",
    "GameEstimator",
    "GameResult",
    "GameTransformer",
    "TrainedModel",
    "select_best_model",
    "train_glm_grid",
]
