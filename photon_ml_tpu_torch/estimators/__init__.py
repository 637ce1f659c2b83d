"""Estimators: the legacy GLM driver's grid training and model selection
(``model_training``). The GAME estimator is ROADMAP A12."""

from .model_training import TrainedModel, select_best_model, train_glm_grid

__all__ = ["TrainedModel", "train_glm_grid", "select_best_model"]
