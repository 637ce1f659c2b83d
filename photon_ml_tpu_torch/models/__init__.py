from .coefficients import Coefficients
from .game import FixedEffectModel, GameModel, RandomEffectModel
from .glm import (
    GeneralizedLinearModel,
    LinearRegressionModel,
    LogisticRegressionModel,
    MODEL_CLASSES,
    PoissonRegressionModel,
    SmoothedHingeLossLinearSVMModel,
    model_for_task,
)

__all__ = [
    "Coefficients",
    "FixedEffectModel",
    "GameModel",
    "RandomEffectModel",
    "GeneralizedLinearModel",
    "LogisticRegressionModel",
    "LinearRegressionModel",
    "PoissonRegressionModel",
    "SmoothedHingeLossLinearSVMModel",
    "MODEL_CLASSES",
    "model_for_task",
]
