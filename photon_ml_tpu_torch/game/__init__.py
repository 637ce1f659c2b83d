from .coordinate import Coordinate, FixedEffectCoordinate, ModelCoordinate, RandomEffectCoordinate
from .data import (
    EntityBlocks,
    FixedEffectDataset,
    RandomEffectDataset,
    build_fixed_effect_dataset,
    build_random_effect_dataset,
)
from .descent import CoordinateDescent, CoordinateDescentResult, ValidationContext
from .problem import GLMOptimizationConfig, GLMProblem

__all__ = [
    "Coordinate",
    "CoordinateDescent",
    "CoordinateDescentResult",
    "EntityBlocks",
    "FixedEffectCoordinate",
    "FixedEffectDataset",
    "GLMOptimizationConfig",
    "GLMProblem",
    "ModelCoordinate",
    "RandomEffectCoordinate",
    "RandomEffectDataset",
    "ValidationContext",
    "build_fixed_effect_dataset",
    "build_random_effect_dataset",
]
