from .coordinate import Coordinate, FixedEffectCoordinate, ModelCoordinate, RandomEffectCoordinate
from . import pipeline
from .data import (
    EntityBlocks,
    FixedEffectDataset,
    HostRowBatch,
    RandomEffectDataset,
    build_fixed_effect_dataset,
    build_fixed_effect_dataset_from_disk,
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
    "HostRowBatch",
    "ModelCoordinate",
    "RandomEffectCoordinate",
    "RandomEffectDataset",
    "ValidationContext",
    "pipeline",
    "build_fixed_effect_dataset",
    "build_fixed_effect_dataset_from_disk",
    "build_random_effect_dataset",
]
