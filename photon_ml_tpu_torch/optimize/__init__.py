from .common import (
    LOCAL,
    CoefficientAxis,
    ConvergenceReason,
    ModelAxis,
    OptimizerConfig,
    OptimizerType,
    SolverResult,
    SyncCounter,
    abs_tolerances,
    project_box,
)
from . import trackers
from .driver import optimize
from .lbfgs import solve_lbfgs
from .tron import solve_tron

__all__ = [
    "LOCAL",
    "CoefficientAxis",
    "ConvergenceReason",
    "ModelAxis",
    "OptimizerConfig",
    "OptimizerType",
    "SolverResult",
    "SyncCounter",
    "abs_tolerances",
    "project_box",
    "optimize",
    "solve_lbfgs",
    "solve_tron",
    "trackers",
]
