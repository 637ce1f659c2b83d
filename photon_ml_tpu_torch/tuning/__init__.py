from .criteria import confidence_bound, expected_improvement
from .gp import GaussianProcessEstimator, GaussianProcessModel, GaussianProcessPosterior
from .kernels import KERNELS, Matern52, RBF, StationaryKernel
from .rescaling import HyperparameterConfig, ParamRange
from .search import EvaluationFn, GaussianProcessSearch, Observation, RandomSearch
from .serialization import (
    TUNING_MODE_BAYESIAN,
    TUNING_MODE_NONE,
    TUNING_MODE_RANDOM,
    config_from_json,
    prior_from_json,
    prior_to_json,
)
from .shrink import get_bounds
from .slice_sampler import slice_sample
from .tuner import (
    BayesianTuner,
    DummyTuner,
    HyperparameterTuner,
    RandomTuner,
    get_tuner,
)

__all__ = [
    "expected_improvement",
    "confidence_bound",
    "GaussianProcessModel",
    "GaussianProcessEstimator",
    "GaussianProcessPosterior",
    "StationaryKernel",
    "RBF",
    "Matern52",
    "KERNELS",
    "HyperparameterConfig",
    "ParamRange",
    "RandomSearch",
    "GaussianProcessSearch",
    "Observation",
    "EvaluationFn",
    "slice_sample",
    "HyperparameterTuner",
    "DummyTuner",
    "RandomTuner",
    "BayesianTuner",
    "get_tuner",
    "config_from_json",
    "prior_from_json",
    "prior_to_json",
    "get_bounds",
    "TUNING_MODE_NONE",
    "TUNING_MODE_RANDOM",
    "TUNING_MODE_BAYESIAN",
]
