"""Non-GAME GLM training over a regularization-weight grid with warm starts.

The JAX package's ``estimators/model_training.py`` on the port's
``GLMProblem`` and ``EvaluationSuite``. Reference: photon-api
.../ModelTraining.trainGeneralizedLinearModel (ModelTraining.scala:53-228):
for each lambda in the grid (ascending), warm-start from the previous
lambda's coefficients, then select the best model by a validation metric
(legacy Driver's validate stage, Driver.scala:451).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..evaluation.suite import EvaluationSuite
from ..game.problem import GLMOptimizationConfig, GLMProblem
from ..models.glm import GeneralizedLinearModel
from ..ops.features import LabeledBatch
from ..ops.normalization import NormalizationContext
from ..optimize import SolverResult


@dataclasses.dataclass
class TrainedModel:
    reg_weight: float
    model: GeneralizedLinearModel
    solver_result: SolverResult
    validation_metrics: Optional[Dict[str, float]] = None


def train_glm_grid(
    batch: LabeledBatch,
    task: str,
    base_config: GLMOptimizationConfig,
    reg_weights: Sequence[float],
    normalization: Optional[NormalizationContext] = None,
    warm_start: bool = True,
    initial_model: Optional[GeneralizedLinearModel] = None,
    plain: bool = False,
) -> List[TrainedModel]:
    """Train one model per regularization weight, warm-starting along the
    grid. ``plain`` runs the kernels' plain versions on the card (a
    reference solve to hold the kernels' grid against)."""
    out: List[TrainedModel] = []
    prev = initial_model
    for lam in sorted(reg_weights):
        problem = GLMProblem(
            task=task,
            config=base_config.with_reg_weight(lam),
            normalization=normalization,
        )
        model, result = problem.run(
            batch, initial_model=prev if warm_start else initial_model, plain=plain
        )
        out.append(TrainedModel(reg_weight=lam, model=model, solver_result=result))
        prev = model
    return out


def select_best_model(
    trained: Sequence[TrainedModel],
    validation_batch: LabeledBatch,
    suite: EvaluationSuite,
) -> Tuple[TrainedModel, List[TrainedModel]]:
    """Evaluate every model on the validation batch; pick by primary metric
    (legacy Driver model selection, Driver.scala:416)."""
    best: Optional[TrainedModel] = None
    best_value: float = float("nan")
    for tm in trained:
        results = suite.evaluate(tm.model.score(validation_batch))
        tm.validation_metrics = results.metrics
        v = results.primary_metric
        if best is None or suite.primary.better(v, best_value):
            best, best_value = tm, v
    return best, list(trained)
