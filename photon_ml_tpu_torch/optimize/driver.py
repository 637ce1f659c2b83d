"""Optimizer dispatch: config -> solver run.

Counterpart of the JAX package's ``optimize/driver.py``: the relative ->
absolute tolerance conversion from the zero state, then dispatch on the
optimizer type: LBFGS, OWLQN (an L1 weight) and LBFGSB (box constraints)
to ``solve_lbfgs``, TRON to ``solve_tron``. One ``SyncCounter`` follows the whole solve, the tolerance
pass included, so ``SolverResult.syncs`` counts every wait on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import (
    LOCAL,
    CoefficientAxis,
    HvpFn,
    OptimizerConfig,
    OptimizerType,
    SolverResult,
    SyncCounter,
    ValueAndGradFn,
    abs_tolerances,
)
from .lbfgs import solve_lbfgs
from .tron import solve_tron


def optimize(
    value_and_grad: ValueAndGradFn,
    w0: torch.Tensor,
    config: OptimizerConfig,
    hvp: Optional[HvpFn] = None,
    axis: CoefficientAxis = LOCAL,
) -> SolverResult:
    """Solve from ``w0`` as ``config`` says. ``axis`` is where the
    coefficient vector lies (``optimize.common``): ``LOCAL``, or a
    ``ModelAxis`` for a tiled batch's model-sharded slice, whose
    reductions every solver routes through it."""
    kind = config.normalized_type()
    # refuse before the tolerance pass sweeps the data
    if kind == OptimizerType.TRON and hvp is None:
        raise ValueError("TRON requires a Hessian-vector-product function")

    syncs = SyncCounter()
    loss_tol, grad_tol = abs_tolerances(value_and_grad, w0, config.tolerance, syncs, axis=axis)
    if kind in (OptimizerType.LBFGS, OptimizerType.LBFGSB, OptimizerType.OWLQN):
        return solve_lbfgs(
            value_and_grad,
            w0,
            loss_tol,
            grad_tol,
            max_iterations=config.max_iterations,
            num_corrections=config.num_corrections,
            l1_weight=config.l1_weight if kind == OptimizerType.OWLQN else 0.0,
            box_constraints=config.box_constraints,
            max_line_search_iterations=config.max_line_search_iterations,
            syncs=syncs,
            axis=axis,
        )
    return solve_tron(
        value_and_grad,
        hvp,
        w0,
        loss_tol,
        grad_tol,
        max_iterations=config.max_iterations,
        max_cg_iterations=config.max_cg_iterations,
        max_improvement_failures=config.max_improvement_failures,
        box_constraints=config.box_constraints,
        syncs=syncs,
        axis=axis,
    )
