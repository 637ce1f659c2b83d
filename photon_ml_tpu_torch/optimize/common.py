"""Shared optimizer contracts: convergence reasons, configs, results.

Counterpart of the JAX package's ``optimize/common.py``. The solvers of this
package drive their loop from the host, with the iterate, the gradient, the
CG state and the L-BFGS history on the device; only the scalars that decide
a branch cross to the host, a few at a time in one ``fetch``.

Convergence semantics: tolerances are relative, turned absolute from the
state at zero coefficients (loss(0) * tol, ||grad(0)|| * tol), and the
reasons are checked in the reference's precedence order.

The helpers are lane-generic, as the JAX package's are: a 1-D coefficient
vector is one problem, and an entity-minor stack ``[S, E]`` is E problems
whose reductions run over axis 0, with per-lane ``[E]`` losses, tolerances
and reasons (the batched L-BFGS of ``lbfgs.py``, the batched TRON of
``tron.py``). ``Lanes`` names the other layout the batched solvers take:
entity-leading ``[E, S]``, the JAX package's vmapped per-entity solve.

One problem's reductions over its coefficient vector (dots, norms, the
finite check, OWL-QN's ``||w||_1``) go through one hook, a
``CoefficientAxis``: ``LOCAL`` where the whole vector is on this rank (a
total is the rank's own ``torch.dot``, the bits the solvers always had),
``ModelAxis`` where it is sharded over a model axis of ranks (a tiled
batch's ``[d_loc]`` slice, ``parallel/sparse.py``): the rank's partials
summed over its data row, those that do not depend on each other in one
collective, so that every rank fetches the same scalars and takes the same
decisions.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.lane_reduce import lane_reduce

Tensor = torch.Tensor

# Callable w -> (value, gradient)
ValueAndGradFn = Callable[[Tensor], Tuple[Tensor, Tensor]]
# Callable (w, v) -> H(w) v
HvpFn = Callable[[Tensor, Tensor], Tensor]


class ConvergenceReason(enum.IntEnum):
    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    OBJECTIVE_NOT_IMPROVING = 2
    FUNCTION_VALUES_CONVERGED = 3
    GRADIENT_CONVERGED = 4
    # the objective or gradient went non-finite: the solver keeps its last
    # good iterate and stops
    NUMERICAL_DIVERGENCE = 5


class OptimizerType(str, enum.Enum):
    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    LBFGSB = "LBFGSB"
    TRON = "TRON"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Solver settings; defaults are the reference's. ``l1_weight`` routes
    LBFGS to OWL-QN; ``box_constraints`` = (lower[d], upper[d]) makes LBFGS
    run L-BFGS-B, and TRON project into the box after each accepted step."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    tolerance: float = 1e-7
    max_iterations: int = 100
    num_corrections: int = 10
    l1_weight: float = 0.0
    box_constraints: Optional[Tuple[Tensor, Tensor]] = None
    max_line_search_iterations: int = 25
    # TRON-specific
    max_improvement_failures: int = 5
    max_cg_iterations: int = 20

    def normalized_type(self) -> OptimizerType:
        t = OptimizerType(self.optimizer_type)
        if t == OptimizerType.LBFGS and self.l1_weight > 0.0:
            return OptimizerType.OWLQN
        return t


@dataclasses.dataclass(frozen=True)
class SolverResult:
    """Final solver state plus per-iteration history (NaN-padded to
    ``max_iterations + 1``). For one problem ``iterations`` and ``reason``
    are host ints; for a batch of lanes they are ``[E]`` int32 tensors and
    the histories ``[max_iterations + 1, E]``. ``syncs`` counts the
    device-to-host fetches the solve made."""

    coefficients: Tensor
    loss: Tensor
    gradient: Tensor
    iterations: Union[int, Tensor]
    reason: Union[int, Tensor]
    loss_history: Tensor
    grad_norm_history: Tensor
    syncs: int = 0

    @property
    def converged(self):
        return self.reason != ConvergenceReason.NOT_CONVERGED


class SyncCounter:
    """Fetches device scalars to the host, several in one transfer, and
    counts the transfers: each one waits for the device.

    Values come back as numpy scalars of the first value's dtype (the
    solver's dtype), so that the host-side branch arithmetic rounds as the
    JAX package's on-device solvers do."""

    def __init__(self) -> None:
        self.count = 0

    def fetch(self, first: Tensor, *rest) -> List[np.generic]:
        self.count += 1
        packed = torch.stack(
            [first.reshape(())]
            + [torch.as_tensor(v, device=first.device).to(first.dtype).reshape(()) for v in rest]
        )
        return list(packed.cpu().numpy())


class Lanes:
    """Where the lanes of a batch of problems lie in a coefficient stack.

    ``MINOR`` (entity-minor, the packed solve): ``[S, E]`` (or ``[d, L]``),
    per-lane reductions are axis-0 sums and a per-lane ``[E]`` value
    broadcasts against the stack as it is. ``LEADING`` (entity-leading, the
    JAX package's vmapped per-entity solve): ``[E, S]``, reductions run over
    the last axis and a per-lane value spreads as ``[E, 1]``. Its
    reductions are the lane reduction (``ops/lane_reduce.py``: V1 on the
    card; on the CPU a last-axis ``torch.sum``, which adds each row in the
    same order whatever the number of rows), so a lane's bits do not depend
    on the other lanes of its stack."""

    def __init__(self, axis: int) -> None:
        self.axis = axis

    def dot(self, a: Tensor, b: Tensor) -> Tensor:
        if self.axis == -1:
            return lane_reduce(a, b)
        return torch.sum(a * b, dim=self.axis)

    def norm(self, v: Tensor) -> Tensor:
        return torch.sqrt(self.dot(v, v))

    def sum(self, a: Tensor) -> Tensor:
        if self.axis == -1:
            return lane_reduce(a)
        return torch.sum(a, dim=self.axis)

    def spread(self, x: Tensor) -> Tensor:
        """A per-lane value shaped to broadcast against the stack."""
        return x.unsqueeze(-1) if self.axis == -1 else x

    def where(self, mask: Tensor, a, b) -> Tensor:
        """``torch.where`` with a per-lane mask over stacks."""
        return torch.where(self.spread(mask), a, b)

    def finite(self, f: Tensor, g: Tensor) -> Tensor:
        """``finite_state`` per lane."""
        return torch.isfinite(f) & torch.all(torch.isfinite(g), dim=self.axis)


MINOR = Lanes(0)
LEADING = Lanes(-1)


class CoefficientAxis:
    """Where one problem's coefficient vector lies: whole on this rank. The
    solvers reduce over it only through ``total``: partial sums this rank
    computed over its coefficients in, their totals over every coefficient
    out, in one call for all of them. Here a total is its partial."""

    def total(self, *partials: Tensor) -> Tuple[Tensor, ...]:
        return partials

    def dot(self, a: Tensor, b: Tensor) -> Tensor:
        return self.total(torch.dot(a, b))[0]

    def norm(self, v: Tensor) -> Tensor:
        return torch.sqrt(self.dot(v, v))

    @staticmethod
    def nonfinite(g: Tensor) -> Tensor:
        """A partial whose total is 0 exactly when every coefficient of
        ``g`` is finite (its non-finite entries, counted in ``g``'s dtype)."""
        return torch.sum(~torch.isfinite(g)).to(g.dtype)


class ModelAxis(CoefficientAxis):
    """A coefficient vector sharded over the ranks of ``group`` (a
    ``parallel.mesh.DataParallelGroup``: a data row of the grid, whose
    ranks hold the model axis's slices): the partials of one ``total`` are
    summed over the group in one exact collective (``group.sum``: float64
    slots, the rank-order sum), every rank the same bits."""

    def __init__(self, group) -> None:
        self.group = group

    def total(self, *partials: Tensor) -> Tuple[Tensor, ...]:
        dtype = partials[0].dtype
        stacked = torch.stack([p.reshape(()).to(dtype) for p in partials])
        return tuple(self.group.sum(stacked).unbind())


LOCAL = CoefficientAxis()


def project_box(w: Tensor, box: Optional[Tuple[Tensor, Tensor]]) -> Tensor:
    """Clamp coefficients into [lower, upper]."""
    if box is None:
        return w
    lower, upper = box
    return torch.clamp(w, lower, upper)


def check_convergence(
    it,
    max_iterations: int,
    loss,
    prev_loss,
    grad_norm,
    loss_abs_tol,
    grad_abs_tol,
    objective_not_improving,
    diverged=False,
):
    """Reason code in the reference's precedence order: later conditions
    override earlier ones, divergence overrides all. Host scalars give a
    host int; ``[E]`` lane tensors give an ``[E]`` int32 tensor."""
    if isinstance(loss, torch.Tensor):
        r = ConvergenceReason
        zero = torch.zeros_like(loss, dtype=torch.int32)
        reason = torch.where(grad_norm <= grad_abs_tol, int(r.GRADIENT_CONVERGED), zero)
        reason = torch.where(
            torch.abs(loss - prev_loss) <= loss_abs_tol, int(r.FUNCTION_VALUES_CONVERGED), reason
        )
        reason = torch.where(objective_not_improving, int(r.OBJECTIVE_NOT_IMPROVING), reason)
        reason = torch.where(it >= max_iterations, int(r.MAX_ITERATIONS), reason)
        return torch.where(diverged, int(r.NUMERICAL_DIVERGENCE), reason).to(torch.int32)
    reason = 0
    if grad_norm <= grad_abs_tol:
        reason = int(ConvergenceReason.GRADIENT_CONVERGED)
    if abs(loss - prev_loss) <= loss_abs_tol:
        reason = int(ConvergenceReason.FUNCTION_VALUES_CONVERGED)
    if objective_not_improving:
        reason = int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)
    if it >= max_iterations:
        reason = int(ConvergenceReason.MAX_ITERATIONS)
    if diverged:
        reason = int(ConvergenceReason.NUMERICAL_DIVERGENCE)
    return reason


def finite_state(f: Tensor, g: Tensor) -> Tensor:
    """Device bool per lane: the (loss, gradient) pair is numerically sound
    (scalar for a 1-D gradient, ``[E]`` for an ``[S, E]`` stack)."""
    return torch.isfinite(f) & torch.all(torch.isfinite(g), dim=0)


def vdot(a: Tensor, b: Tensor) -> Tensor:
    """Coefficient-axis dot: ``torch.dot`` for 1-D operands, per-lane
    ``[E]`` axis-0 sums for ``[S, E]`` stacks."""
    if a.dim() == 1:
        return torch.dot(a, b)
    return torch.sum(a * b, dim=0)


def norm(v: Tensor) -> Tensor:
    return torch.sqrt(vdot(v, v))


def abs_tolerances(
    value_and_grad: ValueAndGradFn,
    zero_like: Tensor,
    tolerance: float,
    syncs: Optional[SyncCounter] = None,
    lanes: Lanes = MINOR,
    axis: CoefficientAxis = LOCAL,
):
    """Absolute tolerances from the state at zero coefficients: host
    scalars for one problem (one fetch; ``axis`` where its coefficients
    lie); ``[E]`` device tensors for a stack of lanes laid out as ``lanes``
    says, which the batched solvers keep on the device (no fetch)."""
    f0, g0 = value_and_grad(torch.zeros_like(zero_like))
    if zero_like.dim() > 1:
        # a Python scalar: no upload (and the same products as a 0-dim
        # tensor of the value's dtype)
        return torch.abs(f0) * tolerance, lanes.norm(g0) * tolerance
    f0_h, g0_norm = (syncs or SyncCounter()).fetch(f0, axis.norm(g0))
    tol = f0_h.dtype.type(tolerance)
    return abs(f0_h) * tol, g0_norm * tol


def nan_history(values: List, length: int, like: Tensor) -> Tensor:
    out = [math.nan] * length
    out[: len(values)] = [float(v) for v in values]
    return torch.tensor(out, dtype=like.dtype, device=like.device)
