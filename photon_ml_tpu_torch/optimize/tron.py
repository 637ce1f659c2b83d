"""TRON: trust-region Newton with truncated conjugate-gradient inner solves.

Counterpart of the JAX package's ``optimize/tron.py``, in the structure of
its single-lane host-loop twin (``optimize/host_driver.py``): PyTorch has no
device loop, so the loop runs on the host while ``w``, ``g`` and the CG state
stay on the device. Constants match: eta = (1e-4, 0.25, 0.75),
sigma = (0.25, 0.5, 4.0); CG stops at ||r|| <= 0.1 ||g|| or at the trust
region's boundary, which it crosses back to; the first trial shrinks the
radius to min(delta, ||step||).

Host scalars are numpy scalars of the solver's dtype, so the branch
arithmetic rounds as the on-device reference does.

Syncs: one fetch per CG step (the step's norm against the radius and the
residual's norm against the CG tolerance) and one per TRON iteration (the
trial's loss, the predicted reduction, the norms and the finite flag), so
a TRON iteration with k CG steps waits on the device k + 1 times.

A stack of lanes (``w0`` of 2 or more dimensions) runs the JAX package's
lane-generic ``_solve``: entity-minor ``[S, E]`` (or ``[d, L]``) with the
reductions over axis 0, or with ``entity_leading=True`` ``[E, S]`` with the
reductions over the last axis (its vmapped per-entity solve). Each lane has
its own trust radius, CG state, failure count and reason, all on the
device; masked commits freeze a converged or diverged lane at its last
committed iterate, and a non-finite trial rolls its lane back without
touching the others. Every lane runs until all lanes are done (the
reference's lockstep artifact: a lane may take a few more accepted steps
than a solve of its own). The host fetches one flag per CG step (every
lane's CG done) and one per outer iteration (every lane done), so the
counts stay 1 + CG steps per iteration, plus one at the start. Values may
be wider than the iterate (a float64 sum of float32 terms): the actual and
predicted reductions compare there, and the radius follows the iterate's
dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import obs
from ..analysis.runtime import device_put
from .common import (
    LEADING,
    LOCAL,
    MINOR,
    CoefficientAxis,
    ConvergenceReason,
    Lanes,
    HvpFn,
    SolverResult,
    SyncCounter,
    ValueAndGradFn,
    check_convergence,
    nan_history,
    project_box,
)

Tensor = torch.Tensor

_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0


def _nonzero(x: Tensor) -> Tensor:
    return torch.where(x != 0, x, torch.ones_like(x))


def _truncated_cg(
    hvp: HvpFn,
    w: Tensor,
    gradient: Tensor,
    grad_norm,
    delta,
    max_cg_iterations: int,
    syncs: SyncCounter,
    axis: CoefficientAxis = LOCAL,
) -> Tuple[Tensor, Tensor, int]:
    """Approximately solve H step = -gradient within ||step|| <= delta.
    Returns (step, residual, cg_iterations); the residual r = -g - H step
    feeds the predicted reduction. The reductions that do not depend on
    each other share one ``axis`` total."""
    tol = 0.1 * grad_norm
    step = torch.zeros_like(gradient)
    r = -gradient
    d = r.clone()
    rtr = axis.dot(r, r)
    if grad_norm <= tol:
        return step, r, 0
    it = 0
    while it < max_cg_iterations:
        hd = hvp(w, d)
        alpha = rtr / _nonzero(axis.dot(d, hd))
        step_try = step + alpha * d
        r_new = r - alpha * hd
        sts_try, rtr_new = axis.total(torch.dot(step_try, step_try), torch.dot(r_new, r_new))
        step_norm, r_norm = syncs.fetch(torch.sqrt(sts_try), torch.sqrt(rtr_new))
        if step_norm > delta:
            # hit the trust-region boundary: back off to the crossing
            std, sts, dtd = axis.total(torch.dot(step, d), torch.dot(step, step), torch.dot(d, d))
            delta_t = device_put(delta, gradient.device, gradient.dtype)
            dsq = delta_t * delta_t
            rad = torch.sqrt(torch.clamp(std * std + dtd * (dsq - sts), min=0.0))
            alpha_b = torch.where(
                std >= 0, (dsq - sts) / _nonzero(std + rad), (rad - std) / _nonzero(dtd)
            )
            return step + alpha_b * d, r - alpha_b * hd, it + 1
        step = step_try
        r = r_new
        d = r + (rtr_new / _nonzero(rtr)) * d
        rtr = rtr_new
        it += 1
        if r_norm <= tol:
            break
    return step, r, it


def _recorded(result: SolverResult) -> SolverResult:
    """A one-problem solve's result, recorded in the obs registry when a
    sink listens (``obs.record_solver_metrics``)."""
    obs.record_solver_metrics("tron", result)
    return result


def solve_tron(
    value_and_grad: ValueAndGradFn,
    hvp: HvpFn,
    w0: Tensor,
    loss_abs_tol,
    grad_abs_tol,
    max_iterations: int = 15,
    max_cg_iterations: int = 20,
    max_improvement_failures: int = 5,
    box_constraints: Optional[Tuple[Tensor, Tensor]] = None,
    syncs: Optional[SyncCounter] = None,
    entity_leading: bool = False,
    axis: CoefficientAxis = LOCAL,
) -> SolverResult:
    """Minimize f(w) from ``w0``: one problem for a 1-D ``w0``, else a stack
    of lanes (``entity_leading`` picks the layout; see the module's
    docstring), with per-lane ``[E]`` absolute tolerances or scalars.
    ``axis``: where one problem's coefficients lie (``optimize.common``)."""
    syncs = syncs or SyncCounter()
    if w0.dim() != 1:
        return _solve_batched(
            value_and_grad, hvp, w0, loss_abs_tol, grad_abs_tol, max_iterations,
            max_cg_iterations, max_improvement_failures, box_constraints, syncs,
            LEADING if entity_leading else MINOR,
        )
    w = w0.clone()
    f, g = value_and_grad(w)
    gg, bad = axis.total(torch.dot(g, g), axis.nonfinite(g))
    f_h, g_norm, ok = syncs.fetch(f, torch.sqrt(gg), torch.isfinite(f) & (bad == 0))
    lh, gh = [f_h], [g_norm]

    def result(it: int, reason: int) -> SolverResult:
        T = max_iterations + 1
        return _recorded(SolverResult(
            coefficients=w,
            loss=f,
            gradient=g,
            iterations=it,
            reason=reason,
            loss_history=nan_history(lh, T, w),
            grad_norm_history=nan_history(gh, T, w),
            syncs=syncs.count,
        ))

    if not ok:
        # corrupt at start: no good iterate to roll back to
        return result(0, int(ConvergenceReason.NUMERICAL_DIVERGENCE))

    delta = g_norm
    it = 0
    failures = 0
    while True:
        step, residual, _ = _truncated_cg(hvp, w, g, g_norm, delta, max_cg_iterations, syncs, axis)
        w_try = w + step
        f_try, g_try = value_and_grad(w_try)
        gs, s_res, ss, gg_try, bad = axis.total(
            torch.dot(g, step), torch.dot(step, residual), torch.dot(step, step), torch.dot(g_try, g_try),
            axis.nonfinite(g_try),
        )
        predicted = -0.5 * (gs - s_res)
        f_try_h, gs_h, predicted_h, step_norm, g_try_norm, finite_try = syncs.fetch(
            f_try, gs, predicted, torch.sqrt(ss), torch.sqrt(gg_try), torch.isfinite(f_try) & (bad == 0)
        )
        finite_try = bool(finite_try)
        actual = f_h - f_try_h

        # the first-ever trial shrinks the initial bound
        delta0 = min(delta, step_norm) if (it == 0 and failures == 0) else delta

        denom = f_try_h - f_h - gs_h
        if denom <= 0:
            alpha = _SIGMA3
        else:
            alpha = max(_SIGMA1, -0.5 * gs_h / denom)

        a, p = actual, predicted_h
        if a < _ETA0 * p:
            delta_new = min(max(alpha, _SIGMA1) * step_norm, _SIGMA2 * delta0)
        elif a < _ETA1 * p:
            delta_new = max(_SIGMA1 * delta0, min(alpha * step_norm, _SIGMA2 * delta0))
        elif a < _ETA2 * p:
            delta_new = max(_SIGMA1 * delta0, min(alpha * step_norm, _SIGMA3 * delta0))
        else:
            delta_new = max(delta0, min(alpha * step_norm, _SIGMA3 * delta0))

        # a non-finite trial is numerical divergence: never accept it, and
        # keep the NaN out of the trust-region radius
        accepted = (actual > _ETA0 * predicted_h) and finite_try
        if finite_try:
            delta = delta_new

        prev_f = f_h
        if accepted:
            w = project_box(w_try, box_constraints)
            f, g, f_h, g_norm = f_try, g_try, f_try_h, g_try_norm
            it += 1
            lh.append(f_h)
            gh.append(g_norm)
        else:
            failures += 1

        too_many = failures >= max_improvement_failures
        reason = check_convergence(
            it, max_iterations, f_h, prev_f, g_norm, loss_abs_tol, grad_abs_tol,
            objective_not_improving=too_many, diverged=not finite_try,
        )
        # a rejected trial alone isn't convergence; only repeated failure
        # (or divergence) is
        if not (accepted or too_many or not finite_try):
            reason = 0
        if reason != 0:
            return result(it, reason)


def _truncated_cg_batched(
    hvp: HvpFn, w: Tensor, gradient: Tensor, delta: Tensor, max_cg_iterations: int,
    syncs: SyncCounter, L: Lanes,
) -> Tuple[Tensor, Tensor]:
    """The JAX package's masked CG (``tron.py`` ``_truncated_cg``), a lane
    freezing once its step crosses the radius (backed off to the crossing),
    its residual falls under 0.1 ||g||, or it has taken the most steps.
    Returns (step, residual)."""
    tol = 0.1 * L.norm(gradient)
    r = -gradient
    step = torch.zeros_like(gradient)
    d = r
    rtr = L.dot(r, r)
    done = L.norm(r) <= tol
    sp = L.spread
    for n in range(max_cg_iterations):
        hd = hvp(w, d)
        alpha = rtr / _nonzero(L.dot(d, hd))
        step_try = step + sp(alpha) * d
        over = L.norm(step_try) > delta
        std = L.dot(step, d)
        sts = L.dot(step, step)
        dtd = L.dot(d, d)
        dsq = delta * delta
        rad = torch.sqrt(torch.clamp(std * std + dtd * (dsq - sts), min=0.0))
        alpha_b = torch.where(std >= 0, (dsq - sts) / _nonzero(std + rad), (rad - std) / _nonzero(dtd))
        alpha_eff = torch.where(over, alpha_b, alpha)
        step_new = step + sp(alpha_eff) * d
        r_new = r - sp(alpha_eff) * hd
        rtr_new = L.dot(r_new, r_new)
        d_new = r_new + sp(rtr_new / _nonzero(rtr)) * d
        converged = L.norm(r_new) <= tol
        keep = done
        step = L.where(keep, step, step_new)
        r = L.where(keep, r, r_new)
        d = L.where(keep, d, d_new)
        rtr = torch.where(keep, rtr, rtr_new)
        done = keep | over | converged | (n + 1 >= max_cg_iterations)
        (all_done,) = syncs.fetch(torch.all(done))
        if all_done:
            break
    return step, r


def _solve_batched(
    value_and_grad: ValueAndGradFn,
    hvp: HvpFn,
    w0: Tensor,
    loss_abs_tol,
    grad_abs_tol,
    max_iterations: int,
    max_cg_iterations: int,
    max_improvement_failures: int,
    box: Optional[Tuple[Tensor, Tensor]],
    syncs: SyncCounter,
    L: Lanes,
) -> SolverResult:
    """Lockstep TRON over lanes (``photon_ml_tpu/optimize/tron.py`` ``_solve``)."""
    w = w0.clone()
    f, g = value_and_grad(w)
    dtype, dev = w.dtype, w.device
    lanes = tuple(f.shape)
    loss_tol = device_put(loss_abs_tol, dev, f.dtype)
    grad_tol = device_put(grad_abs_tol, dev, g.dtype)
    T = max_iterations + 1

    # a lane corrupt at its start has no good iterate: it freezes at w0
    done = ~L.finite(f, g)
    reason = torch.where(done, int(ConvergenceReason.NUMERICAL_DIVERGENCE), 0).to(torch.int32)
    it = torch.zeros(lanes, dtype=torch.int32, device=dev)
    failures = torch.zeros_like(it)
    delta = L.norm(g)
    lh = torch.full((T,) + lanes, math.nan, dtype=f.dtype, device=dev)
    gh = torch.full((T,) + lanes, math.nan, dtype=g.dtype, device=dev)
    lh[0] = f
    gh[0] = L.norm(g)
    rows = torch.arange(T, device=dev).reshape((T,) + (1,) * len(lanes))

    (all_done,) = syncs.fetch(torch.all(done))
    while not all_done:
        step, residual = _truncated_cg_batched(hvp, w, g, delta, max_cg_iterations, syncs, L)
        w_try = w + step
        gs = L.dot(g, step)
        predicted = -0.5 * (gs - L.dot(step, residual))
        f_try, g_try = value_and_grad(w_try)
        actual = f - f_try
        step_norm = L.norm(step)

        # the first-ever trial shrinks the initial bound
        delta0 = torch.where((it == 0) & (failures == 0), torch.minimum(delta, step_norm), delta)
        denom = f_try - f - gs
        alpha = torch.where(denom <= 0, _SIGMA3, torch.clamp(-0.5 * gs / _nonzero(denom), min=_SIGMA1))
        a, p = actual, predicted
        delta_new = torch.where(
            a < _ETA0 * p,
            torch.minimum(torch.clamp(alpha, min=_SIGMA1) * step_norm, _SIGMA2 * delta0),
            torch.where(
                a < _ETA1 * p,
                torch.maximum(_SIGMA1 * delta0, torch.minimum(alpha * step_norm, _SIGMA2 * delta0)),
                torch.where(
                    a < _ETA2 * p,
                    torch.maximum(_SIGMA1 * delta0, torch.minimum(alpha * step_norm, _SIGMA3 * delta0)),
                    torch.maximum(delta0, torch.minimum(alpha * step_norm, _SIGMA3 * delta0)),
                ),
            ),
        ).to(dtype)

        # a non-finite trial is never accepted and keeps its NaN out of the
        # radius
        finite_try = L.finite(f_try, g_try)
        accepted = (actual > _ETA0 * predicted) & finite_try
        delta_new = torch.where(finite_try, delta_new, delta)
        w_new = L.where(accepted, project_box(w_try, box), w)
        f_new = torch.where(accepted, f_try, f)
        g_new = L.where(accepted, g_try, g)
        it_new = torch.where(accepted, it + 1, it)
        failures_new = torch.where(accepted, failures, failures + 1)
        g_new_norm = L.norm(g_new)

        too_many = failures_new >= max_improvement_failures
        reason_new = check_convergence(
            it_new, max_iterations, f_new, f, g_new_norm, loss_tol, grad_tol,
            objective_not_improving=too_many, diverged=~finite_try,
        )
        # a rejected trial alone isn't convergence; only repeated failure
        # (or divergence) is
        reason_new = torch.where(accepted | too_many | ~finite_try, reason_new, 0).to(torch.int32)

        keep = done
        # accepted-iteration counters differ across lanes: history rows by mask
        write = (rows == it_new) & accepted & ~keep
        lh = torch.where(write, f_new, lh)
        gh = torch.where(write, g_new_norm, gh)
        w = L.where(keep, w, w_new)
        f = torch.where(keep, f, f_new)
        g = L.where(keep, g, g_new)
        delta = torch.where(keep, delta, delta_new)
        it = torch.where(keep, it, it_new)
        failures = torch.where(keep, failures, failures_new)
        reason = torch.where(keep, reason, reason_new)
        done = keep | (reason_new != 0)
        (all_done,) = syncs.fetch(torch.all(done))
    return SolverResult(
        coefficients=w, loss=f, gradient=g, iterations=it, reason=reason,
        loss_history=lh, grad_norm_history=gh, syncs=syncs.count,
    )
