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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import (
    ConvergenceReason,
    HvpFn,
    SolverResult,
    SyncCounter,
    ValueAndGradFn,
    check_convergence,
    finite_state,
    nan_history,
    norm,
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
) -> Tuple[Tensor, Tensor, int]:
    """Approximately solve H step = -gradient within ||step|| <= delta.
    Returns (step, residual, cg_iterations); the residual r = -g - H step
    feeds the predicted reduction."""
    tol = 0.1 * grad_norm
    step = torch.zeros_like(gradient)
    r = -gradient
    d = r.clone()
    rtr = torch.dot(r, r)
    if grad_norm <= tol:
        return step, r, 0
    it = 0
    while it < max_cg_iterations:
        hd = hvp(w, d)
        alpha = rtr / _nonzero(torch.dot(d, hd))
        step_try = step + alpha * d
        r_new = r - alpha * hd
        rtr_new = torch.dot(r_new, r_new)
        step_norm, r_norm = syncs.fetch(norm(step_try), torch.sqrt(rtr_new))
        if step_norm > delta:
            # hit the trust-region boundary: back off to the crossing
            std = torch.dot(step, d)
            sts = torch.dot(step, step)
            dtd = torch.dot(d, d)
            delta_t = torch.as_tensor(delta, dtype=gradient.dtype, device=gradient.device)
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
) -> SolverResult:
    if w0.dim() != 1:
        raise NotImplementedError(
            "batched (lane-stacked) TRON is not ported yet (ROADMAP A2); "
            "photon_ml_tpu_torch runs single-lane TRON"
        )
    syncs = syncs or SyncCounter()
    w = w0.clone()
    f, g = value_and_grad(w)
    f_h, g_norm, ok = syncs.fetch(f, norm(g), finite_state(f, g))
    lh, gh = [f_h], [g_norm]

    def result(it: int, reason: int) -> SolverResult:
        T = max_iterations + 1
        return SolverResult(
            coefficients=w,
            loss=f,
            gradient=g,
            iterations=it,
            reason=reason,
            loss_history=nan_history(lh, T, w),
            grad_norm_history=nan_history(gh, T, w),
            syncs=syncs.count,
        )

    if not ok:
        # corrupt at start: no good iterate to roll back to
        return result(0, int(ConvergenceReason.NUMERICAL_DIVERGENCE))

    delta = g_norm
    it = 0
    failures = 0
    while True:
        step, residual, _ = _truncated_cg(hvp, w, g, g_norm, delta, max_cg_iterations, syncs)
        w_try = w + step
        gs = torch.dot(g, step)
        predicted = -0.5 * (gs - torch.dot(step, residual))
        f_try, g_try = value_and_grad(w_try)
        f_try_h, gs_h, predicted_h, step_norm, g_try_norm, finite_try = syncs.fetch(
            f_try, gs, predicted, norm(step), norm(g_try), finite_state(f_try, g_try)
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
