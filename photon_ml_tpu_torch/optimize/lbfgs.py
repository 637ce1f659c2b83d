"""L-BFGS with a weak-Wolfe bisection/expansion line search: one problem,
or a batch of lanes solved in lockstep.

Counterpart of the JAX package's ``optimize/lbfgs.py`` in the structure of
its host-loop twin (``optimize/host_driver.py``): the loop runs on the host,
the iterate, the gradient and the correction history stay on the device.
Constants match (c1 = 1e-4, c2 = 0.9; history guard s.y > 1e-10 ||y||^2;
steepest-descent fallback when the two-loop direction does not descend).

``batched=True`` is the JAX package's entity-minor mode: ``w`` is
``[S, E]``, every reduction runs over axis 0, and each lane has its own
``done`` flag and reason. The correction history has one circular cursor
shared by all lanes, with per-lane validity (``rho == 0`` marks a pair a
lane did not store; the gamma guard then falls back to 1). Lanes commit
with masks, so a converged or diverged lane freezes at its last iterate; a
lane whose start is already non-finite freezes at ``w0`` with
NUMERICAL_DIVERGENCE. A lane that is done before an iteration starts takes
no part in its line search (the JAX loop runs it along and discards the
result), which changes no lane's outcome and saves trials.

Syncs: one fetch at the start, then one per line-search trial. For one
problem the trial's fetch also brings the correction pair's s.y and y.y and
the trial gradient's norm; for lanes it brings two flags, "every lane's
line search is done" and "every lane would be done if the line search ended
here", so the iteration's commit costs no fetch of its own.

OWL-QN (an L1 weight), L-BFGS-B (box constraints) and batched TRON are
ROADMAP item A2 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .common import (
    ConvergenceReason,
    SolverResult,
    SyncCounter,
    ValueAndGradFn,
    check_convergence,
    finite_state,
    nan_history,
    norm,
    vdot,
)

Tensor = torch.Tensor

_C1 = 1e-4  # Armijo (sufficient decrease)
_C2 = 0.9  # curvature

NOT_PORTED = (
    "{} is not ported yet (ROADMAP A2); photon_ml_tpu_torch runs L-BFGS (single-lane "
    "or batched) and single-lane TRON"
)


class _Trial:
    """One line-search point with the host scalars fetched beside it."""

    def __init__(self, value_and_grad, w, g, direction, dg, t, syncs):
        self.w = w + float(t) * direction
        self.f, self.g = value_and_grad(self.w)
        s_vec = self.w - w
        y_vec = self.g - g
        (self.f_h, self.gd_h, finite, self.dg_h, self.sy_h, self.yy_h,
         self.g_norm_h) = syncs.fetch(
            self.f, torch.dot(self.g, direction), finite_state(self.f, self.g), dg,
            torch.dot(s_vec, y_vec), torch.dot(y_vec, y_vec), norm(self.g),
        )
        self.finite = bool(finite)
        self.s_vec, self.y_vec = s_vec, y_vec


def _two_loop(pairs: List[Tuple[Tensor, Tensor, np.generic, np.generic]], g: Tensor) -> Tensor:
    """Two-loop recursion over the (s, y, rho, gamma) history, oldest to
    newest: newest-first pass 1, oldest-first pass 2, gamma from the newest
    pair (1 without history)."""
    q = g.clone()
    alphas = []
    for s, y, rho, _ in reversed(pairs):
        a = float(rho) * torch.dot(s, q)
        alphas.append(a)
        q = q - a * y
    gamma = pairs[-1][3] if pairs else 1.0
    r = float(gamma) * q
    for (s, y, rho, _), a in zip(pairs, reversed(alphas)):
        b = float(rho) * torch.dot(y, r)
        r = r + (a - b) * s
    return r


def _line_search(value_and_grad, w, f_h, g, direction, dg, max_iters, syncs) -> Tuple[_Trial, bool]:
    f32 = type(f_h)  # the solver's dtype, as the on-device reference rounds
    t, lo, hi = f32(1.0), f32(0.0), f32(math.inf)
    trial = _Trial(value_and_grad, w, g, direction, dg, t, syncs)
    dg_h = trial.dg_h
    for n in range(max_iters):
        finite = math.isfinite(trial.f_h)
        armijo_ok = trial.f_h <= f_h + _C1 * t * dg_h
        curv_ok = trial.gd_h >= _C2 * dg_h
        if armijo_ok and curv_ok and finite:
            return trial, True
        if n + 1 >= max_iters:
            break
        if armijo_ok and finite:
            # Armijo held but curvature failed: raise the lower bracket
            lo = t
            t = 2.0 * lo + 1.0 if math.isinf(hi) else 0.5 * (lo + hi)
        else:
            # Armijo failed (or non-finite): bisect downward
            hi = t
            t = 0.5 * (lo + t)
        trial = _Trial(value_and_grad, w, g, direction, dg, t, syncs)
    return trial, False


def solve_lbfgs(
    value_and_grad: ValueAndGradFn,
    w0: Tensor,
    loss_abs_tol,
    grad_abs_tol,
    max_iterations: int = 100,
    num_corrections: int = 10,
    l1_weight: float = 0.0,
    box_constraints: Optional[Tuple[Tensor, Tensor]] = None,
    max_line_search_iterations: int = 25,
    syncs: Optional[SyncCounter] = None,
    batched: bool = False,
) -> SolverResult:
    """Minimize f(w) from ``w0``. ``batched=True`` solves an entity-minor
    stack of independent problems in lockstep: ``w0`` is ``[S, E]``,
    ``value_and_grad`` maps ``[S, E] -> ([E], [S, E])``, and the absolute
    tolerances are per-lane ``[E]`` tensors (or scalars)."""
    if l1_weight > 0.0:
        raise NotImplementedError(NOT_PORTED.format("OWL-QN (L1 regularization)"))
    if box_constraints is not None:
        raise NotImplementedError(NOT_PORTED.format("L-BFGS-B (box constraints)"))
    syncs = syncs or SyncCounter()
    if batched:
        if w0.dim() != 2:
            raise ValueError(f"batched L-BFGS takes w0 of shape [S, E], got {tuple(w0.shape)}")
        return _solve_batched(
            value_and_grad, w0, loss_abs_tol, grad_abs_tol, max_iterations,
            num_corrections, max_line_search_iterations, syncs,
        )
    if w0.dim() != 1:
        raise ValueError(f"single-lane L-BFGS takes a 1-D w0 (batched=True for lanes), got {tuple(w0.shape)}")
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

    pairs: List[Tuple[Tensor, Tensor, np.generic, np.generic]] = []
    it = 0
    while True:
        direction = -_two_loop(pairs, g)
        dg = torch.dot(direction, g)
        # not a descent direction: steepest-descent fallback, decided on the
        # device so that it costs no fetch
        bad = dg >= 0
        direction = torch.where(bad, -g, direction)
        dg = torch.where(bad, -torch.dot(g, g), dg)

        trial, ls_ok = _line_search(
            value_and_grad, w, f_h, g, direction, dg, max_line_search_iterations, syncs
        )
        improved = ls_ok and (trial.f_h < f_h) and trial.finite

        sy, yy = trial.sy_h, trial.yy_h
        if improved and sy > 1e-10 * yy:
            pairs.append((trial.s_vec, trial.y_vec, 1.0 / sy, sy / yy if yy > 0 else f_h.dtype.type(1.0)))
            if len(pairs) > num_corrections:
                pairs.pop(0)

        it += 1
        reason = check_convergence(
            it, max_iterations, trial.f_h, f_h, trial.g_norm_h, loss_abs_tol,
            grad_abs_tol, objective_not_improving=not improved,
            diverged=not trial.finite,
        )
        if improved:
            w, f, g, f_h, g_norm = trial.w, trial.f, trial.g, trial.f_h, trial.g_norm_h
        lh.append(f_h)
        gh.append(g_norm)
        if reason != 0:
            return result(it, reason)


def _two_loop_batched(S: Tensor, Y: Tensor, rho: Tensor, count: int, head: int, g: Tensor) -> Tensor:
    """Two-loop recursion over the shared circular history ``S, Y [m, S, E]``,
    ``rho [m, E]``: ``count`` valid slots, the newest at ``head - 1``. A slot
    a lane did not store holds zeros and rho 0, so it adds exactly nothing
    (the JAX package's masked scan adds 0 * 0 there); gamma comes from the
    newest slot, 1 where it is empty."""
    m = S.shape[0]
    newest_first = [(head - 1 - i) % m for i in range(count)]
    q = g
    alphas = []
    for j in newest_first:
        a = rho[j] * vdot(S[j], q)
        alphas.append(a)
        q = q - a * Y[j]
    one = torch.ones((), dtype=g.dtype, device=g.device)
    if count > 0:
        j0 = newest_first[0]
        ys, yy = vdot(S[j0], Y[j0]), vdot(Y[j0], Y[j0])
        gamma = torch.where(yy > 0, ys / torch.where(yy > 0, yy, one), one)
    else:
        gamma = one
    r = gamma * q
    for j, a in zip(reversed(newest_first), reversed(alphas)):
        b = rho[j] * vdot(Y[j], r)
        r = r + (a - b) * S[j]
    return r


def _solve_batched(
    value_and_grad: ValueAndGradFn,
    w0: Tensor,
    loss_abs_tol,
    grad_abs_tol,
    max_iterations: int,
    m: int,
    max_ls: int,
    syncs: SyncCounter,
) -> SolverResult:
    """Entity-minor lockstep L-BFGS (``photon_ml_tpu/optimize/lbfgs.py``
    ``_solve`` with ``batched=True``), looped on the host."""
    w = w0.clone()
    f, g = value_and_grad(w)
    # the values may be wider than the iterate (a float64 sum of float32
    # terms): step sizes and history follow the iterate's dtype
    dtype, dev = w.dtype, w.device
    lanes = tuple(f.shape)
    loss_tol = torch.as_tensor(loss_abs_tol, dtype=f.dtype, device=dev)
    grad_tol = torch.as_tensor(grad_abs_tol, dtype=g.dtype, device=dev)
    T = max_iterations + 1

    done = ~finite_state(f, g)
    reason = torch.where(done, int(ConvergenceReason.NUMERICAL_DIVERGENCE), 0).to(torch.int32)
    it = torch.zeros(lanes, dtype=torch.int32, device=dev)
    S = torch.zeros((m,) + tuple(w.shape), dtype=dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m,) + lanes, dtype=dtype, device=dev)
    count = head = 0
    lh = torch.full((T,) + lanes, math.nan, dtype=f.dtype, device=dev)
    gh = torch.full((T,) + lanes, math.nan, dtype=g.dtype, device=dev)
    lh[0] = f
    gh[0] = norm(g)

    def result() -> SolverResult:
        return SolverResult(
            coefficients=w, loss=f, gradient=g, iterations=it, reason=reason,
            loss_history=lh, grad_norm_history=gh, syncs=syncs.count,
        )

    (all_done,) = syncs.fetch(torch.all(done))
    k = 0
    while not all_done:
        direction = -_two_loop_batched(S, Y, rho, count, head, g)
        dg = vdot(direction, g)
        # not a descent direction: steepest-descent fallback
        bad = dg >= 0
        direction = torch.where(bad, -g, direction)
        dg = torch.where(bad, -vdot(g, g), dg)

        # line search from t = 1; lanes already done sit it out
        t = torch.ones(lanes, dtype=dtype, device=dev)
        lo = torch.zeros_like(t)
        hi = torch.full_like(t, math.inf)
        w_t = w + t * direction
        f_t, g_t = value_and_grad(w_t)
        ls_done = done.clone()
        success = torch.zeros_like(done)
        n = 0
        while True:
            finite_t = torch.isfinite(f_t)
            armijo_ok = f_t <= f + _C1 * t * dg
            curv_ok = vdot(g_t, direction) >= _C2 * dg
            accept = armijo_ok & curv_ok & finite_t
            success = success | (accept & ~ls_done)
            ls_done = ls_done | accept | (n + 1 >= max_ls)
            # what the commit would make of this trial, should it be the last
            finite_new = finite_state(f_t, g_t)
            improved = success & (f_t < f) & finite_new
            reason_new = check_convergence(
                it + 1, max_iterations, f_t, f, norm(g_t), loss_tol, grad_tol,
                objective_not_improving=~improved, diverged=~finite_new,
            )
            ls_all, all_done = syncs.fetch(torch.all(ls_done), torch.all(done | (reason_new != 0)))
            if ls_all:
                break
            # bracket update (Armijo held: raise lo, expand or bisect;
            # failed or non-finite: bisect downward)
            ok = armijo_ok & finite_t
            new_hi = torch.where(ok, hi, t)
            new_lo = torch.where(ok & ~curv_ok, t, lo)
            new_t = torch.where(torch.isinf(new_hi), 2.0 * new_lo + 1.0, 0.5 * (new_lo + new_hi))
            new_t = torch.where(ok, new_t, 0.5 * (lo + t))
            w_n = w + new_t * direction
            f_n, g_n = value_and_grad(w_n)
            # lanes done keep their trial
            t = torch.where(ls_done, t, new_t)
            lo = torch.where(ls_done, lo, new_lo)
            hi = torch.where(ls_done, hi, new_hi)
            f_t = torch.where(ls_done, f_t, f_n)
            g_t = torch.where(ls_done, g_t, g_n)
            w_t = torch.where(ls_done, w_t, w_n)
            n += 1

        # history: every iteration writes the shared slot; a lane that must
        # not store writes an invalid (zero, rho = 0) pair
        s_vec = w_t - w
        y_vec = g_t - g
        sy = vdot(s_vec, y_vec)
        store = improved & (sy > 1e-10 * norm(y_vec) ** 2)
        S[head] = torch.where(store, s_vec, 0.0)
        Y[head] = torch.where(store, y_vec, 0.0)
        rho[head] = torch.where(store, 1.0 / torch.where(sy != 0, sy, 1.0), 0.0)
        head = (head + 1) % m
        count = min(count + 1, m)

        # masked commit: lanes done before this iteration keep their state
        keep = done
        w = torch.where(keep, w, torch.where(improved, w_t, w))
        f = torch.where(keep, f, torch.where(improved, f_t, f))
        g = torch.where(keep, g, torch.where(improved, g_t, g))
        it = torch.where(keep, it, it + 1)
        reason = torch.where(keep, reason, reason_new)
        done = keep | (reason_new != 0)
        # history rows at the global counter: active lanes all sit at it == k
        k += 1
        lh[k] = torch.where(keep, lh[k], f)
        gh[k] = torch.where(keep, gh[k], norm(g))
    return result()
