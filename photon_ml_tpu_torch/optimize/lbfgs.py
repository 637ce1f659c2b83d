"""L-BFGS, OWL-QN and L-BFGS-B with a bisection/expansion line search: one
problem, or a batch of lanes solved in lockstep.

Counterpart of the JAX package's ``optimize/lbfgs.py`` in the structure of
its host-loop twin (``optimize/host_driver.py``): the loop runs on the host,
the iterate, the gradient and the correction history stay on the device.
Constants match (c1 = 1e-4, c2 = 0.9; history guard s.y > 1e-10 ||y||^2;
steepest-descent fallback when the two-loop direction does not descend).

- OWL-QN (``l1_weight`` > 0): the objective carries ``l1 * ||w||_1``; the
  pseudo-gradient drives the two-loop direction, which is projected into
  the orthant of ``-pg``; every trial point is projected onto the orthant
  of the iterate (``sign(w)``, or ``-sign(pg)`` at zero), the line search
  asks Armijo only, and convergence reads the pseudo-gradient's norm. The
  correction pairs use the plain gradient.
- L-BFGS-B (``box_constraints``, one problem only): the start is clamped
  into the box; the projected gradient ``w - P(w - g)`` drives the
  direction and the convergence test; every trial point is projected onto
  the box and Armijo is measured on the actual displacement,
  ``f_t <= f + c1 g.(w_t - w)``, with no curvature condition.

``batched=True`` is the JAX package's entity-minor mode: ``w`` is
``[S, E]``, every reduction runs over axis 0, and each lane has its own
``done`` flag and reason. The correction history has one circular cursor
shared by all lanes, with per-lane validity (``rho == 0`` marks a pair a
lane did not store; the gamma guard then falls back to 1). Lanes commit
with masks, so a converged or diverged lane freezes at its last iterate; a
lane whose start is already non-finite freezes at ``w0`` with
NUMERICAL_DIVERGENCE. A lane that is done before an iteration starts takes
no part in its line search (the JAX loop runs it along and discards the
result), which changes no lane's outcome and saves trials. Both variants
run there: OWL-QN, and L-BFGS-B with a box broadcastable to ``w``.

``batched=True, entity_leading=True`` is the JAX package's vmapped
per-entity solve (``jax.vmap`` of the one-problem mode): ``w`` is
``[E, S]``, the reductions run over the last axis, and each lane keeps its
own history cursor, advanced only when that lane stores a pair, as the
one-problem mode does. Every lane runs the same operations whatever its
neighbours do, so an entity's result does not depend on the other lanes of
its stack.

Syncs: one fetch at the start, then one per line-search trial. For one
problem the trial's fetch also brings the correction pair's s.y and y.y and
the trial's (pseudo- or projected) gradient norm; for lanes it brings two
flags, "every lane's line search is done" and "every lane would be done if
the line search ended here", so the iteration's commit costs no fetch of
its own.

``SolverResult.gradient`` is the gradient that the convergence test reads:
the plain gradient, OWL-QN's pseudo-gradient or L-BFGS-B's projected one.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
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
    SolverResult,
    SyncCounter,
    ValueAndGradFn,
    check_convergence,
    nan_history,
    project_box,
)

Tensor = torch.Tensor

_C1 = 1e-4  # Armijo (sufficient decrease)
_C2 = 0.9  # curvature

def _pseudo_gradient(w: Tensor, g: Tensor, l1: float) -> Tensor:
    """OWL-QN pseudo-gradient of f(w) + l1*||w||_1."""
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gp = g + l1
    gm = g - l1
    pg = torch.where(w > 0, gp, torch.where(w < 0, gm, zero))
    at_zero = torch.where(gm > 0, gm, torch.where(gp < 0, gp, zero))
    return torch.where(w == 0, at_zero, pg)


class _Variant:
    """What OWL-QN (``l1``) and L-BFGS-B (``box``) change in the plain
    L-BFGS iteration; with neither it is plain L-BFGS. Every reduction over
    one problem's coefficients goes through ``axis`` (``optimize.common``:
    ``LOCAL``, or a model-sharded slice's ``ModelAxis``); a stack of lanes
    reduces through its ``Lanes``."""

    def __init__(
        self,
        value_and_grad: ValueAndGradFn,
        l1: float,
        box: Optional[Tuple[Tensor, Tensor]],
        lanes: Optional[Lanes] = None,
        axis: CoefficientAxis = LOCAL,
    ):
        self.value_and_grad, self.l1, self.box = value_and_grad, l1, box
        # the curvature condition holds only for the smooth, unconstrained problem
        self.wolfe = l1 == 0.0 and box is None
        # None: one problem (1-D w)
        self.lanes = lanes
        self.axis = axis
        self.dot = axis.dot if lanes is None else lanes.dot
        self.spread = (lambda x: x) if lanes is None else lanes.spread  # noqa: E731

    def objective(self, w: Tensor) -> Tuple[Tensor, Tensor]:
        """(f(w) + l1 ||w||_1, the smooth part's gradient)."""
        f, g = self.value_and_grad(w)
        if self.l1 > 0.0:
            if self.lanes is None:
                (l1_norm,) = self.axis.total(MINOR.sum(torch.abs(w).to(f.dtype)))
            else:
                l1_norm = self.lanes.sum(torch.abs(w).to(f.dtype))
            f = f + self.l1 * l1_norm
        return f, g

    def effective_grad(self, w: Tensor, g: Tensor) -> Tensor:
        if self.l1 > 0.0:
            return _pseudo_gradient(w, g, self.l1)
        if self.box is not None:
            # zero at bound-held coordinates: the direction and the
            # convergence test respect the active set
            return w - project_box(w - g, self.box)
        return g

    def direction(self, raw: Tensor, pg: Tensor) -> Tuple[Tensor, Tensor]:
        """The search direction from the two-loop result ``raw`` (projected
        into the orthant of ``-pg`` for OWL-QN) and its slope along ``pg``;
        steepest descent where it does not descend, decided on the device
        so that it costs no fetch."""
        direction = -raw
        if self.l1 > 0.0:
            direction = torch.where(direction * pg >= 0, torch.zeros_like(direction), direction)
        if self.lanes is None:
            dg, pgpg = self.axis.total(torch.dot(direction, pg), torch.dot(pg, pg))
        else:
            dg, pgpg = self.dot(direction, pg), self.dot(pg, pg)
        bad = dg >= 0
        return torch.where(self.spread(bad), -pg, direction), torch.where(bad, -pgpg, dg)

    def orthant(self, w: Tensor, pg: Tensor) -> Optional[Tensor]:
        if self.l1 == 0.0:
            return None
        return torch.where(w != 0, torch.sign(w), -torch.sign(pg))

    def point(self, w: Tensor, t, direction: Tensor, orthant: Optional[Tensor]) -> Tensor:
        """The trial point ``w + t d``, projected onto the orthant and the box
        (``t`` a host scalar, or one step per lane)."""
        if isinstance(t, Tensor):
            t = self.spread(t)
        w_t = w + t * direction
        if orthant is not None:
            w_t = torch.where(w_t * orthant < 0, torch.zeros_like(w_t), w_t)
        return project_box(w_t, self.box)


class _Trial:
    """One line-search point with the host scalars fetched beside it (its
    five coefficient reductions and the finite check in one ``total``)."""

    def __init__(self, var: _Variant, w, g, direction, dg, orthant, t, syncs):
        self.w = var.point(w, float(t), direction, orthant)
        self.f, self.g = var.objective(self.w)
        self.pg = var.effective_grad(self.w, self.g)
        s_vec = self.w - w
        y_vec = self.g - g
        gd, sy, yy, pgpg, gs, bad = var.axis.total(
            torch.dot(self.g, direction), torch.dot(s_vec, y_vec), torch.dot(y_vec, y_vec),
            torch.dot(self.pg, self.pg), torch.dot(g, s_vec), var.axis.nonfinite(self.g),
        )
        (self.f_h, self.gd_h, finite, self.dg_h, self.sy_h, self.yy_h,
         self.g_norm_h, self.gs_h) = syncs.fetch(
            self.f, gd, torch.isfinite(self.f) & (bad == 0), dg, sy, yy, torch.sqrt(pgpg), gs,
        )
        self.finite = bool(finite)
        self.s_vec, self.y_vec = s_vec, y_vec


def _two_loop(
    pairs: List[Tuple[Tensor, Tensor, np.generic, np.generic]], g: Tensor, axis: CoefficientAxis = LOCAL
) -> Tensor:
    """Two-loop recursion over the (s, y, rho, gamma) history, oldest to
    newest: newest-first pass 1, oldest-first pass 2, gamma from the newest
    pair (1 without history). Each dot depends on the one before it: one
    ``axis`` total each."""
    q = g.clone()
    alphas = []
    for s, y, rho, _ in reversed(pairs):
        a = float(rho) * axis.dot(s, q)
        alphas.append(a)
        q = q - a * y
    gamma = pairs[-1][3] if pairs else 1.0
    r = float(gamma) * q
    for (s, y, rho, _), a in zip(pairs, reversed(alphas)):
        b = float(rho) * axis.dot(y, r)
        r = r + (a - b) * s
    return r


def _line_search(var: _Variant, w, f_h, g, direction, dg, orthant, max_iters, syncs) -> Tuple[_Trial, bool]:
    f32 = type(f_h)  # the solver's dtype, as the on-device reference rounds
    t, lo, hi = f32(1.0), f32(0.0), f32(math.inf)
    trial = _Trial(var, w, g, direction, dg, orthant, t, syncs)
    dg_h = trial.dg_h
    for n in range(max_iters):
        finite = math.isfinite(trial.f_h)
        if var.box is not None:
            # Armijo on the actual (projected) displacement
            armijo_ok = trial.f_h <= f_h + _C1 * trial.gs_h
        else:
            armijo_ok = trial.f_h <= f_h + _C1 * t * dg_h
        curv_ok = trial.gd_h >= _C2 * dg_h if var.wolfe else True
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
        trial = _Trial(var, w, g, direction, dg, orthant, t, syncs)
    return trial, False


def _recorded(result: SolverResult) -> SolverResult:
    """A one-problem solve's result, recorded in the obs registry when a
    sink listens (``obs.record_solver_metrics``)."""
    obs.record_solver_metrics("lbfgs", result)
    return result


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
    entity_leading: bool = False,
    axis: CoefficientAxis = LOCAL,
) -> SolverResult:
    """Minimize f(w) (+ ``l1_weight * ||w||_1``, OWL-QN; within
    ``box_constraints``, L-BFGS-B) from ``w0``. ``batched=True`` solves an
    entity-minor stack of independent problems in lockstep: ``w0`` is
    ``[S, E]``, ``value_and_grad`` maps ``[S, E] -> ([E], [S, E])``, and the
    absolute tolerances are per-lane ``[E]`` tensors (or scalars). With
    ``entity_leading=True`` as well the stack is ``[E, S]``, each lane with
    its own history cursor (the JAX package's vmapped solve). ``axis``:
    where one problem's coefficients lie (``optimize.common``)."""
    syncs = syncs or SyncCounter()
    if batched:
        if w0.dim() != 2:
            raise ValueError(f"batched L-BFGS takes w0 of shape [S, E] (or [E, S]), got {tuple(w0.shape)}")
        lanes = LEADING if entity_leading else MINOR
        var = _Variant(value_and_grad, float(l1_weight), box_constraints, lanes)
        return _solve_batched(
            var, w0, loss_abs_tol, grad_abs_tol, max_iterations,
            num_corrections, max_line_search_iterations, syncs,
        )
    var = _Variant(value_and_grad, float(l1_weight), box_constraints, axis=axis)
    if w0.dim() != 1:
        raise ValueError(f"single-lane L-BFGS takes a 1-D w0 (batched=True for lanes), got {tuple(w0.shape)}")
    w = project_box(w0, box_constraints).clone()  # start feasible
    f, g = var.objective(w)
    pg = var.effective_grad(w, g)
    pgpg, bad = axis.total(torch.dot(pg, pg), axis.nonfinite(g))
    f_h, g_norm, ok = syncs.fetch(f, torch.sqrt(pgpg), torch.isfinite(f) & (bad == 0))
    lh, gh = [f_h], [g_norm]

    def result(it: int, reason: int) -> SolverResult:
        T = max_iterations + 1
        return _recorded(SolverResult(
            coefficients=w,
            loss=f,
            gradient=pg,
            iterations=it,
            reason=reason,
            loss_history=nan_history(lh, T, w),
            grad_norm_history=nan_history(gh, T, w),
            syncs=syncs.count,
        ))

    if not ok:
        # corrupt at start: no good iterate to roll back to
        return result(0, int(ConvergenceReason.NUMERICAL_DIVERGENCE))

    pairs: List[Tuple[Tensor, Tensor, np.generic, np.generic]] = []
    it = 0
    while True:
        direction, dg = var.direction(_two_loop(pairs, pg, axis), pg)
        trial, ls_ok = _line_search(
            var, w, f_h, g, direction, dg, var.orthant(w, pg), max_line_search_iterations, syncs
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
            w, f, g, pg, f_h, g_norm = trial.w, trial.f, trial.g, trial.pg, trial.f_h, trial.g_norm_h
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
        a = rho[j] * MINOR.dot(S[j], q)
        alphas.append(a)
        q = q - a * Y[j]
    one = torch.ones((), dtype=g.dtype, device=g.device)
    if count > 0:
        j0 = newest_first[0]
        ys, yy = MINOR.dot(S[j0], Y[j0]), MINOR.dot(Y[j0], Y[j0])
        gamma = torch.where(yy > 0, ys / torch.where(yy > 0, yy, one), one)
    else:
        gamma = one
    r = gamma * q
    for j, a in zip(reversed(newest_first), reversed(alphas)):
        b = rho[j] * MINOR.dot(Y[j], r)
        r = r + (a - b) * S[j]
    return r


def _two_loop_lanes(S: Tensor, Y: Tensor, rho: Tensor, count: Tensor, head: Tensor, g: Tensor) -> Tensor:
    """Two-loop recursion over per-lane circular histories ``S, Y [m, E, S]``,
    ``rho [m, E]``, each lane with its own ``count`` and ``head`` ``[E]``:
    the one-problem recursion of the JAX package (``fori_loop`` over all m
    slots, a slot past a lane's count adding a masked zero), lane by lane."""
    m, E = S.shape[0], S.shape[1]
    lanes = torch.arange(E, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    one = torch.ones((), dtype=g.dtype, device=g.device)

    def slot(i: int):
        j = torch.remainder(head - 1 - i, m)
        return S[j, lanes], Y[j, lanes], rho[j, lanes], i < count

    q = g
    alphas = []
    for i in range(m):
        s_j, y_j, rho_j, valid = slot(i)
        a = torch.where(valid, rho_j * LEADING.dot(s_j, q), zero)
        alphas.append(a)
        q = q - LEADING.spread(torch.where(valid, a, zero)) * y_j
    s_n, y_n, _, _ = slot(0)
    ys, yy = LEADING.dot(s_n, y_n), LEADING.dot(y_n, y_n)
    gamma = torch.where((count > 0) & (yy > 0), ys / torch.where(yy > 0, yy, one), one)
    r = LEADING.spread(gamma) * q
    for i in reversed(range(m)):
        s_j, y_j, rho_j, valid = slot(i)
        b = torch.where(valid, rho_j * LEADING.dot(y_j, r), zero)
        r = r + LEADING.spread(torch.where(valid, alphas[i] - b, zero)) * s_j
    return r


def _solve_batched(
    var: _Variant,
    w0: Tensor,
    loss_abs_tol,
    grad_abs_tol,
    max_iterations: int,
    m: int,
    max_ls: int,
    syncs: SyncCounter,
) -> SolverResult:
    """Lockstep L-BFGS / OWL-QN / L-BFGS-B over lanes, looped on the host:
    entity-minor (``photon_ml_tpu/optimize/lbfgs.py`` ``_solve`` with
    ``batched=True``) or entity-leading with per-lane cursors (``jax.vmap``
    of ``_solve``)."""
    L = var.lanes
    per_lane = L is LEADING
    w = project_box(w0, var.box).clone()  # start feasible
    f, g = var.objective(w)
    # the values may be wider than the iterate (a float64 sum of float32
    # terms): step sizes and history follow the iterate's dtype
    dtype, dev = w.dtype, w.device
    lanes = tuple(f.shape)
    loss_tol = device_put(loss_abs_tol, dev, f.dtype)
    grad_tol = device_put(grad_abs_tol, dev, g.dtype)
    T = max_iterations + 1

    done = ~L.finite(f, g)
    reason = torch.where(done, int(ConvergenceReason.NUMERICAL_DIVERGENCE), 0).to(torch.int32)
    it = torch.zeros(lanes, dtype=torch.int32, device=dev)
    S = torch.zeros((m,) + tuple(w.shape), dtype=dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m,) + lanes, dtype=dtype, device=dev)
    if per_lane:
        count = torch.zeros(lanes, dtype=torch.int64, device=dev)
        head = torch.zeros_like(count)
        lane_ids = torch.arange(lanes[0], device=dev)
    else:
        count = head = 0
    lh = torch.full((T,) + lanes, math.nan, dtype=f.dtype, device=dev)
    gh = torch.full((T,) + lanes, math.nan, dtype=g.dtype, device=dev)
    lh[0] = f
    gh[0] = L.norm(var.effective_grad(w, g))

    def result() -> SolverResult:
        return SolverResult(
            coefficients=w, loss=f, gradient=var.effective_grad(w, g), iterations=it, reason=reason,
            loss_history=lh, grad_norm_history=gh, syncs=syncs.count,
        )

    (all_done,) = syncs.fetch(torch.all(done))
    k = 0
    while not all_done:
        pg = var.effective_grad(w, g)
        if per_lane:
            raw = _two_loop_lanes(S, Y, rho, count, head, pg)
        else:
            raw = _two_loop_batched(S, Y, rho, count, head, pg)
        direction, dg = var.direction(raw, pg)
        orthant = var.orthant(w, pg)

        # line search from t = 1; lanes already done sit it out
        t = torch.ones(lanes, dtype=dtype, device=dev)
        lo = torch.zeros_like(t)
        hi = torch.full_like(t, math.inf)
        w_t = var.point(w, t, direction, orthant)
        f_t, g_t = var.objective(w_t)
        ls_done = done.clone()
        success = torch.zeros_like(done)
        n = 0
        while True:
            finite_t = torch.isfinite(f_t)
            if var.box is not None:
                # Armijo on the actual (projected) displacement
                armijo_ok = f_t <= f + _C1 * L.dot(g, w_t - w)
            else:
                armijo_ok = f_t <= f + _C1 * t * dg
            if var.wolfe:
                curv_ok = L.dot(g_t, direction) >= _C2 * dg
            else:
                curv_ok = torch.ones_like(done)
            accept = armijo_ok & curv_ok & finite_t
            success = success | (accept & ~ls_done)
            ls_done = ls_done | accept | (n + 1 >= max_ls)
            # what the commit would make of this trial, should it be the last
            finite_new = L.finite(f_t, g_t)
            improved = success & (f_t < f) & finite_new
            reason_new = check_convergence(
                it + 1, max_iterations, f_t, f, L.norm(var.effective_grad(w_t, g_t)), loss_tol, grad_tol,
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
            w_n = var.point(w, new_t, direction, orthant)
            f_n, g_n = var.objective(w_n)
            # lanes done keep their trial
            t = torch.where(ls_done, t, new_t)
            lo = torch.where(ls_done, lo, new_lo)
            hi = torch.where(ls_done, hi, new_hi)
            f_t = torch.where(ls_done, f_t, f_n)
            g_t = L.where(ls_done, g_t, g_n)
            w_t = L.where(ls_done, w_t, w_n)
            n += 1

        s_vec = w_t - w
        y_vec = g_t - g
        sy = L.dot(s_vec, y_vec)
        store = improved & (sy > 1e-10 * L.norm(y_vec) ** 2)
        inv_sy = 1.0 / torch.where(sy != 0, sy, 1.0)
        keep = done
        if per_lane:
            # each lane writes its own slot, and only when it stores a pair
            write = store & ~keep
            S[head, lane_ids] = L.where(write, s_vec, S[head, lane_ids])
            Y[head, lane_ids] = L.where(write, y_vec, Y[head, lane_ids])
            rho[head, lane_ids] = torch.where(write, inv_sy, rho[head, lane_ids])
            head = torch.where(write, torch.remainder(head + 1, m), head)
            count = torch.where(write, torch.clamp(count + 1, max=m), count)
        else:
            # every iteration writes the shared slot; a lane that must not
            # store writes an invalid (zero, rho = 0) pair
            S[head] = torch.where(store, s_vec, 0.0)
            Y[head] = torch.where(store, y_vec, 0.0)
            rho[head] = torch.where(store, inv_sy, 0.0)
            head = (head + 1) % m
            count = min(count + 1, m)

        # masked commit: lanes done before this iteration keep their state
        w = L.where(keep, w, L.where(improved, w_t, w))
        f = torch.where(keep, f, torch.where(improved, f_t, f))
        g = L.where(keep, g, L.where(improved, g_t, g))
        it = torch.where(keep, it, it + 1)
        reason = torch.where(keep, reason, reason_new)
        done = keep | (reason_new != 0)
        # history rows at the global counter: active lanes all sit at it == k
        k += 1
        lh[k] = torch.where(keep, lh[k], f)
        gh[k] = torch.where(keep, gh[k], L.norm(var.effective_grad(w, g)))
    return result()
