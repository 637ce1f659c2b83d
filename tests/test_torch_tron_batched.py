"""Parity of the port's batched TRON and batched L-BFGS-B with the JAX
package's lane-generic solvers, on the CPU.

Both packages solve the same per-lane problems, made from a seed with
numpy. Entity-minor stacks ``[S, E]`` go through the JAX package's
``solve_tron`` / ``solve_lbfgs(batched=True, box_constraints=...)`` as they
are; entity-leading stacks ``[E, S]`` (the port's ``entity_leading=True``)
are held against ``jax.vmap`` of the one-problem solve, which is what they
port. In float64 the two packages take the same steps, so coefficients are
held at rtol 1e-6 and every lane's iteration count and reason exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.optimize import common as jax_common
from photon_ml_tpu.optimize.lbfgs import solve_lbfgs as jax_solve_lbfgs
from photon_ml_tpu.optimize.tron import solve_tron as jax_solve_tron
from photon_ml_tpu_torch.optimize import ConvergenceReason, SyncCounter
from photon_ml_tpu_torch.optimize import common
from photon_ml_tpu_torch.optimize.lbfgs import solve_lbfgs
from photon_ml_tpu_torch.optimize.tron import solve_tron


def _logistic_lanes(seed, E=23, K=14, S=6, l2=0.3):
    """Per-lane logistic problems: F [K, S, E], labels and weights [K, E]
    (the last rows of each lane zero-weight padding)."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(K, S, E))
    w_true = rng.normal(size=(S, E))
    z = np.einsum("kse,se->ke", F, w_true)
    y = (rng.uniform(size=(K, E)) < 1 / (1 + np.exp(-z))).astype(np.float64)
    wt = np.ones((K, E))
    wt[K - 3:] = 0.0
    return F, y, wt, l2


def _minor_fns(xp, F, y, wt, l2):
    """value_and_grad and hvp over an entity-minor [S, E] stack."""
    if xp is torch:
        F, y, wt = (torch.as_tensor(a) for a in (F, y, wt))
        s, sig, sp = torch.sum, torch.sigmoid, torch.nn.functional.softplus
        kw = lambda ax: {"dim": ax}  # noqa: E731
    else:
        s, sig, sp = jnp.sum, jax.nn.sigmoid, jax.nn.softplus
        kw = lambda ax: {"axis": ax}  # noqa: E731

    def vg(w):
        z = s(F * w[None], **kw(1))
        f = s(wt * (sp(z) - y * z), **kw(0)) + 0.5 * l2 * s(w * w, **kw(0))
        return f, s(F * (wt * (sig(z) - y))[:, None, :], **kw(0)) + l2 * w

    def hvp(w, v):
        z = s(F * w[None], **kw(1))
        p = sig(z)
        c = wt * p * (1 - p) * s(F * v[None], **kw(1))
        return s(F * c[:, None, :], **kw(0)) + l2 * v

    return vg, hvp


def _tolerances(vg_j, vg_t, w0, tol):
    jlt, jgt = jax_common.abs_tolerances(vg_j, jnp.asarray(w0), tol)
    tlt, tgt = common.abs_tolerances(vg_t, torch.as_tensor(w0), tol)
    return (jlt, jgt), (tlt, tgt)


def _hold(tr, jr, rtol=1e-6):
    np.testing.assert_allclose(tr.coefficients.numpy(), np.asarray(jr.coefficients), rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(jr.loss), rtol=1e-9)
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.reason.numpy(), np.asarray(jr.reason))
    np.testing.assert_allclose(tr.loss_history.numpy(), np.asarray(jr.loss_history), rtol=1e-9)


@pytest.mark.parametrize("seed,max_cg", [(0, 20), (1, 3), (2, 1)], ids=["cg20", "cg3", "cg1"])
def test_batched_tron_matches_jax_entity_minor(seed, max_cg):
    F, y, wt, l2 = _logistic_lanes(seed)
    vg_j, hv_j = _minor_fns(jnp, F, y, wt, l2)
    vg_t, hv_t = _minor_fns(torch, F, y, wt, l2)
    w0 = np.zeros(F.shape[1:])
    (jlt, jgt), (tlt, tgt) = _tolerances(vg_j, vg_t, w0, 1e-9)
    kw = dict(max_iterations=30, max_cg_iterations=max_cg, max_improvement_failures=5)
    jr = jax_solve_tron(vg_j, hv_j, jnp.asarray(w0), jlt, jgt, **kw)
    tr = solve_tron(vg_t, hv_t, torch.as_tensor(w0), tlt, tgt, **kw)
    _hold(tr, jr)
    assert tr.loss_history.shape == (31, F.shape[2])


def test_batched_tron_entity_leading_matches_vmapped_jax():
    """tests/test_optimizers.py::test_batched_vmap_tron: per-lane diagonal
    quadratics, the JAX package's vmapped solve against the port's
    entity-leading one; each lane at its own optimum."""
    rng = np.random.default_rng(3)
    E, d = 4, 3
    Hs = np.stack([np.diag(rng.uniform(0.5, 2.0, size=d)) for _ in range(E)])
    bs = rng.normal(size=(E, d))

    def solve_one(H, b):
        vg = lambda w: (0.5 * w @ (H @ w) - b @ w, H @ w - b)  # noqa: E731
        return jax_solve_tron(vg, lambda w, v: H @ v, jnp.zeros(d, jnp.float64), jnp.asarray(1e-12),
                              jnp.asarray(1e-10))

    jr = jax.vmap(solve_one)(jnp.asarray(Hs), jnp.asarray(bs))
    Ht, bt = torch.as_tensor(Hs), torch.as_tensor(bs)

    def vg(w):  # [E, d]
        hw = torch.einsum("eij,ej->ei", Ht, w)
        return 0.5 * torch.sum(w * hw, dim=-1) - torch.sum(bt * w, dim=-1), hw - bt

    tr = solve_tron(vg, lambda w, v: torch.einsum("eij,ej->ei", Ht, v), torch.zeros((E, d), dtype=torch.float64),
                    torch.tensor(1e-12), torch.tensor(1e-10), entity_leading=True)
    for e in range(E):
        np.testing.assert_allclose(tr.coefficients[e].numpy(), np.linalg.solve(Hs[e], bs[e]), atol=1e-6)
    np.testing.assert_allclose(tr.coefficients.numpy(), np.asarray(jr.coefficients), rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.reason.numpy(), np.asarray(jr.reason))


def _poisoned(B, H, corrupt, leading):
    """0.5 w'Hw - b'w per lane (diagonal H); lane ``corrupt`` turns NaN once
    it leaves the origin. Entity-minor [d, E] or entity-leading [E, d]."""
    Bt, Ht = torch.as_tensor(B), torch.as_tensor(H)
    ax = -1 if leading else 0

    def make(poisoned):
        def vg(W):
            f = 0.5 * torch.sum(W * Ht * W, dim=ax) - torch.sum(Bt * W, dim=ax)
            g = Ht * W - Bt
            if not poisoned:
                return f, g
            moved = torch.any(W != 0.0, dim=ax)
            lane = torch.arange(f.shape[0]) == corrupt
            poison = torch.where(lane & moved, torch.nan, 0.0).to(f.dtype)
            return f + poison, g + (poison[:, None] if leading else poison[None, :])

        return vg

    return make(True), make(False), (lambda w, v: Ht * v)


@pytest.mark.parametrize("leading", [False, True], ids=["entity_minor", "entity_leading"])
def test_batched_tron_nan_lane_leaves_neighbours_bitwise(leading):
    """After tests/test_optimizers.py:326: one lane's objective turns NaN
    after its first move. That lane rolls back to w0 with
    NUMERICAL_DIVERGENCE; every other lane is bitwise the clean solve's."""
    E, d, corrupt = 5, 3, 2
    rng = np.random.default_rng(11)
    B = rng.normal(size=(d, E))
    H = rng.uniform(0.5, 2.0, size=(d, E))
    if leading:
        B, H = B.T.copy(), H.T.copy()
    bad, clean, hvp = _poisoned(B, H, corrupt, leading)
    w0 = torch.zeros(B.shape, dtype=torch.float64)
    lt, gt = torch.tensor(1e-12), torch.tensor(1e-10)
    rp = solve_tron(bad, hvp, w0, lt, gt, max_iterations=50, entity_leading=leading)
    rc = solve_tron(clean, hvp, w0, lt, gt, max_iterations=50, entity_leading=leading)
    assert int(rp.reason[corrupt]) == ConvergenceReason.NUMERICAL_DIVERGENCE
    coef_p = rp.coefficients if leading else rp.coefficients.T
    coef_c = rc.coefficients if leading else rc.coefficients.T
    assert bool((coef_p[corrupt] == 0).all())
    assert bool(torch.isfinite(rp.loss).all())
    healthy = [e for e in range(E) if e != corrupt]
    assert torch.equal(coef_p[healthy], coef_c[healthy])
    assert torch.equal(rp.loss[healthy], rc.loss[healthy])
    assert torch.equal(rp.iterations[healthy], rc.iterations[healthy])
    # each healthy lane solved its own problem: w* = b / h
    want = (B / H) if leading else (B / H).T
    np.testing.assert_allclose(coef_p[healthy].numpy(), want[healthy], atol=1e-8)


@pytest.mark.parametrize("leading", [False, True], ids=["entity_minor", "entity_leading"])
def test_batched_tron_syncs_one_per_iteration_and_cg_step(leading):
    """The host waits once per outer iteration and once per CG step (an
    all-lanes-done flag each), plus once at the start: syncs = 1 + the
    iterations' evaluations + their CG steps, i.e. one per call of either
    function."""
    F, y, wt, l2 = _logistic_lanes(5, E=9)
    vg, hv = _minor_fns(torch, F, y, wt, l2)
    if leading:
        vg0, hv0 = vg, hv
        vg = lambda w: (lambda f, g: (f, g.T))(*vg0(w.T))  # noqa: E731
        hv = lambda w, v: hv0(w.T, v.T).T  # noqa: E731
    calls = {"vg": 0, "hv": 0}

    def cvg(w):
        calls["vg"] += 1
        return vg(w)

    def chv(w, v):
        calls["hv"] += 1
        return hv(w, v)

    shape = (F.shape[2], F.shape[1]) if leading else F.shape[1:]
    syncs = SyncCounter()
    res = solve_tron(cvg, chv, torch.zeros(shape, dtype=torch.float64), torch.tensor(1e-12), torch.tensor(1e-9),
                     max_iterations=20, syncs=syncs, entity_leading=leading)
    assert res.syncs == syncs.count == calls["vg"] + calls["hv"]
    assert calls["hv"] > 0 and int(res.iterations.max()) > 1
    assert bool((res.reason != 0).all())


def test_batched_lbfgsb_matches_jax():
    """solve_lbfgs(batched=True, box_constraints=...) against the JAX
    package's, on per-lane logistic problems in float64, with boxes that
    bind some coordinates in some lanes."""
    F, y, wt, l2 = _logistic_lanes(7, E=17, S=5, l2=0.1)
    vg_j, _ = _minor_fns(jnp, F, y, wt, l2)
    vg_t, _ = _minor_fns(torch, F, y, wt, l2)
    rng = np.random.default_rng(8)
    S, E = F.shape[1:]
    lower = -rng.uniform(0.05, 0.6, size=(S, E))
    upper = rng.uniform(0.05, 0.6, size=(S, E))
    w0 = rng.normal(size=(S, E))  # outside the box in places: the start is clamped
    (jlt, jgt), (tlt, tgt) = _tolerances(vg_j, vg_t, np.zeros((S, E)), 1e-10)
    jr = jax_solve_lbfgs(vg_j, jnp.asarray(w0), jlt, jgt, max_iterations=60,
                         box_constraints=(jnp.asarray(lower), jnp.asarray(upper)), batched=True)
    tr = solve_lbfgs(vg_t, torch.as_tensor(w0), tlt, tgt, max_iterations=60,
                     box_constraints=(torch.as_tensor(lower), torch.as_tensor(upper)), batched=True)
    _hold(tr, jr)
    coef = tr.coefficients.numpy()
    assert np.all(coef >= lower) and np.all(coef <= upper)
    # some bounds bind, so the box is doing work
    assert np.sum(np.isclose(coef, lower) | np.isclose(coef, upper)) > 0


def test_batched_lbfgs_entity_leading_matches_vmapped_jax():
    """The per-lane-cursor mode against ``jax.vmap`` of the one-problem
    L-BFGS, with history short enough (m = 3) that the cursors wrap."""
    F, y, wt, l2 = _logistic_lanes(9, E=11, S=5)
    vg_j, _ = _minor_fns(jnp, F, y, wt, l2)

    def solve_one(f, yy, ww):
        vg1, _ = _minor_fns(jnp, f[:, :, None], yy[:, None], ww[:, None], l2)
        vg = lambda w: (lambda v, g: (v[0], g[:, 0]))(*vg1(w[:, None]))  # noqa: E731
        lt, gt = jax_common.abs_tolerances(vg, jnp.zeros(f.shape[1]), 1e-10)
        return jax_solve_lbfgs(vg, jnp.zeros(f.shape[1]), lt, gt, max_iterations=60, num_corrections=3)

    jr = jax.vmap(solve_one, in_axes=(2, 1, 1))(jnp.asarray(F), jnp.asarray(y), jnp.asarray(wt))
    vg_t, _ = _minor_fns(torch, F, y, wt, l2)
    vg_lead = lambda w: (lambda f, g: (f, g.T))(*vg_t(w.T))  # noqa: E731
    w0 = torch.zeros((F.shape[2], F.shape[1]), dtype=torch.float64)
    lt, gt = common.abs_tolerances(vg_lead, w0, 1e-10, lanes=common.LEADING)
    tr = solve_lbfgs(vg_lead, w0, lt, gt, max_iterations=60, num_corrections=3, batched=True, entity_leading=True)
    np.testing.assert_allclose(tr.coefficients.numpy(), np.asarray(jr.coefficients), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(jr.loss), rtol=1e-9)
    np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.reason.numpy(), np.asarray(jr.reason))
    assert int(tr.iterations.max()) > 3  # the cursors wrapped
