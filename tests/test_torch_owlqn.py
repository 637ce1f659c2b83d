"""Parity of the port's OWL-QN and L-BFGS-B with the JAX package, on the CPU.

The cases of tests/test_optimizers.py (OWL-QN on a sparse logistic
solution and at a tiny L1, box constraints, the bound-active QP) run through
both packages on the same numpy data in float64, held at coefficients rtol
1e-3 / atol 1e-5 and, for OWL-QN, the same support (the same exact zeros);
the QP also against scipy's L-BFGS-B. The batched (entity-minor) OWL-QN is
held against one-problem solves of each lane, and the packed random-effect
solve with L1 against the JAX package's at tests/test_packed_solver.py's
bounds (coefficients atol 5e-3, loss atol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from photon_ml_tpu.game.coordinate import _train_blocks_packed as jax_train_blocks_packed
from photon_ml_tpu.game.problem import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game.problem import GLMProblem as JaxProblem
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch
from photon_ml_tpu.ops.glm import GLMObjective as JaxObjective
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOptConfig
from photon_ml_tpu.optimize import OptimizerType as JaxOptType
from photon_ml_tpu.optimize import optimize as jax_optimize
from photon_ml_tpu_torch.game.coordinate import _train_blocks_packed
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.glm import GLMObjective
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import ConvergenceReason, OptimizerConfig, OptimizerType, optimize, solve_lbfgs
from photon_ml_tpu_torch.optimize.common import abs_tolerances
from photon_ml_tpu_torch.optimize.tron import solve_tron


def _logistic_pair(rng, n=200, d=10, l2=0.5):
    """tests/test_optimizers.py's make_logistic, for both packages."""
    x = rng.normal(size=(n, d))
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ w_true)))).astype(float)
    jobj = JaxObjective(loss=JAX_LOSSES["logistic"], batch=jax_batch(x, y, dtype=jnp.float64), l2=l2)
    tobj = GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, dtype=torch.float64, device="cpu"),
                        l2=l2)
    return x, y, jobj, tobj


def _both(jvg, tvg, d, jcfg, tcfg):
    jr = jax_optimize(jvg, jnp.zeros(d, jnp.float64), jcfg)
    tr = optimize(tvg, torch.zeros(d, dtype=torch.float64), tcfg)
    return jr, tr


def _hold_owlqn(jr, tr):
    got, want = tr.coefficients.numpy(), np.asarray(jr.coefficients)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert np.array_equal(got == 0.0, want == 0.0), (got, want)
    np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=1e-9)
    # the result's gradient is the pseudo-gradient, as the reference's
    np.testing.assert_allclose(tr.gradient.numpy(), np.asarray(jr.gradient), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("l1", [5.0, 1.0, 0.2])
def test_owlqn_sparse_solution_matches_jax(rng, l1):
    """tests/test_optimizers.py::test_owlqn_produces_sparse_solution, at its
    L1 weight and two lighter ones."""
    _, _, jobj, tobj = _logistic_pair(rng, n=150, d=8, l2=0.0)
    kw = dict(l1_weight=l1, tolerance=1e-9, max_iterations=300)
    jr, tr = _both(jobj.value_and_grad, tobj.value_and_grad, 8, JaxOptConfig(**kw), OptimizerConfig(**kw))
    _hold_owlqn(jr, tr)
    if l1 == 5.0:
        assert np.sum(tr.coefficients.numpy() == 0.0) > 0


def test_owlqn_with_a_tiny_l1_matches_jax(rng):
    """tests/test_optimizers.py::test_owlqn_matches_smooth_solution_when_l1_tiny."""
    _, _, jobj, tobj = _logistic_pair(rng, n=100, d=6, l2=1.0)
    kw = dict(l1_weight=1e-10, tolerance=1e-10, max_iterations=300)
    jr, tr = _both(jobj.value_and_grad, tobj.value_and_grad, 6, JaxOptConfig(**kw), OptimizerConfig(**kw))
    _hold_owlqn(jr, tr)


@pytest.mark.parametrize("reg", ["L1", "ELASTIC_NET"])
def test_glm_problem_with_l1_matches_jax(rng, reg):
    """The regularization split: L1 and elastic net through GLMProblem.run
    route the L1 part to OWL-QN in both packages."""
    x, y, _, _ = _logistic_pair(rng, n=300, d=12)
    opt = dict(tolerance=1e-9, max_iterations=300)
    alpha = 0.5 if reg == "ELASTIC_NET" else 1.0
    jm, jr = JaxProblem("logistic_regression", JaxConfig(
        optimizer=JaxOptConfig(**opt), regularization=JaxReg(reg, alpha), reg_weight=6.0,
    )).run(jax_batch(x, y, dtype=jnp.float64))
    tm, tr = GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=OptimizerConfig(**opt), regularization=RegularizationContext(reg, alpha), reg_weight=6.0,
    )).run(batch_from_dense(x, y, dtype=torch.float64, device="cpu"))
    got, want = tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert np.array_equal(got == 0.0, want == 0.0)


def test_box_constraints_match_jax(rng):
    """tests/test_optimizers.py::test_box_constraints."""
    _, _, jobj, tobj = _logistic_pair(rng, n=100, d=5)
    lower, upper = np.full(5, -0.1), np.full(5, 0.1)
    jcfg = JaxOptConfig(optimizer_type=JaxOptType.LBFGSB, box_constraints=(jnp.asarray(lower), jnp.asarray(upper)),
                        tolerance=1e-9, max_iterations=100)
    tcfg = OptimizerConfig(optimizer_type=OptimizerType.LBFGSB, box_constraints=(torch.tensor(lower),
                           torch.tensor(upper)), tolerance=1e-9, max_iterations=100)
    jr, tr = _both(jobj.value_and_grad, tobj.value_and_grad, 5, jcfg, tcfg)
    w = tr.coefficients.numpy()
    assert np.all(w >= -0.1 - 1e-12) and np.all(w <= 0.1 + 1e-12)
    np.testing.assert_allclose(w, np.asarray(jr.coefficients), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=1e-9)


@pytest.mark.parametrize("optimizer_type", ["LBFGSB", "LBFGS"])
def test_lbfgsb_bound_active_qp_matches_jax_and_scipy(optimizer_type):
    """tests/test_optimizers.py::test_lbfgsb_bound_active_qp_matches_scipy:
    the constrained optimum [0.5, 1.25] is not the clamp [0.5, 1.0] of the
    unconstrained one. LBFGS with box constraints runs L-BFGS-B as well."""
    A = np.asarray([[2.0, 1.0], [1.0, 2.0]])
    b = np.asarray([3.0, 3.0])
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.tensor(A), torch.tensor(b)
    box = ([-10.0, -10.0], [0.5, 10.0])
    jcfg = JaxOptConfig(optimizer_type=JaxOptType(optimizer_type), tolerance=1e-12, max_iterations=200,
                        box_constraints=tuple(jnp.asarray(v, jnp.float64) for v in box))
    tcfg = OptimizerConfig(optimizer_type=OptimizerType(optimizer_type), tolerance=1e-12, max_iterations=200,
                           box_constraints=tuple(torch.tensor(v, dtype=torch.float64) for v in box))
    jr, tr = _both(lambda w: (0.5 * w @ (Aj @ w) - bj @ w, Aj @ w - bj),
                   lambda w: (0.5 * w @ (At @ w) - bt @ w, At @ w - bt), 2, jcfg, tcfg)
    r = scipy.optimize.minimize(lambda w: 0.5 * w @ (A @ w) - b @ w, np.zeros(2), jac=lambda w: A @ w - b,
                                method="L-BFGS-B", bounds=[(-10.0, 0.5), (-10.0, 10.0)])
    w = tr.coefficients.numpy()
    np.testing.assert_allclose(w, r.x, atol=1e-6)
    np.testing.assert_allclose(w, [0.5, 1.25], atol=1e-6)
    np.testing.assert_allclose(w, np.asarray(jr.coefficients), rtol=1e-3, atol=1e-5)
    assert abs(w[1] - 1.0) > 0.2


def test_glm_problem_with_box_constraints_matches_jax(rng):
    x, y, _, _ = _logistic_pair(rng, n=300, d=6)
    lower, upper = np.full(6, -0.2), np.full(6, 0.3)
    jm, _ = JaxProblem("logistic_regression", JaxConfig(optimizer=JaxOptConfig(
        box_constraints=(jnp.asarray(lower), jnp.asarray(upper)), tolerance=1e-10, max_iterations=200),
        regularization=JaxReg("L2"), reg_weight=0.5)).run(jax_batch(x, y, dtype=jnp.float64))
    tm, _ = GLMProblem("logistic_regression", GLMOptimizationConfig(optimizer=OptimizerConfig(
        box_constraints=(torch.tensor(lower), torch.tensor(upper)), tolerance=1e-10, max_iterations=200),
        regularization=RegularizationContext("L2"), reg_weight=0.5)).run(
        batch_from_dense(x, y, dtype=torch.float64, device="cpu"))
    np.testing.assert_allclose(tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["owlqn", "lbfgsb"])
def test_one_sync_per_line_search_trial(rng, kind):
    """OWL-QN and L-BFGS-B keep the solver's sync count: one fetch per
    objective evaluation (the tolerance pass, the start, each trial)."""
    _, _, _, tobj = _logistic_pair(rng, n=200, d=8)
    calls = {"vg": 0}

    def vg(w):
        calls["vg"] += 1
        return tobj.value_and_grad(w)

    cfg = OptimizerConfig(l1_weight=2.0, tolerance=1e-8) if kind == "owlqn" else OptimizerConfig(
        box_constraints=(torch.full((8,), -0.2, dtype=torch.float64), torch.full((8,), 0.2, dtype=torch.float64)),
        tolerance=1e-8)
    res = optimize(vg, torch.zeros(8, dtype=torch.float64), cfg)
    assert res.syncs == calls["vg"] and res.iterations > 0 and res.reason != 0


# ------------------------------------------------------------ batched lanes


def _lanes(rng, E=7, n=60, S=5):
    """E independent logistic problems, entity-minor: X [E, n, S]."""
    x = rng.normal(size=(E, n, S))
    w_true = rng.normal(size=(E, S)) * 1.5
    y = (rng.uniform(size=(E, n)) < 1 / (1 + np.exp(-np.einsum("ens,es->en", x, w_true)))).astype(float)
    return x, y


def _lane_vg(x, y, l2=0.1):
    X, Y = torch.tensor(x), torch.tensor(y)

    def batched(w):  # [S, E] -> ([E], [S, E])
        z = torch.einsum("ens,se->en", X, w)
        loss = torch.nn.functional.softplus(z) - Y * z
        g = torch.einsum("ens,en->se", X, torch.sigmoid(z) - Y) + l2 * w
        return loss.sum(dim=1) + 0.5 * l2 * (w * w).sum(dim=0), g

    def one(e):
        def vg(w):
            z = X[e] @ w
            return (torch.nn.functional.softplus(z) - Y[e] * z).sum() + 0.5 * l2 * w @ w, X[e].T @ (
                torch.sigmoid(z) - Y[e]) + l2 * w
        return vg

    return batched, one


@pytest.mark.parametrize("l1", [0.5, 3.0])
def test_batched_owlqn_lanes_match_single_solves(rng, l1):
    x, y = _lanes(rng)
    E, _, S = x.shape
    batched, one = _lane_vg(x, y)
    w0 = torch.zeros((S, E), dtype=torch.float64)
    lt, gt = abs_tolerances(batched, w0, 1e-10)
    res = solve_lbfgs(batched, w0, lt, gt, max_iterations=300, l1_weight=l1, batched=True)
    assert res.coefficients.shape == (S, E) and res.loss.shape == (E,)
    for e in range(E):
        lt1, gt1 = abs_tolerances(one(e), torch.zeros(S, dtype=torch.float64), 1e-10)
        r1 = solve_lbfgs(one(e), torch.zeros(S, dtype=torch.float64), lt1, gt1, max_iterations=300, l1_weight=l1)
        got, want = res.coefficients[:, e].numpy(), r1.coefficients.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5, err_msg=f"lane {e}")
        assert np.array_equal(got == 0.0, want == 0.0), f"lane {e}"
        np.testing.assert_allclose(float(res.loss[e]), float(r1.loss), rtol=1e-9)
    assert bool((res.reason != 0).all())


def _packed_problem(seed=0, E=37, K=12, S=9, active_k=10):
    """tests/test_packed_solver.py::_problem."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(E, K, S)).astype(np.float32)
    w_true = rng.normal(size=(E, S)).astype(np.float32)
    logits = np.einsum("eks,es->ek", F, w_true)
    y = (rng.uniform(size=(E, K)) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    off = rng.normal(size=(E, K)).astype(np.float32) * 0.1
    wt = np.ones((E, K), np.float32)
    wt[:, active_k:] = 0.0
    y[:, active_k:] = 0.0
    return F, y, off, wt, np.zeros((E, S), np.float32), np.zeros((E, S), np.float32), np.ones((E, S), np.float32)


@pytest.mark.parametrize("dtype,l1", [(np.float32, 0.05), (np.float64, 0.05), (np.float64, 0.5)],
                         ids=["f32-0.05", "f64-0.05", "f64-0.5"])
def test_packed_random_effect_solve_with_l1_matches_jax(dtype, l1):
    """tests/test_packed_solver.py's owlqn case (float32, L1 0.05) and, in
    float64, a heavier L1. (In float32 at L1 0.5 the JAX package's own
    vmapped and packed solves stop 0.02 apart in a coefficient: the f32
    stopping point, not a bound the port could be held to.)"""
    args = [a.astype(dtype) for a in _packed_problem()]
    kw = dict(l2=0.1, l1=l1, optimizer_type="LBFGS", tolerance=1e-7, max_iterations=80, num_corrections=10,
              max_cg_iterations=20, max_improvement_failures=5)
    jr = jax_train_blocks_packed(*(jnp.asarray(a) for a in args), task="logistic", **kw)
    tr = _train_blocks_packed(*(torch.from_numpy(a) for a in args), task="logistic_regression", **kw)
    np.testing.assert_allclose(tr.coefficients.numpy(), np.asarray(jr.coefficients), atol=5e-3)
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(jr.loss), atol=1e-4)
    assert tr.coefficients.shape == jr.coefficients.shape
    assert tr.loss_history.shape == jr.loss_history.shape


def test_batched_refusals_that_remain():
    vg = lambda w: (torch.sum(w * w, dim=0), 2 * w)  # noqa: E731
    # none remains: batched box constraints and batched TRON run
    # (tests/test_torch_tron_batched.py holds them against the JAX package)
    box = (0.5 * torch.ones((4, 3)), torch.ones((4, 3)))
    res = solve_lbfgs(vg, torch.ones((4, 3)), 0.0, 1e-12, box_constraints=box, batched=True)
    torch.testing.assert_close(res.coefficients, torch.full((4, 3), 0.5), atol=1e-6, rtol=0)
    res = solve_tron(vg, lambda w, v: 2 * v, torch.ones((4, 3)), 0.0, 1e-12)
    assert float(res.coefficients.abs().max()) <= 1e-6
    # batched OWL-QN runs: the minimum of sum(w^2) + l1 |w|_1 is 0
    res = solve_lbfgs(vg, torch.ones((4, 3)), 0.0, 1e-12, l1_weight=0.1, batched=True)
    assert float(res.coefficients.abs().max()) == 0.0
    assert bool((res.reason != ConvergenceReason.NOT_CONVERGED).all())
