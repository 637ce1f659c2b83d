"""Parity of the port's batched (entity-minor, lockstep) L-BFGS with the JAX
package's ``solve_lbfgs(..., batched=True)``, on the CPU.

Both packages solve the same per-entity logistic problems, made from a seed
with numpy, as ``[S, E]`` stacks. Bounds are the JAX suite's own for the
packed solve (tests/test_packed_solver.py): coefficients atol 5e-3, loss
atol 1e-4. In float64 the two solvers take the same steps, so the float64
cases also hold every lane's iteration count and reason exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.losses import LOGISTIC as JAX_LOGISTIC
from photon_ml_tpu.optimize import common as jax_common
from photon_ml_tpu.optimize.lbfgs import solve_lbfgs as jax_solve_lbfgs
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optimize import ConvergenceReason, OptimizerConfig, optimize
from photon_ml_tpu_torch.optimize import common
from photon_ml_tpu_torch.optimize.lbfgs import solve_lbfgs
from photon_ml_tpu_torch.optimize.tron import solve_tron

COEF_ATOL, LOSS_ATOL = 5e-3, 1e-4


def _problem(seed=0, E=37, K=12, S=9, active_k=10, dtype=np.float32):
    """tests/test_packed_solver.py::_problem, entity-minor: F [K, S, E]."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(E, K, S))
    w_true = rng.normal(size=(E, S))
    logits = np.einsum("eks,es->ek", F, w_true)
    y = (rng.uniform(size=(E, K)) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    off = rng.normal(size=(E, K)) * 0.1
    wt = np.ones((E, K))
    wt[:, active_k:] = 0.0  # padded rows carry zero weight
    y[:, active_k:] = 0.0
    cast = lambda a: np.ascontiguousarray(a).astype(dtype)  # noqa: E731
    return cast(F.transpose(1, 2, 0)), cast(y.T), cast(off.T), cast(wt.T)


def _objective(xp, loss, F, y, off, wt, l2, pm, pp):
    """The packed value_and_grad of game/coordinate.py, in either package."""
    if xp is torch:
        s = lambda a, ax: torch.sum(a, dim=ax)  # noqa: E731
    else:
        s = lambda a, ax: jnp.sum(a, axis=ax)  # noqa: E731

    def value_and_grad(w):
        z = s(F * w[None, :, :], 1) + off
        lvals, dz = loss.loss_and_dz(z, y)
        wdz = wt * dz
        delta = w - pm
        value = s(wt * lvals, 0) + 0.5 * l2 * s(pp * delta * delta, 0)
        grad = s(F * wdz[:, None, :], 0) + l2 * pp * delta
        return value, grad

    return value_and_grad


def _both(arrays, l2, w0, pm, pp, tol, max_iter):
    """Solve with both packages; returns (jax result, port result, port vg calls)."""
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.as_tensor(a) for a in arrays]
    jvg = _objective(jnp, JAX_LOGISTIC, *j, l2, jnp.asarray(pm), jnp.asarray(pp))
    tvg = _objective(torch, LOGISTIC, *t, l2, torch.as_tensor(pm), torch.as_tensor(pp))
    jlt, jgt = jax_common.abs_tolerances(jvg, jnp.asarray(w0), tol)
    jr = jax_solve_lbfgs(jvg, jnp.asarray(w0), jlt, jgt, max_iterations=max_iter, batched=True)
    calls = [0]

    def counted(w):
        calls[0] += 1
        return tvg(w)

    tlt, tgt = common.abs_tolerances(tvg, torch.as_tensor(w0), tol)
    np.testing.assert_allclose(tlt.numpy(), np.asarray(jlt), rtol=1e-5)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jgt), rtol=1e-5)
    tr = solve_lbfgs(counted, torch.as_tensor(w0), tlt, tgt, max_iterations=max_iter, batched=True)
    return jr, tr, calls[0]


def _assert_match(jr, tr, exact_path):
    np.testing.assert_allclose(tr.coefficients.numpy(), np.asarray(jr.coefficients), atol=COEF_ATOL)
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(jr.loss), atol=LOSS_ATOL)
    assert tr.loss_history.shape == jr.loss_history.shape
    assert tr.iterations.shape == jr.iterations.shape == tr.reason.shape
    if exact_path:
        np.testing.assert_array_equal(tr.iterations.numpy(), np.asarray(jr.iterations))
        np.testing.assert_array_equal(tr.reason.numpy(), np.asarray(jr.reason))
        np.testing.assert_allclose(tr.coefficients.numpy(), np.asarray(jr.coefficients), atol=1e-10)
        np.testing.assert_allclose(
            tr.loss_history.numpy(), np.asarray(jr.loss_history), atol=1e-9, equal_nan=True
        )


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_batched_lbfgs_matches_jax(dtype):
    arrays = _problem(dtype=dtype)
    S, E = arrays[0].shape[1:]
    zeros, ones = np.zeros((S, E), dtype), np.ones((S, E), dtype)
    jr, tr, _ = _both(arrays, 0.1, zeros, zeros, ones, tol=1e-7, max_iter=80)
    _assert_match(jr, tr, exact_path=dtype == np.float64)
    assert bool((tr.reason > 0).all())


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_batched_prior_centred_l2_with_warm_start(dtype):
    """Prior-centred L2 (incremental training) from a warm start w0, as
    tests/test_packed_solver.py::test_packed_prior_and_warm_start sets it up."""
    arrays = _problem(seed=3, dtype=dtype)
    S, E = arrays[0].shape[1:]
    rng = np.random.default_rng(7)
    w0 = (rng.normal(size=(S, E)) * 0.1).astype(dtype)
    pm = (rng.normal(size=(S, E)) * 0.2).astype(dtype)
    pp = (0.5 + rng.uniform(size=(S, E))).astype(dtype)
    jr, tr, _ = _both(arrays, 0.7, w0, pm, pp, tol=1e-8, max_iter=80)
    _assert_match(jr, tr, exact_path=dtype == np.float64)


def test_nan_lane_freezes_while_the_others_match():
    """A lane whose data is non-finite at the start freezes at w0 with
    NUMERICAL_DIVERGENCE; the other lanes match the JAX package's solve of
    the same stack (whose NaN lane freezes the same way)."""
    F, y, off, wt = _problem(seed=5)
    off = off.copy()
    off[0, 4] = np.nan  # entity 4's first row
    S, E = F.shape[1:]
    rng = np.random.default_rng(1)
    w0 = (rng.normal(size=(S, E)) * 0.05).astype(np.float32)
    zeros, ones = np.zeros((S, E), np.float32), np.ones((S, E), np.float32)
    jr, tr, _ = _both((F, y, off, wt), 0.1, w0, zeros, ones, tol=1e-7, max_iter=60)
    assert int(tr.reason[4]) == ConvergenceReason.NUMERICAL_DIVERGENCE == int(jr.reason[4])
    assert int(tr.iterations[4]) == 0
    assert torch.equal(tr.coefficients[:, 4], torch.as_tensor(w0[:, 4]))
    others = np.arange(E) != 4
    np.testing.assert_allclose(
        tr.coefficients.numpy()[:, others], np.asarray(jr.coefficients)[:, others], atol=COEF_ATOL
    )
    np.testing.assert_allclose(tr.loss.numpy()[others], np.asarray(jr.loss)[others], atol=LOSS_ATOL)
    assert bool(torch.isfinite(tr.coefficients[:, others]).all())
    assert bool((tr.reason[others] != ConvergenceReason.NUMERICAL_DIVERGENCE).all())


def test_one_sync_per_line_search_trial():
    """The host loop waits on the device once at the start and once per
    line-search trial, and nowhere else: each value_and_grad call is the
    start or one trial, so the fetches equal the calls."""
    arrays = _problem(seed=2, E=64)
    S, E = arrays[0].shape[1:]
    zeros, ones = np.zeros((S, E), np.float32), np.ones((S, E), np.float32)
    jr, tr, calls = _both(arrays, 0.1, zeros, zeros, ones, tol=1e-7, max_iter=40)
    assert tr.syncs == calls
    # at least one trial per iteration of the longest-running lane
    assert calls >= 1 + int(tr.iterations.max())


def test_lane_generic_helpers_match_jax():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(6, 5)).astype(np.float32)
    b = rng.normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(
        common.vdot(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jax_common._vdot(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        common.norm(torch.as_tensor(a)).numpy(), np.asarray(jax_common._norm(jnp.asarray(a))), rtol=1e-6
    )
    f = rng.normal(size=5).astype(np.float32)
    f[1] = np.nan
    g = a.copy()
    g[2, 3] = np.inf
    np.testing.assert_array_equal(
        common.finite_state(torch.as_tensor(f), torch.as_tensor(g)).numpy(),
        np.asarray(jax_common.finite_state(jnp.asarray(f), jnp.asarray(g))),
    )
    args = dict(
        it=np.array([3, 10, 2, 4, 1], np.int32), loss=np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32),
        prev_loss=np.array([1.0, 2.5, 3.0, 4.5, 5.5], np.float32),
        grad_norm=np.array([0.5, 0.01, 2.0, 2.0, 0.001], np.float32),
        loss_abs_tol=np.full(5, 1e-3, np.float32), grad_abs_tol=np.full(5, 0.05, np.float32),
        objective_not_improving=np.array([False, False, False, True, False]),
        diverged=np.array([False, False, False, False, True]),
    )
    want = jax_common.check_convergence(
        **{k: jnp.asarray(v) for k, v in args.items() if k != "it"}, it=jnp.asarray(args["it"]),
        max_iterations=10,
    )
    got = common.check_convergence(
        **{k: torch.as_tensor(v) for k, v in args.items()}, max_iterations=10
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_refusals_and_the_single_lane_driver():
    vg = lambda w: (torch.sum(w * w, dim=0), 2 * w)  # noqa: E731
    with pytest.raises(ValueError, match=r"\[S, E\]"):
        solve_lbfgs(vg, torch.zeros(4), 0.0, 0.0, batched=True)
    with pytest.raises(ValueError, match="batched=True"):
        solve_lbfgs(vg, torch.zeros((4, 3)), 0.0, 0.0)
    # batched OWL-QN, box constraints and TRON all run now
    # (tests/test_torch_owlqn.py, tests/test_torch_tron_batched.py): the
    # minimum of sum((w - 2)^2) is 2, and 1 inside the box [-1, 1]
    vg2 = lambda w: (torch.sum((w - 2) ** 2, dim=0), 2 * (w - 2))  # noqa: E731
    res = solve_lbfgs(vg2, torch.zeros((4, 3)), 0.0, 1e-12, box_constraints=(-torch.ones((4, 3)), torch.ones((4, 3))),
                      batched=True)
    torch.testing.assert_close(res.coefficients, torch.ones((4, 3)), atol=1e-6, rtol=0)
    res = solve_tron(vg2, lambda w, v: 2 * v, torch.zeros((4, 3)), 0.0, 1e-12)
    torch.testing.assert_close(res.coefficients, torch.full((4, 3), 2.0), atol=1e-6, rtol=0)
    assert bool((res.reason != ConvergenceReason.NOT_CONVERGED).all())
    # the single-lane driver is unchanged: a 1-D solve still returns host ints
    res = optimize(lambda w: (torch.dot(w - 1, w - 1), 2 * (w - 1)), torch.zeros(4), OptimizerConfig())
    assert isinstance(res.iterations, int) and isinstance(res.reason, int)
    torch.testing.assert_close(res.coefficients, torch.ones(4), atol=1e-5, rtol=0)
