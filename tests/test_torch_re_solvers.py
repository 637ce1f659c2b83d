"""The random effect's solvers against the JAX package's, on the CPU: the
packed (entity-minor) TRON, the vmapped (entity-leading, per-lane history)
L-BFGS, OWL-QN and TRON, and the optimization trackers.

Inputs are tests/test_packed_solver.py's problem, made from a numpy seed.
Bounds are that file's: coefficients atol 5e-3 and per-entity loss atol
1e-4 in float32; in float64 the two packages take the same steps and are
held at rtol 1e-6. The vmapped solve's property, that an entity's result
does not depend on which other entities share its stack, is held bitwise.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.coordinate import _train_blocks as jax_train_blocks
from photon_ml_tpu.game.coordinate import _train_blocks_packed as jax_train_blocks_packed
from photon_ml_tpu.optimize import trackers as jax_trackers
from photon_ml_tpu.optimize.common import SolverResult as JaxResult
from photon_ml_tpu_torch.game.coordinate import _train_blocks, _train_blocks_packed
from photon_ml_tpu_torch.optimize import SolverResult, trackers
from test_torch_glmix import _coordinates, _glmix_data


def _problem(seed=0, E=37, K=12, S=9, active_k=10, dtype=np.float32):
    """tests/test_packed_solver.py::_problem: entity-leading blocks."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(E, K, S))
    w_true = rng.normal(size=(E, S))
    logits = np.einsum("eks,es->ek", F, w_true)
    y = (rng.uniform(size=(E, K)) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    off = rng.normal(size=(E, K)) * 0.1
    wt = np.ones((E, K))
    wt[:, active_k:] = 0.0  # padded rows carry zero weight
    y[:, active_k:] = 0.0
    arrays = [F, y, off, wt, np.zeros((E, S)), np.zeros((E, S)), np.ones((E, S))]
    return [a.astype(dtype) for a in arrays]


def _kwargs(opt, l1=0.0, **over):
    kw = dict(l2=0.1, l1=l1, optimizer_type=opt, tolerance=1e-7, max_iterations=80, num_corrections=10,
              max_cg_iterations=20, max_improvement_failures=5)
    kw.update(over)
    return kw


CASES = [
    ("packed", "TRON", 0.0),
    ("vmapped", "LBFGS", 0.0),
    ("vmapped", "LBFGS", 0.05),
    ("vmapped", "TRON", 0.0),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode,opt,l1", CASES, ids=["packed-tron", "vmapped-lbfgs", "vmapped-owlqn", "vmapped-tron"])
def test_random_effect_solve_matches_jax(mode, opt, l1, dtype):
    args = _problem(dtype=dtype)
    kw = _kwargs(opt, l1)
    jax_fn, port_fn = {
        "packed": (jax_train_blocks_packed, _train_blocks_packed),
        "vmapped": (jax_train_blocks, _train_blocks),
    }[mode]
    jr = jax_fn(*(jnp.asarray(a) for a in args), task="logistic", **kw)
    tr = port_fn(*(torch.from_numpy(a) for a in args), task="logistic_regression", **kw)
    coef, loss = tr.coefficients.numpy(), tr.loss.numpy()
    if dtype == np.float32:
        np.testing.assert_allclose(coef, np.asarray(jr.coefficients), atol=5e-3)
        np.testing.assert_allclose(loss, np.asarray(jr.loss), atol=1e-4)
    else:
        np.testing.assert_allclose(coef, np.asarray(jr.coefficients), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(loss, np.asarray(jr.loss), rtol=1e-6)
    assert tr.coefficients.shape == jr.coefficients.shape
    assert tr.loss_history.shape == jr.loss_history.shape
    assert tr.iterations.shape == jr.iterations.shape
    assert bool((tr.reason != 0).all())


@pytest.mark.parametrize("opt,l1", [("LBFGS", 0.0), ("LBFGS", 0.05), ("TRON", 0.0)], ids=["lbfgs", "owlqn", "tron"])
def test_vmapped_entities_do_not_depend_on_their_bucket(opt, l1):
    """An entity solved alone, among a few others in another order, or
    among all 37 ends with the same bits: every lane's operations and sums
    are its own. (The packed solve does not keep this: its sums over the
    entity-minor stack change with the number of lanes.)"""
    args = [torch.from_numpy(a) for a in _problem(seed=4)]
    kw = dict(task="logistic_regression", **_kwargs(opt, l1))
    whole = _train_blocks(*args, **kw)
    subsets = [[5], [30, 2, 17, 5], list(range(36, 20, -1))]
    for rows in subsets:
        part = _train_blocks(*(a[rows] for a in args), **kw)
        for name in ("coefficients", "loss", "gradient", "iterations", "reason", "loss_history",
                     "grad_norm_history"):
            got, want = getattr(part, name), getattr(whole, name)[rows]
            assert torch.equal(got, want) or (
                got.is_floating_point() and torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
            ), (rows, name)


def test_packed_tron_keeps_one_sync_per_iteration_and_cg_step():
    """The random effect's packed TRON fetches one flag per CG step and one
    per outer iteration (plus one at the start), whatever the lane count."""
    F, y, off, wt, w0, pm, pp = (torch.from_numpy(a) for a in _problem(seed=2, dtype=np.float64))
    res = _train_blocks_packed(F, y, off, wt, w0, pm, pp, task="logistic_regression",
                               **_kwargs("TRON", max_iterations=6, max_cg_iterations=4))
    # at most 1 + 6 * (1 + 4) fetches: each outer iteration's CG stops at 4
    assert 1 + int(res.iterations.max()) <= res.syncs <= 1 + 6 * 5


@pytest.mark.parametrize("mode", ["packed", "vmapped"])
def test_random_effect_coordinate_with_tron_matches_jax(mode, monkeypatch):
    """RandomEffectCoordinate with optimizer_type=TRON in each solver mode
    (PHOTON_RE_SOLVER, read by both packages) against the JAX package's
    coordinate, in float64 on the same data and residuals."""
    monkeypatch.setenv("PHOTON_RE_SOLVER", mode)
    gx, y, ex, ids = _glmix_data(3, n=1200, n_users=30)
    jc, tc = _coordinates(gx, y, ex, ids, torch.float64)

    def tron(cfg):
        return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, optimizer_type="TRON"))

    jre = dataclasses.replace(jc["per-user"], config=tron(jc["per-user"].config))
    tre = dataclasses.replace(tc["per-user"], config=tron(tc["per-user"].config))
    residual = np.random.default_rng(5).normal(size=len(y)) * 0.3
    jm, jr = jre.train(jnp.asarray(residual), None)
    tm, tr = tre.train(torch.from_numpy(residual), None)
    np.testing.assert_allclose(tm.coef_values.numpy(), np.asarray(jm.coef_values), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tr.loss.numpy(), np.asarray(jr.loss), rtol=1e-6)
    np.testing.assert_allclose(tre.score(tm).numpy(), np.asarray(jre.score(jm)), rtol=1e-6, atol=1e-9)
    assert os.environ["PHOTON_RE_SOLVER"] == mode


def _results(seed):
    """The same solver results for both packages: a fixed-effect one
    (scalars) and a random-effect one (per-entity lanes)."""
    rng = np.random.default_rng(seed)
    E, T = 9, 6
    hist = rng.normal(size=T) * 10
    hist[4:] = np.nan
    fe = dict(coefficients=rng.normal(size=4), loss=np.float64(hist[3]), gradient=rng.normal(size=4),
              iterations=np.int32(3), reason=np.int32(3), loss_history=hist, grad_norm_history=np.abs(hist))
    re_ = dict(coefficients=rng.normal(size=(E, 3)), loss=rng.normal(size=E), gradient=rng.normal(size=(E, 3)),
               iterations=rng.integers(1, 20, size=E).astype(np.int32),
               reason=rng.choice([1, 2, 3, 4, 5], size=E).astype(np.int32),
               loss_history=rng.normal(size=(E, T)), grad_norm_history=rng.normal(size=(E, T)))
    jax_res = [JaxResult(**{k: jnp.asarray(v) for k, v in r.items()}) for r in (fe, re_)]
    port_fe = SolverResult(**{k: (torch.from_numpy(np.asarray(v)) if k in ("coefficients", "gradient", "loss_history",
                                                                            "grad_norm_history", "loss") else int(v))
                              for k, v in fe.items()})
    port_re = SolverResult(**{k: torch.from_numpy(v) for k, v in re_.items()})
    return jax_res, (port_fe, port_re)


@pytest.mark.parametrize("masked", [False, True], ids=["all_entities", "entity_mask"])
def test_tracker_summaries_match_jax(masked):
    (jfe, jre), (tfe, tre) = _results(6)
    counts = np.array([3, 0, 5, 1, 0, 2, 7, 0, 1]) if masked else None

    class Coordinate:  # what build_tracker reads of a coordinate
        dataset = type("D", (), {"entity_counts": counts})()

    jt_fe, tt_fe = jax_trackers.build_tracker(Coordinate, jfe), trackers.build_tracker(Coordinate, tfe)
    jt_re, tt_re = jax_trackers.build_tracker(Coordinate, jre), trackers.build_tracker(Coordinate, tre)
    assert isinstance(tt_fe, trackers.FixedEffectOptimizationTracker)
    assert isinstance(tt_re, trackers.RandomEffectOptimizationTracker)
    assert tt_fe.to_summary_string() == jt_fe.to_summary_string()
    assert tt_re.to_summary_string() == jt_re.to_summary_string()
    assert tt_re.convergence_reasons == jt_re.convergence_reasons
    assert str(trackers.StatCounter.of([])) == str(jax_trackers.StatCounter.of([]))
    assert trackers.build_tracker(Coordinate, None) is None
