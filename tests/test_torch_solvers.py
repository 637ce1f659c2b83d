"""Parity of the PyTorch port's solvers and of the fixed-effect training slice
with the JAX package, on the CPU.

Both packages solve the same problem made from a seed with numpy; the
solves are held to the reference suite's end-to-end bound (coefficients at
rtol 1e-3, atol 1e-5, tests/test_pallas_glm.py::
test_end_to_end_solve_matches_unfused). ``convert`` carries parameters
across so that both packages score identical models.

In float32 the solves run at the bench's tolerance, 1e-6. At 1e-9 both f32
solvers end on OBJECTIVE_NOT_IMPROVING where the loss stops resolving
(about 1e-4 at a loss near 1e3), and whether the last tiny step is taken
there is decided by the last bit of two different summation orders. The
float64 cases run at 1e-9 and hold the converged optimum itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation.device import DEVICE_METRICS as JAX_METRICS
from photon_ml_tpu.evaluation.evaluators import area_under_roc_curve
from photon_ml_tpu.game.problem import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game.problem import GLMProblem as JaxProblem
from photon_ml_tpu.models.coefficients import Coefficients as JaxCoefficients
from photon_ml_tpu.models.glm import model_for_task as jax_model_for_task
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOptConfig
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.evaluation.device import DEVICE_METRICS, auc
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.glm import GLMObjective
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig, optimize

F32 = np.float32
N, D = 4096, 256


def _data(rng, n=N, d=D, task="logistic_regression"):
    """The reference suite's solve data (tests/test_pallas_glm.py::_make_batch):
    standard-normal features, 0/1 labels (0/2 for Poisson), small offsets,
    weights in [0.5, 1.5)."""
    x = rng.standard_normal((n, d)).astype(F32)
    y = (rng.random(n) > 0.5).astype(F32)
    if task == "poisson_regression":
        y = y * 2
    off = (rng.standard_normal(n) * 0.1).astype(F32)
    wt = (rng.random(n) + 0.5).astype(F32)
    return x, y, off, wt


def _signal_data(rng, n=N, d=D):
    """Labels drawn from a logistic model, for an AUC worth reading."""
    x = rng.standard_normal((n, d)).astype(F32)
    x[:, -1] = 1.0
    w = (rng.standard_normal(d) / np.sqrt(d)).astype(F32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ w)))).astype(F32)
    return x, y


def _problems(task, optimizer, tol=1e-6, max_iter=60, reg=1.0, jnorm=None, tnorm=None,
              jprior=None, tprior=None):
    jp = JaxProblem(
        task=task,
        config=JaxConfig(
            optimizer=JaxOptConfig(optimizer_type=optimizer, tolerance=tol, max_iterations=max_iter),
            regularization=JaxReg("L2"), reg_weight=reg,
        ),
        normalization=jnorm, prior=jprior,
    )
    tp = GLMProblem(
        task=task,
        config=GLMOptimizationConfig(
            optimizer=OptimizerConfig(optimizer_type=optimizer, tolerance=tol, max_iterations=max_iter),
            regularization=RegularizationContext("L2"), reg_weight=reg,
        ),
        normalization=tnorm, prior=tprior,
    )
    return jp, tp


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
@pytest.mark.parametrize("task", ["logistic_regression", "linear_regression", "poisson_regression"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_matches_reference(rng, optimizer, task, dtype):
    x, y, off, wt = (a.astype(dtype) for a in _data(rng, task=task))
    jp, tp = _problems(task, optimizer, tol=1e-6 if dtype == "float32" else 1e-9)
    jm, jr = jp.run(jax_batch(x, y, offsets=off, weights=wt, dtype=jnp.dtype(dtype)))
    tm, tr = tp.run(
        batch_from_dense(x, y, offsets=off, weights=wt, dtype=getattr(torch, dtype), device="cpu")
    )
    assert tm.coefficients.means.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means), rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=1e-5)
    assert tr.reason == int(jr.reason) and tr.iterations > 0
    assert tm.coefficients.variances is None


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_solve_with_normalization_prior_and_warm_start(rng, optimizer):
    """Normalization shift/factor algebra, prior-centred L2 and a warm start,
    all carried across with ``convert``. Float64 at tolerance 1e-9: in f32
    this problem reaches the loss's resolution before 1e-6 stops it (see the
    module docstring); the objective-level f32 parity of the same algebra is
    in tests/test_torch_ops.py."""
    f64 = np.float64
    x, y, off, wt = (a.astype(f64) for a in _data(rng))
    factors = 1.0 / (rng.random(D) + 0.5)
    shifts = x.mean(axis=0) * 0.5
    factors[-1], shifts[-1] = 1.0, 0.0
    prior_means = rng.standard_normal(D) * 0.05
    prior_vars = rng.random(D) + 0.5
    w_init = rng.standard_normal(D) * 0.01

    jp, tp = _problems(
        "logistic_regression", optimizer, tol=1e-9, reg=2.0,
        jnorm=JaxNorm(jnp.asarray(factors), jnp.asarray(shifts), D - 1),
        tnorm=convert.normalization_from_numpy(factors, shifts, D - 1, dtype=torch.float64, device="cpu"),
        jprior=JaxCoefficients(jnp.asarray(prior_means), jnp.asarray(prior_vars)),
        tprior=convert.coefficients_from_numpy(prior_means, prior_vars, dtype=torch.float64, device="cpu"),
    )
    j_init = jax_model_for_task("logistic_regression", JaxCoefficients(jnp.asarray(w_init)))
    t_init = convert.model_from_numpy("logistic_regression", w_init, dtype=torch.float64, device="cpu")
    jm, jr = jp.run(
        jax_batch(x, y, offsets=off, weights=wt, dtype=jnp.float64), initial_model=j_init
    )
    tm, tr = tp.run(
        batch_from_dense(x, y, offsets=off, weights=wt, dtype=torch.float64, device="cpu"),
        initial_model=t_init,
    )
    task, means, variances = convert.model_to_numpy(tm)
    assert task == "logistic_regression" and variances is None
    assert tr.iterations > 1 and tr.reason != 0
    np.testing.assert_allclose(means, np.asarray(jm.coefficients.means), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=1e-9)


def test_slice_end_to_end_train_score_auc(rng):
    """The slice as a user drives it: batch_from_dense -> GLMProblem.run
    (TRON, the bench's fixed-effect settings) -> model.score -> auc, against
    the JAX package on the same data; then the JAX-trained model carried over
    with ``convert`` scores identically in the port."""
    x, y = _signal_data(rng)
    jp, tp = _problems("logistic_regression", "TRON", tol=1e-6, max_iter=10)
    jb = jax_batch(x, y, dtype=jnp.float32)
    tb = batch_from_dense(x, y, device="cpu")
    jm, jr = jp.run(jb)
    tm, tr = tp.run(tb)
    j_scores = np.asarray(jm.score(jb))
    t_scores = tm.score(tb)
    assert t_scores.shape == (N,) and torch.isfinite(t_scores).all()
    j_auc = float(JAX_METRICS["AUC"](jnp.asarray(j_scores), jnp.asarray(y), jnp.ones(N, jnp.float32)))
    t_auc = float(auc(t_scores, tb.labels, tb.weights))
    assert 0.7 < t_auc < 1.0
    np.testing.assert_allclose(t_auc, j_auc, atol=1e-4)
    np.testing.assert_allclose(t_auc, area_under_roc_curve(t_scores.numpy(), y), atol=1e-9)
    carried = convert.model_from_numpy(
        "logistic_regression", np.asarray(jm.coefficients.means), device="cpu"
    )
    np.testing.assert_allclose(carried.score(tb).numpy(), j_scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        carried.predict_mean(tb).numpy(), np.asarray(jm.predict_mean(jb)), rtol=1e-5, atol=1e-6
    )


def test_device_metrics_match_reference(rng):
    """AUC (with tied scores and weights) and the pointwise metrics."""
    n = 3000
    s = np.round(rng.standard_normal(n), 1).astype(F32)  # many ties
    y = (rng.random(n) > 0.4).astype(F32)
    w = (rng.random(n) + 0.1).astype(F32)
    for name, fn in DEVICE_METRICS.items():
        got = float(fn(torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(w)))
        ref = float(JAX_METRICS[name](jnp.asarray(s), jnp.asarray(y), jnp.asarray(w)))
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
    one_class = torch.ones(10)
    assert np.isnan(float(auc(torch.arange(10.0), one_class, one_class)))


@pytest.mark.parametrize("optimizer", ["TRON", "LBFGS"])
def test_one_sync_per_evaluation(rng, optimizer):
    """The host loop waits on the device once per objective evaluation
    (value+gradient, or H v): the count PERF.md reports per TRON iteration
    is 1 + the iteration's CG steps."""
    x, y, off, wt = _data(rng, n=512, d=16)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, device="cpu"), l2=1.0)
    calls = {"vg": 0, "hv": 0}

    def vg(w):
        calls["vg"] += 1
        return obj.value_and_grad(w)

    def hv(w, v):
        calls["hv"] += 1
        return obj.hessian_vector(w, v)

    res = optimize(vg, torch.zeros(16), OptimizerConfig(optimizer_type=optimizer, tolerance=1e-8), hvp=hv)
    assert res.syncs == calls["vg"] + calls["hv"]
    assert res.iterations > 0 and res.reason != 0
    assert res.loss_history.shape == (res.iterations + 1,) or np.isnan(res.loss_history.numpy()[-1])


def test_unported_paths_raise(rng):
    x, y, _, _ = _data(rng, n=64, d=4)
    batch = batch_from_dense(x, y, device="cpu")
    # OWL-QN (L1) and L-BFGS-B (box constraints) are ported
    # (tests/test_torch_owlqn.py): they run; what remains refused is named
    base = GLMOptimizationConfig(regularization=RegularizationContext("L1"), reg_weight=1.0)
    _, res = GLMProblem("logistic_regression", base).run(batch)
    assert res.reason != 0 and bool(torch.isfinite(res.loss))
    boxed = GLMOptimizationConfig(
        optimizer=OptimizerConfig(box_constraints=(-0.1 * torch.ones(4), 0.1 * torch.ones(4)))
    )
    model, res = GLMProblem("logistic_regression", boxed).run(batch)
    assert float(model.coefficients.means.abs().max()) <= 0.1 and res.reason != 0
    # the tiled layout is ported (tests/test_torch_tiled.py): without a mesh
    # it is refused in the JAX package's words, on a 1 x 1 grid it builds;
    # so is the dense feature-axis shard (tests/test_torch_feature_shard.py):
    # a 1 x 1 grid's tile is the whole batch and solves as it does
    from photon_ml_tpu_torch.parallel import make_mesh, shard_batch

    raw = RawDataset(n_rows=64, labels=y, offsets=np.zeros(64), weights=np.ones(64),
                     shard_coo={"s": (np.zeros(1, int), np.zeros(1, int), np.ones(1))}, shard_dims={"s": 4},
                     id_tags={})
    with pytest.raises(ValueError, match="layout='tiled' requires a device mesh"):
        raw.to_batch("s", layout="tiled", device="cpu")
    assert raw.to_batch("s", layout="tiled", mesh=make_mesh(1, 1, device="cpu")).features.layout == "tiled"
    b64 = batch_from_dense(x, y, dtype=torch.float64, device="cpu")
    tb = shard_batch(b64, make_mesh(1, 1, device="cpu"), shard_features_dim=True)
    assert tb.features.layout == "tiled" and torch.equal(tb.features.to_dense(), b64.features.dense)
    fit = lambda b: GLMProblem("logistic_regression", GLMOptimizationConfig()).run(b)[0]  # noqa: E731
    torch.testing.assert_close(fit(tb).coefficients.means, fit(b64).coefficients.means, rtol=1e-6, atol=1e-9)
    # FULL variance is ported (tests/test_torch_variance.py): it runs
    model, _ = GLMProblem("logistic_regression", GLMOptimizationConfig(variance_type="FULL")).run(batch)
    var = model.coefficients.variances
    assert var.shape == (4,) and bool(torch.isfinite(var).all()) and bool((var > 0).all())
    # the streamed solve is ported (tests/test_torch_fe_streaming.py): over
    # the batch's rows in host memory it is the resident solve
    from photon_ml_tpu_torch.game.data import HostRowBatch

    host = HostRowBatch(dim=4, labels=batch.labels, offsets=batch.offsets, weights=batch.weights,
                        dense=batch.features.dense)
    resident, _ = GLMProblem("logistic_regression", GLMOptimizationConfig()).run(batch)
    streamed, _ = GLMProblem("logistic_regression", GLMOptimizationConfig()).run_streamed(host, 256, device="cpu")
    torch.testing.assert_close(streamed.coefficients.means, resident.coefficients.means, rtol=1e-3, atol=1e-5)
    # the lane solve is ported (tests/test_torch_lanes.py): each lane is its
    # single-lane solve at the packed solve's bound
    l2 = GLMOptimizationConfig(regularization=RegularizationContext("L2"))
    W, res = GLMProblem("logistic_regression", l2).run_lanes(
        batch, torch.zeros((64, 2)), torch.tensor([0.5, 5.0]))
    assert W.shape == (4, 2) and res.reason.shape == (2,)
    for k, lam in enumerate((0.5, 5.0)):
        model, _ = GLMProblem("logistic_regression", l2.with_reg_weight(lam)).run(batch)
        torch.testing.assert_close(W[:, k], model.coefficients.means, atol=5e-3, rtol=0)


def test_tron_with_box_projects(rng):
    """TRON projects each accepted step into the box, as the reference's
    host-loop TRON does."""
    x, y, _, _ = _data(rng, n=800, d=8)
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(
            optimizer_type="TRON", box_constraints=(torch.full((8,), -0.05), torch.full((8,), 0.05))
        ),
        regularization=RegularizationContext("L2"), reg_weight=0.1,
    )
    m, r = GLMProblem("logistic_regression", cfg).run(batch_from_dense(x, y, device="cpu"))
    w = m.coefficients.means
    assert float(w.abs().max()) <= 0.05 + 1e-7 and r.iterations > 0
