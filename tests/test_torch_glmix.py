"""Parity of the port's GLMix slice with the JAX package, on the CPU: SIMPLE
variances (kernel B3's plain version), the random-effect dataset build, the
random-effect scores, and a whole two-coordinate coordinate descent.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``photon_ml_tpu_torch`` (``device="cpu"``). Bounds are the
JAX suite's own:

- Hessian diagonal: max-abs error <= 3e-5 * max(|ref|, 1), against the
  Pallas kernel in interpret mode and against the unfused path
  (tests/test_pallas_glm.py); bf16 X: <= 1e-2 * max|ref|, the suite's bf16
  fused-vs-unfused bound (tests/test_bf16_features.py);
- fixed-effect coefficients and variances: rtol 1e-3, atol 1e-5
  (tests/test_pallas_glm.py::test_end_to_end_solve_matches_unfused);
- random-effect coefficients atol 5e-3, loss atol 1e-4
  (tests/test_packed_solver.py);
- the random-effect dataset build: exactly equal arrays.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import build_suite as jax_build_suite
from photon_ml_tpu.game import CoordinateDescent as JaxCD
from photon_ml_tpu.game import FixedEffectCoordinate as JaxFEC
from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game import RandomEffectCoordinate as JaxREC
from photon_ml_tpu.game import ValidationContext as JaxValidation
from photon_ml_tpu.game.coordinate import _size_buckets as jax_size_buckets
from photon_ml_tpu.game.data import FixedEffectDataset as JaxFEDataset
from photon_ml_tpu.game.data import build_random_effect_dataset as jax_build_re
from photon_ml_tpu.io.data import RawDataset as JaxRaw
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch
from photon_ml_tpu.ops.glm import GLMObjective as JaxObjective
from photon_ml_tpu.ops.glm import compute_variances as jax_compute_variances
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOptConfig
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.evaluation import build_suite
from photon_ml_tpu_torch.game import (
    CoordinateDescent,
    FixedEffectCoordinate,
    FixedEffectDataset,
    GLMOptimizationConfig,
    GLMProblem,
    RandomEffectCoordinate,
    ValidationContext,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game.coordinate import _size_buckets, _train_blocks_packed
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.models.game import (
    ell_row_subspace,
    score_entity_ell,
    score_entity_rows_dense,
)
from photon_ml_tpu_torch.ops import fused_glm
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig

D = 256
TN = pallas_glm.tile_rows(D, 4, parts=2)  # the Hessian-stats tile
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hdiag_bound(got, ref, what, rel=3e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref))
    bound = rel * max(np.max(np.abs(ref)), 1.0)
    assert err <= bound, f"{what}: max-abs error {err:.3e} > bound {bound:.3e}"


def _hd_data(rng, n, loss_name):
    x = rng.standard_normal((n, D)).astype(F32)
    y = (rng.random(n) > 0.5).astype(F32) * (2 if loss_name == "poisson" else 1)
    off = (rng.standard_normal(n) * 0.1).astype(F32)
    wt = (rng.random(n) + 0.5).astype(F32)
    return x, y, off, wt


def _norms(rng, kind):
    if kind == "none":
        return None, None
    factors = (rng.random(D) + 0.5).astype(F32)
    shifts = ((rng.random(D) - 0.5) * 0.2).astype(F32) if kind == "shifts" else None
    factors[0] = 1.0
    if shifts is not None:
        shifts[0] = 0.0
    jn = JaxNorm(
        factors=jnp.asarray(factors), shifts=None if shifts is None else jnp.asarray(shifts),
        intercept_index=0,
    )
    tn = NormalizationContext(
        factors=_t(factors), shifts=None if shifts is None else _t(shifts), intercept_index=0
    )
    return jn, tn


# ---------------------------------------------------------------- B3 / SIMPLE


@pytest.mark.parametrize("loss_name", sorted(LOSSES))
@pytest.mark.parametrize("norm_kind", ["none", "factors", "shifts"])
@pytest.mark.parametrize("n", [2 * TN, TN + 7], ids=["aligned", "ragged"])
def test_hessian_diagonal_and_simple_variances_match_jax(rng, loss_name, norm_kind, n):
    """hessian_diagonal and compute_variances("SIMPLE") against the JAX
    package's Pallas kernel (interpret mode) and its unfused path, with the
    prior-centred L2 of incremental training."""
    x, y, off, wt = _hd_data(rng, n, loss_name)
    jn, tn = _norms(rng, norm_kind)
    pp = (rng.random(D) + 0.5).astype(F32)
    w = (rng.standard_normal(D) * 0.1).astype(F32)
    base = JaxObjective(
        loss=JAX_LOSSES[loss_name], batch=jax_batch(x, y, offsets=off, weights=wt, dtype=jnp.float32),
        l2=0.3, norm=jn, prior_precision=jnp.asarray(pp),
    )
    fused = dataclasses.replace(base, fused="interpret")
    port = GLMObjective(
        loss=LOSSES[loss_name], batch=batch_from_dense(x, y, off, wt, device="cpu"),
        l2=0.3, norm=tn, prior_precision=_t(pp),
    )
    got = port.hessian_diagonal(_t(w)).numpy()
    for ref, what in ((fused, "vs Pallas interpret"), (base, "vs unfused")):
        _hdiag_bound(got, ref.hessian_diagonal(jnp.asarray(w)), f"Hdiag {what}")
    var = compute_variances(port, _t(w), "SIMPLE").numpy()
    jvar = np.asarray(jax_compute_variances(fused, jnp.asarray(w), "SIMPLE"))
    # variance = 1 / diag: hold the diagonals behind them at the Hdiag bound
    _hdiag_bound(1.0 / var, 1.0 / jvar, "1 / SIMPLE variance")
    assert fused_glm.LAUNCHES["fused_hessian_stats"] == 0  # CPU: the plain version


def test_raw_hessian_stats_match_the_pallas_kernel(rng):
    """The three aggregates themselves, with and without shifts, against
    ``pallas_glm.fused_hessian_stats`` in interpret mode; the float64 plain
    version agrees with the f32 one within the same bound."""
    x, y, off, wt = _hd_data(rng, TN + 7, "logistic")
    coef = (rng.standard_normal(D) * 0.1).astype(F32)
    loss = LOSSES["logistic"]
    for need_shifts in (False, True):
        j2, j1, j0 = pallas_glm.fused_hessian_stats(
            jnp.asarray(x), jnp.asarray(coef), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt),
            JAX_LOSSES["logistic"], interpret=True, need_shifts=need_shifts,
        )
        s2, s1, s0 = fused_glm.fused_hessian_stats(_t(x), _t(coef), _t(y), _t(off), _t(wt), loss, need_shifts)
        _hdiag_bound(s2, j2, "s2")
        r2, r1, r0 = fused_glm.hessian_stats_plain(
            _t(x), _t(coef), _t(y), _t(off), _t(wt), loss, need_shifts, compute_dtype=torch.float64
        )
        _hdiag_bound(s2, r2, "s2 vs float64 plain")
        if need_shifts:
            _hdiag_bound(s1, j1, "s1")
            _hdiag_bound(s1, r1, "s1 vs float64 plain")
            np.testing.assert_allclose(float(s0), float(j0), rtol=2e-6)
            np.testing.assert_allclose(float(s0), float(r0), rtol=2e-6)
        else:
            assert s1 is None and s0 is None and j1 is None


def test_bf16_variances_match_jax_at_the_bf16_bound(rng):
    """bf16 X: the port squares x exactly in f32 and rounds c to bf16; the
    TPU kernel also rounds x*x to bf16. Held at the JAX suite's bf16 bound."""
    x, y, off, wt = _hd_data(rng, 2 * TN, "logistic")
    w = (rng.standard_normal(D) * 0.1).astype(F32)
    jb = jax_batch(x, y, offsets=off, weights=wt, feature_dtype=jnp.bfloat16)
    tb = batch_from_dense(x, y, off, wt, feature_dtype=torch.bfloat16, device="cpu")
    got = GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=0.1).hessian_diagonal(_t(w)).numpy()
    for fused in ("interpret", None):
        ref = JaxObjective(loss=JAX_LOSSES["logistic"], batch=jb, l2=0.1, fused=fused)
        _hdiag_bound(got, ref.hessian_diagonal(jnp.asarray(w)), f"bf16 Hdiag fused={fused}", rel=1e-2)


def test_zero_diagonal_pins_variance_to_one(rng):
    """A column with no data and no L2 has a zero diagonal: its variance is
    pinned to 1, as in the JAX package."""
    x, y, off, wt = _hd_data(rng, 300, "logistic")
    x[:, 3] = 0.0
    w = np.zeros(D, F32)
    port = GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, off, wt, device="cpu"))
    ref = JaxObjective(loss=JAX_LOSSES["logistic"], batch=jax_batch(x, y, offsets=off, weights=wt))
    var = compute_variances(port, _t(w), "SIMPLE").numpy()
    jvar = np.asarray(jax_compute_variances(ref, jnp.asarray(w), "SIMPLE"))
    assert var[3] == 1.0 == jvar[3]
    np.testing.assert_allclose(var, jvar, rtol=1e-5)


# ------------------------------------------------------- random-effect build


def _glmix_data(seed, n=3000, d_fixed=12, n_users=60, d_re=5):
    """bench.py's build_data at a small size: dense fixed-effect features
    with a constant last column, Zipf-skewed user assignment, per-user
    features with an intercept column, logistic labels."""
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((n, d_fixed), dtype=np.float32)
    gx[:, -1] = 1.0
    w = (rng.standard_normal(d_fixed) / np.sqrt(d_fixed)).astype(gx.dtype)
    z = gx @ w
    probs = 1.0 / np.arange(1, n_users + 1) ** 1.1
    probs /= probs.sum()
    assign = rng.choice(n_users, size=n, p=probs)
    ex = rng.standard_normal((n, d_re), dtype=np.float32)
    ex[:, -1] = 1.0
    w_u = (rng.standard_normal((n_users, d_re)) * 1.5 / np.sqrt(d_re)).astype(ex.dtype)
    z = z + np.einsum("nd,nd->n", ex, w_u[assign])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(gx.dtype)
    ids = np.char.add("u", assign.astype(str)).astype(object)
    return gx, y, ex, ids


def _raw_pair(gx, y, ex, ids, sparse_every=0):
    """The same RawDataset for both packages; ``sparse_every`` zeroes some
    per-user feature values so subspaces differ by entity."""
    n, d_re = ex.shape
    rows = np.repeat(np.arange(n), d_re)
    cols = np.tile(np.arange(d_re), n)
    vals = ex.reshape(-1).astype(np.float64)
    if sparse_every:
        keep = (rows % sparse_every != 0) | (cols == d_re - 1)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    kw = dict(
        n_rows=n, labels=y.astype(np.float64), offsets=np.zeros(n), weights=np.ones(n),
        shard_coo={"userShard": (rows, cols, vals)}, shard_dims={"userShard": d_re},
        id_tags={"userId": ids},
    )
    return JaxRaw(**kw), RawDataset(**kw)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(active_cap=16),
        dict(active_cap=24, active_lower_bound=5, seed=3),
        dict(active_cap=32, features_to_samples_ratio=0.2),
        dict(pad_entities_to_multiple=8, active_lower_bound=2),
    ],
    ids=["plain", "cap", "cap-lower-bound", "pearson", "padded"],
)
def test_random_effect_build_equals_jax_exactly(kw):
    gx, y, ex, ids = _glmix_data(0, n=2000, n_users=50)
    jraw, traw = _raw_pair(gx, y, ex, ids, sparse_every=3)
    jd = jax_build_re(jraw, "per-user", "userShard", "userId", dtype=jnp.float32, **kw)
    td = build_random_effect_dataset(traw, "per-user", "userShard", "userId", device="cpu", **kw)
    jb, tb = jd.blocks, td.blocks
    for name in ("features", "labels", "offsets", "weights", "proj_cols", "active_rows"):
        a, b = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("row_entity", "ell_idx", "ell_val"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)), err_msg=name)
    for name in ("entity_ids", "passive_rows", "entity_counts", "entity_subspace_dims"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name), err_msg=name)
    assert _size_buckets(td) == jax_size_buckets(jd)
    if "active_cap" in kw:
        assert tb.features.shape[1] <= kw["active_cap"]


def test_size_buckets_at_a_skewed_shape():
    """Enough rows per head user that several power-of-two K buckets form."""
    gx, y, ex, ids = _glmix_data(4, n=6000, n_users=300)
    jraw, traw = _raw_pair(gx, y, ex, ids)
    jd = jax_build_re(jraw, "per-user", "userShard", "userId", active_cap=256)
    td = build_random_effect_dataset(traw, "per-user", "userShard", "userId", active_cap=256, device="cpu")
    buckets = _size_buckets(td)
    assert buckets == jax_size_buckets(jd) and len(buckets) >= 3


def test_ell_row_subspace_is_the_sum_of_each_rows_hits():
    """The slot-by-slot scatter adds duplicate columns of a row into one
    position and scores as the searchsorted path does."""
    ci = torch.tensor([[1, 4, 7, -1], [0, 2, -1, -1]], dtype=torch.int32)
    rows = torch.tensor([0, 1, 0, -1], dtype=torch.int32)
    fi = torch.tensor([[4, 4, 9], [2, 0, 0], [1, 7, 0], [1, 2, 3]], dtype=torch.int32)
    fv = torch.tensor([[1.0, 2.0, 5.0], [3.0, 4.0, 0.0], [0.5, 0.25, 0.0], [1.0, 1.0, 1.0]])
    xs = ell_row_subspace(ci, rows, fi, fv)
    want = torch.tensor([[0, 3.0, 0, 0], [4.0, 3.0, 0, 0], [0.5, 0, 0.25, 0], [0, 0, 0, 0]])
    torch.testing.assert_close(xs[:3], want[:3])
    vals = torch.tensor([[1.0, 2.0, 3.0, 0.0], [-1.0, 0.5, 0.0, 0.0]])
    s = score_entity_ell(ci, vals, rows, fi, fv)
    torch.testing.assert_close(s, torch.tensor([6.0, -2.5, 1.25, 0.0]))
    torch.testing.assert_close(score_entity_rows_dense(vals, rows, xs), s)


# ------------------------------------------------------ coordinate descent


def _configs(variance="SIMPLE", re_iter=30):
    fe_opt = dict(optimizer_type="TRON", tolerance=1e-6, max_iterations=10)
    re_opt = dict(tolerance=1e-6, max_iterations=re_iter)
    reg = dict(reg_weight=1.0)
    jfe = JaxConfig(optimizer=JaxOptConfig(**fe_opt), regularization=JaxReg("L2"), variance_type=variance, **reg)
    jre = JaxConfig(optimizer=JaxOptConfig(**re_opt), regularization=JaxReg("L2"), **reg)
    tfe = GLMOptimizationConfig(
        optimizer=OptimizerConfig(**fe_opt), regularization=RegularizationContext("L2"),
        variance_type=variance, **reg,
    )
    tre = GLMOptimizationConfig(optimizer=OptimizerConfig(**re_opt), regularization=RegularizationContext("L2"), **reg)
    return jfe, jre, tfe, tre


def _coordinates(gx, y, ex, ids, dtype, active_cap=64):
    jraw, traw = _raw_pair(gx, y, ex, ids)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jfe_cfg, jre_cfg, tfe_cfg, tre_cfg = _configs()
    jfe_ds = JaxFEDataset("global", "global", batch=jax_batch(gx, y, dtype=jdt))
    jre_ds = jax_build_re(jraw, "per-user", "userShard", "userId", active_cap=active_cap, dtype=jdt)
    tfe_ds = FixedEffectDataset("global", "global", batch=batch_from_dense(gx, y, dtype=dtype, device="cpu"))
    tre_ds = build_random_effect_dataset(
        traw, "per-user", "userShard", "userId", active_cap=active_cap, dtype=dtype, device="cpu"
    )
    jc = {
        "global": JaxFEC(dataset=jfe_ds, task="logistic_regression", config=jfe_cfg),
        "per-user": JaxREC(dataset=jre_ds, task="logistic_regression", config=jre_cfg),
    }
    tc = {
        "global": FixedEffectCoordinate(dataset=tfe_ds, task="logistic_regression", config=tfe_cfg),
        "per-user": RandomEffectCoordinate(dataset=tre_ds, task="logistic_regression", config=tre_cfg),
    }
    return jc, tc


def _validation(coords, labels, suite_fn):
    return dict(
        suite=suite_fn(["AUC", "LOGISTIC_LOSS"], labels),
        score_fns={name: (lambda m, c=c: c.score(m)) for name, c in coords.items()},
        offsets=np.zeros(len(labels)),
    )


@pytest.mark.parametrize("dtype,sweeps", [(torch.float64, 2), (torch.float32, 1)], ids=["f64", "f32"])
def test_coordinate_descent_matches_jax(dtype, sweeps):
    """Two coordinates (FE TRON with SIMPLE variance, per-user packed
    L-BFGS), validation AUC after every update: the same models, the same
    per-update metrics and the same best model.

    Float64 runs two sweeps and holds every bound on the models and the
    per-entity losses. Float32 runs one sweep at the bench's tolerance
    1e-6, where a solve stops on its loss tolerance at an iterate that
    depends on the summation order (the fixed effect's coefficients spread
    by ~4e-4 here, above rtol 1e-3 on its small entries), and the random
    effect then trains on residuals that differ by that spread. So in
    float32 the fixed effect is held by the loss its coefficients reach
    (rtol 1e-5, the port's f32 convention since the fixed-effect slice), and
    the random effect is held on identical inputs: the port's coordinate
    retrained on the JAX fixed effect's scores, against the JAX model."""
    gx, y, ex, ids = _glmix_data(1)
    jc, tc = _coordinates(gx, y, ex, ids, dtype)
    jv, tv = _validation(jc, y, jax_build_suite), _validation(tc, y, build_suite)
    jr = JaxCD(jc, n_iterations=sweeps, validation=JaxValidation(**jv)).run()
    tr = CoordinateDescent(tc, n_iterations=sweeps, validation=ValidationContext(**tv)).run()

    tf, jf = tr.model["global"].coefficients, jr.model["global"].coefficients
    np.testing.assert_allclose(tf.variances.numpy(), np.asarray(jf.variances), rtol=1e-3, atol=1e-5)
    jre = jr.model["per-user"]
    jre_loss = np.asarray(jr.trackers["per-user"].result.loss)
    if dtype == torch.float64:
        np.testing.assert_allclose(tf.means.numpy(), np.asarray(jf.means), rtol=1e-3, atol=1e-5)
        tre, tre_loss = tr.model["per-user"], tr.solver_results["per-user"].loss
    else:
        # one sweep: the fixed effect trained first, on the base offsets
        fe = tc["global"]
        obj = GLMProblem(fe.task, fe.config).objective(fe.dataset.batch)
        j_fe_loss = float(jr.trackers["global"].result.loss)
        np.testing.assert_allclose(float(obj.value(tf.means)), j_fe_loss, rtol=1e-5)
        carried_fe = convert.game_model_from_numpy(
            {"task": "logistic_regression", "models": {"global": {
                "kind": "fixed", "feature_shard": "global", "task": "logistic_regression",
                "means": np.asarray(jf.means), "variances": None,
            }}}, dtype=dtype, device="cpu",
        )["global"]
        tre, tre_res = tc["per-user"].train(fe.score(carried_fe), None)
        tre_loss = tre_res.loss
    assert list(tre.entity_ids) == list(jre.entity_ids)
    np.testing.assert_array_equal(tre.coef_indices.numpy(), np.asarray(jre.coef_indices))
    np.testing.assert_allclose(tre.coef_values.numpy(), np.asarray(jre.coef_values), atol=5e-3)
    np.testing.assert_allclose(tre_loss.numpy(), jre_loss, atol=1e-4)

    # the evaluation ledger: the same updates, the same metrics (AUC to
    # 1e-4 absolute, a rank statistic over scores that agree to the bounds
    # above), the same best model
    assert [name for name, _ in tr.evaluations] == [name for name, _ in jr.evaluations]
    for (_, te), (_, je) in zip(tr.evaluations, jr.evaluations):
        np.testing.assert_allclose(te.metrics["AUC"], je.metrics["AUC"], atol=1e-4)
        np.testing.assert_allclose(te.metrics["LOGISTIC_LOSS"], je.metrics["LOGISTIC_LOSS"], rtol=1e-4)
    best_t = [e for _, e in tr.evaluations].index(tr.best_evaluation)
    best_j = [e for _, e in jr.evaluations].index(jr.best_evaluation)
    assert best_t == best_j
    assert tr.best_evaluation.primary_metric > 0.7
    # syncs: each update's solver fetches plus one guard fetch
    assert tr.syncs["global"] >= sweeps * 2 and tr.syncs["per-user"] >= sweeps * 2


def test_re_scores_of_a_carried_across_model():
    """A JAX-trained random-effect model carried over with ``convert``
    scores the same rows to 1e-6, both in the dataset's own entity order
    (the densified fast path) and permuted (the searchsorted path)."""
    gx, y, ex, ids = _glmix_data(2, n=1500, n_users=40)
    jc, tc = _coordinates(gx, y, ex, ids, torch.float32)
    jmodel, _ = jc["per-user"].train(None, None)
    jscores = np.asarray(jc["per-user"].score(jmodel))
    parts = {
        "random_effect_type": jmodel.random_effect_type, "feature_shard": jmodel.feature_shard,
        "task": jmodel.task, "entity_ids": np.asarray(jmodel.entity_ids),
        "coef_indices": np.asarray(jmodel.coef_indices), "coef_values": np.asarray(jmodel.coef_values),
    }
    carried = convert.random_effect_model_from_numpy(**parts, device="cpu")
    np.testing.assert_allclose(tc["per-user"].score(carried).numpy(), jscores, atol=1e-6)
    perm = np.random.default_rng(0).permutation(len(parts["entity_ids"]))
    shuffled = convert.random_effect_model_from_numpy(
        **{**parts, **{k: parts[k][perm] for k in ("entity_ids", "coef_indices", "coef_values")}},
        device="cpu",
    )
    np.testing.assert_allclose(tc["per-user"].score(shuffled).numpy(), jscores, atol=1e-6)
    # and a warm start from the permuted model reaches the same solve
    m_warm, _ = tc["per-user"].train(None, shuffled)
    m_cold, _ = tc["per-user"].train(None, carried)
    np.testing.assert_allclose(m_warm.coef_values.numpy(), m_cold.coef_values.numpy(), atol=1e-6)


def test_game_model_round_trips_through_numpy():
    gx, y, ex, ids = _glmix_data(3, n=800, n_users=20)
    _, tc = _coordinates(gx, y, ex, ids, torch.float32)
    result = CoordinateDescent(tc, n_iterations=1).run()
    parts = convert.game_model_to_numpy(result.model)
    back = convert.game_model_from_numpy(parts, device="cpu")
    again = convert.game_model_to_numpy(back)
    assert again["task"] == parts["task"] == "logistic_regression"
    for name, p in parts["models"].items():
        for key, value in p.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(again["models"][name][key], value)
            else:
                assert again["models"][name][key] == value
    for name, c in tc.items():
        torch.testing.assert_close(c.score(back[name]), c.score(result.model[name]))


class _PoisonedCoordinate:
    """Wraps a coordinate; from its ``poison_from``-th update on, the
    returned model scores NaN."""

    def __init__(self, inner, poison_from):
        self.inner, self.poison_from, self.calls = inner, poison_from, 0
        self.coordinate_id, self.task = inner.coordinate_id, inner.task

    @property
    def n_rows(self):
        return self.inner.n_rows

    def train(self, residual, initial_model=None):
        self.calls += 1
        model, result = self.inner.train(residual, initial_model)
        return (("poisoned", model) if self.calls >= self.poison_from else model), result

    def score(self, model):
        if isinstance(model, tuple):
            return torch.full((self.n_rows,), math.nan)
        return self.inner.score(model)


def test_divergence_guard_rejects_non_finite_scores():
    """An update whose scores are NaN is rejected: the previous model and
    scores stand, the summed scores stay finite, and the other coordinate
    trains on as before."""
    gx, y, ex, ids = _glmix_data(5, n=1200, n_users=30)
    _, tc = _coordinates(gx, y, ex, ids, torch.float32)
    first, _ = tc["per-user"].train(None, None)
    poisoned = dict(tc, **{"per-user": _PoisonedCoordinate(tc["per-user"], poison_from=2)})
    cd = CoordinateDescent(poisoned, n_iterations=2, validation=ValidationContext(**_validation(poisoned, y, build_suite)))
    result = cd.run()
    assert result.rejections == {"global": 0, "per-user": 1}
    kept = result.model["per-user"]
    assert not isinstance(kept, tuple)
    # only three updates were accepted, and each was evaluated
    assert [name for name, _ in result.evaluations] == ["global", "per-user", "global"]
    assert all(math.isfinite(e.primary_metric) for _, e in result.evaluations)
    # the kept per-user model is the first sweep's, trained on the first
    # sweep's residual
    fe_first, _ = tc["global"].train(None, None)
    res1 = tc["global"].score(fe_first)
    m1, _ = tc["per-user"].train(res1, None)
    torch.testing.assert_close(kept.coef_values, m1.coef_values)
    assert not torch.equal(first.coef_values, kept.coef_values)
    # without the guard the NaN scores flow into the sums
    unguarded = CoordinateDescent(
        dict(tc, **{"per-user": _PoisonedCoordinate(tc["per-user"], poison_from=2)}),
        n_iterations=2, divergence_guard=False,
    ).run()
    assert isinstance(unguarded.model["per-user"], tuple)


def test_device_evaluation_matches_the_jax_suite(rng):
    n = 500
    s = rng.standard_normal(n).astype(F32)
    y = (rng.random(n) > 0.4).astype(F32)
    w = (rng.random(n) + 0.5).astype(F32)
    specs = ["AUC", "RMSE", "LOGISTIC_LOSS", "SQUARED_LOSS", "POISSON_LOSS", "SMOOTHED_HINGE_LOSS"]
    jsuite = jax_build_suite(specs, y, w)
    tsuite = build_suite(specs, y, w)
    want = jsuite.evaluate(s).metrics
    got_dev = tsuite.evaluate_device(_t(s)).metrics
    got_host = tsuite.evaluate(_t(s)).metrics
    for k in specs:
        np.testing.assert_allclose(got_host[k], want[k], rtol=1e-12)
        np.testing.assert_allclose(got_dev[k], want[k], rtol=1e-5)
    assert build_suite(["AUC:userId"], y).evaluate_device(_t(s)) is None


def test_unported_glmix_paths_raise():
    gx, y, ex, ids = _glmix_data(6, n=400, n_users=10)
    _, tc = _coordinates(gx, y, ex, ids, torch.float32)
    fe, re_ = tc["global"], tc["per-user"]
    # down-sampling, the random effect's TRON and the vmapped solve run now
    # (tests/test_torch_sampling.py, tests/test_torch_re_solvers.py)
    model, res = dataclasses.replace(fe, config=dataclasses.replace(fe.config, down_sampling_rate=0.5)).train(None)
    assert bool(torch.isfinite(res.loss)) and res.reason != 0
    model, _ = re_.train(None, None)
    # the prior-model solve runs (tests/test_torch_incremental.py holds it
    # against the JAX package): a strong prior weight pins it at the prior
    pinned = dataclasses.replace(re_.config, reg_weight=1e6)
    again, res = dataclasses.replace(re_, config=pinned, prior_model=model).train(None)
    assert bool(torch.isfinite(res.loss).all()) and bool((res.reason != 0).all())
    assert float((again.coef_values - model.coef_values).abs().max()) < 1e-3
    tron = dataclasses.replace(
        re_.config, optimizer=dataclasses.replace(re_.config.optimizer, optimizer_type="TRON")
    )
    _, res = dataclasses.replace(re_, config=tron).train(None)
    assert bool(torch.isfinite(res.loss).all()) and bool((res.reason != 0).all())
    # streamed datasets are ported (tests/test_torch_streaming.py): a
    # streamed dataset holds its host rows, not a batch, and a budget below
    # the blocks streams them; the vmapped streamed solve is the in-memory
    # one's bits
    with pytest.raises(ValueError, match="host_batch"):
        FixedEffectDataset("g", "g", batch=fe.dataset.batch, streamed=True)
    traw = _raw_pair(gx, y, ex, ids)[1]
    streamed = build_random_effect_dataset(traw, "r", "userShard", "userId", hbm_budget_bytes=1, device="cpu")
    resident = build_random_effect_dataset(traw, "r", "userShard", "userId", device="cpu")
    assert streamed.streamed and streamed.blocks.features.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="A10"):
        dataclasses.replace(re_.dataset, entity_shard_range=(0, 1))
    import os

    os.environ["PHOTON_RE_SOLVER"] = "vmapped"
    try:
        _, res = re_.train(None)
        r_model, _ = dataclasses.replace(re_, dataset=resident).train(None)
        s_model, _ = dataclasses.replace(re_, dataset=streamed).train(None)
    finally:
        del os.environ["PHOTON_RE_SOLVER"]
    assert bool(torch.isfinite(res.loss).all()) and bool((res.reason != 0).all())
    assert torch.equal(s_model.coef_values, r_model.coef_values)
    b = re_.dataset.blocks
    res = _train_blocks_packed(
        b.features, b.labels, b.offsets, b.weights, torch.zeros(b.proj_cols.shape),
        torch.zeros(b.proj_cols.shape), torch.ones(b.proj_cols.shape),
        task="logistic_regression", l2=1.0, l1=0.0, optimizer_type="TRON", tolerance=1e-6,
        max_iterations=5, num_corrections=10, max_cg_iterations=5, max_improvement_failures=5,
    )
    assert bool(torch.isfinite(res.loss).all())
