"""Incremental training in the port against the JAX package, on the CPU:
prior-centred L2 ("Regularize by Previous Model During Warm-Start
Training"), the fixed effect's prior under normalization, the random
effect's per-entity priors (means, precisions from variances, entities new
to the day), locked coordinates (partial retraining), and the cases of
tests/test_incremental.py and tests/test_estimators.py's partial retrain.

The same numpy inputs, made from a seed, go through both packages
(``device="cpu"``). Bounds: fixed-effect coefficients rtol 1e-3 / atol
1e-5, random-effect coefficients atol 5e-3 and per-entity loss atol 1e-4
(the JAX suite's), objective values and derivatives rtol 1e-10 in
float64."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.estimators import CoordinateConfig as RefCoordinateConfig
from photon_ml_tpu.estimators import GameEstimator as RefGameEstimator
from photon_ml_tpu.game import RandomEffectCoordinate as RefREC
from photon_ml_tpu.game.coordinate import ModelCoordinate as RefModelCoordinate
from photon_ml_tpu.game.data import build_random_effect_dataset as ref_build_re
from photon_ml_tpu.game.descent import CoordinateDescent as RefCD
from photon_ml_tpu.game.problem import GLMOptimizationConfig as RefGLMConfig
from photon_ml_tpu.game.problem import GLMProblem as RefGLMProblem
from photon_ml_tpu.io.data import RawDataset as RefRaw
from photon_ml_tpu.models import Coefficients as RefCoefficients
from photon_ml_tpu.ops import GLMObjective as RefObjective
from photon_ml_tpu.ops import LOGISTIC as REF_LOGISTIC
from photon_ml_tpu.ops import batch_from_dense as ref_batch_from_dense
from photon_ml_tpu.ops.normalization import build_normalization as ref_build_normalization
from photon_ml_tpu.ops.regularization import RegularizationContext as RefReg
from photon_ml_tpu.optimize import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.testing import generate_mixed_effect_data as ref_generate
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as ref_to_raw
from photon_ml_tpu_torch.estimators import CoordinateConfig, GameEstimator
from photon_ml_tpu_torch.game import CoordinateDescent, ModelCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game import build_random_effect_dataset
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.models.game import RandomEffectModel
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.glm import GLMObjective
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.normalization import build_normalization
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.testing import generate_glm_data, generate_mixed_effect_data
from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset

DTYPES = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64)}


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def test_prior_objective_math(rng):
    x, y, _ = generate_glm_data(n=50, d=5, seed=1)
    mean, prec = rng.normal(size=5), rng.uniform(0.5, 2.0, size=5)
    w, v = rng.normal(size=5), rng.normal(size=5)
    lam = 2.0
    batch = batch_from_dense(x, y, dtype=torch.float64, device="cpu")
    obj = GLMObjective(loss=LOSSES["logistic"], batch=batch, l2=lam, prior_mean=_t(mean), prior_precision=_t(prec))
    plain = GLMObjective(loss=LOSSES["logistic"], batch=batch, l2=0.0)
    ref = RefObjective(loss=REF_LOGISTIC, batch=ref_batch_from_dense(x, y, dtype=jnp.float64), l2=lam,
                       prior_mean=jnp.asarray(mean), prior_precision=jnp.asarray(prec))
    v_prior, g_prior = obj.value_and_grad(_t(w))
    v_plain, g_plain = plain.value_and_grad(_t(w))
    delta = w - mean
    np.testing.assert_allclose(float(v_prior), float(v_plain) + 0.5 * lam * np.sum(prec * delta**2), rtol=1e-12)
    np.testing.assert_allclose(g_prior.numpy(), g_plain.numpy() + lam * prec * delta, rtol=1e-10)
    # value, gradient, Hv and the Hessian diagonal as the JAX package's
    rv, rg = ref.value_and_grad(jnp.asarray(w))
    np.testing.assert_allclose(float(v_prior), float(rv), rtol=1e-10)
    np.testing.assert_allclose(g_prior.numpy(), np.asarray(rg), rtol=1e-10)
    np.testing.assert_allclose(obj.hessian_vector(_t(w), _t(v)).numpy(),
                               np.asarray(ref.hessian_vector(jnp.asarray(w), jnp.asarray(v))), rtol=1e-10)
    np.testing.assert_allclose(obj.hessian_diagonal(_t(w)).numpy(), np.asarray(ref.hessian_diagonal(jnp.asarray(w))),
                               rtol=1e-10)
    # and consistent with autodiff of the JAX package's value
    h_auto = np.asarray(jax.hessian(ref.value)(jnp.asarray(w)))
    np.testing.assert_allclose(obj.hessian_vector(_t(w), _t(v)).numpy(), h_auto @ v, rtol=1e-8)
    np.testing.assert_allclose(obj.hessian_diagonal(_t(w)).numpy(), np.diag(h_auto), rtol=1e-8)


@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
def test_incremental_rounds_approach_full_training(norm):
    """Slice 1, then slice 2 with the round-1 posterior (means and SIMPLE
    variances) as the prior: closer to full-data training than slice 2
    alone, and each round as the JAX package's. Under STANDARDIZATION the
    prior's means move into the normalized space and its variances do not,
    as in the JAX package: the precisions then weigh the normalized
    coefficients by original-space variances, so only the parity is held
    there, not the approach to full training."""
    x, y, _ = generate_glm_data(n=2000, d=8, seed=3)
    x[:, :-1] = x[:, :-1] * 3.0 + 1.5  # give the standardization something to do
    opt = dict(tolerance=1e-10, max_iterations=300)
    cfg = GLMOptimizationConfig(optimizer=OptimizerConfig(**opt), regularization=RegularizationContext("L2"),
                                reg_weight=1.0, variance_type="SIMPLE")
    ref_cfg = RefGLMConfig(optimizer=RefOptimizerConfig(**opt), regularization=RefReg("L2"), reg_weight=1.0,
                           variance_type="SIMPLE")
    stats = (x.mean(axis=0), x.var(axis=0), np.abs(x).max(axis=0))
    tn = None if norm == "NONE" else build_normalization(norm, *stats, intercept_index=7, dtype=torch.float64,
                                                         device="cpu")
    jn = None if norm == "NONE" else ref_build_normalization(norm, *stats, intercept_index=7, dtype=jnp.float64)

    def fit(rows, prior=None):
        problem = GLMProblem(task="logistic_regression", config=cfg, normalization=tn, prior=prior)
        model, _ = problem.run(batch_from_dense(x[rows], y[rows], dtype=torch.float64, device="cpu"))
        return model.coefficients

    def ref_fit(rows, prior=None):
        problem = RefGLMProblem(task="logistic_regression", config=ref_cfg, normalization=jn, prior=prior)
        model, _ = problem.run(ref_batch_from_dense(x[rows], y[rows], dtype=jnp.float64))
        return model.coefficients

    full, half1, second = slice(None), slice(0, 1000), slice(1000, None)
    c_full, c_half1, c_alone = fit(full), fit(half1), fit(second)
    c_inc = fit(second, prior=c_half1)
    r_half1 = ref_fit(half1)
    r_inc = ref_fit(second, prior=RefCoefficients(means=r_half1.means, variances=r_half1.variances))
    for ours, theirs in ((c_half1, r_half1), (c_inc, r_inc)):
        np.testing.assert_allclose(ours.means.numpy(), np.asarray(theirs.means), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(ours.variances.numpy(), np.asarray(theirs.variances), rtol=1e-3, atol=1e-5)
    w_full = c_full.means.numpy()
    if norm == "NONE":
        assert np.linalg.norm(c_inc.means.numpy() - w_full) < np.linalg.norm(c_alone.means.numpy() - w_full)


def _game_configs(mod, reg, opt_cfg, glm_cfg, reg_weight=1.0, fe_variance="SIMPLE"):
    opt = opt_cfg(tolerance=1e-8, max_iterations=100)
    return [
        mod(name="global", feature_shard="global",
            config=glm_cfg(optimizer=opt, regularization=reg("L2"), reg_weight=reg_weight, variance_type=fe_variance)),
        mod(name="per-user", feature_shard="userShard", random_effect_type="userId",
            config=glm_cfg(optimizer=opt, regularization=reg("L2"), reg_weight=reg_weight)),
    ]


def _strong(configs, prior):
    return [dataclasses.replace(c, regularize_by_prior=prior, config=dataclasses.replace(c.config, reg_weight=1000.0),
                                reg_weights=(1000.0,)) for c in configs]


def test_game_estimator_incremental():
    kw = dict(n=1000, d_fixed=6, re_specs={"userId": (20, 4)}, seed=41)
    raw, ref_raw = mixed_data_to_raw_dataset(generate_mixed_effect_data(**kw)), ref_to_raw(ref_generate(**kw))
    base = _game_configs(CoordinateConfig, RegularizationContext, OptimizerConfig, GLMOptimizationConfig)
    ref_base = _game_configs(RefCoordinateConfig, RefReg, RefOptimizerConfig, RefGLMConfig)

    def fit(cfgs, initial=None):
        return GameEstimator("logistic_regression", cfgs, dtype=torch.float64, device="cpu").fit(
            raw, initial_model=initial)[0].model

    def ref_fit(cfgs, initial=None):
        return RefGameEstimator("logistic_regression", cfgs, dtype=jnp.float64).fit(
            ref_raw, initial_model=initial)[0].model

    first, ref_first = fit(base), ref_fit(ref_base)
    # round 2 with a STRONG prior weight: the prior pins the coefficients to
    # the round-1 model, where plain L2 at the same weight shrinks them
    second, ref_second = fit(_strong(base, True), first), ref_fit(_strong(ref_base, True), ref_first)
    third, ref_third = fit(_strong(base, False)), ref_fit(_strong(ref_base, False))
    for ours, theirs in ((first, ref_first), (second, ref_second), (third, ref_third)):
        fe, ref_fe = ours["global"].model.coefficients, theirs["global"].model.coefficients
        np.testing.assert_allclose(fe.means.numpy(), np.asarray(ref_fe.means), rtol=1e-3, atol=1e-5)
        re_, ref_re = ours["per-user"], theirs["per-user"]
        order = [ref_re.entity_row(e) for e in re_.entity_ids]
        np.testing.assert_allclose(re_.dense_coefficients(4), np.asarray(ref_re.dense_coefficients(4))[order],
                                   atol=5e-3)
    w1, w2, w3 = (m["global"].model.coefficients.means.numpy() for m in (first, second, third))
    assert np.linalg.norm(w2 - w1) < 0.1  # pinned to the prior
    assert np.linalg.norm(w3) < 0.25 * np.linalg.norm(w1)  # plain L2 shrinks
    r1, r2 = first["per-user"].coef_values.numpy(), second["per-user"].coef_values.numpy()
    assert np.abs(r2 - r1).max() < 0.1


# -- random-effect priors ------------------------------------------------------


def _re_feed(seed=5, n=1500, n_users=40, d_re=4):
    """Two days of per-user rows: day A over users 0-29, day B over users
    10-39 (users 30-39 are new to day B), logistic labels."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=n)
    day_a = np.flatnonzero(users < 30)[:700]
    day_b = np.flatnonzero(users >= 10)[-700:]
    ex = rng.standard_normal((n, d_re))
    ex[:, -1] = 1.0
    w_u = rng.standard_normal((n_users, d_re))
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-np.einsum("nd,nd->n", ex, w_u[users])))).astype(np.float64)
    ids = np.char.add("u", users.astype(str)).astype(object)

    def raw(rows, cls):
        k = len(rows)
        return cls(n_rows=k, labels=y[rows], offsets=np.zeros(k), weights=np.ones(k),
                   shard_coo={"userShard": (np.repeat(np.arange(k), d_re), np.tile(np.arange(d_re), k),
                                            ex[rows].reshape(-1))},
                   shard_dims={"userShard": d_re}, id_tags={"userId": ids[rows]})

    return raw(day_a, RawDataset), raw(day_a, RefRaw), raw(day_b, RawDataset), raw(day_b, RefRaw)


def _re_cfgs(reg_weight=1.0):
    opt = dict(tolerance=1e-7, max_iterations=100)
    return (GLMOptimizationConfig(optimizer=OptimizerConfig(**opt), regularization=RegularizationContext("L2"),
                                  reg_weight=reg_weight),
            RefGLMConfig(optimizer=RefOptimizerConfig(**opt), regularization=RefReg("L2"), reg_weight=reg_weight))


@pytest.mark.parametrize("variances", [False, True], ids=["means", "variances"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_random_effect_prior_matches_jax(dt, variances):
    """Day B's random effect solved with day A's model as its prior: per
    entity as the JAX package's ``RandomEffectCoordinate(prior_model=...)``.
    With variances, a known entity's precisions are 1 / variance. An entity
    new to day B takes mean 0 and precision 1 in the port (its warm start
    and prior are plain L2); the JAX package gives an entry its prior lacks
    precision 1 / max(0, 1e-12) when the prior carries variances, which pins
    the new entity at 0, so the port's new entities are held against the
    JAX package's solve with the means-only prior, which is plain L2 for
    them."""
    tdt, jdt = DTYPES[dt]
    ta, ja, tb, jb = _re_feed()
    tcfg, jcfg = _re_cfgs()
    jds_a = ref_build_re(ja, "per-user", "userShard", "userId", dtype=jdt)
    prior_j, _ = RefREC(dataset=jds_a, task="logistic_regression", config=jcfg).train(None)
    idx, val = np.array(prior_j.coef_indices), np.array(prior_j.coef_values)
    var = None
    if variances:
        var = np.where(idx >= 0, np.random.default_rng(1).uniform(0.2, 2.0, size=idx.shape), 0.0).astype(val.dtype)
    prior_j = dataclasses.replace(prior_j, variances=None if var is None else jnp.asarray(var))
    prior_t = RandomEffectModel(
        random_effect_type="userId", feature_shard="userShard", task="logistic_regression",
        entity_ids=np.asarray(prior_j.entity_ids, dtype=object), coef_indices=torch.as_tensor(idx),
        coef_values=torch.as_tensor(val), variances=None if var is None else torch.as_tensor(var),
    )
    jds_b = ref_build_re(jb, "per-user", "userShard", "userId", dtype=jdt)
    tds_b = build_random_effect_dataset(tb, "per-user", "userShard", "userId", dtype=tdt, device="cpu")
    got, got_res = RandomEffectCoordinate(dataset=tds_b, task="logistic_regression", config=tcfg,
                                          prior_model=prior_t).train(None)
    want, want_res = RefREC(dataset=jds_b, task="logistic_regression", config=jcfg, prior_model=prior_j).train(None)
    plain_l2, plain_res = RefREC(dataset=jds_b, task="logistic_regression", config=jcfg,
                                 prior_model=dataclasses.replace(prior_j, variances=None)).train(None)
    assert list(map(str, got.entity_ids)) == list(map(str, want.entity_ids))
    new = np.asarray([prior_t.entity_row(e) < 0 for e in got.entity_ids])
    assert new.any() and (~new).any()
    ours, loss = got.coef_values.double().numpy(), got_res.loss.double().numpy()
    for rows, ref, ref_res in ((~new, want, want_res), (new, plain_l2, plain_res)):
        np.testing.assert_allclose(ours[rows], np.asarray(ref.coef_values, np.float64)[rows], atol=5e-3)
        np.testing.assert_allclose(loss[rows], np.asarray(ref_res.loss, np.float64)[rows], atol=1e-4)
    # the prior pulls known entities toward day A's model: a strong prior
    # weight pins them to it
    strong, _ = RandomEffectCoordinate(dataset=tds_b, task="logistic_regression", config=_re_cfgs(1e6)[0],
                                       prior_model=prior_t).train(None)
    rows = [prior_t.entity_row(e) for e in got.entity_ids]
    dense_a = prior_t.dense_coefficients(4)
    dense_b = strong.dense_coefficients(4)
    for k, r in enumerate(rows):
        np.testing.assert_allclose(dense_b[k], dense_a[r] if r >= 0 else 0.0, atol=1e-3)


def test_new_entity_under_a_prior_with_variances_in_both_packages():
    """ROADMAP C8, the deliberate departure, recorded in both packages: an
    entity new to day B under a prior that carries variances. The JAX
    package projects the variance 0 for an entry its prior lacks, so the
    entry's precision is 1 / max(0, 1e-12) = 1e12 and the new entity's
    coefficients are pinned at 0. The port gives the entry mean 0 and
    precision 1, so the new entity's solve is the plain-L2 solve: the port's
    solve of day B with no prior at all, for those entities."""
    ta, ja, tb, jb = _re_feed()
    tcfg, jcfg = _re_cfgs()
    jds_a = ref_build_re(ja, "per-user", "userShard", "userId", dtype=jnp.float64)
    prior_j, _ = RefREC(dataset=jds_a, task="logistic_regression", config=jcfg).train(None)
    idx, val = np.array(prior_j.coef_indices), np.array(prior_j.coef_values)
    var = np.where(idx >= 0, np.random.default_rng(1).uniform(0.2, 2.0, size=idx.shape), 0.0)
    prior_j = dataclasses.replace(prior_j, variances=jnp.asarray(var))
    prior_t = RandomEffectModel(
        random_effect_type="userId", feature_shard="userShard", task="logistic_regression",
        entity_ids=np.asarray(prior_j.entity_ids, dtype=object), coef_indices=torch.as_tensor(idx),
        coef_values=torch.as_tensor(val), variances=torch.as_tensor(var),
    )
    tds_b = build_random_effect_dataset(tb, "per-user", "userShard", "userId", dtype=torch.float64, device="cpu")
    jds_b = ref_build_re(jb, "per-user", "userShard", "userId", dtype=jnp.float64)
    ours, _ = RandomEffectCoordinate(dataset=tds_b, task="logistic_regression", config=tcfg,
                                     prior_model=prior_t).train(None)
    theirs, _ = RefREC(dataset=jds_b, task="logistic_regression", config=jcfg, prior_model=prior_j).train(None)
    plain, _ = RandomEffectCoordinate(dataset=tds_b, task="logistic_regression", config=tcfg).train(None)
    new = np.asarray([prior_t.entity_row(e) < 0 for e in ours.entity_ids])
    assert new.any()
    support = np.asarray(ours.coef_indices) >= 0
    # the JAX package: pinned at 0 by the precision 1e12
    theirs_new = np.asarray(theirs.coef_values)[new]
    assert np.abs(theirs_new).max() <= 1e-9
    # the port: the plain-L2 solve, away from 0
    ours_new = ours.coef_values.numpy()[new]
    np.testing.assert_allclose(ours_new, plain.coef_values.numpy()[new], atol=1e-9)
    assert np.abs(ours_new[support[new]]).max() > 1e-2


# -- locked coordinates ----------------------------------------------------------


@pytest.fixture(scope="module")
def game_data():
    """tests/test_estimators.py's fixture, for both packages."""
    kw = dict(n=1800, d_fixed=6, re_specs={"userId": (24, 4)}, seed=21)
    full, ref_full = mixed_data_to_raw_dataset(generate_mixed_effect_data(**kw)), ref_to_raw(ref_generate(**kw))
    return ((full.subset(np.arange(1200)), full.subset(np.arange(1200, 1800))),
            (ref_full.subset(np.arange(1200)), ref_full.subset(np.arange(1200, 1800))))


def _est_configs(mod, reg, opt_cfg, glm_cfg, re_weights=(1.0,)):
    opt = opt_cfg(tolerance=1e-8, max_iterations=100)
    return [
        mod(name="global", feature_shard="global", config=glm_cfg(optimizer=opt, regularization=reg("L2")),
            reg_weights=(1.0,)),
        mod(name="per-user", feature_shard="userShard", random_effect_type="userId",
            config=glm_cfg(optimizer=opt, regularization=reg("L2")), reg_weights=re_weights),
    ]


def test_partial_retrain(game_data):
    """A locked fixed effect keeps the pretrained model bitwise while the
    random effect retrains (with another weight), as in the JAX package."""
    (train, val), (ref_train, ref_val) = game_data
    cfgs = lambda w=(1.0,): _est_configs(CoordinateConfig, RegularizationContext, OptimizerConfig,  # noqa: E731
                                         GLMOptimizationConfig, w)
    ref_cfgs = lambda w=(1.0,): _est_configs(RefCoordinateConfig, RefReg, RefOptimizerConfig,  # noqa: E731
                                             RefGLMConfig, w)
    first = GameEstimator("logistic_regression", cfgs(), evaluator_specs=["AUC"], dtype=torch.float64,
                          device="cpu").fit(train, validation=val)[0]
    ref_first = RefGameEstimator("logistic_regression", ref_cfgs(), evaluator_specs=["AUC"],
                                 dtype=jnp.float64).fit(ref_train, validation=ref_val)[0]
    est2 = GameEstimator("logistic_regression", cfgs((3.0,)), evaluator_specs=["AUC"], dtype=torch.float64,
                         partial_retrain_locked=["global"], device="cpu")
    second = est2.fit(train, validation=val, initial_model=first.model)[0]
    ref_second = RefGameEstimator("logistic_regression", ref_cfgs((3.0,)), evaluator_specs=["AUC"],
                                  dtype=jnp.float64, partial_retrain_locked=["global"]).fit(
        ref_train, validation=ref_val, initial_model=ref_first.model)[0]
    np.testing.assert_array_equal(second.model["global"].model.coefficients.means.numpy(),
                                  first.model["global"].model.coefficients.means.numpy())
    # the random effect did retrain (another reg weight, other coefficients)
    assert not np.allclose(second.model["per-user"].coef_values.numpy(), first.model["per-user"].coef_values.numpy())
    re_, ref_re = second.model["per-user"], ref_second.model["per-user"]
    order = [ref_re.entity_row(e) for e in re_.entity_ids]
    np.testing.assert_allclose(re_.dense_coefficients(5), np.asarray(ref_re.dense_coefficients(5))[order], atol=5e-3)
    assert abs(second.evaluation.metrics["AUC"] - ref_second.evaluation.metrics["AUC"]) <= 1e-4
    # a locked coordinate without a pretrained model, and a descent of
    # locked coordinates only, are refused as in the JAX package
    with pytest.raises(ValueError, match="needs a pretrained model"):
        est2.fit(train)
    coords = est2._make_coordinates(est2.prepare_datasets(train), {"global": 1.0, "per-user": 1.0},
                                    dict(first.model.models))
    assert isinstance(coords["global"], ModelCoordinate)
    assert coords["global"].train(None) == (first.model["global"], None)
    locked = {"global": coords["global"]}
    with pytest.raises(ValueError, match="all coordinates are locked") as ours:
        CoordinateDescent(locked)
    ref_est2 = RefGameEstimator("logistic_regression", ref_cfgs((3.0,)), dtype=jnp.float64,
                                partial_retrain_locked=["global"])
    ref_locked = ref_est2._make_coordinates(ref_est2.prepare_datasets(ref_train), {"global": 1.0, "per-user": 1.0},
                                            dict(ref_first.model.models))["global"]
    assert isinstance(ref_locked, RefModelCoordinate)
    with pytest.raises(ValueError) as theirs:
        RefCD({"global": ref_locked})
    assert str(ours.value) == str(theirs.value)
