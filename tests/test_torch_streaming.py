"""Parity of the port's out-of-core random effect with the JAX package, on the CPU.

The streamed path (``game/streaming.py``) must reproduce the in-memory one:
the same entity blocks and solves, staged in budget-sized slices. The
vmapped solve (``PHOTON_RE_SOLVER=vmapped``) gives each entity's bits
whatever its stack, so the streamed solve equals the in-memory one bit for
bit; the packed solve agrees to the packed bound (coefficients atol 5e-3,
loss atol 1e-4, tests/test_packed_solver.py). The cases are
tests/test_streaming.py's, each also held against the JAX package's
streamed run: in float64, where the two packages take the same steps, at
coefficients atol 1e-9 and loss rtol 1e-12; the CLI runs at the AUC bound
of the JAX file. The mesh half of the estimator case is a refusal naming
ROADMAP A10 here.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game import RandomEffectCoordinate as JaxREC
from photon_ml_tpu.game import build_random_effect_dataset as jax_build_re
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOptConfig
from photon_ml_tpu.testing.generators import generate_mixed_effect_data as jax_generate
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as jax_to_raw
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.game import GLMOptimizationConfig, RandomEffectCoordinate, build_random_effect_dataset
from photon_ml_tpu_torch.game.streaming import entities_per_slice, estimate_block_bytes, solve_streamed
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.testing.generators import generate_mixed_effect_data, mixed_data_to_raw_dataset

SOLVE_ATOL = 1e-9
GEN = dict(n=1800, d_fixed=4, re_specs={"userId": (70, 7)}, seed=21, entity_skew=1.5)


def _cfg(l2=0.8):
    return GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=1e-9, max_iterations=80),
        regularization=RegularizationContext("L2"),
        reg_weight=l2,
    )


def _jcfg(l2=0.8):
    return JaxConfig(optimizer=JaxOptConfig(tolerance=1e-9, max_iterations=80), regularization=JaxReg("L2"),
                     reg_weight=l2)


@pytest.fixture(scope="module")
def raw():
    return mixed_data_to_raw_dataset(generate_mixed_effect_data(**GEN))


@pytest.fixture(scope="module")
def jraw():
    return jax_to_raw(jax_generate(**GEN))


def _pair(raw, budget_bytes, dtype=torch.float32):
    kw = dict(active_cap=64, dtype=dtype, device="cpu")
    mem = build_random_effect_dataset(raw, "re", "userShard", "userId", **kw)
    streamed = build_random_effect_dataset(raw, "re", "userShard", "userId", hbm_budget_bytes=budget_bytes, **kw)
    assert streamed.streamed, "budget should force the streamed build"
    assert streamed.blocks.features.device.type == "cpu"
    return mem, streamed


def _jstreamed(jraw, dtype=jnp.float32):
    ds = jax_build_re(jraw, "re", "userShard", "userId", active_cap=64, dtype=dtype, hbm_budget_bytes=64 << 10)
    assert ds.streamed
    return ds


@pytest.mark.parametrize("solver", ["vmapped", "packed"])
def test_streamed_train_matches_in_memory(raw, jraw, solver, monkeypatch):
    monkeypatch.setenv("PHOTON_RE_SOLVER", solver)
    mem, streamed = _pair(raw, budget_bytes=64 << 10)  # tiny: many slices
    cm = RandomEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg())
    cs = RandomEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg())
    res_np = np.random.default_rng(0).normal(size=cm.n_rows).astype(np.float32) * 0.1
    res = torch.from_numpy(res_np)
    m_mem, r_mem = cm.train(res)
    m_str, r_str = cs.train(res)
    if solver == "vmapped":
        # the vmapped solve's entity bits do not depend on the stack
        assert torch.equal(m_str.coef_values, m_mem.coef_values)
        assert torch.equal(r_str.iterations, r_mem.iterations)
        assert torch.equal(r_str.loss, r_mem.loss)
    else:
        np.testing.assert_allclose(m_str.coef_values.numpy(), m_mem.coef_values.numpy(), atol=5e-3)
        np.testing.assert_allclose(r_str.loss.numpy(), r_mem.loss.numpy(), atol=1e-4)
    s_mem, s_str = cm.score(m_mem), cs.score(m_str)
    if solver == "vmapped":
        assert torch.equal(s_str, s_mem)
    else:
        np.testing.assert_allclose(s_str.numpy(), s_mem.numpy(), atol=1e-3)
    # the x_sub cache is reused by the second call
    assert torch.equal(cs.score(m_str), s_str)
    # the JAX package's streamed solve, in float64 at the solve bound
    jds = _jstreamed(jraw)
    np.testing.assert_array_equal(jds.blocks.features, streamed.blocks.features.numpy())
    _, s64 = _pair(raw, budget_bytes=64 << 10, dtype=torch.float64)
    res64 = res_np.astype(np.float64)
    m64, r64 = RandomEffectCoordinate(dataset=s64, task="logistic_regression", config=_cfg()).train(
        torch.from_numpy(res64))
    jm, jr = JaxREC(dataset=_jstreamed(jraw, jnp.float64), task="logistic_regression", config=_jcfg()).train(
        jnp.asarray(res64))
    np.testing.assert_allclose(m64.coef_values.numpy(), np.asarray(jm.coef_values), atol=SOLVE_ATOL)
    np.testing.assert_allclose(r64.loss.numpy(), np.asarray(jr.loss), rtol=1e-12)


def test_streamed_warm_start_and_prior(raw, jraw, monkeypatch):
    monkeypatch.setenv("PHOTON_RE_SOLVER", "packed")
    mem, streamed = _pair(raw, budget_bytes=64 << 10)
    m0, _ = RandomEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg()).train(None)
    cs = RandomEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg(l2=2.0), prior_model=m0)
    cp = RandomEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg(l2=2.0), prior_model=m0)
    m_str, _ = cs.train(None, initial_model=m0)
    m_mem, _ = cp.train(None, initial_model=m0)
    np.testing.assert_allclose(m_str.coef_values.numpy(), m_mem.coef_values.numpy(), atol=2e-3)
    # the JAX package's, in float64 at the solve bound
    mem64, s64 = _pair(raw, budget_bytes=64 << 10, dtype=torch.float64)
    p0, _ = RandomEffectCoordinate(dataset=mem64, task="logistic_regression", config=_cfg()).train(None)
    p64, _ = RandomEffectCoordinate(dataset=s64, task="logistic_regression", config=_cfg(l2=2.0),
                                    prior_model=p0).train(None, initial_model=p0)
    jmem = jax_build_re(jraw, "re", "userShard", "userId", active_cap=64, dtype=jnp.float64)
    j0, _ = JaxREC(dataset=jmem, task="logistic_regression", config=_jcfg()).train(None)
    jm, _ = JaxREC(dataset=_jstreamed(jraw, jnp.float64), task="logistic_regression", config=_jcfg(l2=2.0),
                   prior_model=j0).train(None, initial_model=j0)
    np.testing.assert_allclose(p64.coef_values.numpy(), np.asarray(jm.coef_values), atol=SOLVE_ATOL)


def test_estimator_streamed_fixed_policy_and_mesh():
    """A streamed fixed effect constructs on the row-sliceable layouts with
    variance NONE and full sampling, and the planner resolves it streamed;
    the JAX package refuses the same configurations with the same messages.
    Streamed coordinates under a mesh are ROADMAP A10 on the port."""
    from photon_ml_tpu.estimators.game_estimator import CoordinateConfig as JaxCC
    from photon_ml_tpu.estimators.game_estimator import GameEstimator as JaxEstimator
    from photon_ml_tpu_torch.estimators.game_estimator import CoordinateConfig, GameEstimator
    from photon_ml_tpu_torch.plan import PlanError

    est = GameEstimator(task="logistic_regression", device="cpu", coordinate_configs=[
        CoordinateConfig(name="global", feature_shard="g", config=_cfg(), hbm_budget_mb=64)])
    (cplan,) = est.execution_plan.coordinates
    assert cplan.residency == "streamed" and cplan.sharding == "single-device"
    for change, match in ((dict(layout="coo"), "row-sliceable layout"),
                          (dict(config=dataclasses.replace(_cfg(), variance_type="SIMPLE")), "variance"),
                          (dict(config=dataclasses.replace(_cfg(), down_sampling_rate=0.5)), "down_sampling_rate")):
        kw = dict(name="global", feature_shard="g", config=_cfg(), hbm_budget_mb=64)
        jkw = dict(kw, config=_jcfg())
        jkw.update({k: v for k, v in change.items() if k != "config"})
        if "config" in change:
            jkw["config"] = dataclasses.replace(_jcfg(), **{
                f: getattr(change["config"], f) for f in ("variance_type", "down_sampling_rate")})
        with pytest.raises(ValueError, match=match) as ours:
            GameEstimator(task="logistic_regression", device="cpu",
                          coordinate_configs=[CoordinateConfig(**dict(kw, **change))])
        with pytest.raises(ValueError, match=match) as theirs:
            JaxEstimator(task="logistic_regression", coordinate_configs=[JaxCC(**jkw)])
        assert str(ours.value) == str(theirs.value)
    for extra in (dict(), dict(random_effect_type="userId")):
        with pytest.raises(PlanError, match="ROADMAP A10"):
            GameEstimator(task="logistic_regression", device="cpu", mesh={"data": 8}, coordinate_configs=[
                CoordinateConfig(name="c", feature_shard="s", config=_cfg(), hbm_budget_mb=64, **extra)])


def test_cli_trains_streamed_re_with_parity(tmp_path):
    """An RE coordinate over a zero budget trains streamed through
    cli.train (slices of the 8-entity minimum) and reproduces the in-memory
    run, and the JAX package's streamed run."""
    from photon_ml_tpu.cli.train import run as jax_train_run
    from photon_ml_tpu_torch.cli.train import run as train_run
    from photon_ml_tpu_torch.io import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing.generators import generate_game_records

    data = generate_mixed_effect_data(n=600, d_fixed=6, re_specs={"userId": (24, 5)}, seed=4, entity_skew=1.4)
    schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    train_path = str(tmp_path / "train.avro")
    write_avro_file(train_path, schema, generate_game_records(data))
    args = [
        "--input-data", train_path, "--validation-data", train_path, "--task", "logistic_regression",
        "--feature-shard", "name=global,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
        "--coordinate", "name=global,shard=global,optimizer=LBFGS,reg.type=L2,reg.weights=1",
        "--evaluators", "AUC",
    ]
    re_coord = "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1"
    s_mem = train_run(args + ["--coordinate", re_coord, "--output-dir", str(tmp_path / "m"), "--device", "cpu"])
    s_str = train_run(args + ["--coordinate", re_coord + ",hbm.budget.mb=0", "--output-dir", str(tmp_path / "s"),
                              "--device", "cpu"])
    j_str = jax_train_run(args + ["--coordinate", re_coord + ",hbm.budget.mb=0", "--output-dir", str(tmp_path / "j")])
    auc = s_str["best"]["metrics"]["AUC"]
    assert abs(auc - s_mem["best"]["metrics"]["AUC"]) < 1e-3
    assert abs(auc - j_str["best"]["metrics"]["AUC"]) < 1e-3


def test_solve_streamed_all_segments_empty():
    """No segment at all: zero coefficients, NOT_CONVERGED, NaN histories,
    as the JAX package returns."""
    from photon_ml_tpu.game.data import EntityBlocks as JaxBlocks
    from photon_ml_tpu.game.streaming import solve_streamed as jax_solve_streamed
    from photon_ml_tpu_torch.game.data import EntityBlocks
    from photon_ml_tpu_torch.optimize.common import ConvergenceReason

    E, K, S = 4, 3, 2
    planes = dict(features=np.zeros((E, K, S), np.float32), labels=np.zeros((E, K), np.float32),
                  offsets=np.zeros((E, K), np.float32), weights=np.zeros((E, K), np.float32),
                  proj_cols=np.full((E, S), -1, np.int32), active_rows=np.full((E, K), -1, np.int32))

    def _never_called(*a, **kw):
        raise AssertionError("train_fn must not run with no slices")

    zeros = np.zeros((E, S), np.float32)
    res = solve_streamed(EntityBlocks(**{k: torch.from_numpy(v) for k, v in planes.items()}), [], None,
                         torch.from_numpy(zeros), torch.from_numpy(zeros), torch.from_numpy(zeros), 1 << 20,
                         _never_called, {"max_iterations": 5}, device="cpu")
    jres = jax_solve_streamed(JaxBlocks(**planes), [], None, zeros, zeros, zeros, 1 << 20, _never_called,
                              {"max_iterations": 5})
    assert res.coefficients.shape == (E, S)
    assert (res.coefficients == 0).all()
    assert (res.reason == int(ConvergenceReason.NOT_CONVERGED)).all() and (res.iterations == 0).all()
    assert res.loss_history.shape == (E, 6) == jres.loss_history.shape
    assert torch.isnan(res.loss_history).all() and torch.isnan(res.grad_norm_history).all()
    np.testing.assert_array_equal(res.reason.numpy(), jres.reason)


def test_block_byte_estimates_respect_scalar_itemsize():
    from photon_ml_tpu.game.streaming import entities_per_slice as jax_eps
    from photon_ml_tpu.game.streaming import estimate_block_bytes as jax_ebb

    E, K, S = 2, 3, 4
    f32 = estimate_block_bytes(E, K, S, feature_itemsize=4)
    f64 = estimate_block_bytes(E, K, S, feature_itemsize=4, scalar_itemsize=8)
    assert f64 == f32 + 3 * E * K * 4
    assert (f32, f64) == (jax_ebb(E, K, S, feature_itemsize=4), jax_ebb(E, K, S, feature_itemsize=4, scalar_itemsize=8))
    budget = 1 << 16
    wide = entities_per_slice(budget, K, S, feature_itemsize=4, scalar_itemsize=8)
    narrow = entities_per_slice(budget, K, S, feature_itemsize=4)
    assert 0 < wide <= narrow
    assert (wide, narrow) == (jax_eps(budget, K, S, feature_itemsize=4, scalar_itemsize=8),
                              jax_eps(budget, K, S, feature_itemsize=4))


def test_solve_streamed_uses_label_dtype_for_budget(raw, monkeypatch):
    """A float64 streamed dataset budgets with 8-byte scalars: the staged
    slice never exceeds the estimate."""
    monkeypatch.setenv("PHOTON_RE_SOLVER", "vmapped")
    _, streamed = _pair(raw, budget_bytes=64 << 10, dtype=torch.float64)
    assert streamed.blocks.labels.element_size() == 8
    run = obs.RunTelemetry()
    with obs.use_run(run):
        RandomEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg()).train(None)
        snap = {m["name"]: m for m in run.registry.snapshot()}
    actual = snap["photon_stream_actual_slice_bytes"]["value"]
    assert actual <= snap["photon_stream_estimated_slice_bytes"]["value"]
    assert snap["photon_stream_slices_total"]["value"] >= 1
    assert snap["photon_stream_staged_bytes_total"]["value"] >= actual
