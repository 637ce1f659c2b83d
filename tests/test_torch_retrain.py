"""The port's day-chained retrain (``photon_ml_tpu_torch.game.incremental``,
``cli.retrain``, ``serving.store`` / ``serving.refresh``) against the JAX
package's, on the CPU: the cases of tests/test_retrain.py and
tests/test_cli.py's retrain cases, each run through both packages on the
same feed (``generate_mixed_effect_data``, made from a seed).

Bounds: float64, as the reference tests run; merges bitwise; gate
decisions, reasons, touched counts, rows and snapshot names identical, the
ledger's metrics within 1e-8 (float64) or 1e-4 (the float32 CLI run);
fixed-effect coefficients rtol 1e-3 / atol 1e-5, random-effect
coefficients atol 5e-3."""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import obs as ref_obs
from photon_ml_tpu.cli import index as ref_index
from photon_ml_tpu.cli import retrain as ref_retrain
from photon_ml_tpu.estimators.game_estimator import CoordinateConfig as RefCoordinateConfig
from photon_ml_tpu.estimators.game_estimator import GameEstimator as RefGameEstimator
from photon_ml_tpu.game import incremental as ref_incremental
from photon_ml_tpu.game.problem import GLMOptimizationConfig as RefGLMConfig
from photon_ml_tpu.io.index_map import IndexMap as RefIndexMap
from photon_ml_tpu.io.model_io import check_prior_compatibility as ref_check_prior_compatibility
from photon_ml_tpu.models.game import FixedEffectModel as RefFixedEffectModel
from photon_ml_tpu.models.game import GameModel as RefGameModel
from photon_ml_tpu.models.game import RandomEffectModel as RefRandomEffectModel
from photon_ml_tpu.models.glm import Coefficients as RefCoefficients
from photon_ml_tpu.models.glm import LogisticRegressionModel as RefLogisticModel
from photon_ml_tpu.ops.regularization import RegularizationContext as RefReg
from photon_ml_tpu.optimize import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.robust import faults as ref_faults
from photon_ml_tpu.serving import refresh as ref_refresh
from photon_ml_tpu.serving import store as ref_store
from photon_ml_tpu.testing import generate_mixed_effect_data as ref_generate
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as ref_to_raw
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli import index, retrain
from photon_ml_tpu_torch.estimators.game_estimator import CoordinateConfig, GameEstimator, GameTransformer
from photon_ml_tpu_torch.game import incremental
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig
from photon_ml_tpu_torch.io import write_avro_file
from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.io.model_io import check_prior_compatibility, load_game_model, save_game_model
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, LogisticRegressionModel
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.plan import PlanError
from photon_ml_tpu_torch.robust import faults
from photon_ml_tpu_torch.robust.faults import SimulatedKill
from photon_ml_tpu_torch.serving import refresh, store
from photon_ml_tpu_torch.testing import generate_game_records, generate_mixed_effect_data
from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset

D_FIXED = 6
N_ENT, D_RE = 10, 3
SPECS = ["AUC", "AUC:userId"]


@pytest.fixture(autouse=True)
def _no_leaked_injector(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    yield
    faults.clear()
    ref_faults.clear()


@pytest.fixture
def run():
    r = obs.RunTelemetry()
    with obs.use_run(r):
        yield r


def _estimator(n_cd_iterations=2):
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=1e-9, max_iterations=200),
        regularization=RegularizationContext("L2"), reg_weight=1.0,
    )
    coords = [
        CoordinateConfig(name="global", feature_shard="global", config=cfg),
        CoordinateConfig(name="per-user", feature_shard="userShard", random_effect_type="userId", config=cfg),
    ]
    return GameEstimator(task="logistic_regression", coordinate_configs=coords, n_cd_iterations=n_cd_iterations,
                         evaluator_specs=SPECS, dtype=torch.float64, device="cpu")


def _ref_estimator(n_cd_iterations=2):
    cfg = RefGLMConfig(
        optimizer=RefOptimizerConfig(tolerance=1e-9, max_iterations=200), regularization=RefReg("L2"),
        reg_weight=1.0,
    )
    coords = [
        RefCoordinateConfig(name="global", feature_shard="global", config=cfg),
        RefCoordinateConfig(name="per-user", feature_shard="userShard", random_effect_type="userId", config=cfg),
    ]
    return RefGameEstimator(task="logistic_regression", coordinate_configs=coords, n_cd_iterations=n_cd_iterations,
                            evaluator_specs=SPECS, dtype=jnp.float64)


def _index_maps(cls=IndexMap):
    return {
        "global": cls.from_name_terms([(f"g{j}", "") for j in range(D_FIXED)], add_intercept=False),
        "userShard": cls.from_name_terms([(f"u{j}", "") for j in range(D_RE)], add_intercept=False),
    }


def _split(raw, data):
    """tests/test_retrain.py's feed: day 1 rows 0-349, day 2 the next 350
    rows of the first half of the entities, day 3 those of the second half,
    validation the rest."""
    first_half = np.isin(data.entity_ids["userId"], [f"e{k}" for k in range(N_ENT // 2)])
    rows = np.arange(data.n)
    in_day1 = (rows >= 350) & (rows < 700)
    return {
        "union": raw.subset(rows[:700]),
        "days": [("20260101", raw.subset(rows[:350])), ("20260102", raw.subset(rows[in_day1 & first_half])),
                 ("20260103", raw.subset(rows[in_day1 & ~first_half]))],
        "validation": raw.subset(rows[700:]),
    }


@pytest.fixture(scope="module")
def feeds():
    """The same feed for both packages, each made by its own generator from
    the same seed (held equal here)."""
    kw = dict(task="logistic_regression", n=1100, d_fixed=D_FIXED, re_specs={"userId": (N_ENT, D_RE)}, seed=7)
    data, ref_data = generate_mixed_effect_data(**kw), ref_generate(**kw)
    raw, ref_raw = mixed_data_to_raw_dataset(data), ref_to_raw(ref_data)
    np.testing.assert_array_equal(raw.labels, np.asarray(ref_raw.labels))
    for shard in raw.shard_coo:
        for a, b in zip(raw.shard_coo[shard], ref_raw.shard_coo[shard]):
            np.testing.assert_array_equal(a, np.asarray(b))
    return _split(raw, data), _split(ref_raw, ref_data)


def _ledger(res):
    return [dataclasses.asdict(r) for r in res.ledger]


def _same_ledger(ours, theirs, atol=1e-8):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a, b = dict(a), dict(b)
        ma, mb = a.pop("metrics") or {}, b.pop("metrics") or {}
        assert a == b
        assert set(ma) == set(mb)
        for k in ma:
            assert abs(ma[k] - mb[k]) <= atol, (k, ma[k], mb[k])


def _same_model(ours, theirs, d_re=D_RE):
    fe, ref_fe = ours.models["global"].model.coefficients, theirs.models["global"].model.coefficients
    np.testing.assert_allclose(fe.means.numpy(), np.asarray(ref_fe.means), rtol=1e-3, atol=1e-5)
    re_, ref_re = ours.models["per-user"], theirs.models["per-user"]
    assert list(map(str, re_.entity_ids)) == list(map(str, ref_re.entity_ids))
    np.testing.assert_allclose(re_.dense_coefficients(d_re), np.asarray(ref_re.dense_coefficients(d_re)), atol=5e-3)


def _ref_chain(ref_feed, tmp_path, name, days=None, **kw):
    r = ref_obs.RunTelemetry()
    with ref_obs.use_run(r):
        return ref_incremental.run_chain(
            _ref_estimator(), ref_feed["days"] if days is None else days, ref_feed["validation"],
            chain_dir=str(tmp_path / name), evaluator_specs=SPECS, dtype=jnp.float64, **kw,
        ), r


# -- the entity merge --------------------------------------------------------


def _re(ids, idx, val, variances=None):
    return RandomEffectModel(
        random_effect_type="userId", feature_shard="userShard", task="logistic_regression",
        entity_ids=np.asarray(ids, dtype=object),
        coef_indices=torch.tensor(idx, dtype=torch.int32),
        coef_values=torch.tensor(val, dtype=torch.float64),
        variances=None if variances is None else torch.tensor(variances, dtype=torch.float64),
    )


def _ref_re(ids, idx, val, variances=None):
    return RefRandomEffectModel(
        random_effect_type="userId", feature_shard="userShard", task="logistic_regression",
        entity_ids=np.asarray(ids, dtype=object),
        coef_indices=jnp.asarray(idx, jnp.int32), coef_values=jnp.asarray(val, jnp.float64),
        variances=None if variances is None else jnp.asarray(variances, jnp.float64),
    )


def _same_re_bits(ours, theirs):
    assert list(map(str, ours.entity_ids)) == list(map(str, theirs.entity_ids))
    for name in ("coef_indices", "coef_values", "variances"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_grow_random_effect_bitwise_carry_and_growth():
    args = (["uA", "uB"], [[0, 1], [2, -1]], [[0.5, -1.5], [2.25, 0.0]])
    upd = (["uB", "uD"], [[0, 1, 2], [1, -1, -1]], [[9.0, 8.0, 7.0], [3.5, 0.0, 0.0]])
    out = incremental.grow_random_effect(_re(*args), _re(*upd))
    _same_re_bits(out, ref_incremental.grow_random_effect(_ref_re(*args), _ref_re(*upd)))
    assert list(out.entity_ids) == ["uA", "uB", "uD"]
    # uA untouched: bitwise carry, widened with the -1 sentinel / 0.0 pad
    np.testing.assert_array_equal(out.coef_indices[0].numpy(), [0, 1, -1])
    np.testing.assert_array_equal(out.coef_values[0].numpy(), [0.5, -1.5, 0.0])
    # uB re-solved in place, uD appended (model growth)
    np.testing.assert_array_equal(out.coef_indices[1].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(out.coef_values[1].numpy(), [9.0, 8.0, 7.0])
    np.testing.assert_array_equal(out.coef_values[2].numpy(), [3.5, 0.0, 0.0])
    assert out.variances is None
    assert out.entity_row("uA") == 0 and out.entity_row("uD") == 2
    # float32 values stay float32 (no round trip through another dtype)
    f32 = dataclasses.replace(_re(*args), coef_values=_re(*args).coef_values.float())
    grown = incremental.grow_random_effect(f32, dataclasses.replace(_re(*upd), coef_values=_re(*upd).coef_values.float()))
    assert grown.coef_values.dtype == torch.float32
    np.testing.assert_array_equal(grown.coef_values[0, :2].numpy(), f32.coef_values[0].numpy())


def test_grow_random_effect_variances_merge_only_when_both_sides_have_them():
    prior, upd = (["uA"], [[0]], [[1.0]], [[0.25]]), (["uB"], [[1]], [[2.0]], [[0.5]])
    both = incremental.grow_random_effect(_re(*prior), _re(*upd))
    _same_re_bits(both, ref_incremental.grow_random_effect(_ref_re(*prior), _ref_re(*upd)))
    np.testing.assert_array_equal(both.variances.numpy(), [[0.25], [0.5]])
    # a means-only update invalidates the prior's stale variances
    mixed = incremental.grow_random_effect(_re(*prior), _re(*upd[:3]))
    _same_re_bits(mixed, ref_incremental.grow_random_effect(_ref_re(*prior), _ref_re(*upd[:3])))
    assert mixed.variances is None


def test_grow_random_effect_refuses_mismatched_models():
    other = dataclasses.replace(_re(["i1"], [[0]], [[1.0]]), random_effect_type="itemId")
    ref_other = dataclasses.replace(_ref_re(["i1"], [[0]], [[1.0]]), random_effect_type="itemId")
    with pytest.raises(ValueError, match="different types") as ours:
        incremental.grow_random_effect(_re(["uA"], [[0]], [[1.0]]), other)
    with pytest.raises(ValueError) as theirs:
        ref_incremental.grow_random_effect(_ref_re(["uA"], [[0]], [[1.0]]), ref_other)
    assert str(ours.value) == str(theirs.value)
    shard = dataclasses.replace(_re(["i1"], [[0]], [[1.0]]), feature_shard="itemShard")
    with pytest.raises(ValueError, match="different feature shards"):
        incremental.grow_random_effect(_re(["uA"], [[0]], [[1.0]]), shard)


def test_merge_models_counts_touched_entities():
    fe = FixedEffectModel(model=LogisticRegressionModel(Coefficients(torch.zeros(3, dtype=torch.float64))),
                          feature_shard="global")
    ref_fe = RefFixedEffectModel(model=RefLogisticModel(RefCoefficients(jnp.zeros(3))), feature_shard="global")
    p_args, u_args = (["uA", "uB"], [[0], [1]], [[1.0], [2.0]]), (["uB", "uC"], [[0], [1]], [[5.0], [6.0]])
    prior = GameModel(models={"global": fe, "per-user": _re(*p_args)}, task="logistic_regression")
    update = GameModel(models={"global": fe, "per-user": _re(*u_args)}, task="logistic_regression")
    merged, touched = incremental.merge_models(prior, update)
    ref_merged, ref_touched = ref_incremental.merge_models(
        RefGameModel(models={"global": ref_fe, "per-user": _ref_re(*p_args)}, task="logistic_regression"),
        RefGameModel(models={"global": ref_fe, "per-user": _ref_re(*u_args)}, task="logistic_regression"),
    )
    assert touched == ref_touched == {"per-user": 2}
    assert merged.models["per-user"].num_entities == 3
    _same_re_bits(merged.models["per-user"], ref_merged.models["per-user"])
    # no prior: the whole update counts as touched
    _, touched0 = incremental.merge_models(None, update)
    assert touched0 == {"per-user": 2}


# -- the chain ---------------------------------------------------------------


def _auc(model, validation):
    _, ev = GameTransformer(model=model, dtype=torch.float64, device="cpu").transform(validation, ["AUC"])
    return ev.metrics["AUC"]


def test_chain_matches_scratch_union_and_touches_fraction(feeds, run, tmp_path):
    feed, ref_feed = feeds
    res = incremental.run_chain(
        _estimator(), feed["days"], feed["validation"], chain_dir=str(tmp_path / "chain"),
        evaluator_specs=SPECS, gate_margin=0.05, dtype=torch.float64,
    )
    ref_res, _ = _ref_chain(ref_feed, tmp_path, "ref", gate_margin=0.05)
    _same_ledger(_ledger(res), _ledger(ref_res))
    _same_model(res.model, ref_res.model)
    assert (res.rows_touched, res.rows_cumulative) == (ref_res.rows_touched, ref_res.rows_cumulative)
    assert [r.accepted for r in res.ledger].count(True) == 3
    assert res.rows_touched < res.rows_cumulative
    assert res.rows_touched_fraction == pytest.approx(res.rows_touched / res.rows_cumulative)
    scratch = _estimator().fit(feed["union"])
    scratch_auc = _auc(scratch[-1].model, feed["validation"])
    chain_auc = _auc(res.model, feed["validation"])
    assert chain_auc > 0.6
    assert abs(chain_auc - scratch_auc) < 0.05
    # every day's stages were timed
    assert list(res.day_seconds) == [d for d, _ in feed["days"]]
    assert all({"read", "train", "merge", "gate", "day"} <= set(s) for s in res.day_seconds.values())


def test_chain_untouched_entities_carry_bitwise(feeds, run, tmp_path):
    feed, ref_feed = feeds
    days = feed["days"]
    est = _estimator()
    kw = dict(evaluator_specs=SPECS, gate_margin=0.05, dtype=torch.float64)
    first = incremental.run_chain(est, days[:1], feed["validation"], chain_dir=str(tmp_path / "a"), **kw)
    chained = incremental.run_chain(est, days[:2], feed["validation"], chain_dir=str(tmp_path / "b"), **kw)
    ref_chained, _ = _ref_chain(ref_feed, tmp_path, "ref", days=ref_feed["days"][:2], gate_margin=0.05)
    _same_ledger(_ledger(chained), _ledger(ref_chained))
    _same_model(chained.model, ref_chained.model)
    # day 2 only touches e0..e4; e5.. carry forward bitwise from day 1
    day0_re = first.model.models["per-user"]
    re2 = chained.model.models["per-user"]
    assert chained.ledger[1].accepted
    carried = [f"e{k}" for k in range(N_ENT // 2, N_ENT) if day0_re.entity_row(f"e{k}") >= 0]
    assert carried, "no untouched entities materialized on day 1"
    S0 = day0_re.coef_indices.shape[1]
    for e in carried:
        r0, r2 = day0_re.entity_row(e), re2.entity_row(e)
        assert r2 >= 0
        np.testing.assert_array_equal(re2.coef_indices[r2, :S0].numpy(), day0_re.coef_indices[r0].numpy())
        np.testing.assert_array_equal(re2.coef_values[r2, :S0].numpy(), day0_re.coef_values[r0].numpy())
        np.testing.assert_array_equal(re2.coef_indices[r2, S0:].numpy(), -1)


def test_gate_blocks_degraded_day_and_counts_refusal(feeds, run, tmp_path):
    feed, ref_feed = feeds
    poisoned = dataclasses.replace(feed["days"][1][1], labels=1.0 - feed["days"][1][1].labels)
    ref_poisoned = dataclasses.replace(ref_feed["days"][1][1], labels=1.0 - ref_feed["days"][1][1].labels)
    srv = str(tmp_path / "serving")
    res = incremental.run_chain(
        _estimator(), [feed["days"][0], ("20260102", poisoned)], feed["validation"],
        chain_dir=str(tmp_path / "chain"), serving_root=srv, evaluator_specs=SPECS, dtype=torch.float64,
    )
    ref_res, _ = _ref_chain(ref_feed, tmp_path, "ref", days=[ref_feed["days"][0], ("20260102", ref_poisoned)],
                            serving_root=str(tmp_path / "ref-serving"))
    _same_ledger(_ledger(res), _ledger(ref_res))
    assert res.ledger[0].accepted and res.ledger[0].published
    assert not res.ledger[1].accepted
    assert res.ledger[1].reason.startswith("degraded:")
    assert res.ledger[1].snapshot is None
    # the poisoned day never reaches the live store: day 1 keeps serving
    assert refresh.current_snapshot(srv) == res.ledger[0].snapshot
    solo = incremental.run_chain(
        _estimator(), feed["days"][:1], feed["validation"], chain_dir=str(tmp_path / "solo"),
        evaluator_specs=SPECS, dtype=torch.float64,
    )
    np.testing.assert_array_equal(res.model.models["per-user"].coef_values.numpy(),
                                  solo.model.models["per-user"].coef_values.numpy())
    snap = run.registry.snapshot()
    rejected = [m for m in snap if m["name"] == "photon_retrain_rejected_total"]
    assert rejected and rejected[0].get("labels", {}).get("reason") == res.ledger[1].reason
    days_m = {m.get("labels", {}).get("outcome"): m["value"] for m in snap if m["name"] == "photon_retrain_days_total"}
    assert days_m["rejected"] == 1


def test_gate_refuses_non_finite_candidate(feeds, run):
    feed, ref_feed = feeds
    fe = FixedEffectModel(
        model=LogisticRegressionModel(Coefficients(torch.full((D_FIXED,), float("nan"), dtype=torch.float64))),
        feature_shard="global",
    )
    decision = incremental.no_degrade_gate(
        GameModel(models={"global": fe}, task="logistic_regression"), None, feed["validation"], ["AUC"],
        dtype=torch.float64,
    )
    ref_fe = RefFixedEffectModel(model=RefLogisticModel(RefCoefficients(jnp.asarray([np.nan] * D_FIXED))),
                                 feature_shard="global")
    ref_decision = ref_incremental.no_degrade_gate(
        RefGameModel(models={"global": ref_fe}, task="logistic_regression"), None, ref_feed["validation"], ["AUC"],
        dtype=jnp.float64,
    )
    assert (decision.accepted, decision.reason) == (ref_decision.accepted, ref_decision.reason) == (False, "non-finite")


def test_gate_first_publish_without_live_model(feeds, run, tmp_path):
    feed, ref_feed = feeds
    res = incremental.run_chain(
        _estimator(), feed["days"][:1], feed["validation"], chain_dir=str(tmp_path / "chain"),
        evaluator_specs=SPECS, dtype=torch.float64,
    )
    ref_res, _ = _ref_chain(ref_feed, tmp_path, "ref", days=ref_feed["days"][:1])
    _same_ledger(_ledger(res), _ledger(ref_res))
    assert res.ledger[0].accepted and res.ledger[0].reason == "first-publish"


# -- failure drills ----------------------------------------------------------


def _chain_days_json(chain_dir):
    with open(os.path.join(chain_dir, incremental.CHAIN_STATE_NAME)) as f:
        return json.load(f)["days"]


def test_kill_between_days_resumes_identical_ledger(feeds, run, tmp_path):
    feed, ref_feed = feeds
    kw = dict(evaluator_specs=SPECS, dtype=torch.float64, index_maps=_index_maps())
    baseline_dir = str(tmp_path / "baseline")
    incremental.run_chain(_estimator(), feed["days"], feed["validation"], chain_dir=baseline_dir, **kw)
    drilled_dir = str(tmp_path / "drilled")
    faults.configure("retrain.day:kill:2")
    try:
        with pytest.raises(SimulatedKill):
            incremental.run_chain(_estimator(), feed["days"], feed["validation"], chain_dir=drilled_dir, **kw)
    finally:
        faults.clear()
    # the crash-between-days drill: day 1's decision is already durable
    assert len(_chain_days_json(drilled_dir)) == 1
    res = incremental.run_chain(_estimator(), feed["days"], feed["validation"], chain_dir=drilled_dir, **kw)
    assert len(res.ledger) == 3
    # the resumed ledger is bit-exact against the uninterrupted run's
    assert _chain_days_json(drilled_dir) == _chain_days_json(baseline_dir)
    ref_res, _ = _ref_chain(ref_feed, tmp_path, "ref", index_maps=_index_maps(RefIndexMap))
    _same_ledger(_chain_days_json(drilled_dir), _ledger(ref_res))


def test_midday_kill_resumes_via_boundary_checkpoints(feeds, run, tmp_path):
    feed, _ = feeds
    kw = dict(evaluator_specs=SPECS, dtype=torch.float64, index_maps=_index_maps(), checkpoint_every=1)
    baseline_dir = str(tmp_path / "baseline")
    incremental.run_chain(_estimator(), feed["days"][:2], feed["validation"], chain_dir=baseline_dir, **kw)
    drilled_dir = str(tmp_path / "drilled")
    # 2 coordinates x 2 sweeps = 4 boundaries a day; boundary 6 is mid-day-2
    faults.configure("cd.boundary:kill:6")
    try:
        with pytest.raises(SimulatedKill):
            incremental.run_chain(_estimator(), feed["days"][:2], feed["validation"], chain_dir=drilled_dir, **kw)
    finally:
        faults.clear()
    with open(os.path.join(drilled_dir, incremental.CHAIN_STATE_NAME)) as f:
        assert json.load(f)["in_progress"] == "20260102"
    # the day's boundary checkpoints identify their chain position on their
    # own: manifests carry the day label and the decided ledger so far
    day_dir = os.path.join(drilled_dir, "checkpoints", "day-0001")
    manifests = []
    for d in sorted(os.listdir(day_dir)):
        if os.path.isdir(os.path.join(day_dir, d)):
            with open(os.path.join(day_dir, d, "MANIFEST.json")) as f:
                manifests.append(json.load(f))
    assert manifests
    assert all(m["chain_day"] == "20260102" for m in manifests)
    assert all(len(m["chain_ledger"]) == 1 for m in manifests)
    res = incremental.run_chain(_estimator(), feed["days"][:2], feed["validation"], chain_dir=drilled_dir, **kw)
    assert len(res.ledger) == 2 and res.ledger[1].day == "20260102"
    assert _chain_days_json(drilled_dir) == _chain_days_json(baseline_dir)


def test_torn_publish_keeps_old_snapshot_and_repairs_next_cycle(feeds, run, tmp_path):
    feed, _ = feeds
    srv, chain = str(tmp_path / "serving"), str(tmp_path / "chain")
    kw = dict(evaluator_specs=SPECS, dtype=torch.float64, index_maps=_index_maps(), serving_root=srv)
    faults.configure("retrain.publish:io:1")
    try:
        res = incremental.run_chain(_estimator(), feed["days"][:1], feed["validation"], chain_dir=chain, **kw)
    finally:
        faults.clear()
    # the decision is durable, the publish is not: nothing serves yet
    assert res.ledger[0].accepted and not res.ledger[0].published
    assert refresh.current_snapshot(srv) is None
    assert any(m["name"] == "photon_swallowed_errors_total" and m.get("labels", {}).get("site") == "retrain.publish"
               for m in run.registry.snapshot())

    def boom():
        raise AssertionError("a decided day must not reload on repair")

    # the next cycle repairs the store WITHOUT retraining the decided day
    res2 = incremental.run_chain(_estimator(), [("20260101", boom)], feed["validation"], chain_dir=chain, **kw)
    assert refresh.current_snapshot(srv) == res.ledger[0].snapshot
    assert res2.ledger[0].published
    published = [m for m in run.registry.snapshot() if m["name"] == "photon_retrain_published_total"]
    assert published and published[0]["value"] == 1
    # the repaired snapshot holds the accepted model's arrays bitwise
    name, opened = refresh.open_current(srv)
    assert name == res.ledger[0].snapshot
    fe, re_ = opened.coords
    np.testing.assert_array_equal(np.asarray(fe.weights), res.model["global"].model.coefficients.means.numpy())
    np.testing.assert_array_equal(np.asarray(re_.coef_values), res.model["per-user"].coef_values.numpy())
    np.testing.assert_array_equal(np.asarray(re_.coef_indices), res.model["per-user"].coef_indices.numpy())


# -- prior-index compatibility (cli train --incremental-training) ------------


def _save_prior(tmp_path, index_maps):
    model = GameModel(
        models={
            "global": FixedEffectModel(
                model=LogisticRegressionModel(Coefficients(torch.arange(1.0, D_FIXED + 1, dtype=torch.float64))),
                feature_shard="global",
            ),
            "per-user": _re(["uA"], [[0, 1, 2]], [[1.0, 2.0, 3.0]]),
        },
        task="logistic_regression",
    )
    d = str(tmp_path / "prior")
    save_game_model(d, model, index_maps)
    return d


def test_prior_compatibility_exact_remap_refused(tmp_path):
    imaps, ref_imaps = _index_maps(), _index_maps(RefIndexMap)
    model_dir = _save_prior(tmp_path, imaps)
    assert check_prior_compatibility(model_dir, imaps) == ref_check_prior_compatibility(model_dir, ref_imaps) == {
        "global": "exact", "userShard": "exact",
    }
    # permuted index: same key set, another layout -> lossless remap
    permuted = dict(imaps, **{"global": IndexMap({feature_key(f"g{j}", ""): D_FIXED - 1 - j for j in range(D_FIXED)})})
    ref_permuted = dict(ref_imaps, **{"global": RefIndexMap(
        {feature_key(f"g{j}", ""): D_FIXED - 1 - j for j in range(D_FIXED)})})
    assert check_prior_compatibility(model_dir, permuted) == ref_check_prior_compatibility(model_dir, ref_permuted)
    assert check_prior_compatibility(model_dir, permuted)["global"] == "remap"
    # an index missing a prior feature would silently zero its prior mean:
    # refused, not remapped; a shard with no current index at all likewise
    shrunk = dict(imaps, **{"global": IndexMap.from_name_terms([(f"g{j}", "") for j in range(D_FIXED - 1)])})
    ref_shrunk = dict(ref_imaps, **{"global": RefIndexMap.from_name_terms([(f"g{j}", "") for j in range(D_FIXED - 1)])})
    for ours, theirs in ((shrunk, ref_shrunk), ({"global": imaps["global"]}, {"global": ref_imaps["global"]})):
        with pytest.raises(ValueError, match="prior model features absent from the current feature index") as e1:
            check_prior_compatibility(model_dir, ours)
        with pytest.raises(ValueError) as e2:
            ref_check_prior_compatibility(model_dir, theirs)
        assert str(e1.value) == str(e2.value)


def test_fingerprint_stamped_into_model_meta(tmp_path):
    model_dir = _save_prior(tmp_path, _index_maps())
    with open(os.path.join(model_dir, "model-metadata.json")) as f:
        fp = json.load(f)["featureIndexFingerprint"]
    assert set(fp["shards"]) == {"global", "userShard"}
    assert fp["shards"]["global"]["size"] == D_FIXED
    assert fp["shards"]["global"]["keys"] != fp["shards"]["userShard"]["keys"]
    # the JAX package stamps the same digests for the same index
    ref_model = RefGameModel(models={"global": RefFixedEffectModel(
        model=RefLogisticModel(RefCoefficients(jnp.arange(1.0, D_FIXED + 1))), feature_shard="global")},
        task="logistic_regression")
    from photon_ml_tpu.io.model_io import save_game_model as ref_save_game_model

    ref_dir = str(tmp_path / "ref-prior")
    ref_save_game_model(ref_dir, ref_model, _index_maps(RefIndexMap))
    with open(os.path.join(ref_dir, "model-metadata.json")) as f:
        assert json.load(f)["featureIndexFingerprint"] == fp


def test_prior_round_trips_through_chain_store(feeds, run, tmp_path):
    """The chain's models/day-* store reloads bit-exact: day k+1 warm-starts
    from the reloaded model on a resume."""
    feed, _ = feeds
    imaps = _index_maps()
    res = incremental.run_chain(
        _estimator(), feed["days"][:1], feed["validation"], chain_dir=str(tmp_path / "chain"),
        evaluator_specs=SPECS, dtype=torch.float64, index_maps=imaps,
    )
    reloaded = load_game_model(os.path.join(str(tmp_path / "chain"), "models", "day-20260101"), imaps,
                               task="logistic_regression", device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(res.model.models["global"].model.coefficients.means.numpy(),
                                  reloaded.models["global"].model.coefficients.means.numpy())
    re0, re1 = res.model.models["per-user"], reloaded.models["per-user"]
    assert sorted(map(str, re0.entity_ids)) == sorted(map(str, re1.entity_ids))
    for e in map(str, re0.entity_ids):
        a = re0.coef_values[re0.entity_row(e)].numpy()
        b = re1.coef_values[re1.entity_row(e)].numpy()
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_store_files_equal_the_jax_package_stores(feeds, run, tmp_path):
    """A snapshot the port publishes holds the same bytes as the JAX
    package's store of the same model, and each package opens the other's."""
    feed, _ = feeds
    res = incremental.run_chain(
        _estimator(), feed["days"][:1], feed["validation"], chain_dir=str(tmp_path / "chain"),
        evaluator_specs=SPECS, dtype=torch.float64,
    )
    ours = store.build_store_from_model(res.model, str(tmp_path / "ours"))
    m = res.model
    ref_model = RefGameModel(models={
        "global": RefFixedEffectModel(model=RefLogisticModel(RefCoefficients(
            jnp.asarray(m["global"].model.coefficients.means.numpy()))), feature_shard="global"),
        "per-user": _ref_re(m["per-user"].entity_ids, m["per-user"].coef_indices.numpy(),
                            m["per-user"].coef_values.numpy()),
    }, task="logistic_regression")
    theirs = ref_store.build_store_from_model(ref_model, str(tmp_path / "theirs"))
    for name in sorted(os.listdir(theirs)):
        with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    for opened in (store.ModelStore.open(theirs), ref_store.ModelStore.open(ours)):
        assert [c.name for c in opened.coords] == ["global", "per-user"]
        np.testing.assert_array_equal(np.asarray(opened.coords[1].rows_for(["e3", "nobody"])),
                                      [m["per-user"].entity_row("e3"), -1])
    # publish: CURRENT flips atomically, a finished name is immutable unless
    # repaired, and the JAX package reads the port's serving root
    srv = str(tmp_path / "srv")
    refresh.publish_snapshot(srv, "v1", game_model=res.model)
    assert refresh.current_snapshot(srv) == ref_refresh.current_snapshot(srv) == "v1"
    with pytest.raises(FileExistsError):
        refresh.publish_snapshot(srv, "v1", game_model=res.model)
    os.makedirs(os.path.join(srv, "snapshots", ".tmp-v2"))
    refresh.publish_snapshot(srv, "v2", game_model=res.model, replace=True)
    assert ref_refresh.open_current(srv)[0] == "v2"
    model_dir = _save_prior(tmp_path, _index_maps())
    assert store.discover_shards(model_dir) == ref_store.discover_shards(model_dir) == ["global", "userShard"]


def test_grouped_auc_equals_the_jax_package():
    """The gate's per-group AUC (one stable sort by group in the port, a
    mask per group in the JAX package) gives the same bits on many small
    groups, NaN groups included."""
    from photon_ml_tpu.evaluation import build_suite as ref_build_suite
    from photon_ml_tpu_torch.evaluation import build_suite

    rng = np.random.default_rng(3)
    n = 3000
    probs = 1.0 / np.arange(1, 501) ** 1.1
    ids = np.char.add("u", rng.choice(500, size=n, p=probs / probs.sum()).astype(str)).astype(object)
    y, w, s = (rng.random(n) < 0.4).astype(float), rng.random(n) + 0.5, rng.standard_normal(n)
    ours = build_suite(SPECS, y, w, id_tags={"userId": ids}).evaluate(s).metrics
    theirs = ref_build_suite(SPECS, y, w, id_tags={"userId": ids}).evaluate(s).metrics
    assert ours == theirs


# -- cli.retrain end to end ----------------------------------------------------


@pytest.fixture(scope="module")
def retrain_feed(tmp_path_factory):
    """tests/test_cli.py's day-partitioned feed: <base>/yyyy/MM/dd with one
    missing day in the range, a union file for index building and held-out
    validation from the same generating model."""
    d = tmp_path_factory.mktemp("retrainfeed")
    recs = generate_game_records(generate_mixed_effect_data(n=900, d_fixed=5, re_specs={"userId": (15, 3)}, seed=31))
    schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    base = d / "feed"
    for rel, rr in (("2026/01/01", recs[:250]), ("2026/01/02", recs[250:500]), ("2026/01/04", recs[500:700])):
        (base / rel).mkdir(parents=True)
        write_avro_file(str(base / rel / "part-00000.avro"), schema, rr)
    union_p, val_p = str(d / "union.avro"), str(d / "val.avro")
    write_avro_file(union_p, schema, recs[:700])
    write_avro_file(val_p, schema, recs[700:])
    return str(base), union_p, val_p


def _retrain_args(base, idx, val_p, out, srv, extra=()):
    return [
        "--input-data", base, "--input-data-date-range", "20260101-20260104", "--validation-data", val_p,
        "--feature-index-dir", idx, "--task", "logistic_regression",
        "--feature-shard", "name=globalShard,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
        "--coordinate", "name=global,shard=globalShard,optimizer=LBFGS,tolerance=1e-7,max.iter=100,reg.type=L2,"
                        "reg.weights=1",
        "--coordinate", "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1",
        "--coordinate-descent-iterations", "2", "--evaluators", "AUC", "--gate-margin", "0.05",
        "--output-dir", out, "--serving-root", srv, "--log-level", "WARNING", *extra,
    ]


def test_retrain_cli_day_chain_end_to_end(retrain_feed, tmp_path):
    base, union_p, val_p = retrain_feed
    idx = str(tmp_path / "index")
    index.run(["--input-data", union_p, "--feature-shard", "name=globalShard,bags=features",
               "--feature-shard", "name=userShard,bags=userFeatures", "--output-dir", idx, "--num-partitions", "2"])
    out, srv = str(tmp_path / "chain"), str(tmp_path / "serving")
    argv = _retrain_args(base, idx, val_p, out, srv)
    summary = retrain.run(argv + ["--device", "cpu", "--metrics-out", str(tmp_path / "m")])
    ref_idx = str(tmp_path / "ref-index")
    ref_index.run(["--input-data", union_p, "--feature-shard", "name=globalShard,bags=features",
                   "--feature-shard", "name=userShard,bags=userFeatures", "--output-dir", ref_idx,
                   "--num-partitions", "2"])
    ref_srv = str(tmp_path / "ref-serving")
    ref_summary = ref_retrain.run(_retrain_args(base, ref_idx, val_p, str(tmp_path / "ref-chain"), ref_srv))
    # the same decisions, snapshot names and publishes as the JAX package's
    _same_ledger(summary["days"], ref_summary["days"], atol=1e-4)
    for key in ("accepted_days", "rejected_days", "rows_touched", "rows_cumulative"):
        assert summary[key] == ref_summary[key], key
    # the missing 20260103 day dir is skipped, not an error
    assert [d["day"] for d in summary["days"]] == ["20260101", "20260102", "20260104"]
    assert summary["accepted_days"] >= 1
    assert 0.0 < summary["rows_touched_fraction"] <= 1.0
    assert os.path.exists(os.path.join(out, "retrain-summary.json"))
    published = [d for d in summary["days"] if d["published"]]
    assert published
    assert refresh.current_snapshot(srv) == ref_refresh.current_snapshot(ref_srv) == \
        f"retrain-{published[-1]['day']}"
    assert set(summary["day_seconds"]) == {d["day"] for d in summary["days"]}
    with open(os.path.join(str(tmp_path / "m"), "metrics.prom")) as f:
        prom = f.read()
    assert "photon_retrain_days_total" in prom and "photon_retrain_stage_seconds" in prom
    # a rerun is a resume: decided days are skipped, the ledger is unchanged
    summary2 = retrain.run(argv + ["--device", "cpu"])
    assert summary2["days"] == summary["days"]
    assert summary2["day_seconds"] == {}


def test_retrain_cli_refusals(retrain_feed, tmp_path):
    base, _, val_p = retrain_feed
    out = str(tmp_path / "chain")
    no_index = ["--input-data", base, "--input-data-date-range", "20260101-20260104", "--validation-data", val_p,
                "--output-dir", out, "--device", "cpu"]
    no_range = ["--input-data", base, "--validation-data", val_p, "--feature-index-dir", str(tmp_path / "idx"),
                "--output-dir", out, "--device", "cpu"]
    for argv, what in ((no_index, "feature-index-dir"), (no_range, "day-partitioned feed")):
        with pytest.raises(SystemExit, match=what) as ours:
            retrain.run(argv)
        with pytest.raises(SystemExit) as theirs:
            ref_retrain.run(argv[:-2])
        assert str(ours.value) == str(theirs.value)
    # illegal compositions are typed refusals in the JAX package's words
    common = ["--input-data", base, "--input-data-date-range", "20260101-20260104", "--validation-data", val_p,
              "--feature-index-dir", str(tmp_path / "idx"), "--output-dir", out]
    for extra, what in (
        (["--distributed", "coordinator=127.0.0.1:9000"], "not composable with --distributed"),
        (["--trial-lanes", "4"], "not composable with --trial-lanes"),
        (["--coordinate", "name=global,shard=globalShard,reg.type=L2,reg.weights=1,hbm.budget.mb=64"],
         "hbm.budget.mb streaming"),
    ):
        with pytest.raises(PlanError, match=what) as ours:
            retrain.run(common + extra + ["--device", "cpu"])
        with pytest.raises(ValueError) as theirs:
            ref_retrain.run(common + extra)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(PlanError, match="ROADMAP A13"):
        retrain.run(common + ["--status-port", "0", "--device", "cpu"])
