"""The port's counterpart of tests/test_support_matrix.py: the JAX package's
refusal inventory held against the port's refusal sites.

For each of the JAX suite's 38 cases (its ``CASES``, imported as they are)
that has a site in the port, the port's trigger raises the same exception
type (the port's ``PlanError`` for the JAX package's) and its message is
the JAX package's message, or contains the documented fragment where the
message carries something of the port's own (a path, a call site); every
case whose message differs says so in ``PARAPHRASED``.

The port departs on purpose where its ranks stand for a mesh's devices
(``DEPARTURES``): several processes train with no mesh (their data axis is
the process count), and a model axis over processes runs on a grid of
ranks. Those cases run here; none is skipped.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import test_support_matrix as jax_matrix
from photon_ml_tpu.plan import PlanError as JaxPlanError
from photon_ml_tpu.testing import generate_mixed_effect_data as jax_generate
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as jax_to_raw
from photon_ml_tpu_torch.estimators.game_estimator import CoordinateConfig, GameEstimator
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.ops.glm import MAX_FULL_VARIANCE_DIM, check_full_variance_dim
from photon_ml_tpu_torch.ops.normalization import build_normalization
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.parallel import mesh as mesh_mod
from photon_ml_tpu_torch.plan import PlanError
from photon_ml_tpu_torch.testing import generate_mixed_effect_data, mixed_data_to_raw_dataset

JAX_CASES = {c[0]: c[1:] for c in jax_matrix.CASES}


@pytest.fixture(scope="module")
def raw():
    """tests/test_support_matrix.py's ``raw``: 80 rows, 5 fixed features,
    6 users of 3, seed 3, in each package."""
    kw = dict(n=80, d_fixed=5, re_specs={"userId": (6, 3)}, seed=3)
    return mixed_data_to_raw_dataset(generate_mixed_effect_data(**kw)), jax_to_raw(jax_generate(**kw))


def _cfg(**kw):
    return GLMOptimizationConfig(regularization=RegularizationContext("L2"), reg_weight=1.0, **kw)


def _estimator(ccs, mesh=None, **kw):
    return GameEstimator(task="logistic_regression", coordinate_configs=ccs, mesh=mesh, device="cpu", **kw)


def _fe(name="global", **kw):
    return CoordinateConfig(name=name, feature_shard="global", config=kw.pop("config", _cfg()), **kw)


def _lane_check(ccs, mesh=None, distributed=False, **est_kw):
    from photon_ml_tpu_torch.game.lanes import check_lane_composition

    check_lane_composition(_estimator(ccs, mesh=mesh, **est_kw), 4, distributed=distributed)


def _write_parts(tmp_path):
    from photon_ml_tpu_torch.io import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing import generate_game_records

    data = generate_mixed_effect_data(n=8, d_fixed=3, re_specs={}, seed=11)
    write_avro_file(str(tmp_path / "part-00000.avro"), TRAINING_EXAMPLE_AVRO, generate_game_records(data))


def _disk_slice(raw, tmp_path):
    from photon_ml_tpu_torch.game.data import build_fixed_effect_dataset_from_disk
    from photon_ml_tpu_torch.io import FeatureShardConfig

    _write_parts(tmp_path)
    build_fixed_effect_dataset_from_disk(
        str(tmp_path), {"global": FeatureShardConfig(feature_bags=("features",))}, "global", "global", 1 << 20,
        layout="coo", device="cpu",
    )


def _prior_index_mismatch(raw, tmp_path):
    from photon_ml_tpu_torch.io.index_map import IndexMap
    from photon_ml_tpu_torch.io.model_io import check_prior_compatibility, save_game_model
    from photon_ml_tpu_torch.models.coefficients import Coefficients
    from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel
    from photon_ml_tpu_torch.models.glm import LogisticRegressionModel

    imaps = {"global": IndexMap.from_name_terms([("f0", ""), ("f1", "")], add_intercept=False)}
    model = GameModel(models={"global": FixedEffectModel(
        model=LogisticRegressionModel(Coefficients(torch.tensor([1.0, 2.0]))), feature_shard="global",
    )}, task="logistic_regression")
    model_dir = str(tmp_path / "prior")
    save_game_model(model_dir, model, imaps)
    check_prior_compatibility(model_dir, {"global": IndexMap.from_name_terms([("f0", "")], add_intercept=False)})


def _store_version(raw, tmp_path):
    import json

    from photon_ml_tpu_torch.serving.store import ModelStore

    d = tmp_path / "store"
    d.mkdir()
    (d / "store-meta.json").write_text(json.dumps({"version": 99, "task": "x", "coordinates": []}))
    ModelStore.open(str(d))


def _chain_state_version(raw, tmp_path):
    import json

    from photon_ml_tpu_torch.game import incremental

    chain_dir = tmp_path / "chain"
    chain_dir.mkdir()
    (chain_dir / incremental.CHAIN_STATE_NAME).write_text(json.dumps({"version": 99, "days": []}))
    incremental._load_chain_state(str(chain_dir))


def _planner():
    from photon_ml_tpu_torch.plan import planner

    return planner


def _norm(intercept_index):
    return build_normalization("STANDARDIZATION", np.ones(4), np.ones(4), np.ones(4),
                               intercept_index=intercept_index, device="cpu")


# the port's trigger of each JAX case with a site in the port: ``raw`` is
# the port's dataset; ``tmp_path`` where the case writes files
PORT_TRIGGERS = {
    "ckpt-model-axis-reshape": lambda raw: _planner().check_checkpoint_topology(
        {"mesh_axes": {"data": 8, "model": 1}}, {"mesh_axes": {"data": 4, "model": 2}}),
    "ckpt-process-count-reshape": lambda raw: _planner().check_checkpoint_topology(
        {"n_processes": 2, "global_rows": 8}, {"n_processes": 3, "global_rows": 9}),
    "ckpt-plan-fingerprint": lambda raw: _planner().check_checkpoint_topology(
        {"plan_fingerprint": "fp-aaaa"}, {"plan_fingerprint": "fp-bbbb"}),
    "chain-state-version": _chain_state_version,
    "retrain-distributed": lambda raw: _planner().check_retrain_composition(True, 1),
    "retrain-trial-lanes": lambda raw: _planner().check_retrain_composition(False, 4),
    "retrain-streamed": lambda raw: _planner().check_retrain_composition(False, 1, ["global"]),
    "prior-index-mismatch": _prior_index_mismatch,
    "lanes-mesh": lambda raw: _lane_check([_fe()], mesh=mesh_mod.make_mesh(1, 1, device="cpu")),
    "lanes-multiprocess": lambda raw: _lane_check([_fe()], distributed=True),
    "lanes-pipeline": lambda raw: _lane_check([_fe()], pipeline_depth=2),
    "lanes-partial-retrain": lambda raw: _lane_check([_fe()], partial_retrain_locked=["global"]),
    "lanes-streamed": lambda raw: _lane_check([_fe(hbm_budget_mb=1)]),
    "lanes-l1": lambda raw: _lane_check([_fe(config=GLMOptimizationConfig(
        regularization=RegularizationContext("L1"), reg_weight=1.0))]),
    "lanes-variance": lambda raw: _lane_check([_fe(config=_cfg(variance_type="SIMPLE"))]),
    "lanes-down-sampling": lambda raw: _lane_check([_fe(config=_cfg(down_sampling_rate=0.5))]),
    "lanes-normalization": lambda raw: _lane_check([_fe(normalization=_norm(0))]),
    "lanes-regularize-by-prior": lambda raw: _lane_check([_fe(regularize_by_prior=True)]),
    "feature-dtype-tiled-estimator": lambda raw: _estimator([_fe(layout="tiled", feature_dtype=torch.bfloat16)]),
    "feature-dtype-tiled-batch": lambda raw: raw.to_batch("global", layout="tiled", feature_dtype=torch.bfloat16),
    "tiled-no-mesh-estimator": lambda raw: _estimator([_fe(layout="tiled")]),
    "tiled-no-mesh-batch": lambda raw: raw.to_batch("global", layout="tiled"),
    "streamed-fe-bad-layout": lambda raw: _estimator([_fe(layout="coo", hbm_budget_mb=1)]),
    "streamed-fe-variance": lambda raw: _estimator([_fe(config=_cfg(variance_type="SIMPLE"), hbm_budget_mb=1)]),
    "streamed-fe-down-sampling": lambda raw: _estimator([_fe(config=_cfg(down_sampling_rate=0.5), hbm_budget_mb=1)]),
    "streamed-fe-deep-check": lambda raw: GLMProblem(
        task="logistic_regression", config=_cfg(variance_type="FULL")).run_streamed(None, 1 << 20),
    "full-variance-ceiling": lambda raw: check_full_variance_dim(MAX_FULL_VARIANCE_DIM + 1),
    "standardization-no-intercept": lambda raw: _norm(None),
    "coo-on-mesh": lambda raw: mesh_mod.shard_batch(
        raw.to_batch("global", layout="coo", device="cpu"), mesh_mod.make_mesh(1, 1, device="cpu")),
    # a row-sharded ELL batch over two processes: the group of rank 0 of 2
    "multiprocess-ell": lambda raw: mesh_mod.shard_batch(
        raw.to_batch("global", layout="ell", device="cpu"), mesh_mod.DataParallelGroup(0, 2, "cpu", "gloo")),
    # a model axis over processes with no grid: a data-only group of 2
    "multiprocess-model-axis": lambda raw: mesh_mod.shard_coefficients(
        torch.zeros(8), mesh_mod.DataParallelGroup(0, 2, "cpu", "gloo")),
    "serving-width-ladder": lambda raw: _ladder(),
    "serving-store-version": _store_version,
    "socket-and-listen": lambda raw: _check_socket_front(),
    "fleet-duplicate-model": lambda raw: _planner().check_fleet_composition(["jobs-us", "jobs-emea", "jobs-us"]),
    "fleet-front-af-unix": lambda raw: _planner().check_fleet_composition(
        (), front_replicas=["/tmp/photon-serve.sock"]),
    "disk-slice-bad-layout": _disk_slice,
}


def _ladder():
    from photon_ml_tpu_torch.serving.engine import LADDER_WIDTH, _ladder_width

    _ladder_width(LADDER_WIDTH[-1] + 1)


def _check_socket_front():
    from photon_ml_tpu_torch.cli.serve import check_socket_front

    check_socket_front("/tmp/serve.sock", "127.0.0.1:8473")


# cases whose message carries something of the port's own beside the
# documented fragment, and what
PARAPHRASED = {
    "multiprocess-model-axis": "prefixed with the port's call site (shard_coefficients)",
    "chain-state-version": "the port's own chain directory's path",
    "serving-store-version": "the port's own store directory's path",
    "prior-index-mismatch": "the port's own model directory's path",
    "disk-slice-bad-layout": "the port's own part directory's path",
    "full-variance-ceiling": "the port's ceiling, d = 65,536 (ops/glm.py MAX_FULL_VARIANCE_DIM, measured on the card)",
}


def _departure_multiprocess_no_mesh():
    """The JAX package needs a mesh spanning the global devices; the port's
    ranks are processes of one card each, so two processes with no mesh
    resolve the JAX package's plan over a data axis of the process count."""
    from photon_ml_tpu.cli.params import parse_coordinate as ref_parse_coordinate
    from photon_ml_tpu.plan import resolve as ref_resolve
    from photon_ml_tpu_torch.cli.params import parse_coordinate

    planner = _planner()
    assert planner.check_multiprocess_mesh(2, None) is None
    spec = "name=global,shard=global,reg.type=L2,reg.weights=1"
    ours = planner.resolve([parse_coordinate(spec)], n_processes=2, distributed=True)
    theirs = ref_resolve([ref_parse_coordinate(spec)], mesh={"data": 2, "model": 1}, n_processes=2,
                         distributed=True)
    assert [c.sharding for c in ours.coordinates] == [c.sharding for c in theirs.coordinates] == ["row-sharded"]


def _departure_multiprocess_model_axis():
    """The JAX package refuses a model axis over processes; the port's ranks
    take a mesh's devices' place, so on a (1 x 2) grid of ranks (made by
    hand here: cutting a slice needs no collective) each rank keeps its
    model slice, zero-padded to the grid."""
    groups = [mesh_mod.DataParallelGroup(j, 2, "cpu", "gloo") for j in range(2)]
    for j in range(2):
        grid = mesh_mod.MeshGroup(1, 2, 0, j, mesh_mod.DataParallelGroup(0, 1, "cpu", "gloo"), groups[j], groups[j])
        got = mesh_mod.shard_coefficients(torch.arange(7.0), grid)
        assert torch.equal(got, torch.tensor([0.0, 1, 2, 3, 4, 5, 6, 0])[4 * j : 4 * (j + 1)])


DEPARTURES = {
    "multiprocess-no-mesh": _departure_multiprocess_no_mesh,
    "multiprocess-model-axis": _departure_multiprocess_model_axis,
}


# the port's pins, one per JAX case: (id, documented fragment, the port's
# exception type, or None where the port departs). The port's lint (its R10
# pass) reads them statically; a test holds them to the JAX package's CASES.
CASES = [
    ('ckpt-model-axis-reshape', 'checkpoint mesh reshape across the model axis is not supported', PlanError),
    ('ckpt-process-count-reshape', 'the process count changed and no legal reshape exists', PlanError),
    ('ckpt-plan-fingerprint', 'resuming across a changed execution plan is not supported', PlanError),
    ('chain-state-version', 'unsupported chain-state version', ValueError),
    ('retrain-distributed', 'incremental retrain is single-process: not composable with --distributed', PlanError),
    (
        'retrain-trial-lanes',
        'incremental retrain warm-starts with regularize-by-prior: not composable with --trial-lanes',
        PlanError,
    ),
    (
        'retrain-streamed',
        'incremental retrain requires HBM-resident coordinates: not composable with hbm.budget.mb streaming',
        PlanError,
    ),
    ('prior-index-mismatch', 'prior model features absent from the current feature index', ValueError),
    ('lanes-mesh', 'trial-lanes sweeps are single-chip: not composable with a device mesh', PlanError),
    (
        'lanes-multiprocess',
        'trial-lanes sweeps are single-process: not composable with multi-process training',
        PlanError,
    ),
    (
        'lanes-pipeline',
        'trial-lanes sweeps drive their own lane schedule: not composable with pipeline_depth > 1',
        PlanError,
    ),
    ('lanes-partial-retrain', 'partial retraining (locked coordinates) is not supported with trial-lanes', PlanError),
    ('lanes-streamed', 'trial-lanes sweeps require HBM-resident coordinates', PlanError),
    (
        'lanes-l1',
        'trial-lanes sweeps support L2 regularization only (the OWL-QN l1 weight is compile-time static, not a per-lane operand)',
        ValueError,
    ),
    ('lanes-variance', 'trial-lanes sweeps require variance=NONE', ValueError),
    ('lanes-down-sampling', 'down-sampling is not supported with trial-lanes', ValueError),
    ('lanes-normalization', 'feature normalization is not supported with trial-lanes', ValueError),
    ('lanes-regularize-by-prior', 'regularize-by-prior is not supported with trial-lanes', ValueError),
    ('feature-dtype-tiled-estimator', "feature_dtype is not supported with layout='tiled'", PlanError),
    ('feature-dtype-tiled-batch', 'feature_dtype is not supported on the tiled layout', ValueError),
    ('tiled-no-mesh-estimator', "layout='tiled' requires the estimator to be built with a device mesh", ValueError),
    ('tiled-no-mesh-batch', "layout='tiled' requires a device mesh", ValueError),
    ('streamed-fe-bad-layout', 'hbm_budget_mb on a fixed effect requires a row-sliceable layout', ValueError),
    (
        'streamed-fe-variance',
        'is not supported with hbm_budget_mb on a fixed effect (out-of-core row slices never materialize the Hessian)',
        PlanError,
    ),
    (
        'streamed-fe-down-sampling',
        'down_sampling_rate < 1 is not supported with hbm_budget_mb on a fixed effect',
        PlanError,
    ),
    ('streamed-fe-deep-check', 'not supported on the streamed fixed-effect path', ValueError),
    ('full-variance-ceiling', 'exceeds the supported ceiling', ValueError),
    ('standardization-no-intercept', 'STANDARDIZATION requires an intercept term', ValueError),
    ('coo-on-mesh', 'shard_batch does not support the column-sorted COO layout', NotImplementedError),
    ('multiprocess-ell', 'multi-process ELL sharding is not supported', NotImplementedError),
    ('multiprocess-no-mesh', 'multi-process training requires a device mesh spanning all global devices', None),
    ('multiprocess-model-axis', 'model-axis sharding across processes is not supported yet', NotImplementedError),
    ('serving-width-ladder', "exceeds the serving engine's padded feature-width ladder", ValueError),
    ('serving-store-version', 'unsupported serving store version', ValueError),
    ('socket-and-listen', 'pass at most one of --socket / --listen (one socket front per server process)', ValueError),
    ('fleet-duplicate-model', 'duplicate model name in the serving fleet', PlanError),
    (
        'fleet-front-af-unix',
        'the replica front routes over TCP replicas: not composable with AF_UNIX socket paths',
        PlanError,
    ),
    ('disk-slice-bad-layout', 'the disk-to-slice ingest path requires a row-sliceable layout', ValueError),
]


def test_port_pins_are_the_jax_cases():
    assert [c[:2] for c in CASES] == [c[:2] for c in jax_matrix.CASES]
    for case, _, exc in CASES:
        if exc is None:
            assert case in DEPARTURES and case not in PORT_TRIGGERS
        else:
            jax_exc = JAX_CASES[case][1]
            assert exc is (PlanError if jax_exc is JaxPlanError else jax_exc)


def test_every_jax_case_has_a_port_site_or_a_departure():
    assert len(JAX_CASES) == 38
    assert set(PORT_TRIGGERS) | set(DEPARTURES) == set(JAX_CASES)
    assert set(PARAPHRASED) <= set(PORT_TRIGGERS)


def _call(trigger, raw, monkeypatch, tmp_path):
    available = {"monkeypatch": monkeypatch, "tmp_path": tmp_path}
    kwargs = {k: v for k, v in available.items() if k in trigger.__code__.co_varnames}
    trigger(raw, **kwargs)


@pytest.mark.parametrize("case", sorted(PORT_TRIGGERS))
def test_port_refuses_as_the_jax_package(case, raw, monkeypatch, tmp_path):
    """The JAX package's trigger and the port's raise the same type; the
    port's message is the JAX package's, or holds its documented fragment
    where ``PARAPHRASED`` says why it differs."""
    fragment, jax_exc, jax_trigger = JAX_CASES[case]
    ours_raw, jax_raw = raw
    (tmp_path / "jax").mkdir()
    with pytest.raises(jax_exc) as theirs:
        with monkeypatch.context() as m:
            _call(jax_trigger, jax_raw, m, tmp_path / "jax")
    port_exc = PlanError if jax_exc is JaxPlanError else jax_exc
    (tmp_path / "port").mkdir()
    with pytest.raises(port_exc, match=re.escape(fragment)) as ours:
        _call(PORT_TRIGGERS[case], ours_raw, monkeypatch, tmp_path / "port")
    assert "ROADMAP" not in str(ours.value)
    if case not in PARAPHRASED:
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("case", sorted(DEPARTURES))
def test_port_runs_what_it_departs_on(case):
    DEPARTURES[case]()
