"""A dense fixed effect on the port's (data x model) grid through ``cli.train``.

``cli.train --mesh-shape data=2,model=2`` over 4 gloo CPU ranks with a
tiled fixed effect (the whole grid), a dense fixed effect (each data row's
rows, replicated over the model axis: each model column runs B1-B3 through
B4 over its data subgroup) and a random effect over the data axis, in
float64, both fixed effects under STANDARDIZATION, against the JAX package
on the CPU:

- the models against the JAX package's ``GameEstimator(mesh=make_mesh(2,
  2))`` in one process, in float64: both fixed effects rtol 1e-3 / atol
  1e-5 (the dense one's SIMPLE variances too), the random effect by entity
  id atol 5e-3, the validation logistic loss atol 1e-4 and AUC within 1e-4;
- every rank's best model bitwise alike (the dense fixed effect's M
  replicas among them: each rank logs its digest);
- the plan against the JAX package's ``cli.train --mesh-shape
  data=2,model=2 --explain-plan`` (each coordinate's kind, layout,
  sharding, residency and notes) and the checkpoint's plan fingerprint
  against the JAX package's;
- the run killed at every rank's second boundary checkpoint and resumed:
  the straight run's models, bitwise; a resume on data=4,model=1 refused in
  the JAX package's words.

Every rank is an OS process (``tests/_torch_mp_common.py``).
"""

from __future__ import annotations

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mp_common import assert_ok, build_index, launch, write_glmix_avro
from photon_ml_tpu.cli import train as ref_train
from photon_ml_tpu.cli.params import parse_coordinate as ref_parse_coordinate
from photon_ml_tpu.estimators.game_estimator import GameEstimator as RefGameEstimator
from photon_ml_tpu.io import FeatureShardConfig as RefShardConfig
from photon_ml_tpu.io import read_avro_dataset as ref_read_avro_dataset
from photon_ml_tpu.io.index_map import load_partitioned as ref_load_partitioned
from photon_ml_tpu.ops.normalization import build_normalization as ref_build_normalization
from photon_ml_tpu.parallel import make_mesh as ref_make_mesh
from photon_ml_tpu.plan import plan_fingerprint as ref_plan_fingerprint
from photon_ml_tpu.plan import resolve as ref_resolve
from photon_ml_tpu.utils.stats import compute_feature_statistics as ref_feature_statistics
from photon_ml_tpu_torch.cli import train
from photon_ml_tpu_torch.io.index_map import load_partitioned
from photon_ml_tpu_torch.io.model_io import load_game_model

SHARDS = ["--feature-shard", "name=globalShard,bags=features", "--feature-shard", "name=userShard,bags=userFeatures"]
BAGS = {"globalShard": "features", "userShard": "userFeatures"}
SOLVE = "tolerance=1e-12,max.iter=300,reg.type=L2,reg.weights=1"
SPECS = [
    f"name=global,shard=globalShard,optimizer=LBFGS,{SOLVE},layout=tiled",
    f"name=user-fixed,shard=userShard,optimizer=TRON,{SOLVE},variance=SIMPLE",
    f"name=per-user,shard=userShard,re.type=userId,optimizer=LBFGS,{SOLVE}",
]
PORT = ["--device", "cpu", "--dtype", "float64"]
GRID = ["--mesh-shape", "data=2,model=2"]
DIGEST = re.compile(r"best model sha256 ([0-9a-f]{64}) \(process (\d+)\)")


def _common(data, index_dir, ck):
    argv = [*SHARDS, "--input-data", data, "--validation-data", data, "--task", "logistic_regression",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC,LOGISTIC_LOSS", "--feature-index-dir",
            index_dir, "--normalization", "STANDARDIZATION", *PORT, "--checkpoint-dir", ck, "--checkpoint-every", "1"]
    for spec in SPECS:
        argv += ["--coordinate", spec]
    return argv


def _digests(outs):
    """Each rank's logged best-model digest, in rank order."""
    found = {}
    for _, _, err in outs:
        for digest, process in DIGEST.findall(err):
            found[int(process)] = digest
    return [found.get(i) for i in range(len(outs))]


def _load(out, index_dir):
    maps = {s: load_partitioned(index_dir, s) for s in BAGS}
    return load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression", device="cpu",
                           dtype=torch.float64)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """641 GLMix rows (321 / 320 on the two data rows) and their index; the
    straight grid run, a boundary checkpoint every update."""
    d = tmp_path_factory.mktemp("dense-grid")
    data = write_glmix_avro(d / "glmix.avro", n=641)
    index_dir = build_index(data, SHARDS, d / "index")
    argv = _common(data, index_dir, str(d / "ck"))
    out = str(d / "out")
    outs = launch("train", argv + ["--output-dir", out] + GRID, world=4)
    assert_ok(outs)
    return dict(root=d, data=data, index=index_dir, argv=argv, out=out, outs=outs)


def test_dense_and_tiled_fixed_effects_on_a_grid_match_the_jax_mesh(straight):
    """The grid's models against the JAX package's one-process (2 x 2) mesh
    at ROADMAP's bounds; every rank's best model bitwise alike."""
    digests = _digests(straight["outs"])
    assert digests[0] is not None and digests == [digests[0]] * 4
    maps = {s: ref_load_partitioned(straight["index"], s) for s in BAGS}
    raw, _ = ref_read_avro_dataset(straight["data"], {s: RefShardConfig((b,)) for s, b in BAGS.items()},
                                   index_maps=maps, id_tag_columns=["userId"])
    coords = [ref_parse_coordinate(s) for s in SPECS]
    for cc in coords:
        if not cc.is_random_effect:
            st = ref_feature_statistics(raw, cc.feature_shard)
            cc.normalization = ref_build_normalization(
                "STANDARDIZATION", st["mean"], st["variance"], st["max_magnitude"],
                intercept_index=maps[cc.feature_shard].intercept_index)
    est = RefGameEstimator("logistic_regression", coords, n_cd_iterations=2, evaluator_specs=["AUC", "LOGISTIC_LOSS"],
                           dtype=jnp.float64, mesh=ref_make_mesh(n_data=2, n_model=2))
    ref = est.fit(raw, validation=raw)[0]
    m = _load(straight["out"], straight["index"])
    for name in ("global", "user-fixed"):
        ours, theirs = m.models[name].model.coefficients, ref.model[name].model.coefficients
        assert ours.means.shape[0] == np.asarray(theirs.means).shape[0]  # the tiled padding trimmed
        np.testing.assert_allclose(ours.means.numpy(), np.asarray(theirs.means), rtol=1e-3, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(m.models["user-fixed"].model.coefficients.variances.numpy(),
                               np.asarray(ref.model["user-fixed"].model.coefficients.variances), rtol=1e-3, atol=1e-5)
    re_m, re_r = m.models["per-user"], ref.model["per-user"]
    dim = int(np.asarray(re_r.coef_indices).max()) + 1
    ids = [str(e) for e in re_r.entity_ids if not str(e).startswith("__pad")]
    rows_m = re_m.rows_for(ids)
    assert np.all(rows_m >= 0), "the grid's model is missing entities"
    np.testing.assert_allclose(np.asarray(re_m.dense_coefficients(dim))[rows_m],
                               np.asarray(re_r.dense_coefficients(dim))[re_r.rows_for(ids)], rtol=0, atol=5e-3)
    with open(os.path.join(straight["out"], "training-summary.json")) as f:
        metrics = json.load(f)["best"]["metrics"]
    assert abs(metrics["LOGISTIC_LOSS"] - ref.evaluation.metrics["LOGISTIC_LOSS"]) <= 1e-4
    assert abs(metrics["AUC"] - ref.evaluation.metrics["AUC"]) <= 1e-4


def test_grid_plan_and_fingerprint_match_the_jax_cli(straight, capsys):
    """The port's plan for the grid against the JAX package's ``cli.train
    --mesh-shape data=2,model=2 --explain-plan``, and the fingerprint in
    the grid run's checkpoint manifest against the JAX package's."""
    argv = [*SHARDS, "--input-data", "x", "--output-dir", "o", *GRID, "--normalization", "STANDARDIZATION",
            "--explain-plan"]
    for spec in SPECS:
        argv += ["--coordinate", spec]
    ours = train.run(argv + ["--distributed", "coordinator=h:1,process=0,n=4"])["plan"]
    theirs = ref_train.run(argv)["plan"]
    keys = ("name", "kind", "layout", "feature_dtype", "residency", "sharding", "pipelined", "notes")
    assert [{k: c[k] for k in keys} for c in ours["coordinates"]] == [
        {k: c[k] for k in keys} for c in theirs["coordinates"]]
    assert [c["sharding"] for c in ours["coordinates"]] == ["row+model-sharded", "row+model-sharded",
                                                            "entity-sharded"]
    assert ours["mesh_axes"] == theirs["mesh_axes"] == {"data": 2, "model": 2}
    capsys.readouterr()
    boundaries = os.path.join(straight["root"], "ck", "cd-boundaries")
    with open(os.path.join(boundaries, sorted(os.listdir(boundaries))[-1], "MANIFEST.json")) as f:
        topology = json.load(f)["topology"]
    assert topology["mesh_axes"] == {"data": 2, "model": 2}
    # the JAX package's checkpoint records its estimator's plan (the
    # estimator resolves with the default normalization, as the port's does)
    ref_plan = ref_resolve([ref_parse_coordinate(s) for s in SPECS], mesh={"data": 2, "model": 2})
    assert topology["plan_fingerprint"] == ref_plan_fingerprint(ref_plan)


def test_grid_kill_and_resume_is_bitwise(straight, tmp_path):
    """Every rank dies after its second boundary checkpoint; the same
    command with --resume ends with the straight run's models, bitwise, and
    a resume on a grid without the model axis is refused in the JAX
    package's words."""
    argv = list(straight["argv"])
    argv[argv.index("--checkpoint-dir") + 1] = str(tmp_path / "ck")
    kill = {"PHOTON_FAULTS": "cd.boundary_saved:kill:2"}
    outs = launch("train", argv + ["--output-dir", str(tmp_path / "out")] + GRID, world=4,
                  env_by_rank={i: kill for i in range(4)})
    for rc, _, err in outs:
        assert rc != 0 and "SimulatedKill" in err, err[-3000:]
    outs = launch("train", argv + ["--output-dir", str(tmp_path / "out")] + GRID + ["--resume"], world=4)
    assert_ok(outs)
    assert "resuming from checkpoint" in outs[0][2]
    assert _digests(outs) == _digests(straight["outs"])
    outs = launch("train", argv + ["--output-dir", str(tmp_path / "again"), "--mesh-shape", "data=4,model=1",
                                   "--resume"], world=4)
    for rc, _, err in outs:
        assert rc != 0 and "checkpoint mesh reshape across the model axis is not supported" in err
