"""The port's GAME driver (``photon_ml_tpu_torch.cli.train`` /
``cli.score`` with ``--device cpu``, ``GameEstimator``, ``ScoreEngine``)
against the JAX package's on tests/test_cli.py's fixture
(generate_mixed_effect_data, n=900, a 600 / 300 Avro split):

- ``cli train`` in float32 on both sides: each coordinate's last accepted
  training loss at rtol 1e-5 and the best validation AUC within 1e-4;
- ``GameEstimator.fit`` in float64 on both sides: fixed-effect coefficients
  at rtol 1e-3 / atol 1e-5, random-effect coefficients at atol 5e-3;
- models written by either driver load in the other package and score
  within rtol 1e-5 of the writer's scores;
- ``cli score`` equals ``GameTransformer.transform`` bit for bit;
- the checkpoint, grid-resume and kill-and-resume cases of
  tests/test_cli.py through the port (boundary resume bit for bit);
- ``--explain-plan``, and the PlanError of every refused flag, which
  names its ROADMAP item;
- ``--model-input-dir``, ``--incremental-training`` and
  ``--partial-retrain-locked``, warm-started from a model the JAX package
  trained, at the float32 bounds above."""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import score as ref_score
from photon_ml_tpu.cli import train as ref_train
from photon_ml_tpu.estimators.game_estimator import GameEstimator as RefGameEstimator
from photon_ml_tpu.io import FeatureShardConfig as RefShardConfig
from photon_ml_tpu.io import read_avro_dataset as ref_read_avro_dataset
from photon_ml_tpu.io.model_io import load_game_model as ref_load_game_model
from photon_ml_tpu.cli.params import check_retrain_composition as ref_check_retrain_composition
from photon_ml_tpu.cli.params import parse_coordinate as ref_parse_coordinate
from photon_ml_tpu.plan import plan_fingerprint as ref_plan_fingerprint
from photon_ml_tpu.plan import resolve as ref_resolve
from photon_ml_tpu.serving.engine import ScoreEngine as RefScoreEngine
from photon_ml_tpu_torch.cli import feature_bags, score, train
from photon_ml_tpu_torch.cli.params import (
    check_retrain_composition,
    parse_coordinate,
    parse_mesh_shape,
    plan_host_row_split,
)
from photon_ml_tpu_torch.estimators import GameEstimator, GameTransformer
from photon_ml_tpu_torch.io import FeatureShardConfig, read_avro_dataset, write_avro_file
from photon_ml_tpu_torch.io.model_io import load_game_model, save_game_model
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
from photon_ml_tpu_torch.ops import sparse
from photon_ml_tpu_torch.plan import PlanError, plan_fingerprint, resolve
from photon_ml_tpu_torch.robust import faults
from photon_ml_tpu_torch.serving import ScoreEngine
from photon_ml_tpu_torch.testing import generate_game_records, generate_mixed_effect_data

SHARDS = ["--feature-shard", "name=globalShard,bags=features", "--feature-shard", "name=userShard,bags=userFeatures"]
FE_SPEC = "name=global,shard=globalShard,optimizer=LBFGS,tolerance=1e-7,max.iter=100,reg.type=L2,reg.weights=1"
RE_SPEC = "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1"


@pytest.fixture(autouse=True)
def _no_leaked_injector(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    yield
    faults.clear()


@pytest.fixture(scope="module")
def avro_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("gamedata")
    data = generate_mixed_effect_data(n=900, d_fixed=5, re_specs={"userId": (15, 3)}, seed=31)
    recs = generate_game_records(data)
    schema = {
        **TRAINING_EXAMPLE_AVRO,
        "fields": TRAINING_EXAMPLE_AVRO["fields"]
        + [{"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}],
    }
    train_p, val_p = str(d / "train.avro"), str(d / "val.avro")
    write_avro_file(train_p, schema, recs[:600])
    write_avro_file(val_p, schema, recs[600:])
    return train_p, val_p


def _train_args(train_p, val_p, out, extra=()):
    args = ["--input-data", train_p]
    if val_p is not None:
        args += ["--validation-data", val_p]
    return args + [
        "--task", "logistic_regression", *SHARDS, "--coordinate", FE_SPEC, "--coordinate", RE_SPEC,
        "--coordinate-descent-iterations", "2", "--evaluators", "AUC,LOGISTIC_LOSS", "--output-dir", out,
        "--log-level", "WARNING", *extra,
    ]


def _score_args(val_p, model_dir, out):
    return ["--input-data", val_p, *SHARDS, "--id-tags", "userId", "--model-input-dir", model_dir,
            "--task", "logistic_regression", "--evaluators", "AUC", "--output-dir", out, "--log-level", "WARNING"]


def _accepted_losses(metrics_dir):
    with open(os.path.join(metrics_dir, "run_summary.json")) as f:
        doc = json.load(f)
    return {m["labels"]["coordinate"]: m["value"] for m in doc["metrics"] if m["name"] == "photon_cd_accepted_loss"}


def _shards(mod_cfg):
    return {"globalShard": mod_cfg(("features",)), "userShard": mod_cfg(("userFeatures",))}


def test_cli_train_and_score_match_the_reference(avro_paths, tmp_path):
    train_p, val_p = avro_paths
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    got = train.run(_train_args(train_p, val_p, port_out, ["--metrics-out", str(tmp_path / "pm"), "--device", "cpu"]))
    ref = ref_train.run(_train_args(train_p, val_p, ref_out, ["--metrics-out", str(tmp_path / "rm")]))
    assert got["best"]["metrics"]["AUC"] > 0.65
    assert abs(got["best"]["metrics"]["AUC"] - ref["best"]["metrics"]["AUC"]) <= 1e-4
    ours, theirs = _accepted_losses(str(tmp_path / "pm")), _accepted_losses(str(tmp_path / "rm"))
    assert set(ours) == set(theirs) == {"global", "per-user"}
    for name in ours:
        assert ours[name] == pytest.approx(theirs[name], rel=1e-5)
    assert set(got["stage_seconds"]) >= {"read", "datasets", "train", "write_models"}
    for path in ("models/best/model-metadata.json", "training-summary.json"):
        assert os.path.exists(os.path.join(port_out, path))

    sc, ev = score.run(_score_args(val_p, os.path.join(port_out, "models", "best"), str(tmp_path / "ps"))
                       + ["--device", "cpu"])
    ref_sc, ref_ev = ref_score.run(_score_args(val_p, os.path.join(ref_out, "models", "best"), str(tmp_path / "rs")))
    assert abs(ev.metrics["AUC"] - got["best"]["metrics"]["AUC"]) < 0.02
    # f32 coefficients of the two packages differ in their last digits (the
    # solvers' sums run in other orders), so the two are held by loss and AUC
    assert abs(ev.metrics["AUC"] - ref_ev.metrics["AUC"]) <= 1e-4
    assert sc.shape == np.asarray(ref_sc).shape
    assert os.path.exists(os.path.join(str(tmp_path / "ps"), "scores.avro"))


def test_models_cross_load_and_score_alike(avro_paths, tmp_path):
    """The port's saved model scores in the JAX package, and the JAX
    package's in the port, within rtol 1e-5 of the writer's own scores."""
    train_p, val_p = avro_paths
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    train.run(_train_args(train_p, val_p, port_out, ["--device", "cpu", "--dtype", "float64"]))
    ref_train.run(_train_args(train_p, val_p, ref_out))
    val, maps = read_avro_dataset(val_p, _shards(FeatureShardConfig), id_tag_columns=["userId"])
    ref_val, ref_maps = ref_read_avro_dataset(val_p, _shards(RefShardConfig), id_tag_columns=["userId"])
    for writer_dir in (port_out, ref_out):
        model_dir = os.path.join(writer_dir, "models", "best")
        port_model = load_game_model(model_dir, maps, task="logistic_regression", device="cpu",
                                     dtype=torch.float64)
        ref_model = ref_load_game_model(model_dir, ref_maps, task="logistic_regression")
        ours = ScoreEngine.from_model(port_model, dtype=torch.float64).score_dataset(val)
        theirs = np.asarray(RefScoreEngine.from_model(ref_model).score_dataset(ref_val))
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    # a model the port trained, written by the port's writer, reads back in
    # the JAX package with the same coefficients
    port_model = load_game_model(os.path.join(port_out, "models", "best"), maps, task="logistic_regression",
                                 device="cpu", dtype=torch.float64)
    resaved = str(tmp_path / "resaved")
    save_game_model(resaved, port_model, maps)
    back = ref_load_game_model(resaved, ref_maps, task="logistic_regression")
    np.testing.assert_array_equal(np.asarray(back.models["global"].model.coefficients.means),
                                  port_model["global"].model.coefficients.means.numpy())


def test_estimator_float64_matches_the_reference(avro_paths):
    import jax.numpy as jnp

    train_p, val_p = avro_paths
    raw, maps = read_avro_dataset(train_p, _shards(FeatureShardConfig), id_tag_columns=["userId"])
    val, _ = read_avro_dataset(val_p, _shards(FeatureShardConfig), index_maps=maps, id_tag_columns=["userId"])
    ref_raw, ref_maps = ref_read_avro_dataset(train_p, _shards(RefShardConfig), id_tag_columns=["userId"])
    ref_val, _ = ref_read_avro_dataset(val_p, _shards(RefShardConfig), index_maps=ref_maps, id_tag_columns=["userId"])
    specs = [FE_SPEC.replace("LBFGS", "TRON") + ",variance=SIMPLE", RE_SPEC]
    est = GameEstimator("logistic_regression", [parse_coordinate(s) for s in specs], n_cd_iterations=2,
                        evaluator_specs=["AUC"], dtype=torch.float64, device="cpu")
    ref_est = RefGameEstimator("logistic_regression", [ref_parse_coordinate(s) for s in specs], n_cd_iterations=2,
                               evaluator_specs=["AUC"], dtype=jnp.float64)
    got, ref = est.fit(raw, validation=val)[0], ref_est.fit(ref_raw, validation=ref_val)[0]
    fe, ref_fe = got.model["global"].model.coefficients, ref.model["global"].model.coefficients
    np.testing.assert_allclose(fe.means.numpy(), np.asarray(ref_fe.means), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(fe.variances.numpy(), np.asarray(ref_fe.variances), rtol=1e-3, atol=1e-5)
    d_re = raw.shard_dims["userShard"]
    ours = got.model["per-user"]
    theirs = ref.model["per-user"]
    order = [theirs.entity_row(e) for e in ours.entity_ids]
    np.testing.assert_allclose(ours.dense_coefficients(d_re), theirs.dense_coefficients(d_re)[order], atol=5e-3)
    assert abs(got.evaluation.metrics["AUC"] - ref.evaluation.metrics["AUC"]) <= 1e-4
    # the same configuration has the same plan fingerprint in both packages
    assert plan_fingerprint(est.execution_plan) == ref_plan_fingerprint(ref_est.execution_plan)


def test_cli_score_equals_the_transformer_bitwise(avro_paths, tmp_path):
    train_p, val_p = avro_paths
    out = str(tmp_path / "out")
    train.run(_train_args(train_p, val_p, out, ["--device", "cpu"]))
    model_dir = os.path.join(out, "models", "best")
    sparse.reset_launch_counts()
    sc, ev = score.run(_score_args(val_p, model_dir, str(tmp_path / "s")) + ["--device", "cpu"])
    assert not any(sparse.SPARSE_LAUNCHES.values())  # the CPU runs S1's plain version
    val, maps = read_avro_dataset(val_p, _shards(FeatureShardConfig), id_tag_columns=["userId"])
    model = load_game_model(model_dir, maps, task="logistic_regression", device="cpu")
    total, tev = GameTransformer(model=model, device="cpu").transform(val, evaluator_specs=["AUC"])
    assert np.array_equal(sc, total) and ev.metrics == tev.metrics
    plain = ScoreEngine.from_model(model, plain=True).score_dataset(val)
    np.testing.assert_array_equal(plain, total)
    # the resident request path is the same engine's (tests/test_torch_serving.py)
    empty = ScoreEngine.from_model(model).score_requests([])
    assert empty.dtype == np.float64 and empty.shape == (0,)


def _crash_after_n_sweep_saves(monkeypatch, n):
    """Make the n+1-th per-sweep model save raise KeyboardInterrupt (a crash
    right after the n-th sweep checkpoint landed)."""
    orig = train._Checkpoint._save_model
    count = {"n": 0}

    def wrapper(self, model_dir, game_model, reg_weights):
        if "-sweep-" in model_dir:
            if count["n"] >= n:
                raise KeyboardInterrupt("injected crash between sweeps")
            count["n"] += 1
        orig(self, model_dir, game_model, reg_weights)

    monkeypatch.setattr(train._Checkpoint, "_save_model", wrapper)


def _without_output_dir(argv):
    i = argv.index("--output-dir")
    return argv[:i] + argv[i + 2:]


def _load(out, maps):
    return load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression", device="cpu")


def test_checkpoint_resume_matches_straight_run(avro_paths, tmp_path, monkeypatch):
    """--checkpoint-dir: a run crashed after 2 of 4 sweeps resumes from the
    checkpoint and its final model matches a straight 4-sweep run."""
    train_p, _ = avro_paths
    ckpt = str(tmp_path / "ckpt")
    common = _without_output_dir(_train_args(train_p, None, "", ["--device", "cpu"]))
    common[common.index("--coordinate-descent-iterations") + 1] = "4"
    _crash_after_n_sweep_saves(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        train.run(common + ["--checkpoint-dir", ckpt, "--output-dir", str(tmp_path / "out1"),
                            "--metrics-out", str(tmp_path / "m1"), "--trace-out", str(tmp_path / "m1" / "trace.json")])
    monkeypatch.undo()
    with open(os.path.join(ckpt, "checkpoint-state.json")) as f:
        state = json.load(f)
    assert state["current"]["completed_sweeps"] == 2 and state["completed"] == []
    with open(os.path.join(str(tmp_path / "m1"), "run_summary.json")) as f:
        run_summary = json.load(f)
    assert run_summary["aborted"] is True
    with open(str(tmp_path / "m1" / "trace.json")) as f:
        spans = [e["name"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    # two whole sweeps and the third, which the crash in its checkpoint ended
    assert spans.count("cd.sweep") == 3 and "train" in spans
    assert run_summary["timeline"]["n_sweeps"] == 3

    train.run(common + ["--checkpoint-dir", ckpt, "--output-dir", str(tmp_path / "out2")])
    with open(os.path.join(ckpt, "checkpoint-state.json")) as f:
        state = json.load(f)
    assert state["current"] is None and len(state["completed"]) == 1
    train.run(common + ["--output-dir", str(tmp_path / "out3")])

    _, maps = read_avro_dataset(train_p, _shards(FeatureShardConfig))
    resumed, straight = _load(str(tmp_path / "out2"), maps), _load(str(tmp_path / "out3"), maps)
    np.testing.assert_allclose(resumed["global"].model.coefficients.means.numpy(),
                               straight["global"].model.coefficients.means.numpy(), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(resumed["per-user"].coef_values.numpy(), straight["per-user"].coef_values.numpy(),
                               rtol=5e-3, atol=1e-4)

    # rerunning a completed checkpointed job is idempotent
    train.run(common + ["--checkpoint-dir", ckpt, "--output-dir", str(tmp_path / "out6")])
    assert os.path.isdir(os.path.join(str(tmp_path / "out6"), "models", "best"))
    bad_grid = [RE_SPEC.replace("reg.weights=1", "reg.weights=7") if a == RE_SPEC else a for a in common]
    with pytest.raises(SystemExit, match="was written for grid"):
        train.run(bad_grid + ["--checkpoint-dir", ckpt, "--output-dir", str(tmp_path / "out4")])
    fewer = list(common)
    fewer[fewer.index("--coordinate-descent-iterations") + 1] = "2"
    with pytest.raises(SystemExit, match="coordinate-descent"):
        train.run(fewer + ["--checkpoint-dir", ckpt, "--output-dir", str(tmp_path / "out5")])


def test_checkpoint_grid_resume(avro_paths, tmp_path, monkeypatch):
    """A crash inside config 1 keeps config 0's finished model and resumes
    the grid mid-flight."""
    train_p, val_p = avro_paths
    ckpt = str(tmp_path / "ckpt")
    grid_re = RE_SPEC.replace("reg.weights=1", "reg.weights=1|10")
    common = [a if a != RE_SPEC else grid_re for a in _train_args(train_p, val_p, "", ["--device", "cpu"])]
    common = _without_output_dir(common) + ["--output-mode", "ALL"]
    _crash_after_n_sweep_saves(monkeypatch, 3)
    with pytest.raises(KeyboardInterrupt):
        train.run(common + ["--checkpoint-dir", ckpt, "--output-dir", str(tmp_path / "out1")])
    monkeypatch.undo()
    with open(os.path.join(ckpt, "checkpoint-state.json")) as f:
        state = json.load(f)
    assert len(state["completed"]) == 1
    assert state["current"] == {"index": 1, "completed_sweeps": 1, "model_dir": "config-001-sweep-0001"}
    summary = train.run(common + ["--checkpoint-dir", ckpt, "--output-dir", str(tmp_path / "out2")])
    assert len(summary["configs"]) == 2
    straight = train.run(common + ["--output-dir", str(tmp_path / "out3")])
    for a, b in zip(summary["configs"], straight["configs"]):
        assert a["reg_weights"] == b["reg_weights"]
        assert a["metrics"]["AUC"] == pytest.approx(b["metrics"]["AUC"], abs=2e-3)
    assert sorted(os.listdir(os.path.join(str(tmp_path / "out2"), "models"))) == ["model-0", "model-1"]


@pytest.mark.parametrize("kill_at", [1, 2, 3, 4])
def test_cli_kill_and_resume_is_bitwise(avro_paths, tmp_path, monkeypatch, kill_at):
    """--checkpoint-every 1 with PHOTON_FAULTS killing the run right after
    the kill_at-th boundary checkpoint; --resume then finishes it, and every
    saved coefficient equals the straight run's bit for bit."""
    train_p, val_p = avro_paths
    straight = str(tmp_path / "straight")
    base = _train_args(train_p, val_p, straight, ["--device", "cpu"])
    train.run(base)
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    argv = _train_args(train_p, val_p, out, ["--device", "cpu", "--checkpoint-dir", ckpt, "--checkpoint-every", "1",
                                              "--metrics-out", str(tmp_path / "m")])
    monkeypatch.setenv("PHOTON_FAULTS", f"cd.boundary_saved:kill:{kill_at}")
    with pytest.raises(faults.SimulatedKill):
        train.run(argv)
    monkeypatch.delenv("PHOTON_FAULTS")
    summary = train.run(argv + ["--resume"])
    with open(os.path.join(str(tmp_path / "m"), "run_summary.json")) as f:
        restores = [m for m in json.load(f)["metrics"] if m["name"] == "photon_checkpoint_restore_total"]
    assert restores and restores[0]["value"] == 1
    _, maps = read_avro_dataset(train_p, _shards(FeatureShardConfig))
    a, b = _load(straight, maps), _load(out, maps)
    assert torch.equal(a["global"].model.coefficients.means, b["global"].model.coefficients.means)
    assert torch.equal(a["per-user"].coef_values, b["per-user"].coef_values)
    with open(os.path.join(straight, "training-summary.json")) as f:
        assert json.load(f)["best"] == summary["best"]


def test_explain_plan_prints_without_reading_data(tmp_path, capsys):
    doc = train.run(["--input-data", str(tmp_path / "absent.avro"), "--output-dir", str(tmp_path / "o"),
                     "--coordinate", FE_SPEC, "--coordinate", RE_SPEC, "--normalization", "STANDARDIZATION",
                     "--explain-plan"])
    printed = capsys.readouterr().out
    assert "execution plan" in printed and "per-user: random-effect" in printed
    assert [c["name"] for c in doc["plan"]["coordinates"]] == ["global", "per-user"]
    assert doc["plan"]["normalization"] == "STANDARDIZATION"
    ref_doc = ref_train.run(["--input-data", "x", "--output-dir", str(tmp_path / "r"), "--coordinate", FE_SPEC,
                             "--coordinate", RE_SPEC, "--normalization", "STANDARDIZATION", "--explain-plan"])
    assert [(c["name"], c["kind"], c["layout"]) for c in doc["plan"]["coordinates"]] == [
        (c["name"], c["kind"], c["layout"]) for c in ref_doc["plan"]["coordinates"]]
    with pytest.raises(SystemExit) as e:
        train.run(["--input-data", "x", "--output-dir", "o", "--mesh-shape", "data=2", "--explain-plan"])
    assert e.value.code == 1
    assert "ROADMAP A10" in capsys.readouterr().err


TWO_PROCESSES = ["--mesh-shape", "data=2", "--distributed", "coordinator=127.0.0.1:1,process=0,n=2"]
REFUSED = {
    # a model axis stays refused; a data axis of the process count runs
    "mesh-shape": (["--mesh-shape", "data=2,model=2", "--distributed", "coordinator=127.0.0.1:1,process=0,n=2"],
                   "A10"),
    # the multi-process flags are ported: each resolves the JAX package's
    # two-process plan (the runs themselves: tests/test_torch_multihost.py,
    # tests/test_torch_distributed.py)
    "distributed": (TWO_PROCESSES, None),
    "collective-timeout": (["--collective-timeout", "30", *TWO_PROCESSES], None),
    "heartbeat-interval": (["--heartbeat-interval", "1", *TWO_PROCESSES], None),
    "heartbeat-timeout": (["--heartbeat-timeout", "5", *TWO_PROCESSES], None),
    # sweep pipelining is ported: the flag resolves a pipelined plan, over
    # processes too (each rank pipelines its own staging)
    "pipeline-depth": (["--pipeline-depth", "2"], None),
    "pipeline-depth-distributed": (["--pipeline-depth", "2", *TWO_PROCESSES], None),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_flags_name_their_roadmap_item(tmp_path, case, capsys):
    flags, item = REFUSED[case]
    argv = ["--input-data", str(tmp_path / "absent.avro"), "--output-dir", str(tmp_path / "o"), *flags,
            "--explain-plan"]
    if item is None:
        doc = train.run(argv + ["--device", "cpu"])
        ref = ref_train.run(argv)
        for key in ("pipeline_depth", "n_processes", "mesh_axes", "distributed"):
            assert doc["plan"][key] == ref["plan"][key], key
        assert [c["pipelined"] for c in doc["plan"]["coordinates"]] == [
            c["pipelined"] for c in ref["plan"]["coordinates"]]
        assert doc["plan"]["pipeline_depth"] == (2 if "--pipeline-depth" in flags else 1)
        return
    with pytest.raises(SystemExit) as e:
        train.run(argv + ["--device", "cpu"])
    assert e.value.code == 1 and f"ROADMAP {item}" in capsys.readouterr().err


# the incremental-training flags that were refused until the retrain path
# was ported: each now runs, on the CPU, through cli.train, warm-started from
# a model the JAX package trained, and matches the JAX package's run
INCREMENTAL_FLAGS = {
    "model-input-dir": [],
    "incremental-training": ["--incremental-training"],
    "partial-retrain-locked": ["--partial-retrain-locked", "global"],
}


@pytest.fixture(scope="module")
def prior_model_dir(avro_paths, tmp_path_factory):
    train_p, val_p = avro_paths
    out = str(tmp_path_factory.mktemp("prior") / "out")
    ref_train.run(_train_args(train_p, val_p, out))
    return os.path.join(out, "models", "best")


@pytest.mark.parametrize("case", sorted(INCREMENTAL_FLAGS))
def test_incremental_flags_match_the_reference(avro_paths, prior_model_dir, tmp_path, caplog, case):
    import logging

    train_p, val_p = avro_paths
    flags = ["--model-input-dir", prior_model_dir, *INCREMENTAL_FLAGS[case]]
    port_out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    with caplog.at_level(logging.INFO, logger="photon_ml_tpu_torch"):
        got = train.run(_train_args(train_p, val_p, port_out, [*flags, "--metrics-out", str(tmp_path / "pm"),
                                                               "--device", "cpu", "--log-level", "INFO"]))
    ref = ref_train.run(_train_args(train_p, val_p, ref_out, [*flags, "--metrics-out", str(tmp_path / "rm")]))
    assert abs(got["best"]["metrics"]["AUC"] - ref["best"]["metrics"]["AUC"]) <= 1e-4
    ours, theirs = _accepted_losses(str(tmp_path / "pm")), _accepted_losses(str(tmp_path / "rm"))
    locked = case == "partial-retrain-locked"
    assert set(ours) == set(theirs) == ({"per-user"} if locked else {"global", "per-user"})
    for name in ours:
        assert ours[name] == pytest.approx(theirs[name], rel=1e-5)
    assert "model_input" in got["stage_seconds"]
    logged = [r.getMessage() for r in caplog.records if "prior feature-index compatibility" in r.getMessage()]
    if case == "incremental-training":
        assert logged == ["incremental prior feature-index compatibility: globalShard=exact, userShard=exact"]
    else:
        assert not logged
    if locked:
        # the locked fixed effect is saved as it was loaded
        _, maps = read_avro_dataset(train_p, _shards(FeatureShardConfig), id_tag_columns=["userId"])
        prior = load_game_model(prior_model_dir, maps, task="logistic_regression", device="cpu")
        best = load_game_model(os.path.join(port_out, "models", "best"), maps, task="logistic_regression",
                               device="cpu")
        assert torch.equal(best["global"].model.coefficients.means, prior["global"].model.coefficients.means)
    if case == "incremental-training":
        with pytest.raises(SystemExit, match="--incremental-training requires --model-input-dir"):
            train.run(_train_args(train_p, val_p, str(tmp_path / "none"), ["--incremental-training", "--device",
                                                                            "cpu"]))


TUNING_CONFIG = json.dumps({"tuning_mode": "RANDOM", "variables": {
    "global.reg_weight": {"type": "DOUBLE", "min": 0.01, "max": 100.0, "transform": "LOG"}}})

# the tuning flags that were refused until the tuning path was ported: each
# now runs, on the CPU, through cli.train
TUNING_FLAGS = {
    "hyper-parameter-tuning": ["--hyper-parameter-tuning", "BAYESIAN", "--hyper-parameter-tuning-iter", "2"],
    "trial-lanes": ["--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter", "4", "--trial-lanes", "4"],
    "hyper-parameter-config": ["--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter", "2",
                               "--hyper-parameter-config", "CONFIG"],
    "output-mode-tuned": ["--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter", "2",
                          "--output-mode", "TUNED"],
}


@pytest.mark.parametrize("case", sorted(TUNING_FLAGS))
def test_tuning_flags_run(avro_paths, tmp_path, case):
    train_p, val_p = avro_paths
    cfg = tmp_path / "tuning.json"
    cfg.write_text(TUNING_CONFIG)
    flags = [str(cfg) if f == "CONFIG" else f for f in TUNING_FLAGS[case]]
    out = str(tmp_path / "o")
    got = train.run(_train_args(train_p, val_p, out, ["--device", "cpu", *flags]))
    n_trials = int(flags[flags.index("--hyper-parameter-tuning-iter") + 1])
    assert len(got["configs"]) == 1 + n_trials  # the grid's one configuration, then the trials
    assert all(c["metrics"]["AUC"] > 0.5 for c in got["configs"])
    with open(os.path.join(out, "hyperparameter-prior.json")) as f:
        assert len(json.load(f)["records"]) == 1 + n_trials
    if case == "hyper-parameter-config":
        # only the configured coordinate is tuned, inside its range
        for c in got["configs"][1:]:
            assert 0.01 <= c["reg_weights"]["global"] <= 100.0 and c["reg_weights"]["per-user"] == 1.0
    assert os.path.exists(os.path.join(out, "models", "best", "model-metadata.json"))


@pytest.mark.parametrize("spec,item", [
    (FE_SPEC + ",hbm.budget.mb=64", None), (FE_SPEC + ",layout=tiled", "A10"),
])
def test_refused_coordinates_name_their_roadmap_item(tmp_path, spec, item):
    if item is None:
        # streaming is ported: the budget resolves a streamed coordinate, as
        # in the JAX package
        (ours,) = resolve([parse_coordinate(spec)], dims={"globalShard": 5000}).coordinates
        (theirs,) = ref_resolve([ref_parse_coordinate(spec)], dims={"globalShard": 5000}).coordinates
        assert ours.residency == theirs.residency == "streamed"
        assert ours.geometry["rows_per_slice"] == theirs.geometry["rows_per_slice"]
        # over processes it streams each rank's rows, as the JAX package's
        # plan over a mesh of the process count; two devices in one process
        # stay in A10 (one card a process)
        (ours,) = resolve([parse_coordinate(spec)], mesh={"data": 2}, n_processes=2, dims={"globalShard": 5000},
                          distributed=True).coordinates
        (theirs,) = ref_resolve([ref_parse_coordinate(spec)], mesh={"data": 2}, n_processes=2,
                                dims={"globalShard": 5000}, distributed=True).coordinates
        assert ours.sharding == theirs.sharding == "host-sharded rows (streamed slices)"
        assert ours.geometry["hosts_streaming"] == theirs.geometry["hosts_streaming"] == 2
        with pytest.raises(PlanError, match="ROADMAP A10"):
            resolve([parse_coordinate(spec)], mesh={"data": 2})
        return
    # the tiled layout is ported: it needs a mesh in the JAX package's
    # words, resolves on one as the JAX package's plan does, pipelines on a
    # grid of processes, and takes no budget (the JAX package's words)
    tiled = parse_coordinate(spec)
    with pytest.raises(PlanError, match="layout='tiled' requires the estimator to be built with a device mesh"):
        resolve([tiled])
    with pytest.raises(Exception, match="layout='tiled' requires the estimator to be built with a device mesh"):
        ref_resolve([ref_parse_coordinate(spec)])
    for mesh, n in (({"data": 1, "model": 1}, 1), ({"data": 2, "model": 2}, 4)):
        (ours,) = resolve([tiled], mesh=mesh, n_processes=n, dims={"globalShard": 10}).coordinates
        (theirs,) = ref_resolve([ref_parse_coordinate(spec)], mesh=mesh).coordinates
        assert ours.sharding == theirs.sharding == "row+model-sharded"
        assert ours.geometry["tile_columns"] == -(-10 // mesh["model"])
    assert plan_fingerprint(resolve([tiled], mesh={"data": 1, "model": 1})) == ref_plan_fingerprint(
        ref_resolve([ref_parse_coordinate(spec)], mesh={"data": 1, "model": 1}))
    for kwargs in (dict(pipeline_depth=2, distributed=True), dict(pipeline_depth=2)):
        (ours,) = resolve([tiled], mesh={"data": 2, "model": 2}, n_processes=4, **kwargs).coordinates
        (theirs,) = ref_resolve([ref_parse_coordinate(spec)], mesh={"data": 2, "model": 2},
                                pipeline_depth=2).coordinates
        assert ours.pipelined and theirs.pipelined and ours.sharding == theirs.sharding
    with pytest.raises(PlanError) as ours:
        resolve([parse_coordinate(spec + ",hbm.budget.mb=64")], mesh={"data": 2, "model": 2}, n_processes=4)
    with pytest.raises(Exception) as theirs:
        ref_resolve([ref_parse_coordinate(spec + ",hbm.budget.mb=64")], mesh={"data": 2, "model": 2})
    assert str(ours.value) == str(theirs.value) and "row-sliceable layout" in str(ours.value)
    # a dense fixed effect beside it on the grid is ported: rows over the
    # data axis, replicated over the model axis, the JAX package's label and
    # fingerprint; a grid whose size is not the process count names the item
    both = [tiled, parse_coordinate(FE_SPEC.replace("name=global", "name=dense"))]
    ref_both = [ref_parse_coordinate(spec), ref_parse_coordinate(FE_SPEC.replace("name=global", "name=dense"))]
    ours = resolve(both, mesh={"data": 2, "model": 2}, n_processes=4, dims={"globalShard": 10})
    theirs = ref_resolve(ref_both, mesh={"data": 2, "model": 2})
    assert [c.sharding for c in ours.coordinates] == [c.sharding for c in theirs.coordinates] == [
        "row+model-sharded"] * 2
    assert [c.notes for c in ours.coordinates] == [c.notes for c in theirs.coordinates]
    assert plan_fingerprint(ours) == ref_plan_fingerprint(theirs)
    with pytest.raises(PlanError, match=f"ROADMAP {item}"):
        resolve(both, mesh={"data": 2, "model": 2}, n_processes=2)


def test_planner_refusals_and_helpers():
    cc = parse_coordinate(FE_SPEC)
    plan = resolve([cc], dims={"globalShard": 5000})
    assert plan.coordinates[0].geometry == {"dim": 5000, "batch_layout": "ell"}
    assert plan_fingerprint(plan) == ref_plan_fingerprint(ref_resolve([ref_parse_coordinate(FE_SPEC)]))
    for kwargs, item in (({"mesh": {"data": 2}}, "A10"), ({"mesh": {"data": 2, "model": 2}, "n_processes": 2}, "A10")):
        with pytest.raises(PlanError, match=f"ROADMAP {item}"):
            resolve([cc], **kwargs)
    # a dense fixed effect under a model axis resolves as the JAX package's
    (ours,) = resolve([cc], mesh={"data": 2, "model": 2}, n_processes=4).coordinates
    (theirs,) = ref_resolve([ref_parse_coordinate(FE_SPEC)], mesh={"data": 2, "model": 2}).coordinates
    assert ours.sharding == theirs.sharding == "row+model-sharded"
    # sweep pipelining over processes resolves as in the JAX package
    piped = resolve([cc], pipeline_depth=2, distributed=True, n_processes=2)
    ref_piped = ref_resolve([ref_parse_coordinate(FE_SPEC)], pipeline_depth=2, distributed=True, n_processes=2,
                            mesh={"data": 2})
    assert piped.pipeline_depth == ref_piped.pipeline_depth == 2
    assert piped.coordinates[0].pipelined and ref_piped.coordinates[0].pipelined
    # the model axis is ported for a tiled fixed effect: a (data x model)
    # grid of data * model processes, the random effects over its data axis
    re_cc = parse_coordinate("name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1")
    grid = resolve([parse_coordinate(FE_SPEC + ",layout=tiled"), re_cc], mesh={"data": 2, "model": 2}, n_processes=4,
                   distributed=True)
    assert grid.mesh_axes == {"data": 2, "model": 2} and grid.n_processes == 4
    assert [c.sharding for c in grid.coordinates] == ["row+model-sharded", "entity-sharded"]
    assert "mesh data=2 model=2" in grid.pretty()
    # several processes resolve as the JAX package's mesh of their data axis
    for kwargs in ({"n_processes": 2}, {"distributed": True, "n_processes": 2}, {"mesh": {"data": 2}, "n_processes": 2}):
        ours = resolve([cc], **kwargs)
        theirs = ref_resolve([ref_parse_coordinate(FE_SPEC)], **{**kwargs, "mesh": {"data": 2, "model": 1}})
        assert ours.n_processes == theirs.n_processes == 2
        assert ours.coordinates[0].sharding == theirs.coordinates[0].sharding == "row-sharded"
        assert plan_fingerprint(ours) == ref_plan_fingerprint(theirs)
    # sweep pipelining resolves as in the JAX package
    piped = resolve([cc], pipeline_depth=2)
    ref_piped = ref_resolve([ref_parse_coordinate(FE_SPEC)], pipeline_depth=2)
    assert piped.pipeline_depth == ref_piped.pipeline_depth == 2
    assert piped.coordinates[0].pipelined and ref_piped.coordinates[0].pipelined
    assert "pipelined" in piped.pretty() and "staging/solve/eval overlap" in piped.pretty()
    # locked coordinates and regularize-by-prior resolve as in the JAX package
    locked = [parse_coordinate(FE_SPEC), parse_coordinate(RE_SPEC)]
    ref_locked = [ref_parse_coordinate(FE_SPEC), ref_parse_coordinate(RE_SPEC)]
    for c in locked + ref_locked:
        c.regularize_by_prior = True
    ours = resolve(locked, partial_retrain_locked=("global",))
    theirs = ref_resolve(ref_locked, partial_retrain_locked=("global",))
    assert [(c.name, c.kind, c.layout, c.residency) for c in ours.coordinates] == [
        (c.name, c.kind, c.layout, c.residency) for c in theirs.coordinates]
    assert plan_fingerprint(ours) == ref_plan_fingerprint(theirs)
    # trial lanes are ported: the plan carries them as the JAX package's does
    assert resolve([cc], trial_lanes=2).trial_lanes == ref_resolve([ref_parse_coordinate(FE_SPEC)], trial_lanes=2).trial_lanes == 2
    for args in ((True, 1, ()), (False, 4, ()), (False, 1, ("global",))):
        with pytest.raises(PlanError) as ours:
            check_retrain_composition(*args)
        with pytest.raises(ValueError) as theirs:
            ref_check_retrain_composition(*args)
        assert str(ours.value) == str(theirs.value)
    check_retrain_composition(False, 1, ())
    assert parse_mesh_shape("") is None
    assert parse_mesh_shape("data=4") == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="unknown mesh keys"):
        parse_mesh_shape("data=4,rows=2")
    assert plan_host_row_split("x") == (None, None)
    with pytest.raises(PlanError, match="trial-lanes must be >= 1: 0"):
        GameEstimator("logistic_regression", [cc], device="cpu").fit_lanes(None, [])


def test_entry_points_default_to_the_card(avro_paths, tmp_path, monkeypatch):
    train_p, val_p = avro_paths
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run(_train_args(train_p, val_p, str(tmp_path / "o")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        score.run(_score_args(val_p, str(tmp_path / "m"), str(tmp_path / "s")))


def test_feature_bags_match_the_reference(avro_paths, tmp_path):
    from photon_ml_tpu.cli import feature_bags as ref_feature_bags

    train_p, _ = avro_paths
    argv = ["--input-data", train_p, "--feature-bags", "features,userFeatures", "--log-level", "WARNING"]
    got = feature_bags.run(argv + ["--output-dir", str(tmp_path / "p")])
    ref = ref_feature_bags.run(argv + ["--output-dir", str(tmp_path / "r")])
    assert got == ref
    for bag in ("features", "userFeatures"):
        assert open(tmp_path / "p" / bag).read() == open(tmp_path / "r" / bag).read()
