"""The port's ``cli.train`` and ``cli.score`` across two gloo CPU ranks
(``python -m photon_ml_tpu_torch.cli.train --distributed
coordinator=127.0.0.1:PORT,process=I,n=2 --device cpu --dtype float64``,
and ``cli.score --distributed``) against the JAX package's single-process
runs on the cases of tests/test_multihost.py. The JAX suite's own slow tests
hold its two-process runs to that same single-process run
(tests/test_multihost.py:326-457); here every rank is an OS process of its
own (``tests/_torch_mp_common.py``), each under its own timeout.

The ranks train in float64 (``--dtype float64``) and are held against the
JAX package's ``GameEstimator.fit`` in float64 (the JAX package's CLI trains in
float32, whose solves stop at the loss's resolution: ROADMAP C3) on the
same rows and index, at ROADMAP's bounds: fixed-effect coefficients rtol
1e-3 / atol 1e-5, random-effect coefficients (keyed by entity id) atol
5e-3, the validation AUC within 1e-4 and the logistic loss rel 1e-5; the
feature statistics against the JAX package's CLI's at rel 1e-12. The distributed
scores (float32, as the JAX package's CLI scores) are bitwise the port's
one-process ``cli.score`` and their AUC within 1e-12 of it; against the JAX
CLI's scores rtol 1e-5 / atol 1e-6 (float32 resolution) and AUC within
1e-4.

Also: ``host_row_range`` and the spec parser, the backend choice, the
planner's multi-process plans (streamed and pipelined ones among them, as
the JAX package's) and the refusals that stay (the JAX package's in its
words, the port's topology limits naming ROADMAP A10), resume without a
shared file system, and the passive rows of the padded global row space."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from _torch_mp_common import assert_ok, build_index, launch, write_glmix_avro, write_logistic_avro
import jax.numpy as jnp
from photon_ml_tpu.cli import score as ref_score
from photon_ml_tpu.cli import train as ref_train
from photon_ml_tpu.estimators.game_estimator import GameEstimator as RefGameEstimator
from photon_ml_tpu.io import FeatureShardConfig as RefShardConfig
from photon_ml_tpu.io import read_avro_dataset as ref_read_avro_dataset
from photon_ml_tpu.io import read_avro_file as ref_read_avro_file
from photon_ml_tpu.io.index_map import load_partitioned as ref_load_partitioned
from photon_ml_tpu.ops.normalization import build_normalization as ref_build_normalization
from photon_ml_tpu.utils.stats import compute_feature_statistics as ref_feature_statistics
from photon_ml_tpu.parallel.multihost import equal_host_share as ref_equal_host_share
from photon_ml_tpu.parallel.multihost import host_row_range as ref_host_row_range
from photon_ml_tpu.plan import plan_fingerprint as ref_plan_fingerprint
from photon_ml_tpu.plan import resolve as ref_resolve
from photon_ml_tpu.cli.params import parse_coordinate as ref_parse_coordinate
from photon_ml_tpu_torch.cli import score, train
from photon_ml_tpu_torch.cli.params import parse_coordinate, parse_mesh_shape, plan_host_row_split
from photon_ml_tpu_torch.game.data_mp import build_random_effect_dataset_global
from photon_ml_tpu_torch.io import read_avro_file
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.io.index_map import load_partitioned
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.parallel import (
    DataParallelGroup,
    choose_backend,
    equal_host_share,
    host_row_range,
    initialize_from_spec,
    spawn,
)
from photon_ml_tpu_torch.parallel.multihost import parse_spec
from photon_ml_tpu_torch.plan import PlanError, plan_fingerprint, resolve

GLOBAL = ["--feature-shard", "name=global,bags=features"]
GLMIX_SHARDS = ["--feature-shard", "name=globalShard,bags=features", "--feature-shard", "name=userShard,bags=userFeatures"]
FE = "name=global,shard=global,optimizer=LBFGS,tolerance=1e-12,max.iter=300,reg.type=L2,reg.weights=1"
PORT = ["--device", "cpu", "--dtype", "float64"]


def _summary(out):
    with open(os.path.join(out, "training-summary.json")) as f:
        return json.load(f)


def _port_model(out, index_dir, shards):
    maps = {s: load_partitioned(index_dir, s) for s in shards}
    return load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression", device="cpu",
                           dtype=torch.float64)


def _jax_fit(data, index_dir, bags, specs, n_iter=1, normalization="NONE"):
    """The JAX package's one-process fit in float64 on the same rows and
    index, validated on the training rows as the CLI runs are."""
    maps = {s: ref_load_partitioned(index_dir, s) for s in bags}
    raw, _ = ref_read_avro_dataset(data, {s: RefShardConfig((b,)) for s, b in bags.items()}, index_maps=maps,
                                   id_tag_columns=["userId"] if len(bags) > 1 else [])
    coords = [ref_parse_coordinate(s) for s in specs]
    for cc in coords:
        if normalization != "NONE" and not cc.is_random_effect:
            st = ref_feature_statistics(raw, cc.feature_shard)
            cc.normalization = ref_build_normalization(
                normalization, st["mean"], st["variance"], st["max_magnitude"],
                intercept_index=maps[cc.feature_shard].intercept_index)
    est = RefGameEstimator("logistic_regression", coords, n_cd_iterations=n_iter,
                           evaluator_specs=["AUC", "LOGISTIC_LOSS"], dtype=jnp.float64)
    return est.fit(raw, validation=raw)[0]


def _hold_fe(out, index_dir, ref, shard="global"):
    ours = _port_model(out, index_dir, [shard]).models["global"].model.coefficients.means.numpy()
    np.testing.assert_allclose(ours, np.asarray(ref.model["global"].model.coefficients.means), rtol=1e-3, atol=1e-5)
    metrics = _summary(out)["best"]["metrics"]
    assert abs(metrics["AUC"] - ref.evaluation.metrics["AUC"]) <= 1e-4
    assert metrics["LOGISTIC_LOSS"] == pytest.approx(ref.evaluation.metrics["LOGISTIC_LOSS"], rel=1e-5)


# ------------------------------------------------------------ unit cases


def test_host_row_range_balanced():
    for n, p in [(10, 3), (8, 8), (7, 2), (0, 4), (5, 1), (321, 2)]:
        spans = [host_row_range(n, i, p) for i in range(p)]
        assert spans == [ref_host_row_range(n, i, p) for i in range(p)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 == b0
        sizes = [b - a for a, b in spans]
        assert max(sizes) - min(sizes) <= 1
        assert equal_host_share(n, p) == ref_equal_host_share(n, p)


def test_initialize_spec_validation():
    with pytest.raises(ValueError, match="unknown --distributed keys"):
        initialize_from_spec("coordinator=x:1,bogus=2", device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        parse_spec("coordinator=x:1,process=0")
    with pytest.raises(ValueError, match="outside n=2"):
        initialize_from_spec("coordinator=127.0.0.1:1,process=2,n=2", device="cpu")
    assert parse_spec("coordinator=h:5,process=1,n=4") == {"coordinator": "h:5", "process": 1, "n": 4}


def test_backend_follows_the_devices(monkeypatch):
    assert choose_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert choose_backend("cuda", 1) == "nccl"  # one rank a card
    assert choose_backend("cuda", 2) == "gloo"  # two ranks share the card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_backend("cuda", 4) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert choose_backend("cuda", 8) == "nccl"  # torchrun: 2 ranks on this host of 4 cards


def test_multiprocess_plans_and_the_refusals_that_stay():
    cc = parse_coordinate(FE)
    re_cc = parse_coordinate("name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1")
    plan = resolve([cc, re_cc], n_processes=2, distributed=True)
    ref_plan = ref_resolve([ref_parse_coordinate(FE)], mesh={"data": 8, "model": 1}, n_processes=2, distributed=True)
    assert plan.n_processes == ref_plan.n_processes == 2 and plan.distributed
    assert [c.sharding for c in plan.coordinates] == ["row-sharded", "entity-sharded"]
    assert plan.coordinates[0].sharding == ref_plan.coordinates[0].sharding
    assert resolve([cc], mesh=parse_mesh_shape("data=2"), n_processes=2).mesh_axes == {"data": 2, "model": 1}
    assert plan_host_row_split("unused") == (None, None)  # one process here
    refused = [
        dict(mesh={"data": 2, "model": 2}, n_processes=2),  # a model axis
        dict(mesh={"data": 4}, n_processes=2),  # a data axis other than the process count
        dict(mesh={"data": 2}),  # several devices in one process
    ]
    for kw in refused:
        with pytest.raises(PlanError, match="ROADMAP A10"):
            resolve([cc], **kw)
    # streaming and pipelining over processes resolve as the JAX package's
    # plan over a data axis of the process count
    for spec in (FE + ",hbm.budget.mb=64", FE + ",layout=ell,hbm.budget.mb=64"):
        re_s = "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1,hbm.budget.mb=64"
        kw = dict(n_processes=2, distributed=True, pipeline_depth=2, dims={"global": 6, "userShard": 3})
        ours = resolve([parse_coordinate(spec), parse_coordinate(re_s)], **kw)
        theirs = ref_resolve([ref_parse_coordinate(spec), ref_parse_coordinate(re_s)], mesh={"data": 2, "model": 1},
                             **kw)
        assert [c.sharding for c in ours.coordinates] == [c.sharding for c in theirs.coordinates] == [
            "host-sharded rows (streamed slices)", "entity-sharded (host-resident blocks)"]
        for mine, ref in zip(ours.coordinates, theirs.coordinates):
            assert (mine.residency, mine.pipelined, mine.notes) == (ref.residency, ref.pipelined, ref.notes)
            assert {k: mine.geometry[k] for k in ref.geometry} == ref.geometry
        assert ours.pipeline_depth == theirs.pipeline_depth == 2
        assert plan_fingerprint(ours) == ref_plan_fingerprint(theirs)
    # what the JAX package refuses stays refused, in its words: a resident
    # ELL or COO fixed effect over processes, a budget on a tiled one
    for spec in (FE + ",layout=ell", FE + ",layout=coo"):
        with pytest.raises(PlanError) as ours:
            resolve([parse_coordinate(spec)], n_processes=2, distributed=True)
        with pytest.raises(Exception) as theirs:
            ref_resolve([ref_parse_coordinate(spec)], mesh={"data": 2, "model": 1}, n_processes=2, distributed=True)
        assert str(ours.value) == str(theirs.value) and "A10" not in str(ours.value)
    spec = FE + ",layout=tiled,hbm.budget.mb=64"
    with pytest.raises(PlanError) as ours:
        resolve([parse_coordinate(spec)], mesh={"data": 2, "model": 1}, n_processes=2, distributed=True)
    with pytest.raises(Exception) as theirs:
        ref_resolve([ref_parse_coordinate(spec)], mesh={"data": 2, "model": 1})
    assert str(ours.value) == str(theirs.value) and "row-sliceable layout" in str(ours.value)
    # a tiled fixed effect over processes is ported: it needs a mesh (the
    # JAX package's words), and resolves on a grid of the process count,
    # the random effect over its data axis; so does a dense one under a
    # model axis, as the JAX package's plan labels it
    tiled = parse_coordinate(FE + ",layout=tiled")
    with pytest.raises(PlanError, match="layout='tiled' requires the estimator to be built with a device mesh"):
        resolve([tiled], n_processes=2, distributed=True)
    for mesh in ({"data": 1, "model": 2}, {"data": 2, "model": 1}):
        grid = resolve([tiled, re_cc], mesh=mesh, n_processes=2, distributed=True)
        assert [c.sharding for c in grid.coordinates] == ["row+model-sharded", "entity-sharded"]
    dense = resolve([cc, re_cc], mesh={"data": 1, "model": 2}, n_processes=2, distributed=True)
    ref_dense = ref_resolve([ref_parse_coordinate(FE)], mesh={"data": 1, "model": 2})
    assert [c.sharding for c in dense.coordinates] == ["row+model-sharded", "entity-sharded"]
    assert dense.coordinates[0].sharding == ref_dense.coordinates[0].sharding
    # lanes over processes: refused in the JAX package's words
    with pytest.raises(PlanError, match="trial-lanes sweeps are single-process"):
        resolve([cc], n_processes=2, distributed=True, trial_lanes=4)


def test_explain_plan_over_processes(capsys):
    doc = train.run(["--input-data", "x", "--output-dir", "o", "--coordinate", FE, "--mesh-shape", "data=2",
                     "--distributed", "coordinator=h:1,process=0,n=2", "--explain-plan"])
    assert doc["plan"]["n_processes"] == 2 and doc["plan"]["distributed"]
    assert "2 process(es)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.run(["--input-data", "x", "--output-dir", "o", "--mesh-shape", "data=2,model=2",
                   "--distributed", "coordinator=h:1,process=0,n=2", "--explain-plan"])
    assert "ROADMAP A10" in capsys.readouterr().err
    # the grid of a tiled fixed effect: data * model processes
    doc = train.run(["--input-data", "x", "--output-dir", "o", "--coordinate", FE + ",layout=tiled",
                     "--mesh-shape", "data=2,model=2", "--distributed", "coordinator=h:1,process=0,n=4",
                     "--explain-plan"])
    assert doc["plan"]["mesh_axes"] == {"data": 2, "model": 2} and doc["plan"]["n_processes"] == 4
    printed = capsys.readouterr().out
    assert "4 process(es), mesh data=2 model=2" in printed and "row+model-sharded" in printed


def _passive_raw(n_total):
    g = np.arange(n_total)
    d = 2
    return dict(
        n_rows=n_total, labels=np.asarray(g % 2, np.float64), offsets=np.zeros(n_total), weights=np.ones(n_total),
        shard_coo={"userShard": (np.repeat(np.arange(n_total), d), np.tile(np.arange(d), n_total),
                                 np.linspace(0.1, 1.0, n_total * d))},
        shard_dims={"userShard": d},
        id_tags={"userId": np.array([f"u{x % 3}" for x in g], dtype=object)},
    )


def _partition_ok(active_rows, passive, row_entity):
    in_entity = np.flatnonzero(row_entity >= 0).astype(np.int64)
    ar = np.asarray(active_rows).ravel()
    active = np.sort(ar[ar >= 0].astype(np.int64))
    assert np.array_equal(np.sort(np.concatenate([active, passive])), in_entity)
    assert len(np.intersect1d(active, passive)) == 0


def test_single_process_passive_rows_partition():
    raw = RawDataset(**_passive_raw(21))
    raw.global_row_start = 0
    ds = build_random_effect_dataset_global(raw, "re", "userShard", "userId", DataParallelGroup(0, 1, "cpu", "gloo"),
                                            active_cap=2, pad_entities_to_multiple=8, device="cpu")
    _partition_ok(ds.blocks.active_rows.numpy(), ds.passive_rows, ds.row_entity.numpy())
    assert len(ds.passive_rows) == 3 * (7 - 2)


def test_two_process_passive_rows_padded_space(tmp_path):
    """21 rows on 2 ranks (11 / 10, padded to 11): the active rows and the
    passive rows partition exactly the padded global rows of kept entities
    (3 users x 7 rows, cap 2 -> 15 passive)."""
    payload = dict(raw=_passive_raw(21), shard="userShard", re_type="userId",
                   cases=[dict(active_cap=2, pad_entities_to_multiple=8)])
    ranks = spawn("_torch_mp_ranks:builds", 2, "gloo", "cpu", args=(payload,), timeout_s=120.0, store_dir=tmp_path)
    a, b = ranks[0][0], ranks[1][0]
    assert np.array_equal(a["passive_rows"], b["passive_rows"]) and len(a["passive_rows"]) == 15
    row_entity = torch.cat([a["row_entity"], b["row_entity"]]).numpy()
    assert row_entity.shape[0] == 22 and row_entity[21] == -1  # rank 1's padding row
    _partition_ok(torch.cat([a["active_rows"], b["active_rows"]]).numpy(), a["passive_rows"], row_entity)


# --------------------------------------------- two ranks against one process


@pytest.fixture(scope="module")
def fe_fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("fe")
    data = write_logistic_avro(d / "train.avro", n=320)
    return d, data, build_index(data, GLOBAL, d / "index")


def test_two_process_training_matches_single_process(fe_fixture):
    d, data, index_dir = fe_fixture
    common = [*GLOBAL, "--input-data", data, "--validation-data", data, "--task", "logistic_regression",
              "--coordinate", FE, "--evaluators", "AUC,LOGISTIC_LOSS", "--feature-index-dir", index_dir]
    out, metrics = str(d / "multi"), str(d / "metrics")
    outs = launch("train", common + PORT + ["--output-dir", out, "--metrics-out", metrics])
    assert_ok(outs)
    errs = "".join(err for _, _, err in outs)
    assert "reads rows [0, 160) of 320 (padded to 160)" in errs and "reads rows [160, 320) of 320" in errs
    _hold_fe(out, index_dir, _jax_fit(data, index_dir, {"global": "features"}, [FE]))
    # the coordinator alone writes; each rank streams its own telemetry
    with open(os.path.join(metrics, "run_summary.json")) as f:
        doc = json.load(f)
    assert doc["distributed"] == {"backend": "gloo", "world_size": 2}
    assert sorted(os.listdir(metrics)) == [
        "flight", "flight.p1", "heartbeats", "metrics.jsonl", "metrics.p1.jsonl", "metrics.p1.prom",
        "metrics.prom", "run_summary.json",
    ]
    assert sorted(os.listdir(os.path.join(metrics, "heartbeats"))) == ["heartbeat-p0.json", "heartbeat-p1.json"]


def test_two_process_uneven_rows(tmp_path):
    """321 rows on 2 ranks (161 / 160): each rank pads its own range."""
    data = write_logistic_avro(tmp_path / "train.avro", n=321)
    index_dir = build_index(data, GLOBAL, tmp_path / "index")
    common = [*GLOBAL, "--input-data", data, "--validation-data", data, "--task", "logistic_regression",
              "--coordinate", FE, "--evaluators", "AUC,LOGISTIC_LOSS", "--feature-index-dir", index_dir]
    outs = launch("train", common + PORT + ["--output-dir", str(tmp_path / "multi")])
    assert_ok(outs)
    errs = "".join(err for _, _, err in outs)
    assert "reads rows [0, 161) of 321 (padded to 161)" in errs
    assert "reads rows [161, 321) of 321 (padded to 161)" in errs
    _hold_fe(str(tmp_path / "multi"), index_dir, _jax_fit(data, index_dir, {"global": "features"}, [FE]))


def test_two_process_glmix_matches_single_process(tmp_path):
    """GLMix across 2 ranks (per-host reads, the cross-rank entity plan and
    shuffle, entity-sharded solves) against the JAX package's one process."""
    data = write_glmix_avro(tmp_path / "glmix.avro", n=641)
    index_dir = build_index(data, GLMIX_SHARDS, tmp_path / "index")
    specs = ["name=global,shard=globalShard,optimizer=LBFGS,tolerance=1e-12,max.iter=300,reg.type=L2,reg.weights=1",
             "name=per-user,shard=userShard,re.type=userId,optimizer=LBFGS,tolerance=1e-12,max.iter=300,"
             "reg.type=L2,reg.weights=1"]
    common = [*GLMIX_SHARDS, "--input-data", data, "--validation-data", data, "--task", "logistic_regression",
              "--coordinate", specs[0], "--coordinate", specs[1], "--coordinate-descent-iterations", "2",
              "--evaluators", "AUC,LOGISTIC_LOSS", "--feature-index-dir", index_dir]
    out = str(tmp_path / "multi")
    assert_ok(launch("train", common + PORT + ["--output-dir", out]))
    ref = _jax_fit(data, index_dir, {"globalShard": "features", "userShard": "userFeatures"}, specs, n_iter=2)
    m = _port_model(out, index_dir, ("globalShard", "userShard"))
    np.testing.assert_allclose(m.models["global"].model.coefficients.means.numpy(),
                               np.asarray(ref.model["global"].model.coefficients.means), rtol=1e-3, atol=1e-5)
    metrics = _summary(out)["best"]["metrics"]
    assert abs(metrics["AUC"] - ref.evaluation.metrics["AUC"]) <= 1e-4
    assert metrics["LOGISTIC_LOSS"] == pytest.approx(ref.evaluation.metrics["LOGISTIC_LOSS"], rel=1e-5)
    re_m, re_r = m.models["per-user"], ref.model["per-user"]
    dim = int(np.asarray(re_r.coef_indices).max()) + 1
    ids = [str(e) for e in re_r.entity_ids if not str(e).startswith("__pad")]
    rows_m, rows_r = re_m.rows_for(ids), re_r.rows_for(ids)
    assert np.all(rows_m >= 0), "the two-rank model is missing entities"
    np.testing.assert_allclose(np.asarray(re_m.dense_coefficients(dim))[rows_m],
                               np.asarray(re_r.dense_coefficients(dim))[rows_r], rtol=0, atol=5e-3)


def test_two_process_normalization_stats_and_scoring(fe_fixture, tmp_path):
    """STANDARDIZATION from the gathered moment sums, --compute-feature-stats
    (global statistics, the coordinator writes) and cli.score --distributed
    (per-rank part files, metrics over every rank's rows), each against the
    JAX package's one process."""
    _, data, index_dir = fe_fixture
    common = [*GLOBAL, "--input-data", data, "--validation-data", data, "--task", "logistic_regression",
              "--coordinate", FE, "--evaluators", "AUC,LOGISTIC_LOSS", "--feature-index-dir", index_dir,
              "--normalization", "STANDARDIZATION", "--compute-feature-stats"]
    out = str(tmp_path / "multi")
    assert_ok(launch("train", common + PORT + ["--output-dir", out]))
    _hold_fe(out, index_dir, _jax_fit(data, index_dir, {"global": "features"}, [FE], normalization="STANDARDIZATION"))
    ref_train.run(common + ["--output-dir", str(tmp_path / "single")])
    _, recs_m = read_avro_file(os.path.join(out, "feature-stats-global.avro"))
    _, recs_s = ref_read_avro_file(os.path.join(str(tmp_path / "single"), "feature-stats-global.avro"))
    sm = {(r["featureName"], r["featureTerm"]): r["metrics"] for r in recs_m}
    ss = {(r["featureName"], r["featureTerm"]): r["metrics"] for r in recs_s}
    assert sm.keys() == ss.keys() and len(sm) > 0
    for k in sm:
        for metric in ("mean", "variance", "numNonzeros"):
            assert sm[k][metric] == pytest.approx(ss[k][metric], rel=1e-12), (k, metric)

    score_common = [*GLOBAL, "--input-data", data, "--feature-index-dir", index_dir, "--model-input-dir",
                    os.path.join(out, "models", "best"), "--task", "logistic_regression", "--evaluators", "AUC"]
    multi_dir, ref_dir = str(tmp_path / "score-multi"), str(tmp_path / "score-ref")
    outs = launch("score", score_common + ["--device", "cpu", "--output-dir", multi_dir])
    assert_ok(outs)
    assert any("scores rows [160, 320)" in err for _, _, err in outs)
    one, one_ev = score.run(score_common + ["--device", "cpu", "--output-dir", str(tmp_path / "score-one")])
    ref_score.run(score_common + ["--output-dir", ref_dir])
    _, ref_recs = ref_read_avro_file(os.path.join(ref_dir, "scores.avro"))
    multi_recs = []
    for i in range(2):
        multi_recs += read_avro_file(os.path.join(multi_dir, f"scores-part-{i:04d}.avro"))[1]
    assert len(multi_recs) == len(ref_recs) == 320
    multi_scores = np.asarray([r["predictionScore"] for r in multi_recs])
    assert np.array_equal(multi_scores, np.asarray(one, np.float64))
    np.testing.assert_allclose(multi_scores, [r["predictionScore"] for r in ref_recs], rtol=1e-5, atol=1e-6)
    with open(os.path.join(multi_dir, "evaluation.json")) as f:
        ev_m = json.load(f)
    assert ev_m["AUC"] == pytest.approx(one_ev.metrics["AUC"], abs=1e-12)
    with open(os.path.join(ref_dir, "evaluation.json")) as f:
        assert ev_m["AUC"] == pytest.approx(json.load(f)["AUC"], abs=1e-4)


def test_two_process_checkpoint_resume_without_shared_fs(fe_fixture, tmp_path):
    """Each rank its own checkpoint and output directories: only the
    coordinator's fill; on resume its state and its model files are
    broadcast and the grid completes from them."""
    _, data, index_dir = fe_fixture
    argv = [*GLOBAL, "--input-data", data, "--task", "logistic_regression", "--feature-index-dir", index_dir,
            "--coordinate", "name=global,shard=global,optimizer=LBFGS,tolerance=1e-10,max.iter=60,reg.type=L2,"
            "reg.weights=1|10", *PORT]
    per_rank = {i: ("--checkpoint-dir", str(tmp_path / f"ckpt-p{i}"), "--output-dir", str(tmp_path / f"out-p{i}"))
                for i in range(2)}
    assert_ok(launch("train", argv, extra_by_rank=per_rank))
    assert os.path.exists(tmp_path / "ckpt-p0" / "checkpoint-state.json")
    assert not os.path.exists(tmp_path / "ckpt-p1" / "checkpoint-state.json")
    outs = launch("train", argv, extra_by_rank=per_rank)
    assert_ok(outs)
    assert all("2/2 configurations already trained" in err for _, _, err in outs)
    assert not os.path.exists(tmp_path / "out-p1" / "models")


# ------------------------------------------------ the (data x model) grid


def test_tiled_glmix_on_a_grid_matches_single_process(tmp_path):
    """tests/test_multihost.py's tiled case on the port's grid, with a random
    effect: cli.train --mesh-shape data=2,model=2 over 4 ranks (each data
    row reads its rows, the tiled fixed effect solves on every rank, the
    per-user random effect over the data axis) against the JAX package's
    one process (FE rtol 1e-3 / atol 1e-5, AUC within 1e-4, RE by entity
    atol 5e-3), every update a two-phase checkpoint written by the first
    model index only; then a resume on data=2,model=1 refused on every
    rank in the JAX package's words."""
    data = write_glmix_avro(tmp_path / "glmix.avro", n=641)
    index_dir = build_index(data, GLMIX_SHARDS, tmp_path / "index")
    specs = ["name=global,shard=globalShard,optimizer=LBFGS,tolerance=1e-12,max.iter=300,reg.type=L2,reg.weights=1",
             "name=per-user,shard=userShard,re.type=userId,optimizer=LBFGS,tolerance=1e-12,max.iter=300,"
             "reg.type=L2,reg.weights=1"]
    common = [*GLMIX_SHARDS, "--input-data", data, "--validation-data", data, "--task", "logistic_regression",
              "--coordinate", specs[0] + ",layout=tiled", "--coordinate", specs[1], "--coordinate-descent-iterations",
              "2", "--evaluators", "AUC,LOGISTIC_LOSS", "--feature-index-dir", index_dir, *PORT,
              "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"]
    out = str(tmp_path / "grid")
    outs = launch("train", common + ["--output-dir", out, "--mesh-shape", "data=2,model=2"], world=4)
    assert_ok(outs)
    errs = "".join(err for _, _, err in outs)
    assert "reads rows [0, 321) of 641 (padded to 321)" in errs and "reads rows [321, 641) of 641" in errs
    ref = _jax_fit(data, index_dir, {"globalShard": "features", "userShard": "userFeatures"}, specs, n_iter=2)
    m = _port_model(out, index_dir, ("globalShard", "userShard"))
    w = m.models["global"].model.coefficients.means.numpy()
    assert w.shape[0] == load_partitioned(index_dir, "globalShard").size  # the padding trimmed
    np.testing.assert_allclose(w, np.asarray(ref.model["global"].model.coefficients.means), rtol=1e-3, atol=1e-5)
    metrics = _summary(out)["best"]["metrics"]
    assert abs(metrics["AUC"] - ref.evaluation.metrics["AUC"]) <= 1e-4
    re_m, re_r = m.models["per-user"], ref.model["per-user"]
    dim = int(np.asarray(re_r.coef_indices).max()) + 1
    ids = [str(e) for e in re_r.entity_ids if not str(e).startswith("__pad")]
    rows_m, rows_r = re_m.rows_for(ids), re_r.rows_for(ids)
    assert np.all(rows_m >= 0), "the grid's model is missing entities"
    np.testing.assert_allclose(np.asarray(re_m.dense_coefficients(dim))[rows_m],
                               np.asarray(re_r.dense_coefficients(dim))[rows_r], rtol=0, atol=5e-3)
    last = sorted(os.listdir(tmp_path / "ck" / "cd-boundaries"))[-1]
    assert sorted(os.listdir(tmp_path / "ck" / "cd-boundaries" / last)) == [
        "MANIFEST.json", "shard-p0.pkl", "shard-p1.pkl", "state.pkl"]
    with open(tmp_path / "ck" / "cd-boundaries" / last / "MANIFEST.json") as f:
        assert json.load(f)["topology"]["mesh_axes"] == {"data": 2, "model": 2}
    outs = launch("train", common + ["--output-dir", str(tmp_path / "again"), "--mesh-shape", "data=2,model=1",
                                     "--resume"], world=2)
    for rc, _, err in outs:
        assert rc != 0 and "checkpoint mesh reshape across the model axis is not supported" in err


def test_full_variance_on_tiled_through_cli_on_8_ranks(fe_fixture, tmp_path):
    """tests/test_cli.py's FULL-on-tiled case: cli.train --mesh-shape
    data=4,model=2 --distributed on 8 ranks with variance=FULL on a tiled
    fixed effect, against the JAX package's one-process dense FULL fit
    (means and variances rtol 1e-3 / atol 1e-5, AUC within 1e-4)."""
    _, data, index_dir = fe_fixture
    spec = FE + ",variance=FULL"
    out = str(tmp_path / "grid")
    assert_ok(launch("train", [*GLOBAL, "--input-data", data, "--validation-data", data, "--task",
                               "logistic_regression", "--coordinate", spec + ",layout=tiled", "--evaluators",
                               "AUC,LOGISTIC_LOSS", "--feature-index-dir", index_dir, *PORT, "--output-dir", out,
                               "--mesh-shape", "data=4,model=2"], world=8))
    ref = _jax_fit(data, index_dir, {"global": "features"}, [spec])
    _hold_fe(out, index_dir, ref)
    got = _port_model(out, index_dir, ["global"]).models["global"].model.coefficients.variances.numpy()
    np.testing.assert_allclose(got, np.asarray(ref.model["global"].model.coefficients.variances), rtol=1e-3, atol=1e-5)
