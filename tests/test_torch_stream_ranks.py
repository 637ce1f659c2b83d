"""Out-of-core training across processes: the port's streamed coordinates
over two gloo CPU ranks (``--distributed`` with ``hbm.budget.mb`` and
``--pipeline-depth 2``), against the JAX package on the CPU.

- (a) tests/test_multihost.py:460 on the port: ``cli.train`` over two ranks
  with ``hbm.budget.mb=0`` on both coordinates and ``--pipeline-depth 2``,
  in float64, against the JAX package's single-process resident fit
  (``GameEstimator.fit`` in float64) at ROADMAP's bounds: fixed-effect
  coefficients rtol 1e-3 / atol 1e-5, random-effect coefficients (by
  entity id) atol 5e-3, per-entity loss atol 1e-4 on identical residuals,
  the validation AUC within 2e-3; the JAX test's plan fields; both ranks'
  best models bitwise alike.
- (b) The streamed objective over two ranks, dense and ELL, on 321 uneven
  rows: value, gradient and Hv against the JAX package's single-process
  ``StreamedFEObjective`` over the whole batch (float64: rtol 1e-12), the
  ranks bitwise alike.
- (c) The streamed random effect over two ranks (``entity_shard_range``):
  the vmapped solve bitwise the port's one-process streamed solve, the
  packed solve at the packed bound (atol 5e-3, loss atol 1e-4), the table
  whole on every rank.
- (d) One rank through ``--distributed``, streamed, bitwise the
  one-process streamed run.
- (e) The streamed two-rank run killed at both ranks' second boundary
  checkpoint and resumed: models bitwise the straight run's.

Every rank is an OS process (``tests/_torch_mp_common.py``) or a spawned
child (rank bodies in ``tests/_torch_mp_ranks.py``)."""

from __future__ import annotations

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mp_common import assert_ok, build_index, launch, write_glmix_avro
from photon_ml_tpu.cli.params import parse_coordinate as ref_parse_coordinate
from photon_ml_tpu.estimators.game_estimator import GameEstimator as RefGameEstimator
from photon_ml_tpu.game import build_fixed_effect_dataset as jax_build_fe
from photon_ml_tpu.game.fe_streaming import StreamedFEObjective as JaxStreamedObjective
from photon_ml_tpu.io import FeatureShardConfig as RefShardConfig
from photon_ml_tpu.io import read_avro_dataset as ref_read_avro_dataset
from photon_ml_tpu.io.data import RawDataset as JaxRawDataset
from photon_ml_tpu.io.index_map import load_partitioned as ref_load_partitioned
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu_torch.cli import train
from photon_ml_tpu_torch.game import GLMOptimizationConfig, RandomEffectCoordinate, build_random_effect_dataset
from photon_ml_tpu_torch.game.coordinate import _project_model_values
from photon_ml_tpu_torch.io import FeatureShardConfig, read_avro_dataset
from photon_ml_tpu_torch.io.data import RawDataset
from photon_ml_tpu_torch.io.index_map import load_partitioned
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.models.game import RandomEffectModel
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel import spawn

SHARDS = ["--feature-shard", "name=globalShard,bags=features", "--feature-shard", "name=userShard,bags=userFeatures"]
BAGS = {"globalShard": "features", "userShard": "userFeatures"}
FE = "name=global,shard=globalShard,optimizer=LBFGS,tolerance=1e-12,max.iter=300,reg.type=L2,reg.weights=1"
RE = ("name=per-user,shard=userShard,re.type=userId,optimizer=LBFGS,tolerance=1e-12,max.iter=300,reg.type=L2,"
      "reg.weights=1")
STREAMED = ["--coordinate", FE + ",hbm.budget.mb=0", "--coordinate", RE + ",hbm.budget.mb=0", "--pipeline-depth", "2"]
PORT = ["--device", "cpu", "--dtype", "float64"]
DIGEST = re.compile(r"best model sha256 ([0-9a-f]{64}) \(process (\d+)\)")


def _common(data, index_dir):
    return [*SHARDS, "--input-data", data, "--validation-data", data, "--task", "logistic_regression",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC,LOGISTIC_LOSS",
            "--feature-index-dir", index_dir, *PORT]


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


def _same_models(a, b):
    fa, fb = a["global"].model.coefficients.means, b["global"].model.coefficients.means
    ra, rb = a["per-user"], b["per-user"]
    return (torch.equal(fa, fb) and list(map(str, ra.entity_ids)) == list(map(str, rb.entity_ids))
            and torch.equal(ra.coef_values, rb.coef_values) and torch.equal(ra.coef_indices, rb.coef_indices))


@pytest.fixture(scope="module")
def glmix(tmp_path_factory):
    """641 GLMix rows (321 / 320 on two ranks) and their index; the straight
    streamed two-rank run, a boundary checkpoint every update."""
    d = tmp_path_factory.mktemp("stream-ranks")
    data = write_glmix_avro(d / "glmix.avro", n=641)
    index_dir = build_index(data, SHARDS, d / "index")
    out, metrics, ck = str(d / "out"), str(d / "metrics"), str(d / "ck")
    argv = _common(data, index_dir) + STREAMED + ["--checkpoint-dir", ck, "--checkpoint-every", "1"]
    outs = launch("train", argv + ["--output-dir", out, "--metrics-out", metrics])
    assert_ok(outs)
    return dict(root=d, data=data, index=index_dir, argv=argv, out=out, metrics=metrics, outs=outs)


def _jax_fit(data, index_dir):
    """The JAX package's one-process resident fit in float64 on the same
    rows and index, validated on the training rows."""
    maps = {s: ref_load_partitioned(index_dir, s) for s in BAGS}
    raw, _ = ref_read_avro_dataset(data, {s: RefShardConfig((b,)) for s, b in BAGS.items()}, index_maps=maps,
                                   id_tag_columns=["userId"])
    est = RefGameEstimator("logistic_regression", [ref_parse_coordinate(s) for s in (FE, RE)], n_cd_iterations=2,
                           evaluator_specs=["AUC", "LOGISTIC_LOSS"], dtype=jnp.float64)
    return est.fit(raw, validation=raw)[0]


def _re_losses(ds, model, residual, l2):
    """Each entity's L2-regularized logistic loss in float64 on ``ds``'s
    blocks at ``model``'s coefficients (projected by entity id and
    feature), on ``residual``."""
    b = ds.blocks
    w = _project_model_values(ds, model, model.coef_values, torch.float64)
    valid = b.active_rows >= 0
    off = b.offsets + residual[b.active_rows.clamp(min=0).long()] * valid
    z = torch.einsum("eks,es->ek", b.features, w) + off
    ll = b.weights * (torch.nn.functional.softplus(z) - b.labels * z)
    return ll.sum(dim=1) + 0.5 * l2 * (w * w).sum(dim=1)


def test_two_rank_streamed_pipelined_glmix_matches_single_process(glmix):
    """(a): the plan's fields, the stream counters of both ranks, both ranks'
    models bitwise alike, and the fit against the JAX package's resident
    one-process fit."""
    with open(os.path.join(glmix["metrics"], "run_summary.json")) as f:
        summary = json.load(f)
    plan = summary["plan"]
    assert plan["n_processes"] == 2 and plan["pipeline_depth"] == 2 and plan["distributed"]
    routing = {c["name"]: c for c in plan["coordinates"]}
    assert routing["global"]["residency"] == routing["per-user"]["residency"] == "streamed"
    assert routing["global"]["sharding"] == "host-sharded rows (streamed slices)"
    assert routing["per-user"]["sharding"] == "entity-sharded (host-resident blocks)"
    assert routing["global"]["pipelined"] and routing["per-user"]["pipelined"]
    slices = {m["labels"]["site"]: m["value"] for m in summary["metrics"] if m["name"] == "photon_stream_slices_total"}
    assert slices["fe.train"] > 0 and slices["re.train"] > 0
    with open(os.path.join(glmix["metrics"], "metrics.p1.prom")) as f:
        p1 = f.read()
    for site in ("fe.train", "re.train"):
        assert re.search(rf'photon_stream_slices_total{{site="{site}"}} [1-9]', p1), site
    digests = _digests(glmix["outs"])
    assert digests[0] is not None and digests[0] == digests[1]

    ref = _jax_fit(glmix["data"], glmix["index"])
    ours = _load(glmix["out"], glmix["index"])
    np.testing.assert_allclose(ours["global"].model.coefficients.means.numpy(),
                               np.asarray(ref.model["global"].model.coefficients.means), rtol=1e-3, atol=1e-5)
    with open(os.path.join(glmix["out"], "training-summary.json")) as f:
        metrics = json.load(f)["best"]["metrics"]
    assert abs(metrics["AUC"] - ref.evaluation.metrics["AUC"]) <= 2e-3
    assert metrics["LOGISTIC_LOSS"] == pytest.approx(ref.evaluation.metrics["LOGISTIC_LOSS"], rel=1e-3)
    re_m, re_r = ours["per-user"], ref.model["per-user"]
    dim = int(np.asarray(re_r.coef_indices).max()) + 1
    ids = [str(e) for e in re_r.entity_ids if not str(e).startswith("__pad")]
    rows_m, rows_r = re_m.rows_for(ids), re_r.rows_for(ids)
    assert np.all(rows_m >= 0), "the two-rank model is missing entities"
    np.testing.assert_allclose(np.asarray(re_m.dense_coefficients(dim))[rows_m],
                               np.asarray(re_r.dense_coefficients(dim))[rows_r], rtol=0, atol=5e-3)
    # per-entity losses of both models on one residual: the JAX fit's
    # fixed-effect scores
    maps = {s: load_partitioned(glmix["index"], s) for s in BAGS}
    raw, _ = read_avro_dataset(glmix["data"], {s: FeatureShardConfig((b,)) for s, b in BAGS.items()},
                               index_maps=maps, id_tag_columns=["userId"])
    ds = build_random_effect_dataset(raw, "per-user", "userShard", "userId", dtype=torch.float64, device="cpu")
    rows, cols, vals = raw.shard_coo["globalShard"]
    w_fe = np.asarray(ref.model["global"].model.coefficients.means)
    residual = torch.from_numpy(np.bincount(rows, weights=vals * w_fe[cols], minlength=raw.n_rows))
    theirs = RandomEffectModel(
        random_effect_type="userId", feature_shard="userShard", task="logistic_regression",
        entity_ids=np.asarray(re_r.entity_ids), coef_indices=torch.as_tensor(np.asarray(re_r.coef_indices)),
        coef_values=torch.as_tensor(np.asarray(re_r.coef_values)),
    )
    np.testing.assert_allclose(_re_losses(ds, re_m, residual, 1.0).numpy(),
                               _re_losses(ds, theirs, residual, 1.0).numpy(), rtol=0, atol=1e-4)


def _fe_fields(n=321, d=12, seed=3):
    """n rows of d features; the second half's rows carry more entries, so
    the two ranks' ELL widths differ."""
    rng = np.random.default_rng(seed)
    nnz = np.where(np.arange(n) < (n + 1) // 2, rng.integers(1, 4, n), rng.integers(3, 9, n))
    rows = np.repeat(np.arange(n), nnz)
    cols = np.concatenate([np.sort(rng.choice(d, k, replace=False)) for k in nnz])
    return dict(
        n_rows=n, labels=(rng.uniform(size=n) < 0.5).astype(np.float64), offsets=0.1 * rng.normal(size=n),
        weights=rng.uniform(0.5, 2.0, n), shard_coo={"g": (rows, cols, rng.normal(size=len(rows)))},
        shard_dims={"g": d}, id_tags={},
    )


def test_streamed_objective_over_two_ranks_matches_the_jax_package(tmp_path):
    """(b): dense and ELL, 321 uneven rows (161 / 160), budgets below every
    share; each rank streams its own rows (ELL at its own width) and every
    pass sums both ranks' slot rows in (rank, slice) order."""
    fields = _fe_fields()
    rng = np.random.default_rng(5)
    d = fields["shard_dims"]["g"]
    w, v, residual = rng.normal(size=d), rng.normal(size=d), 0.3 * rng.normal(size=fields["n_rows"])
    budget = 1 << 10
    payload = dict(raw=fields, shard="g", layouts=("dense", "ell"), budget=budget, l2=0.7, w=w, v=v,
                   residual=residual)
    ranks = spawn("_torch_mp_ranks:streamed_objective", 2, "gloo", "cpu", args=(payload,), timeout_s=120.0,
                  store_dir=tmp_path)
    jraw = JaxRawDataset(**fields)
    for layout in ("dense", "ell"):
        a, b = ranks[0][layout], ranks[1][layout]
        assert a["streamed"] and b["streamed"] and a["host_layout"] == layout
        assert (a["host_rows"], b["host_rows"]) == (161, 160) and a["n_rows"] == 322
        for key in ("value", "grad", "hv"):
            assert torch.equal(a[key], b[key]), (layout, key)
        jds = jax_build_fe(jraw, "global", "g", dtype=jnp.float64, layout=layout, hbm_budget_bytes=budget)
        jobj = JaxStreamedObjective(JAX_LOSSES["logistic"], jds.host_batch, budget, l2_weight=0.7,
                                    residual_scores=jnp.asarray(residual))
        jv, jg = jobj.value_and_grad(w)
        jhv = jobj.hessian_vector(w, v)
        np.testing.assert_allclose(float(a["value"]), float(jv), rtol=1e-12)
        np.testing.assert_allclose(a["grad"].numpy(), np.asarray(jg), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(a["hv"].numpy(), np.asarray(jhv), rtol=1e-12, atol=1e-12)
    # the ELL widths are the ranks' own: rank 1's rows carry more entries
    assert (ranks[0]["ell"]["ell_width"], ranks[1]["ell"]["ell_width"]) == (3, 8)


def _re_fields(n=321, n_users=24, d=5, seed=9):
    rng = np.random.default_rng(seed)
    users = rng.zipf(1.4, n) % n_users
    x = rng.normal(size=(n, d))
    x[:, 0] = 1.0
    w = rng.normal(size=(n_users, d))
    z = np.einsum("nd,nd->n", x, w[users])
    rows, cols = np.nonzero(x)
    return dict(
        n_rows=n, labels=(rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64), offsets=np.zeros(n),
        weights=np.ones(n), shard_coo={"u": (rows, cols, x[rows, cols])}, shard_dims={"u": d},
        id_tags={"userId": np.array([f"u{k}" for k in users], dtype=object)},
    )


def test_streamed_random_effect_over_two_ranks(tmp_path, monkeypatch):
    """(c): each rank keeps the blocks of its entity range in host memory
    and solves them; the gathered table is whole and bitwise alike on both
    ranks; the vmapped solve is bitwise the one-process streamed solve and
    the packed solve at the packed bound."""
    fields = _re_fields()
    opts = dict(tolerance=1e-10, max_iterations=60, reg_weight=1.0)
    payload = dict(raw=fields, shard="u", re_type="userId", budget=1, solvers=("vmapped", "packed"), **opts)
    ranks = spawn("_torch_mp_ranks:streamed_random_effect", 2, "gloo", "cpu", args=(payload,), timeout_s=120.0,
                  store_dir=tmp_path)
    a, b = ranks
    assert a["streamed"] and b["streamed"]
    assert a["range"] == (0, a["block_rows"]) and b["range"] == (a["block_rows"], 2 * a["block_rows"])
    raw = RawDataset(**fields)
    one = build_random_effect_dataset(raw, "re", "u", "userId", dtype=torch.float64, hbm_budget_bytes=1, device="cpu")
    assert one.streamed
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=opts["tolerance"], max_iterations=opts["max_iterations"]),
        regularization=RegularizationContext("L2"), reg_weight=opts["reg_weight"],
    )
    ids = [str(e) for e in one.entity_ids]
    for solver in ("vmapped", "packed"):
        ra, rb = a[solver], b[solver]
        for key in ("coef_values", "coef_indices", "loss", "scores"):
            assert torch.equal(ra[key], rb[key]), (solver, key)
        assert ra["entity_ids"] == rb["entity_ids"] and ra["coef_values"].shape[0] == 2 * a["block_rows"]
        monkeypatch.setenv("PHOTON_RE_SOLVER", solver)
        coord = RandomEffectCoordinate(dataset=one, task="logistic_regression", config=cfg)
        model, res = coord.train(None)
        rows = [ra["entity_ids"].index(e) for e in ids]
        got, got_loss = ra["coef_values"][rows], ra["loss"][rows]
        if solver == "vmapped":
            assert torch.equal(got, model.coef_values) and torch.equal(got_loss, res.loss)
        else:
            np.testing.assert_allclose(got.numpy(), model.coef_values.numpy(), rtol=0, atol=5e-3)
            np.testing.assert_allclose(got_loss.numpy(), res.loss.numpy(), rtol=0, atol=1e-4)
        # scores of the padded global rows: rank r's row i is r * 161 + i
        padded = ra["scores"].numpy()
        whole = np.concatenate([padded[:161], padded[161:321]])
        np.testing.assert_allclose(whole, coord.score(model).numpy(), rtol=1e-12, atol=1e-12)


def test_one_rank_streamed_is_the_one_process_run(glmix, tmp_path):
    """(d): one rank through --distributed, both coordinates streamed at
    depth 2, bitwise the one-process streamed run's models."""
    argv = _common(glmix["data"], glmix["index"]) + STREAMED
    one = str(tmp_path / "one")
    summary = train.run(argv + ["--output-dir", one])
    outs = launch("train", argv + ["--output-dir", str(tmp_path / "rank")], world=1)
    assert_ok(outs)
    assert _digests(outs) == [summary["best"]["model_sha256"]]
    assert _same_models(_load(one, glmix["index"]), _load(str(tmp_path / "rank"), glmix["index"]))


def test_streamed_two_rank_kill_and_resume(glmix, tmp_path):
    """(e): both ranks die after their second boundary checkpoint (the
    first sweep's end); the same command with --resume ends with the
    straight run's models, bitwise."""
    argv = glmix["argv"] + ["--output-dir", str(tmp_path / "out")]
    argv[argv.index("--checkpoint-dir") + 1] = str(tmp_path / "ck")
    kill = {"PHOTON_FAULTS": "cd.boundary_saved:kill:2"}
    outs = launch("train", argv, env_by_rank={0: kill, 1: kill})
    for rc, _, err in outs:
        assert rc != 0 and "SimulatedKill" in err, err[-3000:]
    outs = launch("train", argv + ["--resume"])
    assert_ok(outs)
    assert "resuming from checkpoint" in outs[0][2]
    assert _digests(outs) == _digests(glmix["outs"])
    assert _same_models(_load(str(tmp_path / "out"), glmix["index"]), _load(glmix["out"], glmix["index"]))
