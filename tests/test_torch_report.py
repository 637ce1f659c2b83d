"""The port's training report (``photon_ml_tpu_torch.obs.report``,
``obs.diagnostics``, ``cli.report``) against the JAX package's, on the CPU:
every case of tests/test_report.py, each run through both packages on the
same inputs, and the report of a ``cli.train --report-out`` run rebuilt by
``cli.report`` byte for byte, for a run of either package.

Bounds: the diagnostics, the bench diff and the report are float64 numpy and
stdlib code copied from the JAX package, so both packages' results are held
equal (``==``) on equal inputs, report.html text included. The reference's
own checks keep its tolerance (``pytest.approx``'s default, rel 1e-6).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest

from photon_ml_tpu.cli import report as ref_report_cli
from photon_ml_tpu.obs import diagnostics as ref_diagnostics
from photon_ml_tpu.obs import report as ref_report
from photon_ml_tpu_torch.cli import report as report_cli
from photon_ml_tpu_torch.obs import diagnostics
from photon_ml_tpu_torch.obs import report as report_mod

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _poisoned_env(tmp_path):
    """PYTHONPATH on which ``jax`` and ``photon_ml_tpu`` raise on import."""
    poison = tmp_path / "poison"
    (poison / "photon_ml_tpu").mkdir(parents=True)
    (poison / "jax.py").write_text("raise ImportError('jax is poisoned for this test')\n")
    (poison / "photon_ml_tpu" / "__init__.py").write_text(
        "raise ImportError('photon_ml_tpu is poisoned for this test')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(poison), REPO_ROOT, env.get("PYTHONPATH", "")])
    return env


# ---------------------------------------------------------------- oracles


def test_coefficient_summary_oracle():
    values = [0.0, 1.0, -2.0, 0.5]
    names = ["a", "b", "c", "d"]
    s = diagnostics.coefficient_summary(values, names, n_features_total=10, top_k=2)
    assert s == ref_diagnostics.coefficient_summary(values, names, n_features_total=10, top_k=2)
    assert s["n_recorded"] == 4 and s["n_nonzero"] == 3
    assert s["n_features_total"] == 10
    assert s["sparsity"] == pytest.approx(0.7)
    assert s["l1_norm"] == pytest.approx(3.5)
    assert s["l2_norm"] == pytest.approx(math.sqrt(1 + 4 + 0.25))
    assert s["max_abs"] == pytest.approx(2.0)
    assert s["quantiles"]["p0"] == pytest.approx(-2.0)
    assert s["quantiles"]["p100"] == pytest.approx(1.0)
    assert s["quantiles"]["p50"] == pytest.approx(0.25)
    assert s["top_features"] == [{"feature": "c", "weight": -2.0}, {"feature": "b", "weight": 1.0}]


def test_coefficient_summary_empty_and_nameless():
    s = diagnostics.coefficient_summary([])
    assert s == ref_diagnostics.coefficient_summary([])
    assert s["n_recorded"] == 0 and s["l2_norm"] == 0.0
    assert s["top_features"] == []
    assert diagnostics.coefficient_summary([1.0])["top_features"] == []
    assert diagnostics.coefficient_summary([1.0]) == ref_diagnostics.coefficient_summary([1.0])


def test_shrinkage_summary_oracle():
    """log2 binning: bin = floor(log2(count)), count 0 its own bin."""
    norms = [1.0, 2.0, 3.0, 4.0, 5.0]
    counts = [1, 2, 3, 5, 0]
    s = diagnostics.shrinkage_summary(norms, counts)
    assert s == ref_diagnostics.shrinkage_summary(norms, counts)
    assert s["n_entities"] == 5
    assert s["norm_quantiles"]["p50"] == pytest.approx(3.0)
    assert [h["support"] for h in s["histogram"]] == ["0", "[1,2)", "[2,4)", "[4,8)"]
    by_bin = {h["support"]: h for h in s["histogram"]}
    assert by_bin["0"]["n_entities"] == 1
    assert by_bin["0"]["mean_norm"] == pytest.approx(5.0)
    assert by_bin["[2,4)"]["n_entities"] == 2
    assert by_bin["[2,4)"]["mean_norm"] == pytest.approx(2.5)
    assert by_bin["[2,4)"]["min_norm"] == pytest.approx(2.0)
    assert by_bin["[2,4)"]["max_norm"] == pytest.approx(3.0)
    with pytest.raises(ValueError):
        diagnostics.shrinkage_summary([1.0], [1, 2])


def test_gauge_trajectories_align_with_none_gaps():
    def g(name, value, **labels):
        return {"name": name, "kind": "gauge", "labels": labels, "value": value}

    snaps = [
        [g("photon_cd_accepted_loss", 5.0, coordinate="global")],
        [g("photon_cd_accepted_loss", 4.0, coordinate="global"),
         g("photon_cd_accepted_loss", 9.0, coordinate="per-user")],
    ]
    t = diagnostics.gauge_trajectories(snaps, "photon_cd_accepted_loss", "coordinate")
    assert t == {"global": [5.0, 4.0], "per-user": [None, 9.0]}
    assert t == ref_diagnostics.gauge_trajectories(snaps, "photon_cd_accepted_loss", "coordinate")


def test_iter_metric_snapshots_tolerates_torn_lines():
    lines = [
        json.dumps({"type": "metrics", "metrics": [{"name": "x"}]}),
        '{"type": "span", "name": "cd.sweep"}',
        '{"type": "metrics", "metr',  # torn trailing line from a crash
    ]
    snaps = list(diagnostics.iter_metric_snapshots(lines))
    assert snaps == [[{"name": "x"}]] == list(ref_diagnostics.iter_metric_snapshots(lines))


def test_bench_diff_oracle():
    old = {"quadrants": {"fe": {"wall_s": 2.0, "label": "x"}, "re": {"wall_s": 1.0}}}
    new = {"quadrants": {"fe": {"wall_s": 3.0, "label": "y"}}}
    d = report_mod.bench_diff(old, new)
    assert d == ref_report.bench_diff(old, new)
    assert set(d) == {"quadrants.fe.wall_s"}
    assert d["quadrants.fe.wall_s"]["delta_pct"] == pytest.approx(50.0)


def test_sparkline_svg():
    for values in ([1.0, None, 3.0, 2.0], [1.0]):
        assert report_mod.sparkline_svg(values) == ref_report.sparkline_svg(values)
    svg = report_mod.sparkline_svg([1.0, None, 3.0, 2.0])
    assert svg.startswith("<svg") and "polyline" in svg
    placeholder = report_mod.sparkline_svg([1.0])
    assert "n/a" in placeholder and "polyline" not in placeholder


# ---------------------------------------------------------------- fixtures


def _gauge(name, value, **labels):
    return {"name": name, "kind": "gauge", "help": "", "labels": labels, "value": value}


def _final_snapshot():
    return [
        _gauge("photon_cd_accepted_loss", 4.0, coordinate="global"),
        _gauge("photon_cd_final_loss", 4.0, coordinate="global"),
        _gauge("photon_cd_update_iterations", 7.0, coordinate="global"),
        _gauge("photon_validation_metric", 0.71, metric="AUC", coordinate="global"),
        {"name": "photon_jax_compile_seconds", "kind": "summary", "help": "",
         "labels": {"event": "jit_fn"}, "sum": 1.25,
         "stat": {"count": 2, "mean": 0.625, "stdev": 0.1, "max": 1.0, "min": 0.25}},
        _gauge("photon_stream_budget_bytes", 1024.0, site="fe.train"),
        _gauge("photon_stream_actual_slice_bytes", 256.0, site="fe.train"),
        _gauge("photon_stream_budget_headroom_bytes", 512.0, site="fe.train"),
        _gauge("photon_mem_host_rss_bytes", 1000.0),
        _gauge("photon_mem_host_peak_rss_bytes", 2000.0),
        _gauge("photon_mem_device_bytes_in_use", 300.0, device="cuda:0"),
        _gauge("photon_mem_device_peak_bytes_in_use", 400.0, device="cuda:0"),
        _gauge("photon_mem_device_bytes_limit", 4096.0, device="cuda:0"),
    ]


def _write_model_fixture(model_dir):
    """A saved-model layout written by the port's avro writer: one fixed
    effect, one random effect with three entities."""
    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL_AVRO

    def rec(model_id, triples):
        return {"modelId": model_id, "modelClass": None,
                "means": [{"name": n, "term": t, "value": v} for n, t, v in triples],
                "variances": None, "lossFunction": None}

    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "model-metadata.json"), "w") as f:
        json.dump({"modelType": "LOGISTIC_REGRESSION"}, f)
    fe = os.path.join(model_dir, "fixed-effect", "global")
    os.makedirs(os.path.join(fe, "coefficients"), exist_ok=True)
    with open(os.path.join(fe, "id-info"), "w") as f:
        f.write("globalShard\n")
    write_avro_file(os.path.join(fe, "coefficients", "part-00000.avro"), BAYESIAN_LINEAR_MODEL_AVRO,
                    [rec("global", [("f0", "", 2.0), ("f1", "t", -1.0), ("f2", "", 0.5)])])
    re_ = os.path.join(model_dir, "random-effect", "per-user")
    os.makedirs(os.path.join(re_, "coefficients"), exist_ok=True)
    with open(os.path.join(re_, "id-info"), "w") as f:
        f.write("userId\nuserShard\n")
    write_avro_file(os.path.join(re_, "coefficients", "part-00000.avro"), BAYESIAN_LINEAR_MODEL_AVRO,
                    [rec("u1", [("f0", "", 3.0), ("f1", "", 4.0)]), rec("u2", [("f0", "", 1.0)]), rec("u3", [])])


def _make_artifacts(root):
    """A complete synthetic artifacts tree ``cli.report`` can discover."""
    os.makedirs(root, exist_ok=True)
    final = _final_snapshot()
    with open(os.path.join(root, "run_summary.json"), "w") as f:
        json.dump({
            "total_wall_seconds": 12.5,
            "task": "logistic_regression",
            "best": {"reg_weights": {"global": 1.0}, "metrics": {"AUC": 0.71}},
            "coordinates": {"global": {
                "iterations": {"count": 2, "mean": 7.0, "stdev": 0.0, "max": 7.0, "min": 7.0},
                "convergence_reasons": {"GRADIENT_CONVERGED": 2}, "rejections": 1}},
            "metrics": final,
            "plan": {
                "coordinates": [{"name": "global", "kind": "fixed-effect", "layout": "auto", "feature_dtype": None,
                                 "residency": "streamed", "sharding": "host-sharded rows (streamed slices)",
                                 "pipelined": True, "hbm_budget_mb": 0, "geometry": {}, "notes": []}],
                "mesh_axes": {"data": 8, "model": 1}, "n_processes": 2, "pipeline_depth": 2, "trial_lanes": 1,
                "normalization": "NONE", "distributed": True,
            },
            "memory": {"host": {"rss_bytes": 1000, "peak_rss_bytes": 2000}},
            "timeline": {
                "n_sweeps": 2,
                "sweeps": [{"overlap_factor": 0.0}, {"overlap_factor": 0.25}],
                "total": {"wall_seconds": 10.0, "phases": {"solve": 8.0}, "critical_path_seconds": 9.0,
                          "other_seconds": 1.0, "sum_of_phases_seconds": 12.0, "overlap_factor": 0.25},
            },
        }, f)
    with open(os.path.join(root, "metrics.jsonl"), "w") as f:
        first = [_gauge("photon_cd_accepted_loss", 5.0, coordinate="global"),
                 _gauge("photon_validation_metric", 0.65, metric="AUC", coordinate="global")]
        f.write(json.dumps({"type": "metrics", "metrics": first}) + "\n")
        f.write(json.dumps({"type": "metrics", "metrics": final}) + "\n")
    with open(os.path.join(root, "training-summary.json"), "w") as f:
        json.dump({"task": "logistic_regression", "best": {"reg_weights": {"global": 1.0}}}, f)
    _write_model_fixture(os.path.join(root, "models", "best"))
    idx = os.path.join(root, "index")
    os.makedirs(idx, exist_ok=True)
    with open(os.path.join(idx, "_index-globalShard-meta.json"), "w") as f:
        json.dump({"shard": "globalShard", "numPartitions": 1, "size": 6}, f)
    ck = os.path.join(root, "ckpt", "boundary-000001")
    os.makedirs(ck, exist_ok=True)
    with open(os.path.join(ck, "MANIFEST.json"), "w") as f:
        json.dump({"step": 1, "iteration": 0, "coordinate": "global", "bytes": 123, "sha256": "0" * 64}, f)
    with open(os.path.join(root, "bench-progress.jsonl"), "w") as f:
        f.write(json.dumps({"ts": 1.0, "type": "bench_diff", "tolerance": 0.2, "regressed": [],
                            "series": {"fe.wall_s": {"old": 2.0, "new": 1.8, "delta_pct": -10.0}}}) + "\n")
    return root


def _both_reports(root, out_port, out_ref, extra=()):
    """``cli.report`` of each package over ``root``: the documents and the
    report.html texts held equal; the port's document returned."""
    doc = report_cli.run([root, "--out", out_port, *extra])
    ref = ref_report_cli.run([root, "--out", out_ref, *extra])
    assert doc == ref
    with open(os.path.join(out_port, "report.json"), "rb") as a, open(os.path.join(out_ref, "report.json"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(out_port, "report.html")) as a, open(os.path.join(out_ref, "report.html")) as b:
        assert a.read() == b.read()
    return doc


# ---------------------------------------------------------------- golden schema


def test_report_json_golden_schema(tmp_path):
    """The report.json schema, key sets at every level a consumer binds to,
    and the same document and HTML from both packages."""
    root = _make_artifacts(str(tmp_path / "artifacts"))
    out = str(tmp_path / "rep")
    doc = _both_reports(root, out, str(tmp_path / "ref-rep"))

    assert doc["schema_version"] == 3 == report_mod.REPORT_SCHEMA_VERSION
    assert set(doc) == {"schema_version", "task", "best", "models", "convergence", "performance", "plan",
                        "memory", "checkpoints", "bench", "flight"}
    assert doc["task"] == "logistic_regression"
    assert doc["flight"] == []
    plan = doc["plan"]
    assert plan["n_processes"] == 2 and plan["mesh_axes"] == {"data": 8, "model": 1}
    (cp,) = plan["coordinates"]
    assert cp["residency"] == "streamed"
    assert cp["sharding"] == "host-sharded rows (streamed slices)"

    assert set(doc["models"]) == {"best"}
    model = doc["models"]["best"]
    assert set(model) == {"metadata", "coordinates"}
    assert set(model["coordinates"]) == {"global", "per-user"}
    fe = model["coordinates"]["global"]
    assert set(fe) == {"type", "feature_shard", "coefficients"}
    assert fe["type"] == "fixed" and fe["feature_shard"] == "globalShard"
    assert set(fe["coefficients"]) == {"n_nonzero", "n_recorded", "n_features_total", "sparsity", "l1_norm",
                                       "l2_norm", "max_abs", "quantiles", "top_features"}
    assert set(fe["coefficients"]["quantiles"]) == {"p0", "p25", "p50", "p75", "p100"}
    assert fe["coefficients"]["sparsity"] == pytest.approx(0.5)  # 3 recorded of 6
    assert fe["coefficients"]["top_features"][0] == {"feature": "f0", "weight": 2.0}
    re_ = model["coordinates"]["per-user"]
    assert set(re_) == {"type", "feature_shard", "random_effect_type", "n_entities", "coefficients", "shrinkage"}
    assert re_["type"] == "random" and re_["n_entities"] == 3
    assert set(re_["shrinkage"]) == {"n_entities", "norm_quantiles", "histogram"}
    assert [h["support"] for h in re_["shrinkage"]["histogram"]] == ["0", "[1,2)", "[2,4)"]
    assert set(re_["shrinkage"]["histogram"][0]) == {"support", "n_entities", "mean_norm", "min_norm", "max_norm"}

    conv = doc["convergence"]
    assert set(conv) == {"coordinates", "validation_trajectories", "n_metric_flushes"}
    assert conv["n_metric_flushes"] == 2
    g = conv["coordinates"]["global"]
    assert g["accepted_loss_trajectory"] == [5.0, 4.0]
    assert g["iterations_trajectory"] == [None, 7.0]
    assert g["final_loss"] == pytest.approx(4.0)
    assert g["rejections"] == 1
    assert conv["validation_trajectories"]["AUC"] == [0.65, 0.71]

    perf = doc["performance"]
    assert set(perf) == {"total_wall_seconds", "aborted", "compile_seconds", "timeline", "streaming"}
    assert perf["aborted"] is False
    assert perf["compile_seconds"] == pytest.approx(1.25)
    assert set(perf["timeline"]) == {"n_sweeps", "total", "overlap_factor_per_sweep"}
    assert perf["timeline"]["overlap_factor_per_sweep"] == [0.0, 0.25]
    assert perf["streaming"]["fe.train"]["budget_utilization"] == pytest.approx(0.5)

    assert doc["memory"]["host"]["rss_bytes"] == 1000
    assert doc["checkpoints"] == [{"step": 1, "iteration": 0, "coordinate": "global", "bytes": 123}]
    assert len(doc["bench"]["progress"]) == 1

    with open(os.path.join(out, "report.json")) as f:
        assert json.load(f) == json.loads(json.dumps(doc, default=float))
    with open(os.path.join(out, "report.html")) as f:
        html = f.read()
    assert html.lower().startswith("<!doctype html>") and "<svg" in html


def test_report_discovers_flight_dumps(tmp_path):
    """A flight-recorder postmortem in the artifacts tree lands as a
    doc["flight"] row (and an HTML section), ordered by trigger time."""
    root = _make_artifacts(str(tmp_path / "artifacts"))
    flight_dir = os.path.join(root, "flight")
    os.makedirs(flight_dir, exist_ok=True)
    for seq, (kind, t) in enumerate([("shed_spike", 200.0), ("crash", 100.0)]):
        with open(os.path.join(flight_dir, f"flight-{kind}-{seq:04d}.json"), "w") as f:
            json.dump({"trigger": {"kind": kind, "detail": "drill", "unix_time": t}, "window_seconds": 30.0,
                       "identity": {"process_index": 0, "replica": None, "host": "h"},
                       "events": [{"type": "span", "name": "x"}], "metrics": []}, f)
    doc = _both_reports(root, str(tmp_path / "rep"), str(tmp_path / "ref-rep"))
    assert [row["trigger"] for row in doc["flight"]] == ["crash", "shed_spike"]
    row = doc["flight"][0]
    assert row["detail"] == "drill" and row["n_events"] == 1
    assert row["path"].startswith("flight/")
    assert "Flight recorder" in open(os.path.join(str(tmp_path / "rep"), "report.html")).read()


def test_report_cli_rejects_empty_dir(tmp_path):
    with pytest.raises(SystemExit) as ours:
        report_cli.run([str(tmp_path / "empty")])
    with pytest.raises(SystemExit) as theirs:
        ref_report_cli.run([str(tmp_path / "empty")])
    assert str(ours.value) == str(theirs.value)


def test_report_cli_bench_pair_required_together(tmp_path):
    root = _make_artifacts(str(tmp_path / "a"))
    with pytest.raises(SystemExit, match="must be given together"):
        report_cli.run([root, "--bench-baseline", "x.json"])


def test_report_cli_bench_diff_section(tmp_path):
    root = _make_artifacts(str(tmp_path / "a"))
    old, new = str(tmp_path / "old.json"), str(tmp_path / "new.json")
    with open(old, "w") as f:
        json.dump({"quadrants": {"fe": {"wall_s": 2.0}}}, f)
    with open(new, "w") as f:
        json.dump({"quadrants": {"fe": {"wall_s": 1.0}}}, f)
    doc = _both_reports(root, str(tmp_path / "rep"), str(tmp_path / "ref-rep"),
                        ["--bench-baseline", old, "--bench-candidate", new])
    assert doc["bench"]["diff"]["quadrants.fe.wall_s"]["delta_pct"] == pytest.approx(-50.0)


# ---------------------------------------------------------------- no JAX


def test_report_cli_runs_with_poisoned_jax(tmp_path):
    """The port's cli.report runs where neither ``jax`` nor
    ``photon_ml_tpu`` can be imported, leaves neither in sys.modules, and
    rebuilds the report.json built in process."""
    root = _make_artifacts(str(tmp_path / "artifacts"))
    ref = report_cli.run([root, "--out", str(tmp_path / "ref")])
    env = _poisoned_env(tmp_path)
    out = str(tmp_path / "rebuilt")
    src = ("import runpy, sys\n"
           f"sys.argv = ['report', {root!r}, '--out', {out!r}]\n"
           "runpy.run_module('photon_ml_tpu_torch.cli.report', run_name='__main__')\n"
           "print('BAD:' + ','.join(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'photon_ml_tpu'))))\n")
    # run outside the checkout: the current directory comes first on sys.path
    proc = subprocess.run([sys.executable, "-c", src], env=env, cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "BAD:"
    for mod in ("jax", "photon_ml_tpu"):
        control = subprocess.run([sys.executable, "-c", f"import {mod}"], env=env, cwd=str(tmp_path),
                                 capture_output=True, text=True, timeout=120)
        assert control.returncode != 0  # the poison poisons
    with open(os.path.join(out, "report.json")) as f:
        assert json.load(f) == json.loads(json.dumps(ref, default=float))
    with open(os.path.join(out, "report.html")) as f:
        assert "<svg" in f.read()


def test_obs_and_io_import_without_jax(tmp_path):
    """The report path's modules import where neither ``jax`` nor
    ``photon_ml_tpu`` can be imported."""
    src = ("import photon_ml_tpu_torch.obs as obs\n"
           "import photon_ml_tpu_torch.obs.report, photon_ml_tpu_torch.obs.diagnostics\n"
           "import photon_ml_tpu_torch.obs.memory, photon_ml_tpu_torch.cli.report\n"
           "from photon_ml_tpu_torch.io import read_avro_file, IndexMap\n"
           "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", src], env=_poisoned_env(tmp_path), cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ---------------------------------------------------------------- memory block


def test_memory_block_from_snapshot():
    from photon_ml_tpu.obs.memory import memory_block as ref_memory_block
    from photon_ml_tpu_torch.obs.memory import memory_block

    block = memory_block(_final_snapshot())
    assert block == ref_memory_block(_final_snapshot())
    assert block["host"] == {"rss_bytes": 1000, "peak_rss_bytes": 2000}
    # the port labels a card by its torch device
    assert block["devices"]["cuda:0"] == {"bytes_in_use": 300, "peak_bytes_in_use": 400, "bytes_limit": 4096}
    assert block["streaming"]["fe.train"]["hbm_budget_bytes"] == 1024
    assert memory_block([]) == {}


def test_sample_memory_host_and_peak_monotone():
    from photon_ml_tpu_torch.obs.memory import sample_memory
    from photon_ml_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    sample_memory(reg, devices=["cpu"])  # a CPU device has no allocator statistics: host only
    snap = {m["name"]: m for m in reg.snapshot()}
    assert snap["photon_mem_host_rss_bytes"]["value"] > 0
    assert not any(n.startswith("photon_mem_device_") for n in snap)
    peak1 = snap["photon_mem_host_peak_rss_bytes"]["value"]
    sample_memory(reg)
    snap2 = {m["name"]: m for m in reg.snapshot()}
    assert snap2["photon_mem_host_peak_rss_bytes"]["value"] >= peak1


# ---------------------------------------------------------------- end to end


def test_train_report_rebuild_identity(tmp_path):
    """cli.train --report-out writes report.json and report.html, and
    cli.report rebuilds a byte-identical report.json from the artifacts
    alone. Over the port's artifacts and over the JAX package's, both
    packages' reports are equal, report.html text included."""
    from photon_ml_tpu.cli import train as ref_train
    from photon_ml_tpu_torch.cli import train
    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing import generate_game_records, generate_mixed_effect_data

    recs = generate_game_records(generate_mixed_effect_data(n=300, d_fixed=4, re_specs={"userId": (8, 2)}, seed=7))
    schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    train_p = str(tmp_path / "train.avro")
    write_avro_file(train_p, schema, recs)
    argv = ["--input-data", train_p, "--task", "logistic_regression",
            "--feature-shard", "name=globalShard,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
            "--coordinate", "name=global,shard=globalShard,optimizer=LBFGS,reg.type=L2,reg.weights=1",
            "--coordinate", "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1",
            "--coordinate-descent-iterations", "2"]
    roots = {"port": tmp_path / "run", "ref": tmp_path / "ref-run"}
    for label, root in roots.items():
        run_argv = argv + ["--output-dir", str(root / "out"), "--metrics-out", str(root / "metrics"),
                           "--report-out", str(root / "report")]
        if label == "port":
            train.run(run_argv + ["--device", "cpu"])
        else:
            ref_train.run(run_argv)

    rep = roots["port"] / "report"
    assert (rep / "report.html").exists()
    with open(rep / "report.json", "rb") as f:
        trained_bytes = f.read()
    trained = json.loads(trained_bytes)
    assert trained["task"] == "logistic_regression"
    assert set(trained["models"]) == {"best"}
    assert set(trained["models"]["best"]["coordinates"]) == {"global", "per-user"}
    g = trained["convergence"]["coordinates"]["global"]
    assert len(g["accepted_loss_trajectory"]) == trained["convergence"]["n_metric_flushes"]
    assert any(v is not None for v in g["accepted_loss_trajectory"])
    assert trained["memory"]["host"]["rss_bytes"] > 0
    assert trained["performance"]["aborted"] is False
    assert trained["performance"]["compile_seconds"] is None  # the port records no XLA compiles

    report_cli.run([str(roots["port"]), "--out", str(tmp_path / "rebuilt")])
    with open(tmp_path / "rebuilt" / "report.json", "rb") as f:
        assert f.read() == trained_bytes

    # either package's artifacts: the two packages build the same report
    for label, root in roots.items():
        _both_reports(str(root), str(tmp_path / f"{label}-by-port"), str(tmp_path / f"{label}-by-ref"))
        inputs = report_mod.discover(str(root))
        ref_inputs = ref_report.discover(str(root))
        assert report_mod.build_report(inputs) == ref_report.build_report(ref_inputs)
        assert report_mod.render_html(report_mod.build_report(inputs)) == ref_report.render_html(
            ref_report.build_report(ref_inputs))
