"""The port's telemetry (``photon_ml_tpu_torch.obs``) against the JAX
package's (``photon_ml_tpu.obs``): the same registry operations render the
same Prometheus text and snapshot, the same nested spans give the same tree
and JSONL lines, and every instrumentation site the port put back fires in
a CPU run: the retry counter, the quarantine counter, the chunked reader's
ingest metrics and spans, the solver and tracker metrics, the evaluation
spans and the coordinate-descent spans."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from photon_ml_tpu import obs as ref_obs
from photon_ml_tpu.io import FeatureShardConfig as RefShardConfig
from photon_ml_tpu.io import write_avro_file as ref_write_avro
from photon_ml_tpu.io.data import read_avro_dataset_chunked as ref_read_chunked
from photon_ml_tpu.io.schemas import TRAINING_EXAMPLE_AVRO
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.evaluation import build_suite
from photon_ml_tpu_torch.game import (
    CoordinateDescent,
    FixedEffectCoordinate,
    GLMOptimizationConfig,
    RandomEffectCoordinate,
    ValidationContext,
    build_fixed_effect_dataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.io import FeatureShardConfig
from photon_ml_tpu_torch.io.data import RawDataset, read_avro_dataset_chunked
from photon_ml_tpu_torch.io.validators import VALIDATE_QUARANTINE, validate_dataset
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType, solve_lbfgs, solve_tron
from photon_ml_tpu_torch.optimize.trackers import build_tracker, record_tracker_metrics
from photon_ml_tpu_torch.robust import RetryPolicy
from photon_ml_tpu_torch.testing import generate_mixed_effect_data
from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset


class _Collect:
    """A listener that keeps every event."""

    def __init__(self):
        self.events = []

    def handle(self, event):
        self.events.append(event)

    def close(self):
        pass


def _drive_registry(mod):
    """One sequence of registry operations, run against either package."""
    reg = mod.MetricsRegistry()
    c = reg.counter("photon_things_total", "things\nwith a newline and a \\ backslash")
    c.inc()
    c.labels(site="a").inc(3)
    c.labels(site='b"q').inc(0.5)
    g = reg.gauge("photon_level", "a level")
    g.set(2.25)
    g.labels(coordinate="per-user").set(-1e-7)
    g.labels(coordinate="per-user").inc(4)
    h = reg.histogram("photon_wait_seconds", "waits", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 3.0, 30.0):
        h.labels(stage="x").observe(v)
    h.observe(0.2)
    reg.histogram("photon_default_buckets_seconds").observe(0.3)
    s = reg.summary("photon_iterations", "iterations")
    s.labels(coordinate="global").observe_many([3, 4, 5])
    s.labels(coordinate="per-user").merge_stat(10, 4.5, 1.25, 9.0, 1.0)
    reg.summary("photon_empty_summary").labels(coordinate="none")
    reg.counter("weird-name.with/chars").labels(**{"bad-label": "v"}).inc()
    with pytest.raises(TypeError):
        reg.gauge("photon_things_total")
    return reg


def test_prometheus_text_and_snapshot_match_the_reference():
    ours, ref = _drive_registry(obs), _drive_registry(ref_obs)
    assert ours.to_prometheus() == ref.to_prometheus()
    assert ours.snapshot() == ref.snapshot()
    assert obs.render_prometheus(ours.snapshot()) == ref_obs.render_prometheus(ref.snapshot())
    for q in (0.5, 0.95, 0.99):
        buckets = [[0.1, 1], [1.0, 3], [10.0, 4]]
        assert obs.histogram_quantile(buckets, 5, q) == ref_obs.histogram_quantile(buckets, 5, q)
    assert obs.render_prometheus([]) == ref_obs.render_prometheus([]) == ""


def _span_tree(mod):
    """The span tree, metrics and durations of one nested sequence, as the
    calling thread recorded them: spans another thread closed while this
    run was current (a worker some earlier test left behind) and metrics
    under other names are not the sequence's."""
    run = mod.RunTelemetry()
    sink = _Collect()
    run.register_listener(sink)
    me = threading.get_ident()
    with mod.use_run(run):
        with mod.span("train", phase="all"):
            with mod.span("cd.sweep", iteration=0):
                with mod.span("cd.coordinate", coordinate="global"):
                    mod.add_device_fetch_bytes("cd.update_guard", 16)
                with mod.span("cd.coordinate", coordinate="per-user"):
                    pass
            mod.record_span("stitched", 1.0, 1.5, parent=mod.current_span(), lane="worker")
        run.flush_metrics()
    spans = [e.span for e in sink.events if type(e).__name__ == "SpanEvent" and e.span.thread_id == me]
    ids = {s.span_id: s.name for s in spans}
    tree = [(s.name, ids.get(s.parent_id), {k: v for k, v in s.attrs.items()}) for s in spans]
    metrics = [[m for m in e.metrics if m["name"] == "photon_device_fetch_bytes_total"]
               for e in sink.events if type(e).__name__ == "MetricsSnapshotEvent"]
    return tree, metrics, [s.duration_s for s in spans]


def test_span_tree_and_fetch_bytes_match_the_reference(monkeypatch):
    # the process-wide inputs a span reads, pinned to a fresh process's: a
    # replica id (cli serve --replica-id) or a compile-seconds total that
    # moves under a JAX compile on another thread (once a file installed
    # the compile hook) would otherwise stamp attributes this tree lacks
    from photon_ml_tpu.obs import tracing as ref_tracing
    from photon_ml_tpu_torch.obs import tracing

    monkeypatch.setattr(ref_tracing, "_replica_id", None)
    monkeypatch.setattr(ref_tracing, "compile_seconds_total", lambda: 0.0)
    monkeypatch.setattr(tracing, "_replica_id", None)
    ours, ours_metrics, durations = _span_tree(obs)
    ref, ref_metrics, _ = _span_tree(ref_obs)
    assert ours == ref
    assert ours_metrics == ref_metrics
    assert ours_metrics and ours_metrics[0][0]["value"] == 16
    assert ours[0] == ("cd.coordinate", "cd.sweep", {"coordinate": "global", "fetch_bytes": 16})
    assert all(d is not None and d >= 0 for d in durations)
    # no listener: spans and record_span are host bookkeeping only
    assert obs.record_span("x", 0.0, 1.0) is None
    assert not obs.active()


def test_jsonl_and_prometheus_sinks(tmp_path):
    run = obs.RunTelemetry()
    jsonl, prom = str(tmp_path / "m.jsonl"), str(tmp_path / "m.prom")
    run.register_listener(obs.JsonlSink(jsonl))
    run.register_listener(obs.PrometheusSink(prom))
    with obs.use_run(run):
        assert obs.active()
        with obs.span("outer", tensor=torch.zeros(2)):
            obs.current_run().registry.counter("photon_x_total", "x").inc(2)
        run.close()
    lines = [json.loads(line) for line in open(jsonl)]
    assert [line["type"] for line in lines] == ["span", "metrics"]
    assert lines[0]["name"] == "outer" and lines[0]["attrs"]["tensor"] == "<Tensor>"
    assert lines[0]["process_index"] == 0 and "host" in lines[0]
    assert open(prom).read() == obs.render_prometheus(lines[1]["metrics"])


def test_raising_sink_is_counted_not_propagated(tmp_path):
    run = obs.RunTelemetry()
    sink = obs.JsonlSink(str(tmp_path / "m.jsonl"))
    sink._f.close()  # every write now raises ValueError, a swallowed listener error
    run.register_listener(sink)
    with obs.use_run(run):
        with obs.span("still.runs"):
            pass
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m.get("value") for m in run.registry.snapshot()}
    assert snap[("photon_swallowed_errors_total", (("site", "events.listener_handle.JsonlSink"),))] == 1


def test_retry_counts_its_attempts():
    run = obs.RunTelemetry()
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    with obs.use_run(run):
        assert RetryPolicy(max_attempts=3).call(flaky, site="t", sleep=sleeps.append) == "ok"
    assert run.registry.counter("photon_retry_attempts_total").labels(site="t").value == 2
    assert run.registry.histogram("photon_retry_backoff_seconds").labels(site="t").snapshot()["count"] == 2


def test_quarantine_counts_rows():
    raw = RawDataset(
        n_rows=4, labels=np.array([0.0, 1.0, 2.0, 1.0]), offsets=np.zeros(4),
        weights=np.array([1.0, -1.0, 1.0, 1.0]),
        shard_coo={"global": (np.arange(4), np.zeros(4, dtype=np.int64), np.ones(4))},
        shard_dims={"global": 1}, id_tags={},
    )
    run = obs.RunTelemetry()
    with obs.use_run(run):
        assert validate_dataset(raw, "logistic_regression", VALIDATE_QUARANTINE) == 2
    assert run.registry.counter("photon_rows_quarantined_total").labels().value == 2


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    d = tmp_path_factory.mktemp("parts")
    rng = np.random.default_rng(5)
    for p in range(3):
        recs = [{"uid": f"{p}-{i}", "label": float(rng.random() < 0.5),
                 "features": [{"name": f"f{j}", "term": "", "value": float(rng.standard_normal())}
                              for j in rng.choice(6, 3, replace=False)]} for i in range(20)]
        ref_write_avro(str(d / f"part-{p:05d}.avro"), TRAINING_EXAMPLE_AVRO, recs)
    return str(d)


@pytest.mark.parametrize("engine", ["python", "native"])
def test_chunked_reader_metrics_and_spans(parts, engine):
    from photon_ml_tpu_torch import native

    if engine == "native" and not native.available():
        pytest.skip("the native decoder did not build here (needs g++ and zlib)")
    shards = {"global": FeatureShardConfig(("features",))}
    run, sink = obs.RunTelemetry(), _Collect()
    run.register_listener(sink)
    with obs.use_run(run):
        ds, _ = read_avro_dataset_chunked(parts, shards, engine=engine, workers=2)
    ref_run = ref_obs.RunTelemetry()
    with ref_obs.use_run(ref_run):
        ref_ds, _ = ref_read_chunked(parts, {"global": RefShardConfig(("features",))}, engine="python", workers=2)
    reg = run.registry
    for name, value in (("photon_ingest_parts_total", 3), ("photon_ingest_rows_total", 60)):
        assert reg.counter(name).labels(mode="chunked").value == value
        assert ref_run.registry.counter(name).labels(mode="chunked").value == value
    assert ds.n_rows == ref_ds.n_rows == 60
    names = [e.span.name for e in sink.events if isinstance(e, obs.SpanEvent)]
    # without index maps the Python engine decodes every part twice (a
    # keys-only pass first), as the JAX package's does
    decodes = 6 if engine == "python" else 3
    assert names.count("ingest.decode") == decodes and names[-1] == "ingest.chunked"
    if engine == "python":
        decode = [m for m in reg.snapshot() if m["name"] == "photon_ingest_decode_seconds"]
        assert sum(m["count"] for m in decode) == decodes
        assert reg.counter("photon_ingest_budget_stalls_total").labels(mode="chunked").value == 0


def _quadratic(d):
    target = torch.arange(d, dtype=torch.float64)

    def value_and_grad(w):
        r = w - target
        return 0.5 * torch.sum(r * r), r

    return value_and_grad


def test_solver_metrics_recorded_only_with_a_sink():
    vg = _quadratic(4)
    passive = obs.RunTelemetry()
    with obs.use_run(passive):
        solve_lbfgs(vg, torch.zeros(4, dtype=torch.float64), 1e-12, 1e-9)
    assert passive.registry.snapshot() == []
    run = obs.RunTelemetry()
    run.register_listener(_Collect())
    with obs.use_run(run):
        solve_lbfgs(vg, torch.zeros(4, dtype=torch.float64), 1e-12, 1e-9)
        solve_tron(vg, lambda w, v: v, torch.zeros(4, dtype=torch.float64), 1e-12, 1e-9)
        # a lane stack (the random effect's) is covered by its tracker
        solve_lbfgs(lambda w: (0.5 * (w * w).sum(0), w), torch.ones((3, 2), dtype=torch.float64),
                    1e-12, 1e-9, batched=True)
    reg = run.registry
    for solver in ("lbfgs", "tron"):
        st = reg.summary("photon_solver_iterations").labels(solver=solver).stat()
        assert st["count"] == 1 and st["max"] >= 1
        assert reg.summary("photon_solver_final_grad_norm").labels(solver=solver).stat()["max"] < 1e-6
    reasons = [m for m in reg.snapshot() if m["name"] == "photon_solver_convergence_reason_total"]
    assert sum(m["value"] for m in reasons) == 2
    assert reg.counter("photon_device_fetch_bytes_total").labels(site="solver.lbfgs").value > 0


def _cfg(max_iter=50):
    return GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType.LBFGS, tolerance=1e-9, max_iterations=max_iter),
        regularization=RegularizationContext("L2"), reg_weight=1.0,
    )


@pytest.fixture(scope="module")
def raw():
    data = generate_mixed_effect_data(n=300, d_fixed=4, re_specs={"userId": (8, 3)}, seed=9)
    return mixed_data_to_raw_dataset(data)


def _coords(raw):
    fe = build_fixed_effect_dataset(raw, "global", "global", dtype=torch.float64, device="cpu")
    re_ds = build_random_effect_dataset(raw, "per-user", "userShard", "userId", dtype=torch.float64, device="cpu")
    return {
        "global": FixedEffectCoordinate(dataset=fe, task="logistic_regression", config=_cfg()),
        "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression", config=_cfg()),
    }


def test_tracker_metrics_for_both_coordinates(raw):
    coords = _coords(raw)
    reg = obs.MetricsRegistry()
    fe_model, fe_res = coords["global"].train(None, None)
    re_model, re_res = coords["per-user"].train(coords["global"].score(fe_model), None)
    record_tracker_metrics(reg, "global", build_tracker(coords["global"], fe_res))
    record_tracker_metrics(reg, "per-user", build_tracker(coords["per-user"], re_res))
    assert reg.summary("photon_cd_iterations").labels(coordinate="global").stat()["count"] == 1
    st = reg.summary("photon_cd_iterations").labels(coordinate="per-user").stat()
    assert st["count"] == 8 and st["max"] >= st["mean"] >= st["min"] >= 1
    assert reg.gauge("photon_cd_final_loss").labels(coordinate="global").value == pytest.approx(float(fe_res.loss))
    reasons = [m for m in reg.snapshot() if m["name"] == "photon_cd_convergence_reason_total"]
    assert sum(m["value"] for m in reasons if m["labels"]["coordinate"] == "per-user") == 8
    record_tracker_metrics(reg, "none", None)


def test_descent_and_evaluation_spans_and_sweep_flushes(raw):
    coords = _coords(raw)
    suite = build_suite(["AUC"], raw.labels)
    val = ValidationContext(suite=suite, score_fns={n: coords[n].score for n in coords}, offsets=raw.offsets)
    run, sink = obs.RunTelemetry(), _Collect()
    run.register_listener(sink)
    states = []
    with obs.use_run(run):
        CoordinateDescent(coords, n_iterations=2, validation=val, boundary_fn=states.append).run()
        suite.evaluate(np.zeros(raw.n_rows))
    names = [e.span.name for e in sink.events if isinstance(e, obs.SpanEvent)]
    for name, count in (("cd.sweep", 2), ("cd.coordinate", 4), ("cd.eval", 4), ("cd.checkpoint", 4),
                        ("evaluate.device", 4), ("evaluate.host", 1)):
        assert names.count(name) == count, name
    assert sum(1 for n in names if n.endswith(": train")) == 4
    flushes = [e for e in sink.events if isinstance(e, obs.MetricsSnapshotEvent)]
    assert len(flushes) == 2
    reg = run.registry
    assert reg.counter("photon_device_fetch_bytes_total").labels(site="cd.update_guard").value == 4 * 16
    assert reg.gauge("photon_validation_metric").labels(metric="AUC", coordinate="per-user").value > 0.5
    assert set(obs.build_run_summary(reg, 1.0)["coordinates"]) == {"global", "per-user"}
    assert len(states) == 4


def test_run_summary_document():
    reg = obs.MetricsRegistry()
    reg.summary("photon_cd_iterations").labels(coordinate="global").observe(5)
    reg.counter("photon_cd_convergence_reason_total").labels(coordinate="global", reason="MAX_ITERATIONS").inc()
    reg.counter("photon_coordinate_rejections_total").labels(coordinate="global").inc()
    doc = obs.build_run_summary(reg, 2.5)
    assert doc["total_wall_seconds"] == 2.5
    assert doc["coordinates"]["global"]["rejections"] == 1
    assert doc["coordinates"]["global"]["convergence_reasons"] == {"MAX_ITERATIONS": 1}
    assert doc["coordinates"]["global"]["iterations"]["count"] == 1
    assert doc["build"]["torch"] == torch.__version__
    json.dumps(doc)
    info = obs.record_build_info(reg)
    assert reg.gauge("photon_build_info").labels(**info).value == 1
    assert os.path.basename(__file__) == "test_torch_obs.py"


def test_memory_sample_and_block_match_the_reference():
    """obs.memory: the host reading and the memory document are the JAX
    package's; a CPU device has no allocator statistics and is skipped."""
    from photon_ml_tpu.obs import memory as ref_memory
    from photon_ml_tpu_torch.obs import memory

    reg, ref_reg = obs.MetricsRegistry(), ref_obs.MetricsRegistry()
    host = obs.sample_memory(reg, devices=[torch.device("cpu")])
    ref_obs.sample_memory(ref_reg)
    assert host["rss_bytes"] > 0 and host["peak_rss_bytes"] >= host["rss_bytes"]
    assert memory.read_device_memory("cpu") is None
    assert {m["name"] for m in reg.snapshot()} == {m["name"] for m in ref_reg.snapshot()}
    snaps = []
    for mod in (obs, ref_obs):
        r = mod.MetricsRegistry()
        r.gauge("photon_mem_host_rss_bytes").set(10)
        r.gauge("photon_mem_device_bytes_in_use").labels(device="cuda:0").set(5)
        r.gauge("photon_mem_device_peak_bytes_in_use").labels(device="cuda:0").set(7)
        r.gauge("photon_stream_budget_bytes").labels(site="fe").set(3)
        snaps.append(r.snapshot())
    assert memory.memory_block(snaps[0]) == ref_memory.memory_block(snaps[1]) == {
        "host": {"rss_bytes": 10}, "devices": {"cuda:0": {"bytes_in_use": 5, "peak_bytes_in_use": 7}},
        "streaming": {"fe": {"hbm_budget_bytes": 3}},
    }
    doc = obs.build_run_summary(reg, 1.0)
    assert doc["memory"]["host"]["rss_bytes"] == host["rss_bytes"]
    assert doc["build"]["replica"] == ""
