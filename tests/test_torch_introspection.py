"""The port's timeline profiler and introspection endpoints
(``photon_ml_tpu_torch.obs.timeline`` / ``obs.http``) against the JAX
package's, on the CPU: the timeline and endpoint cases of
tests/test_introspection.py, the trainer's ``--trace-out --status-port``
end to end, ``cli.retrain --status-port`` and the sweep-boundary memory
samples.

Bounds: the timeline is float64 host arithmetic copied from the JAX
package, so each package builds its own spans from the same numbers and the
Chrome-trace documents and phase attributions are held equal (``==``). The
reference's own checks keep its tolerance (``pytest.approx``'s default,
rel 1e-6) and the per-sweep identity ``critical_path + other == wall`` its
rel 1e-6. Endpoint documents are compared whole between the packages, apart
from the scrape time and the live host memory reading.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from photon_ml_tpu import obs as ref_obs
from photon_ml_tpu.obs import run as ref_run
from photon_ml_tpu.obs import timeline as ref_timeline
from photon_ml_tpu.obs import tracing as ref_tracing
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import run as port_run
from photon_ml_tpu_torch.obs import tracing
from photon_ml_tpu_torch.obs.timeline import SWEEP_SPAN_NAME, TimelineRecorder
from photon_ml_tpu_torch.obs.tracing import Span, SpanEvent

_THREADS_AT_START = set()


def _obs_threads():
    return {t for t in threading.enumerate() if t.name.startswith(("photon-introspection", "cli-"))}


@pytest.fixture(scope="module", autouse=True)
def _thread_census():
    _THREADS_AT_START.update(_obs_threads())
    yield


@pytest.fixture(autouse=True)
def _pinned_identity(monkeypatch):
    """Each package's process index, replica id and current run pinned for
    the test: an earlier file in the same worker may have set them."""
    for mod in (tracing, ref_tracing):
        monkeypatch.setattr(mod, "_process_index", 0)
        monkeypatch.setattr(mod, "_replica_id", None)
    monkeypatch.setattr(port_run, "_current", port_run.RunTelemetry())
    monkeypatch.setattr(ref_run, "_current", ref_run.RunTelemetry())


# ---------------------------------------------------------------- helpers


def _mk_span(span_cls, name, span_id, parent_id, start, dur, **attrs):
    """Hand-built span on a synthetic monotonic clock (start_perf), offset
    from zero: start_perf == 0.0 means "not stamped"."""
    return span_cls(
        name=name,
        span_id=span_id,
        parent_id=parent_id,
        start_unix=1_700_000_000.0 + start,
        attrs=dict(attrs),
        duration_s=dur,
        start_perf=100.0 + start,
    )


def _both(specs):
    """The port's and the JAX package's recorders, each fed its own spans
    built from the same numbers, children before parents as in a run."""
    port, ref = TimelineRecorder(), ref_timeline.TimelineRecorder()
    for args, attrs in specs:
        port.handle(SpanEvent(span=_mk_span(Span, *args, **attrs)))
        ref.handle(ref_tracing.SpanEvent(span=_mk_span(ref_tracing.Span, *args, **attrs)))
    return port, ref


def _mirror(port_rec):
    """The JAX package's recorder fed the port's recorded spans, field for
    field."""
    ref = ref_timeline.TimelineRecorder()
    for s in port_rec.spans():
        ref.handle(ref_tracing.SpanEvent(span=ref_tracing.Span(**dataclasses.asdict(s))))
    return ref


def _held_equal(port_rec, ref_rec):
    assert port_rec.chrome_trace() == ref_rec.chrome_trace()
    att = port_rec.phase_attribution()
    assert att == ref_rec.phase_attribution()
    return att


def _s(name, span_id, parent_id, start, dur, **attrs):
    return (name, span_id, parent_id, start, dur), attrs


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ------------------------------------------------------------ chrome trace


def test_chrome_trace_schema_from_real_spans(tmp_path):
    """Golden schema: "X" complete events with microsecond ts/dur, pid/tid
    lane ids, span identity under args, "M" lane-name metadata, ts-sorted,
    displayTimeUnit set; the JAX package renders the same spans to the same
    document."""
    run = obs.RunTelemetry()
    rec = TimelineRecorder()
    run.register_listener(rec)
    with obs.use_run(run):
        with obs.span(SWEEP_SPAN_NAME, iteration=0):
            with obs.span("cd.coordinate", iteration=0, coordinate="global"):
                with obs.span("solve", phase="solve", coordinate="global"):
                    time.sleep(0.002)
            with obs.span("cd.eval", phase="eval"):
                pass

    doc = rec.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert json.loads(json.dumps(doc)) == doc
    xs = [e for e in events if e["ph"] == "X"]
    ms = [e for e in events if e["ph"] == "M"]
    assert {e["name"] for e in xs} == {SWEEP_SPAN_NAME, "cd.coordinate", "solve", "cd.eval"}
    for e in xs:
        assert e["cat"] == "photon"
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert e["dur"] >= 0
        assert "span_id" in e["args"] and "parent_id" in e["args"]
    assert {e["tid"] for e in xs} == {threading.get_ident()}
    assert {m["name"] for m in ms} == {"process_name", "thread_name"}
    ts = [e["ts"] for e in xs]
    assert ts == sorted(ts)
    solve = {e["name"]: e for e in xs}["solve"]
    assert solve["dur"] >= 2000  # slept 2 ms; dur is in microseconds
    assert solve["args"]["phase"] == "solve"
    _held_equal(rec, _mirror(rec))

    out = tmp_path / "trace.json"
    rec.write_chrome_trace(str(out))
    assert json.load(open(out)) == json.loads(json.dumps(doc))


def test_chrome_trace_lane_ids_across_threads():
    run = obs.RunTelemetry()
    rec = TimelineRecorder()
    run.register_listener(rec)

    def worker():
        with obs.use_run(run):
            with obs.span("bg-work"):
                pass

    with obs.use_run(run):
        with obs.span("fg-work"):
            t = threading.Thread(target=worker, name="photon-test-worker")
            t.start()
            t.join()
    xs = {e["name"]: e for e in rec.chrome_trace()["traceEvents"] if e["ph"] == "X"}
    assert xs["fg-work"]["tid"] != xs["bg-work"]["tid"]
    lane_names = {m["args"]["name"] for m in rec.chrome_trace()["traceEvents"]
                  if m["ph"] == "M" and m["name"] == "thread_name"}
    assert "photon-test-worker" in lane_names
    _held_equal(rec, _mirror(rec))


# -------------------------------------------------------- phase attribution


def test_phase_attribution_serial_sweep_scores_zero_overlap():
    port, ref = _both([
        _s("solve", "a", "sw", 0.0, 4.0, phase="solve", coordinate="global"),
        _s("score", "b", "sw", 4.0, 2.0, phase="score", coordinate="global"),
        _s("eval", "c", "sw", 6.0, 1.0, phase="eval"),
        _s("ckpt", "d", "sw", 7.0, 1.0, phase="checkpoint"),
        _s(SWEEP_SPAN_NAME, "sw", None, 0.0, 10.0, iteration=0),
    ])
    att = _held_equal(port, ref)
    assert att["n_sweeps"] == 1
    (rec0,) = att["sweeps"]
    assert rec0["iteration"] == 0
    assert rec0["wall_seconds"] == pytest.approx(10.0)
    assert rec0["phases"] == pytest.approx({"solve": 4.0, "score": 2.0, "eval": 1.0, "checkpoint": 1.0})
    assert rec0["coordinates"]["global"] == pytest.approx({"solve": 4.0, "score": 2.0})
    assert rec0["sum_of_phases_seconds"] == pytest.approx(8.0)
    assert rec0["critical_path_seconds"] == pytest.approx(8.0)
    assert rec0["overlap_factor"] == pytest.approx(0.0)
    assert rec0["critical_path_seconds"] + rec0["other_seconds"] == pytest.approx(rec0["wall_seconds"])
    assert att["total"]["overlap_factor"] == pytest.approx(0.0)


def test_phase_attribution_overlap_factor_rises_with_concurrency():
    port, ref = _both([
        _s("solve", "a", "sw", 0.0, 4.0, phase="solve"),
        _s("stage", "b", "sw", 2.0, 4.0, phase="stage"),
        _s(SWEEP_SPAN_NAME, "sw", None, 0.0, 6.0, iteration=0),
    ])
    (rec0,) = _held_equal(port, ref)["sweeps"]
    # sum 8, union 6: 25% of phase time ran concurrently
    assert rec0["overlap_factor"] == pytest.approx(0.25)
    assert rec0["other_seconds"] == pytest.approx(0.0)


def test_phase_attribution_nested_phase_not_double_counted():
    """A phase span inside another phase span is wall time its ancestor
    already owns: it lands in nested_phases."""
    port, ref = _both([
        _s("stage", "st", "so", 1.0, 2.0, phase="stage"),
        _s("solve", "so", "sw", 0.0, 8.0, phase="solve"),
        _s(SWEEP_SPAN_NAME, "sw", None, 0.0, 10.0, iteration=0),
    ])
    (rec0,) = _held_equal(port, ref)["sweeps"]
    assert rec0["phases"] == pytest.approx({"solve": 8.0})
    assert rec0["nested_phases"] == pytest.approx({"stage": 2.0})
    assert rec0["overlap_factor"] == pytest.approx(0.0)


def test_phase_attribution_clips_to_sweep_window():
    port, ref = _both([
        # starts before the sweep, ends inside: only [2, 5) attributes
        _s("warm", "w", "sw", 0.0, 5.0, phase="solve"),
        # entirely outside the window: contributes nothing
        _s("late", "l", "sw", 20.0, 1.0, phase="eval"),
        _s(SWEEP_SPAN_NAME, "sw", None, 2.0, 6.0, iteration=0),
    ])
    (rec0,) = _held_equal(port, ref)["sweeps"]
    assert rec0["phases"] == pytest.approx({"solve": 3.0})
    assert "eval" not in rec0["phases"]


def test_phase_attribution_ignores_spans_of_other_sweeps():
    port, ref = _both([
        _s("solve", "a0", "sw0", 0.0, 2.0, phase="solve"),
        _s(SWEEP_SPAN_NAME, "sw0", None, 0.0, 3.0, iteration=0),
        _s("solve", "a1", "sw1", 3.0, 4.0, phase="solve"),
        _s(SWEEP_SPAN_NAME, "sw1", None, 3.0, 5.0, iteration=1),
    ])
    att = _held_equal(port, ref)
    assert att["n_sweeps"] == 2
    s0, s1 = att["sweeps"]
    assert s0["phases"] == pytest.approx({"solve": 2.0})
    assert s1["phases"] == pytest.approx({"solve": 4.0})
    assert att["total"]["wall_seconds"] == pytest.approx(8.0)
    assert att["total"]["phases"]["solve"] == pytest.approx(6.0)


# ------------------------------------------------------------ http endpoints


class _Pair:
    """The same registry and board operations on a port run and a JAX
    package run, each behind its own IntrospectionServer."""

    def __init__(self, setup):
        self.runs = (obs.RunTelemetry(), ref_obs.RunTelemetry())
        for run in self.runs:
            setup(run)
        self.servers = []
        for run, pkg in zip(self.runs, (obs, ref_obs)):
            self.servers.append(pkg.IntrospectionServer(run, port=0))

    @property
    def run(self):
        return self.runs[0]

    def base(self, k=0):
        return f"http://127.0.0.1:{self.servers[k].port}"

    def both(self, path):
        return [_get(self.base(k) + path) for k in range(2)]

    def stop(self):
        for srv in self.servers:
            srv.stop()


def _comparable(doc):
    """A /statusz document without its scrape time and live host reading."""
    doc = dict(doc)
    doc.pop("unix_time")
    if "memory" in doc:
        doc["memory"] = {k: v for k, v in doc["memory"].items() if k != "host"}
    return doc


def test_endpoints_respond():
    def setup(run):
        run.registry.counter("photon_test_total", "t").inc(3)
        run.status.update(sweep=1, coordinate="global")

    pair = _Pair(setup)
    try:
        (status, ctype, body), ref_health = pair.both("/healthz")
        assert status == 200 and json.loads(body) == {"status": "ok"} == json.loads(ref_health[2])

        (status, ctype, body), (_, ref_ctype, ref_body) = pair.both("/metrics")
        assert status == 200 and ctype.startswith("text/plain") and "version=0.0.4" in ctype
        assert ctype == ref_ctype
        text = body.decode("utf-8")
        assert "# TYPE photon_test_total counter" in text
        assert "photon_test_total 3" in text
        assert body == ref_body

        (status, ctype, body), (_, _, ref_body) = pair.both("/statusz")
        assert status == 200 and ctype == "application/json"
        doc = json.loads(body)
        assert doc["status"] == "ok"
        assert doc["sweep"] == 1 and doc["coordinate"] == "global"
        assert _comparable(doc) == _comparable(json.loads(ref_body))

        for k in range(2):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(pair.base(k) + "/nope")
            assert e.value.code == 404
    finally:
        pair.stop()


def test_statusz_serving_section_and_qps():
    from photon_ml_tpu_torch.serving.batcher import SERVING_LATENCY_BUCKETS

    def setup(run):
        run.registry.counter("photon_serving_requests_total", "").inc(100)
        lat = run.registry.histogram("photon_serving_request_latency_seconds", "", buckets=SERVING_LATENCY_BUCKETS)
        for _ in range(10):
            lat.observe(0.002)

    pair = _Pair(setup)
    try:
        docs = [json.loads(b) for _, _, b in pair.both("/statusz")]
        doc = docs[0]
        assert doc["serving"]["requests_total"] == 100
        assert 0.001 <= doc["serving"]["latency_p50_seconds"] <= 0.0025
        # the first scrape has no previous sample: no qps yet
        assert "qps" not in doc["serving"]
        assert doc["serving"] == docs[1]["serving"]
        for run in pair.runs:
            run.registry.counter("photon_serving_requests_total", "").inc(50)
        time.sleep(0.05)
        doc2 = json.loads(_get(pair.base() + "/statusz")[2])
        assert doc2["serving"]["requests_total"] == 150
        assert doc2["serving"]["qps"] > 0
    finally:
        pair.stop()


def test_healthz_503_while_refresh_in_progress():
    """/healthz answers 503 while refresh_in_progress is raised, 200 after,
    in both packages' words."""
    pair = _Pair(lambda run: None)
    try:
        for k, run in enumerate(pair.runs):
            run.status.update(refresh_in_progress=True)
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(pair.base(k) + "/healthz")
            assert e.value.code == 503
            assert json.loads(e.value.read()) == {"status": "refreshing"}
            run.status.update(refresh_in_progress=False)
            status, _, body = _get(pair.base(k) + "/healthz")
            assert status == 200 and json.loads(body) == {"status": "ok"}
    finally:
        pair.stop()


def test_statusz_memory_section():
    """/statusz carries live host RSS plus the recorded device watermarks
    and budget headroom; the port labels a card by its torch device."""
    def setup(run):
        reg = run.registry
        reg.gauge("photon_mem_host_rss_bytes", "").set(1000)
        reg.gauge("photon_mem_device_peak_bytes_in_use", "").labels(device="cuda:0").set(4096)
        reg.gauge("photon_stream_budget_bytes", "").labels(site="fe.train").set(2048)
        reg.gauge("photon_stream_budget_headroom_bytes", "").labels(site="fe.train").set(1024)

    pair = _Pair(setup)
    obs.sample_memory(pair.run.registry)
    try:
        docs = [json.loads(b) for _, _, b in pair.both("/statusz")]
        mem = docs[0]["memory"]
        assert mem["host"]["rss_bytes"] > 0  # the live reading
        assert mem["devices"]["cuda:0"]["peak_bytes_in_use"] == 4096
        assert mem["streaming"]["fe.train"]["hbm_budget_bytes"] == 2048
        assert mem["streaming"]["fe.train"]["hbm_budget_headroom_bytes"] == 1024
        assert _comparable(docs[0]) == _comparable(docs[1])
    finally:
        pair.stop()


def test_concurrent_scrape_during_span_storm():
    """Scrapes while another thread hammers spans and status updates: every
    response is complete and parseable, and the emitting thread never
    deadlocks."""
    run = obs.RunTelemetry()
    rec = TimelineRecorder()
    run.register_listener(rec)
    stop = threading.Event()

    def storm():
        with obs.use_run(run):
            i = 0
            while not stop.is_set():
                run.status.update(sweep=i, coordinate=f"c{i % 3}")
                with obs.span(SWEEP_SPAN_NAME, iteration=i):
                    with obs.span("solve", phase="solve", coordinate=f"c{i % 3}"):
                        run.registry.counter("photon_storm_total", "").inc()
                i += 1

    t = threading.Thread(target=storm, name="span-storm")
    t.start()
    srv = obs.IntrospectionServer(run, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        deadline = time.monotonic() + 10
        seen_sweeps = set()
        while time.monotonic() < deadline and len(seen_sweeps) < 3:
            doc = json.loads(_get(base + "/statusz")[2])
            assert doc["status"] == "ok"
            if "sweep" in doc:
                seen_sweeps.add(doc["sweep"])
            text = _get(base + "/metrics")[2].decode("utf-8")
            if "photon_storm_total" in text:
                assert "# TYPE photon_storm_total counter" in text
        assert len(seen_sweeps) >= 3
    finally:
        stop.set()
        t.join(timeout=10)
        srv.stop()
    assert not t.is_alive()
    assert rec.phase_attribution()["n_sweeps"] >= 3


def test_server_stop_releases_port():
    srv = obs.IntrospectionServer(obs.RunTelemetry(), port=0)
    port = srv.port
    srv.stop()
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))  # rebindable after stop()
    finally:
        s.close()


# ------------------------------------------------- the drivers' live endpoints


def _game_avro(tmp_path, n=400, seed=4):
    from photon_ml_tpu_torch.io import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing import generate_game_records, generate_mixed_effect_data

    data = generate_mixed_effect_data(n=n, d_fixed=5, re_specs={"userId": (16, 4)}, seed=seed)
    schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    recs = generate_game_records(data)
    return schema, recs


def _poll_live(base, alive, deadline_s=300):
    """/statusz documents that named a coordinate, whether /metrics showed a
    photon_ family, and whether /healthz answered 200, while ``alive()``."""
    live_statusz, live_metrics, healthy = [], False, False
    deadline = time.monotonic() + deadline_s
    while alive() and time.monotonic() < deadline:
        try:
            doc = json.loads(_get(base + "/statusz", timeout=5)[2])
            if not live_metrics:
                live_metrics = "photon_" in _get(base + "/metrics", timeout=5)[2].decode("utf-8")
            healthy = healthy or _get(base + "/healthz", timeout=5)[0] == 200
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.05)
            continue
        assert doc["status"] == "ok"
        if "coordinate" in doc:
            live_statusz.append(doc)
        time.sleep(0.02)
    return live_statusz, live_metrics, healthy


def test_cli_train_trace_out_and_live_status(tmp_path):
    """The port's cli.train --trace-out --status-port on the CPU: a
    Perfetto-loadable trace and a phase attribution whose per-sweep identity
    critical_path + other == wall holds (rel 1e-6), while /statusz and
    /metrics answer live mid-training."""
    from photon_ml_tpu_torch.cli.train import run as train_run
    from photon_ml_tpu_torch.io import write_avro_file

    schema, recs = _game_avro(tmp_path)
    train_path = str(tmp_path / "train.avro")
    write_avro_file(train_path, schema, recs)
    trace_path = str(tmp_path / "trace.json")
    port = _free_port()
    n_sweeps = 2
    result = {}

    def _train():
        result["summary"] = train_run([
            "--input-data", train_path, "--validation-data", train_path, "--task", "logistic_regression",
            "--feature-shard", "name=global,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
            "--coordinate", "name=global,shard=global,optimizer=LBFGS,reg.type=L2,reg.weights=1",
            "--coordinate", "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1",
            "--evaluators", "AUC", "--coordinate-descent-iterations", str(n_sweeps),
            "--output-dir", str(tmp_path / "out"), "--trace-out", trace_path, "--status-port", str(port),
            "--device", "cpu",
        ])

    t = threading.Thread(target=_train, name="cli-train")
    t.start()
    live_statusz, live_metrics, _ = _poll_live(f"http://127.0.0.1:{port}", t.is_alive)
    t.join(timeout=300)
    assert not t.is_alive()
    assert result["summary"]["best"]["metrics"]["AUC"] > 0.6

    assert live_statusz, "statusz never reported a live coordinate"
    assert live_metrics, "metrics exposition never reported photon_* families"
    assert {d["coordinate"] for d in live_statusz} <= {"global", "per-user"}

    trace = json.load(open(trace_path))
    assert trace["displayTimeUnit"] == "ms"
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert sum(1 for e in xs if e["name"] == "cd.sweep") == n_sweeps
    assert all(e["args"]["pipeline_depth"] == 1 for e in xs if e["name"] == "cd.sweep")
    phases_seen = {e["args"].get("phase") for e in xs} - {None}
    assert "solve" in phases_seen and "score" in phases_seen

    # run_summary.json lands beside the trace when --metrics-out is absent
    rs = json.load(open(tmp_path / "run_summary.json"))
    tl = rs["timeline"]
    assert tl["n_sweeps"] == n_sweeps
    for sweep in tl["sweeps"]:
        assert sweep["critical_path_seconds"] + sweep["other_seconds"] == pytest.approx(
            sweep["wall_seconds"], rel=1e-6)
        assert set(sweep["phases"]) >= {"solve", "score"}
        assert 0.0 <= sweep["overlap_factor"] < 1.0
    assert tl["total"]["wall_seconds"] > 0
    # the JAX package's recorder attributes the port's spans alike
    ref = ref_timeline.TimelineRecorder()
    for e in xs:
        args = dict(e["args"])
        ref.handle(ref_tracing.SpanEvent(span=ref_tracing.Span(
            name=e["name"], span_id=args.pop("span_id"), parent_id=args.pop("parent_id"),
            start_unix=e["ts"] / 1e6, attrs=args, duration_s=e["dur"] / 1e6, start_perf=e["ts"] / 1e6)))
    got = ref.phase_attribution()
    assert got["n_sweeps"] == n_sweeps
    for a, b in zip(got["sweeps"], tl["sweeps"]):
        # microsecond round trip through the trace: rel 1e-6 of the wall
        assert a["wall_seconds"] == pytest.approx(b["wall_seconds"], rel=1e-6)
        assert a["phases"].keys() == b["phases"].keys()


def test_sweep_boundaries_sample_host_memory(tmp_path):
    """Every per-sweep metrics flush of a port run on the CPU carries the
    photon_mem_host_* gauges, as the JAX package's run does; no device is
    sampled on the CPU."""
    from photon_ml_tpu.cli import train as ref_train
    from photon_ml_tpu_torch.cli import train
    from photon_ml_tpu_torch.io import write_avro_file

    schema, recs = _game_avro(tmp_path, n=300, seed=7)
    train_path = str(tmp_path / "train.avro")
    write_avro_file(train_path, schema, recs)
    argv = ["--input-data", train_path, "--task", "logistic_regression",
            "--feature-shard", "name=global,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
            "--coordinate", "name=global,shard=global,optimizer=LBFGS,reg.type=L2,reg.weights=1",
            "--coordinate", "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1",
            "--coordinate-descent-iterations", "3", "--log-level", "WARNING"]
    train.run(argv + ["--output-dir", str(tmp_path / "o"), "--metrics-out", str(tmp_path / "m"), "--device", "cpu"])
    ref_train.run(argv + ["--output-dir", str(tmp_path / "ro"), "--metrics-out", str(tmp_path / "rm")])

    def flushes(d):
        lines = [json.loads(x) for x in open(os.path.join(d, "metrics.jsonl"))]
        return [{m["name"] for m in line["metrics"]} for line in lines if line.get("type") == "metrics"]

    ours, theirs = flushes(str(tmp_path / "m")), flushes(str(tmp_path / "rm"))
    # one flush a sweep and the final one
    assert len(ours) == len(theirs) == 4
    mem = {"photon_mem_host_rss_bytes", "photon_mem_host_peak_rss_bytes"}
    for names, ref_names in zip(ours, theirs):
        assert mem <= names and mem <= ref_names
        assert not any(n.startswith("photon_mem_device_") for n in names)
    rs = json.load(open(tmp_path / "m" / "run_summary.json"))
    assert rs["memory"]["host"]["peak_rss_bytes"] >= rs["memory"]["host"]["rss_bytes"] > 0


def test_cli_retrain_status_port_answers_during_the_chain(tmp_path):
    """cli.retrain --status-port on the CPU: /healthz 200 and /statusz live
    while the chain runs, the port closed after it."""
    from photon_ml_tpu_torch.cli import index, retrain
    from photon_ml_tpu_torch.io import write_avro_file

    schema, recs = _game_avro(tmp_path, n=600, seed=31)
    base = tmp_path / "feed"
    for rel, rr in (("2026/01/01", recs[:200]), ("2026/01/02", recs[200:400])):
        (base / rel).mkdir(parents=True)
        write_avro_file(str(base / rel / "part-00000.avro"), schema, rr)
    union_p, val_p = str(tmp_path / "union.avro"), str(tmp_path / "val.avro")
    write_avro_file(union_p, schema, recs[:400])
    write_avro_file(val_p, schema, recs[400:])
    shards = ["--feature-shard", "name=globalShard,bags=features", "--feature-shard", "name=userShard,bags=userFeatures"]
    idx = str(tmp_path / "index")
    index.run(["--input-data", union_p, *shards, "--output-dir", idx])
    port = _free_port()
    result = {}

    def _chain():
        result["summary"] = retrain.run([
            "--input-data", str(base), "--input-data-date-range", "20260101-20260102", "--validation-data", val_p,
            "--feature-index-dir", idx, "--task", "logistic_regression", *shards,
            "--coordinate", "name=global,shard=globalShard,optimizer=LBFGS,reg.type=L2,reg.weights=1",
            "--coordinate", "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC", "--gate-margin", "0.05",
            "--output-dir", str(tmp_path / "chain"), "--serving-root", str(tmp_path / "serving"),
            "--status-port", str(port), "--log-level", "WARNING", "--device", "cpu",
        ])

    t = threading.Thread(target=_chain, name="cli-retrain")
    t.start()
    live_statusz, _, healthy = _poll_live(f"http://127.0.0.1:{port}", t.is_alive)
    t.join(timeout=300)
    assert not t.is_alive()
    assert [d["day"] for d in result["summary"]["days"]] == ["20260101", "20260102"]
    assert healthy, "/healthz never answered 200 during the chain"
    assert live_statusz, "statusz never reported a live coordinate"
    with pytest.raises(urllib.error.URLError):
        _get(f"http://127.0.0.1:{port}/healthz", timeout=2)


def test_zz_no_thread_outlives_the_file():
    """Every server and training thread this file started has stopped."""
    deadline = time.time() + 10
    while time.time() < deadline and _obs_threads() - _THREADS_AT_START:
        time.sleep(0.05)
    assert not _obs_threads() - _THREADS_AT_START
