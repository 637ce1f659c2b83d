"""The port's fleet plane (``photon_ml_tpu_torch.obs.fleet``,
``cli.fleetz``) and flight recorder against the JAX package's, on the CPU:
the non-slow cases of tests/test_fleet.py, each run through both packages on
the same Prometheus text, snapshots and JSONL streams, and that file's
two-process drill over two gloo CPU ranks of the port's ``cli.train
--distributed``.

Bounds: parsing, merging, loading and stitching are host Python copied from
the JAX package, so both packages' results are held equal (``==``).
Counters merge bit for bit; the summary moments keep the reference's rel
1e-12 against a concatenated oracle, and parsed summary fields its
``pytest.approx`` default (rel 1e-6).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from photon_ml_tpu import obs as ref_obs
from photon_ml_tpu.obs import fleet as ref_fleet
from photon_ml_tpu.obs import run as ref_run
from photon_ml_tpu.obs import tracing as ref_tracing
from photon_ml_tpu.obs.metrics import MetricsRegistry as RefRegistry
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.obs import fleet
from photon_ml_tpu_torch.obs import run as port_run
from photon_ml_tpu_torch.obs import tracing
from photon_ml_tpu_torch.obs.metrics import MetricsRegistry, histogram_quantile, render_prometheus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THREADS_AT_START = set()


def _fleet_threads():
    return {t for t in threading.enumerate() if t.name.startswith(("photon-introspection", "photon-fleet"))}


@pytest.fixture(scope="module", autouse=True)
def _thread_census():
    _THREADS_AT_START.update(_fleet_threads())
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


def _by_key(snapshot):
    return {(m["name"], tuple(sorted(m["labels"].items()))): m for m in snapshot}


def _regs(n):
    """``n`` pairs of (port registry, JAX package registry)."""
    return [(MetricsRegistry(), RefRegistry()) for _ in range(n)]


def _merge_both(pairs_with_identity):
    """The same per-process snapshots merged by both packages: equal."""
    ours = fleet.merge_snapshots([(ident, p.snapshot()) for ident, (p, _) in pairs_with_identity])
    theirs = ref_fleet.merge_snapshots([(ident, r.snapshot()) for ident, (_, r) in pairs_with_identity])
    assert ours == theirs
    return ours


# -- parse_prometheus: inverse of render_prometheus ---------------------------


def test_parse_render_roundtrip_exact():
    reg = MetricsRegistry()
    reg.counter("photon_x_total", "a counter").labels(site="a").inc(3)
    reg.counter("photon_x_total", "a counter").labels(site="b").inc(4)
    reg.gauge("photon_depth", "a gauge").set(7.25)
    h = reg.histogram("photon_lat_seconds", "a hist", buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.005, 0.05, 0.5):
        h.observe(v)
    s = reg.summary("photon_iters", "a summary")
    for v in (1.0, 2.0, 3.0, 4.0):
        s.observe(v)
    snap = reg.snapshot()
    text = render_prometheus(snap)
    parsed = fleet.parse_prometheus(text)
    assert parsed == ref_fleet.parse_prometheus(text)
    a, b = _by_key(snap), _by_key(parsed)
    assert set(a) == set(b)
    for key, m in a.items():
        p = b[key]
        assert p["kind"] == m["kind"]
        if m["kind"] in ("counter", "gauge"):
            assert p["value"] == m["value"]
        elif m["kind"] == "histogram":
            assert p["count"] == m["count"]
            assert p["sum"] == m["sum"]
            assert [list(x) for x in p["buckets"]] == [list(x) for x in m["buckets"]]
        else:
            for field in ("count", "mean", "stdev", "min", "max"):
                assert p["stat"][field] == pytest.approx(m["stat"][field])


def test_parse_prometheus_hostile_label_values():
    reg = MetricsRegistry()
    reg.counter("photon_esc_total", "h").labels(path='a"b\\c\nd', plain="ok").inc(2)
    text = render_prometheus(reg.snapshot())
    parsed = fleet.parse_prometheus(text)
    assert parsed == ref_fleet.parse_prometheus(text)
    (m,) = [e for e in parsed if e["name"] == "photon_esc_total"]
    assert m["labels"] == {"path": 'a"b\\c\nd', "plain": "ok"}
    assert m["value"] == 2.0


def test_parse_drops_derived_hist_gauges_and_folds_summary_moments():
    reg = MetricsRegistry()
    reg.histogram("photon_h_seconds", "h", buckets=(1.0, 5.0)).observe(0.5)
    s = reg.summary("photon_s", "s")
    for v in (1.0, 3.0):
        s.observe(v)
    text = render_prometheus(reg.snapshot())
    parsed = fleet.parse_prometheus(text)
    assert parsed == ref_fleet.parse_prometheus(text)
    names = [m["name"] for m in parsed]
    assert "photon_h_seconds_p50" not in names
    assert "photon_s_mean" not in names
    (summ,) = [m for m in parsed if m["name"] == "photon_s"]
    assert summ["stat"]["mean"] == 2.0
    assert summ["stat"]["min"] == 1.0
    assert summ["stat"]["max"] == 3.0


# -- merge rule-set -----------------------------------------------------------


def test_merge_counters_bit_exact():
    pairs = _regs(3)
    rng = np.random.default_rng(0)
    per = [rng.integers(1, 10_000, size=4) for _ in pairs]
    for pair, counts in zip(pairs, per):
        for reg in pair:
            for j, c in enumerate(counts):
                reg.counter("photon_req_total", "h").labels(site=f"s{j}").inc(int(c))
    got = _by_key(_merge_both([({"process": str(i)}, pair) for i, pair in enumerate(pairs)]))
    for j in range(4):
        key = ("photon_req_total", (("site", f"s{j}"),))
        assert got[key]["value"] == float(sum(int(c[j]) for c in per))


def test_merge_gauges_keep_per_process_identity():
    a, b = _regs(2)
    for reg in a:
        reg.gauge("photon_queue_depth", "h").set(3)
    for reg in b:
        reg.gauge("photon_queue_depth", "h").set(9)
    got = _by_key(_merge_both([({"process": "0"}, a), ({"process": "1", "replica": "west"}, b)]))
    assert got[("photon_queue_depth", (("process", "0"),))]["value"] == 3.0
    assert got[("photon_queue_depth", (("process", "1"), ("replica", "west")))]["value"] == 9.0


def test_merge_histogram_quantiles_match_hand_merged_oracle():
    buckets = (0.001, 0.005, 0.025, 0.1, 0.5)
    rng = np.random.default_rng(7)
    obs_a = rng.exponential(0.01, size=400).tolist()
    obs_b = rng.exponential(0.05, size=300).tolist()
    a, b = _regs(2)
    oracle = MetricsRegistry()
    for regs, values in ((a, obs_a), (b, obs_b)):
        for v in values:
            for reg in (*regs, oracle):
                reg.histogram("photon_lat_seconds", "h", buckets=buckets).observe(v)
    merged = _merge_both([({"process": "0"}, a), ({"process": "1"}, b)])
    (m,) = [e for e in merged if e["name"] == "photon_lat_seconds"]
    (o,) = [e for e in oracle.snapshot() if e["name"] == "photon_lat_seconds"]
    assert m["count"] == o["count"] == 700
    assert m["sum"] == pytest.approx(o["sum"])
    assert [list(x) for x in m["buckets"]] == [list(x) for x in o["buckets"]]
    for q in (0.5, 0.95, 0.99):
        assert histogram_quantile(m["buckets"], m["count"], q) == histogram_quantile(o["buckets"], o["count"], q)


def test_merge_summaries_match_concat_oracle():
    rng = np.random.default_rng(3)
    xs_a, xs_b = rng.normal(2.0, 1.0, 50).tolist(), rng.normal(5.0, 3.0, 80).tolist()
    a, b = _regs(2)
    oracle = MetricsRegistry()
    for regs, values in ((a, xs_a), (b, xs_b)):
        for v in values:
            for reg in (*regs, oracle):
                reg.summary("photon_iters", "h").observe(v)
    merged = _merge_both([({"process": "0"}, a), ({"process": "1"}, b)])
    (m,) = [e for e in merged if e["name"] == "photon_iters"]
    (o,) = [e for e in oracle.snapshot() if e["name"] == "photon_iters"]
    assert m["stat"]["count"] == o["stat"]["count"]
    for field in ("mean", "stdev", "min", "max"):
        assert m["stat"][field] == pytest.approx(o["stat"][field], rel=1e-12)


def test_identity_labels_read_from_build_info():
    reg = MetricsRegistry()
    reg.gauge("photon_build_info", "h").labels(version="0.1.0", torch="x", cuda="none", device="none",
                                               process="3", replica="east").set(1)
    identity = fleet.identity_labels(reg.snapshot(), fallback_process="9")
    assert identity == {"process": "3", "replica": "east"}
    assert identity == ref_fleet.identity_labels(reg.snapshot(), fallback_process="9")
    assert fleet.identity_labels([], fallback_process="9") == {"process": "9"}


# -- JSONL stream loading + trace stitching -----------------------------------


def _write_stream(path, process_index, replica=None, n_spans=2, t0=100.0):
    with open(path, "w") as f:
        header = {"process_index": process_index, "host": f"host{process_index}"}
        if replica is not None:
            header["replica"] = replica
        f.write(json.dumps(header) + "\n")
        for k in range(n_spans):
            f.write(json.dumps({
                "type": "span", "name": f"op{k}", "span_id": f"s{process_index}.{k}", "parent_id": None,
                "start_unix": t0 + process_index + 0.1 * k, "duration_s": 0.05, "thread_id": 1 + k,
                "process_index": process_index, "attrs": {"k": k},
            }) + "\n")
        f.write(json.dumps({"type": "metrics", "metrics": [
            {"name": "photon_req_total", "kind": "counter", "help": "h", "labels": {},
             "value": 10.0 * (process_index + 1)}]}) + "\n")
    return path


def _load_both(path):
    ours, theirs = fleet.load_metrics_jsonl(path), ref_fleet.load_metrics_jsonl(path)
    assert (ours.source, ours.process_index, ours.replica, ours.host, ours.snapshot, ours.spans) == (
        theirs.source, theirs.process_index, theirs.replica, theirs.host, theirs.snapshot, theirs.spans)
    return ours, theirs


def test_load_metrics_jsonl_last_snapshot_wins_and_torn_tail(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"process_index": 1, "host": "h"}) + "\n")
        for v in (1.0, 5.0):
            f.write(json.dumps({"type": "metrics", "metrics": [
                {"name": "c_total", "kind": "counter", "help": "", "labels": {}, "value": v}]}) + "\n")
        f.write('{"type": "metrics", "metr')  # torn tail of a crashed writer
    stream, _ = _load_both(path)
    assert stream.process_index == 1
    assert stream.snapshot[0]["value"] == 5.0  # cumulative: the last flush wins


def test_stitch_spans_two_pid_lanes_no_drops(tmp_path):
    s0, r0 = _load_both(_write_stream(str(tmp_path / "metrics.jsonl"), 0, n_spans=3))
    s1, r1 = _load_both(_write_stream(str(tmp_path / "metrics.p1.jsonl"), 1, replica="r1", n_spans=2))
    trace = fleet.stitch_spans([s0, s1])
    assert trace == ref_fleet.stitch_spans([r0, r1])
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(events) == 5
    assert {e["pid"] for e in events} == {0, 1}
    assert min(e["ts"] for e in events) == 0.0
    assert [e["pid"] for e in sorted(events, key=lambda e: e["ts"])] == [0, 0, 0, 1, 1]
    names = {m["args"]["name"] for m in trace["traceEvents"] if m["ph"] == "M" and m["name"] == "process_name"}
    assert any("replica=r1" in n for n in names)
    assert trace["otherData"]["processes"] == [0, 1]


def test_discover_streams_globs_directories(tmp_path):
    _write_stream(str(tmp_path / "metrics.jsonl"), 0)
    _write_stream(str(tmp_path / "metrics.p1.jsonl"), 1)
    streams = fleet.discover_streams([str(tmp_path)])
    ref_streams = ref_fleet.discover_streams([str(tmp_path)])
    assert sorted(s.process_index for s in streams) == [0, 1]
    assert [(s.source, s.identity) for s in streams] == [(s.source, s.identity) for s in ref_streams]
    merged = fleet.merge_snapshots([(s.identity, s.snapshot) for s in streams])
    assert merged == ref_fleet.merge_snapshots([(s.identity, s.snapshot) for s in ref_streams])
    (c,) = [m for m in merged if m["name"] == "photon_req_total"]
    assert c["value"] == 30.0  # 10 + 20, bit-exact


# -- live aggregation front ---------------------------------------------------


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def _aggregator_families(merged):
    return {m["name"] for m in merged if m["name"].startswith("photon_fleet_")}


def test_fleet_aggregator_scrapes_introspection_server():
    """The port's aggregator scrapes the port's IntrospectionServer, and the
    JAX package's aggregator merges the same scrape to the same counters."""
    run = obs.RunTelemetry()
    obs.record_build_info(run.registry)
    run.registry.counter("photon_serving_requests_total", "h").inc(42)
    srv = obs.IntrospectionServer(run, port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}"
        agg, ref_agg = fleet.FleetAggregator(targets=[url]), ref_fleet.FleetAggregator(targets=[url])
        assert agg.scrape_once() == 1 == ref_agg.scrape_once()
        merged, ref_merged = agg.merged_snapshot(), ref_agg.merged_snapshot()
        got = _by_key(merged)
        assert got[("photon_serving_requests_total", ())]["value"] == 42.0
        assert _by_key(ref_merged)[("photon_serving_requests_total", ())] == got[("photon_serving_requests_total", ())]
        names = {m["name"] for m in merged}
        assert "photon_fleet_scrapes_total" in names
        assert "photon_fleet_processes_up" in names
        assert _aggregator_families(merged) == _aggregator_families(ref_merged)
    finally:
        srv.stop()


def test_fleet_aggregator_counts_down_replica_and_degrades():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    for mod in (fleet, ref_fleet):
        agg = mod.FleetAggregator(targets=[f"http://127.0.0.1:{dead_port}"], timeout_s=0.2)
        assert agg.scrape_once() == 0
        errs = [m for m in agg.registry.snapshot() if m["name"] == "photon_fleet_scrape_errors_total"]
        assert errs and errs[0]["value"] == 1.0


def test_fleet_server_endpoints(tmp_path):
    _write_stream(str(tmp_path / "metrics.jsonl"), 0)
    _write_stream(str(tmp_path / "metrics.p1.jsonl"), 1)
    bodies = []
    for mod in (fleet, ref_fleet):
        agg = mod.FleetAggregator()
        agg.add_streams(mod.discover_streams([str(tmp_path)]))
        front = mod.FleetServer(agg, port=0)
        try:
            base = f"http://127.0.0.1:{front.port}"
            text = _get(base + "/metrics")
            assert "photon_req_total 30" in text
            statusz = json.loads(_get(base + "/statusz"))
            assert statusz["fleet"]["processes_up"] == 2
            assert json.loads(_get(base + "/healthz")) == {"status": "ok", "processes_up": 2}
            bodies.append((text, statusz["fleet"]))
        finally:
            front.stop()
    assert bodies[0] == bodies[1]


# -- build info ---------------------------------------------------------------


def test_build_info_in_exposition_and_run_summary():
    """The port's build info names torch, CUDA and the card where the JAX
    package's names jax and its backend; version, process and replica are
    the same labels in both."""
    run = obs.RunTelemetry()
    obs.set_replica_id("r7")
    try:
        info = obs.record_build_info(run.registry)
    finally:
        obs.set_replica_id(None)
    ref_info = ref_obs.collect_build_info()
    assert info["version"] == "0.1.0" == ref_info["version"]
    assert info["replica"] == "r7"
    assert info["process"] == ref_info["process"] == "0"
    assert set(info) == {"version", "torch", "cuda", "device", "process", "replica"}
    text = render_prometheus(run.registry.snapshot())
    assert "photon_build_info{" in text
    assert 'version="0.1.0"' in text
    assert 'replica="r7"' in text
    doc = obs.build_run_summary(run.registry, total_wall_seconds=1.0)
    assert doc["build"]["version"] == "0.1.0"
    # the fleet reads the same identity from either package's gauge
    assert fleet.identity_labels(run.registry.snapshot(), "9") == {"process": "0", "replica": "r7"}


# -- flight recorder ----------------------------------------------------------


def _recorders(tmp_path, **kw):
    """A port run and recorder beside a JAX package run and recorder."""
    out = []
    for pkg, tag in ((obs, "port"), (ref_obs, "ref")):
        run = pkg.RunTelemetry()
        out.append((run, pkg.FlightRecorder(str(tmp_path / tag / "flight"), run=run, **kw)))
    return out


def test_flight_recorder_shed_storm_exactly_one_dump(tmp_path):
    docs = []
    for run, rec in _recorders(tmp_path, shed_rate_threshold=5.0, poll_interval_s=0.0, cooldown_s=60.0):
        shed = run.registry.counter("photon_serving_shed_total", "h").labels(reason="deadline")
        assert rec.poll(force=True) is None  # the baseline sample: no rate yet
        time.sleep(0.05)
        shed.inc(500)  # a storm far above 5 sheds/second
        path = rec.poll(force=True)
        assert path is not None and os.path.exists(path)
        time.sleep(0.05)
        shed.inc(500)
        assert rec.poll(force=True) is None  # the latch holds
        assert len(rec.dump_paths) == 1
        doc = json.load(open(path))
        assert doc["trigger"]["kind"] == "shed_spike"
        assert "identity" in doc and "metrics" in doc
        dumps = [m for m in run.registry.snapshot() if m["name"] == "photon_flightrec_dumps_total"]
        assert dumps and dumps[0]["labels"]["trigger"] == "shed_spike" and dumps[0]["value"] == 1.0
        docs.append(doc)
    ours, theirs = docs
    assert set(ours) == set(theirs) and ours["identity"].keys() == theirs["identity"].keys()


def test_flight_recorder_solver_divergence_and_rejection_triggers(tmp_path):
    for run, rec in _recorders(tmp_path, poll_interval_s=0.0):
        rec.poll(force=True)  # the baseline
        run.registry.counter("photon_solver_diverged_lanes_total", "h").labels(solver="LBFGS").inc()
        assert rec.poll(force=True) is not None
        run.registry.counter("photon_coordinate_rejections_total", "h").labels(coordinate="global").inc()
        assert rec.poll(force=True) is not None
        kinds = sorted(json.load(open(p))["trigger"]["kind"] for p in rec.dump_paths)
        assert kinds == ["coordinate_rejection", "solver_divergence"]
        assert [os.path.basename(p) for p in rec.dump_paths] == [
            "flight-solver_divergence-1.json", "flight-coordinate_rejection-2.json"]


def test_flight_recorder_ring_rides_event_stream_and_windows(tmp_path):
    run = obs.RunTelemetry()
    rec = obs.FlightRecorder(str(tmp_path / "flight"), run=run, window_s=30.0, poll_interval_s=10.0)
    run.register_listener(rec)
    with obs.use_run(run):
        with obs.span("outer"):
            with obs.span("inner", coordinate="global"):
                pass
    path = rec.trigger("crash", detail="SimulatedKill: drill")
    doc = json.load(open(path))
    span_names = [e["name"] for e in doc["events"] if e["type"] == "span"]
    assert "inner" in span_names and "outer" in span_names
    assert doc["trigger"]["detail"] == "SimulatedKill: drill"
    assert rec.trigger("crash", detail="again") is None  # the cooldown latches crashes too
    # the JAX package's recorder keeps the same record of the same spans
    ref = ref_obs.FlightRecorder(str(tmp_path / "ref-flight"), window_s=30.0, poll_interval_s=10.0)
    for e in doc["events"]:
        if e["type"] == "span":
            ref_span = ref_tracing.Span(name=e["name"], span_id=e["span_id"], parent_id=e["parent_id"],
                                        start_unix=e["unix"] - e["duration_s"], attrs=e["attrs"],
                                        duration_s=e["duration_s"], thread_id=e["thread_id"])
            ref.handle(ref_tracing.SpanEvent(span=ref_span))
    ref_doc = json.load(open(ref.trigger("crash", detail="SimulatedKill: drill")))
    strip = lambda events: [{k: v for k, v in ev.items() if k != "unix"} for ev in events if ev["type"] == "span"]  # noqa: E731
    assert strip(ref_doc["events"]) == strip(doc["events"])


# -- cli fleetz ---------------------------------------------------------------


def test_cli_fleetz_one_shot_stdout(tmp_path, capsys):
    from photon_ml_tpu.cli import fleetz as ref_fleetz
    from photon_ml_tpu_torch.cli import fleetz

    _write_stream(str(tmp_path / "metrics.jsonl"), 0)
    _write_stream(str(tmp_path / "metrics.p1.jsonl"), 1)
    fleetz.run([str(tmp_path)])
    out = capsys.readouterr().out
    assert "photon_req_total 30" in out
    assert "photon_fleet_processes 2" in out
    ref_fleetz.run([str(tmp_path)])
    assert capsys.readouterr().out == out


def test_cli_fleetz_artifacts_mode(tmp_path):
    from photon_ml_tpu.cli import fleetz as ref_fleetz
    from photon_ml_tpu_torch.cli import fleetz

    _write_stream(str(tmp_path / "metrics.jsonl"), 0)
    _write_stream(str(tmp_path / "metrics.p1.jsonl"), 1, replica="r1")
    out_dir, ref_dir = str(tmp_path / "fleet"), str(tmp_path / "ref-fleet")
    fleetz.run([str(tmp_path), "--out", out_dir])
    ref_fleetz.run([str(tmp_path), "--out", ref_dir])
    prom = open(os.path.join(out_dir, "fleet.prom")).read()
    assert "photon_req_total 30" in prom
    assert prom == open(os.path.join(ref_dir, "fleet.prom")).read()
    trace = json.load(open(os.path.join(out_dir, "fleet_trace.json")))
    assert {e["pid"] for e in trace["traceEvents"] if e["ph"] == "X"} == {0, 1}
    assert trace == json.load(open(os.path.join(ref_dir, "fleet_trace.json")))
    summary = json.load(open(os.path.join(out_dir, "fleet_summary.json")))
    assert summary["fleet"]["processes_up"] == 2
    assert summary["fleet"] == json.load(open(os.path.join(ref_dir, "fleet_summary.json")))["fleet"]


def test_cli_fleetz_refuses_empty_input(tmp_path):
    from photon_ml_tpu_torch.cli import fleetz

    with pytest.raises(SystemExit):
        fleetz.run([])
    with pytest.raises(SystemExit):
        fleetz.run([str(tmp_path / "nothing-here")])


def test_cli_fleetz_is_jax_free(tmp_path):
    """The port's fleetz imports and runs where neither ``jax`` nor
    ``photon_ml_tpu`` can be imported, and leaves neither in sys.modules."""
    _write_stream(str(tmp_path / "metrics.jsonl"), 0)
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['photon_ml_tpu'] = None\n"
        f"sys.argv = ['fleetz', {str(tmp_path)!r}, '--out', {str(tmp_path / 'fleet')!r}]\n"
        "runpy.run_module('photon_ml_tpu_torch.cli.fleetz', run_name='__main__')\n"
        "import photon_ml_tpu_torch.obs.fleet\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'photon_ml_tpu') and sys.modules[m])\n"
        "print('JAXFREE_OK' if not bad else bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAXFREE_OK" in proc.stdout
    assert os.path.exists(tmp_path / "fleet" / "fleet.prom")


def test_two_process_fleet_merge_parity(tmp_path):
    """tests/test_fleet.py's two-process drill through the port: two gloo
    CPU ranks of ``cli.train --distributed`` leave their own streams
    (``metrics.jsonl`` and ``metrics.p1.jsonl``); every merged counter is
    the sum of the two, bit for bit, in both packages' merges, and the
    stitched trace holds both pid lanes with no span dropped."""
    from _torch_mp_common import assert_ok, build_index, launch, write_logistic_avro

    data = write_logistic_avro(tmp_path / "train.avro", n=320, d=6, seed=5)
    common = ["--input-data", data, "--feature-shard", "name=global,bags=features"]
    index_dir = build_index(data, common[2:], tmp_path / "index")
    metrics_dir = str(tmp_path / "metrics")
    assert_ok(launch("train", common + [
        "--task", "logistic_regression", "--coordinate",
        "name=global,shard=global,optimizer=LBFGS,max.iter=40,reg.type=L2,reg.weights=1",
        "--feature-index-dir", index_dir, "--output-dir", str(tmp_path / "out"), "--metrics-out", metrics_dir,
        "--device", "cpu",
    ]))
    assert os.path.exists(os.path.join(metrics_dir, "metrics.jsonl"))
    assert os.path.exists(os.path.join(metrics_dir, "metrics.p1.jsonl"))
    streams = fleet.discover_streams([metrics_dir])
    assert sorted(s.process_index for s in streams) == [0, 1]
    merged = _by_key(fleet.merge_snapshots([(s.identity, s.snapshot) for s in streams]))
    ref_streams = ref_fleet.discover_streams([metrics_dir])
    assert _by_key(ref_fleet.merge_snapshots([(s.identity, s.snapshot) for s in ref_streams])) == merged
    per_process = [_by_key(s.snapshot) for s in streams]
    checked = 0
    for key, m in merged.items():
        if m["kind"] != "counter":
            continue
        assert m["value"] == sum(float(pp[key]["value"]) for pp in per_process if key in pp), key
        checked += 1
    assert checked > 0
    events = [e for e in fleet.stitch_spans(streams)["traceEvents"] if e["ph"] == "X"]
    assert len(events) == sum(len(s.spans) for s in streams)
    assert {e["pid"] for e in events} == {0, 1}


def test_zz_no_thread_outlives_the_file():
    """Every server this file started has stopped."""
    deadline = time.time() + 10
    while time.time() < deadline and _fleet_threads() - _THREADS_AT_START:
        time.sleep(0.05)
    assert not _fleet_threads() - _THREADS_AT_START
