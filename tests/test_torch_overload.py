"""Overload-proof serving in the port, on the CPU: every case of
tests/test_overload.py, run through the port (coordinated-omission
accounting, deadline-budget admission, hostile socket input, the TCP front,
/healthz overload signalling, the slow-engine chaos drill). Where a case
computes something deterministic, the JAX package computes it beside the
port: the load generator's schedules and simulations (equal arrays), the
socket's answers to the same hostile lines (equal documents, trace ids
apart), the /statusz documents over the same counters, and the fault
grammar. The refresh-fault case drives the watcher through ``poke`` with a
poll that never fires, so it does not race the poll as the JAX package's
case does.
"""

from __future__ import annotations

import gc
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from _torch_serving_common import counter_total, serving_threads
from photon_ml_tpu import obs as ref_obs
from photon_ml_tpu import serving as ref_serving
from photon_ml_tpu.robust import faults as ref_faults
from photon_ml_tpu.serving import loadgen as ref_loadgen
from photon_ml_tpu_torch import convert, obs, serving
from photon_ml_tpu_torch.robust import faults
from photon_ml_tpu_torch.serving import loadgen
from photon_ml_tpu_torch.serving.batcher import MicroBatcher, ShedError

_THREADS_AT_START = set()


@pytest.fixture(scope="module", autouse=True)
def _thread_census():
    _THREADS_AT_START.update(serving_threads())
    yield
    # the servers, sockets and futures of this file leave cyclic garbage;
    # collect it here, so that the full collection it would set off does
    # not fall inside a later file's timed window in this worker
    gc.collect()


@pytest.fixture
def run_telemetry():
    run = obs.RunTelemetry()
    with obs.use_run(run):
        yield run


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.clear()


class FakeEngine:
    """A stand-in for ScoreEngine: score = sum of feature values + offset,
    with optional per-batch delay / error / blocking hooks."""

    def __init__(self, delay_s=0.0, fail=False, block_on=None):
        self.delay_s = delay_s
        self.fail = fail
        self.block_on = block_on
        self.scored = []

    def warm(self):
        pass

    def score_requests(self, requests):
        if self.block_on is not None:
            assert self.block_on.wait(10.0)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise ValueError("injected engine failure")
        self.scored.extend(requests)
        return [float(sum(v for _, vals in r.features.items() for v in vals[1]) + r.offset) for r in requests]


def make_request(value=1.0, offset=0.0, deadline_ms=None):
    doc = {"features": {"globalShard": [[0], [value]]}, "offset": offset}
    if deadline_ms is not None:
        doc["deadline_ms"] = deadline_ms
    return doc


def score_request(value=1.0, offset=0.0):
    return serving.ScoreRequest(features={"globalShard": ((0,), (value,))}, offset=offset)


# -- coordinated-omission math ------------------------------------------------


def test_poisson_schedule_deterministic_and_calibrated():
    a = loadgen.poisson_intended_times(500.0, 4.0, seed=7)
    np.testing.assert_array_equal(a, loadgen.poisson_intended_times(500.0, 4.0, seed=7))
    np.testing.assert_array_equal(a, ref_loadgen.poisson_intended_times(500.0, 4.0, seed=7))
    assert not np.array_equal(a, loadgen.poisson_intended_times(500.0, 4.0, seed=8))
    assert a[0] >= 0 and a[-1] <= 4.0 and np.all(np.diff(a) >= 0)
    assert 1750 <= len(a) <= 2250
    with pytest.raises(ValueError):
        loadgen.poisson_intended_times(0.0, 1.0)
    with pytest.raises(ValueError):
        loadgen.poisson_intended_times(10.0, -1.0)


def test_open_loop_reports_queueing_a_closed_loop_hides():
    n = 101
    intended = [0.01 * k for k in range(n)]
    service = [1.0] + [0.001] * (n - 1)
    open_lat = loadgen.simulate_fifo_open_loop(intended, service)
    closed_lat = loadgen.simulate_fifo_closed_loop(service)
    np.testing.assert_array_equal(open_lat, ref_loadgen.simulate_fifo_open_loop(intended, service))
    np.testing.assert_array_equal(closed_lat, ref_loadgen.simulate_fifo_closed_loop(service))
    assert np.median(closed_lat) == 0.001
    assert sum(lat > 0.1 for lat in closed_lat) == 1
    assert np.median(open_lat) > 0.25
    assert sum(lat > 0.1 for lat in open_lat) > n // 2
    assert sum(open_lat) > 10 * sum(closed_lat)


def test_open_loop_matches_closed_loop_when_server_keeps_up():
    intended = [0.01 * k for k in range(50)]
    service = [0.002] * 50
    np.testing.assert_allclose(loadgen.simulate_fifo_open_loop(intended, service),
                               loadgen.simulate_fifo_closed_loop(service), atol=1e-12)


def test_find_knee_highest_served_step():
    def step(mod, offered, served):
        return mod.OpenLoopResult(
            offered_qps=offered, duration_s=1.0, sent=int(offered), completed=int(served), shed_admission={},
            shed_expired=0, errors=0, served_qps=served, achieved_offered_qps=offered, latency_mean_s=0.0,
            latency_p50_s=0.0, latency_p99_s=0.0,
        )

    for mod in (loadgen, ref_loadgen):
        steps = [step(mod, 100, 99), step(mod, 200, 195), step(mod, 400, 250), step(mod, 800, 260)]
        assert mod.find_knee(steps).offered_qps == 200
        assert mod.find_knee([step(mod, 400, 250)]) is None


# -- deadline / shed semantics -----------------------------------------------


def test_queue_full_sheds_with_counted_refusal(run_telemetry):
    gate = threading.Event()
    eng = FakeEngine(block_on=gate)
    b = MicroBatcher(lambda: eng, max_batch=1, max_latency_ms=0.1, max_pending=2)
    try:
        admitted = [b.submit(score_request()) for _ in range(2)]
        with pytest.raises(ShedError) as exc:
            b.submit(score_request())
        assert exc.value.reason == "queue_full"
        gate.set()
        for f in admitted:
            assert isinstance(f.result(timeout=10.0), float)
        assert counter_total(run_telemetry, "photon_serving_shed_total", reason="queue_full") == 1
        assert counter_total(run_telemetry, "photon_serving_offered_total") == 3
    finally:
        gate.set()
        b.close()


def test_deadline_admission_sheds_from_ewma(run_telemetry):
    eng = FakeEngine(delay_s=0.2)
    b = MicroBatcher(lambda: eng, max_batch=4, max_latency_ms=0.1)
    try:
        b.submit(score_request()).result(timeout=10.0)
        assert b.queue_stats()["ewma_service_seconds"] > 0.1
        with pytest.raises(ShedError) as exc:
            b.submit(score_request(), deadline_s=0.01)
        assert exc.value.reason == "deadline" and "deadline budget" in str(exc.value)
        assert counter_total(run_telemetry, "photon_serving_shed_total", reason="deadline") == 1
        assert isinstance(b.submit(score_request(), deadline_s=5.0).result(timeout=10.0), float)
    finally:
        b.close()


def test_expired_in_queue_shed_before_scoring_never_dropped(run_telemetry):
    gate = threading.Event()
    eng = FakeEngine(block_on=gate)
    b = MicroBatcher(lambda: eng, max_batch=1, max_latency_ms=0.1)
    try:
        blocker = b.submit(score_request())
        time.sleep(0.05)  # the worker takes the blocker into its own batch
        doomed = b.submit(score_request(offset=42.0), deadline_s=0.02)
        time.sleep(0.05)  # the deadline passes while it waits in the queue
        gate.set()
        assert isinstance(blocker.result(timeout=10.0), float)
        with pytest.raises(ShedError) as exc:
            doomed.result(timeout=10.0)
        assert exc.value.reason == "expired"
        assert counter_total(run_telemetry, "photon_serving_shed_total", reason="expired") == 1
        assert all(r.offset != 42.0 for r in eng.scored)
    finally:
        gate.set()
        b.close()


def test_engine_failure_propagates_counted_not_shed(run_telemetry):
    b = MicroBatcher(lambda: FakeEngine(fail=True), max_batch=4, max_latency_ms=0.5)
    try:
        futs = [b.submit(score_request()) for _ in range(2)]
        for f in futs:
            with pytest.raises(ValueError, match="injected engine failure"):
                f.result(timeout=10.0)
        assert counter_total(run_telemetry, "photon_serving_request_errors_total") == 2
        assert counter_total(run_telemetry, "photon_serving_shed_total") == 0
    finally:
        b.close()


def test_queue_gauges_track_admission_state(run_telemetry):
    eng = FakeEngine(delay_s=0.05)
    b = MicroBatcher(lambda: eng, max_batch=8, max_latency_ms=0.5)
    try:
        b.submit(score_request()).result(timeout=10.0)
        stats = b.queue_stats()
        assert stats["pending"] == 0 and stats["ewma_service_seconds"] > 0.01
        snap = {m["name"]: m["value"] for m in run_telemetry.registry.snapshot() if m["kind"] == "gauge"}
        assert snap["photon_serving_queue_depth"] == 0
        assert "photon_serving_drain_estimate_seconds" in snap
    finally:
        b.close()


def test_open_loop_against_live_batcher_accounts_every_request(run_telemetry):
    # a full collection of what earlier files left in this process stalls
    # every thread; run it before the timed window, not inside it
    gc.collect()
    eng = FakeEngine(delay_s=0.002)
    b = MicroBatcher(lambda: eng, max_batch=64, max_latency_ms=1.0, max_pending=16)
    try:
        res = loadgen.run_open_loop(b.submit, [score_request()], offered_qps=300.0, duration_s=0.5, seed=3,
                                    deadline_s=0.05)
        assert res.sent > 0 and res.sent == res.completed + res.shed_total + res.errors
        assert counter_total(run_telemetry, "photon_serving_offered_total") == res.sent
        assert counter_total(run_telemetry, "photon_serving_shed_total") == res.shed_total
        assert res.latency_p99_s <= 0.15
    finally:
        b.close()


# -- the socket front: TCP + hostile input -----------------------------------


def _tcp_front(mod, server):
    stop, ready, bound = threading.Event(), threading.Event(), {}
    t = threading.Thread(
        target=mod.serve_socket,
        kwargs=dict(server=server, listen="127.0.0.1:0", stop_event=stop,
                    on_bound=lambda a: (bound.update(addr=a), ready.set())),
    )
    t.start()
    assert ready.wait(10.0)
    return bound["addr"], stop, t


@pytest.fixture
def tcp_server(run_telemetry):
    """ScoringServer over a fake engine on an ephemeral TCP port."""
    server = serving.ScoringServer(engine=FakeEngine(), max_latency_ms=0.5)
    addr, stop, t = _tcp_front(serving, server)
    yield server, addr, run_telemetry
    stop.set()
    t.join(timeout=10.0)
    assert not t.is_alive(), "serve_socket leaked its listener thread"
    server.close()


def _connect(addr):
    conn = socket.create_connection(tuple(addr))
    return conn, conn.makefile("rwb")


def _roundtrip(f, doc):
    f.write((json.dumps(doc) + "\n").encode())
    f.flush()
    out = json.loads(f.readline())
    assert out.pop("trace_id"), out
    assert out.pop("model") == "default", out
    return out


def test_tcp_roundtrip_shared_handler(tcp_server):
    _, addr, _ = tcp_server
    conn, f = _connect(addr)
    try:
        assert _roundtrip(f, make_request(value=2.5, offset=1.0)) == {"score": 3.5}
        assert _roundtrip(f, make_request(value=1.0, deadline_ms=5000)) == {"score": 1.0}
    finally:
        conn.close()


HOSTILE = [
    (b"this is not json\n", "not_json"),
    (b"[1, 2, 3]\n", "bad_fields"),
    (b'{"ids": {}}\n', "bad_fields"),
    (b'{"features": "nonsense"}\n', "bad_fields"),
    (b'{"features": {"g": [[0], [1.0, 2.0]]}}\n', "bad_fields"),
    (b'{"features": {"g": [[-1], [1.0]]}}\n', "bad_fields"),
    (b'{"features": {"g": [[0], ["x"]]}}\n', "bad_fields"),
    (b'{"features": {"g": [[0], [1.0]]}, "deadline_ms": 0}\n', "bad_fields"),
    (b'{"features": {"g": [[0], [1.0]]}, "offset": "z"}\n', "bad_fields"),
]


def _answers(addr, lines):
    conn, f = _connect(addr)
    try:
        out = []
        for line in lines:
            f.write(line)
            f.flush()
            doc = json.loads(f.readline())
            assert doc.pop("trace_id")
            out.append(doc)
        return out
    finally:
        conn.close()


def test_hostile_inputs_typed_errors_and_counters(tcp_server):
    """Each hostile line gets a typed error and the connection survives;
    the JAX package's server answers the same lines with the same
    documents."""
    _, addr, run = tcp_server
    ours = _answers(addr, [line for line, _ in HOSTILE])
    for (line, kind), out in zip(HOSTILE, ours):
        assert out["error_type"] == "bad_request" and out["kind"] == kind, (line, out)
    conn, f = _connect(addr)
    try:
        assert _roundtrip(f, make_request(value=1.5)) == {"score": 1.5}
    finally:
        conn.close()
    assert counter_total(run, "photon_serving_bad_request_total", kind="not_json") == 1
    assert counter_total(run, "photon_serving_bad_request_total", kind="bad_fields") == 8
    with ref_obs.use_run(ref_obs.RunTelemetry()):
        ref_server = ref_serving.ScoringServer(engine=FakeEngine(), max_latency_ms=0.5)
        ref_addr, stop, t = _tcp_front(ref_serving, ref_server)
        try:
            theirs = _answers(ref_addr, [line for line, _ in HOSTILE] + [json.dumps(make_request(1.5)).encode() + b"\n"])
        finally:
            stop.set()
            t.join(timeout=10.0)
            ref_server.close()
    assert ours == theirs[:-1] and theirs[-1] == {"score": 1.5, "model": "default"}


def test_oversized_line_refused_and_connection_closed(tcp_server):
    _, addr, run = tcp_server
    conn, f = _connect(addr)
    try:
        f.write(b'{"pad": "' + b"x" * (serving.MAX_REQUEST_LINE_BYTES + 16) + b'"}\n')
        f.flush()
        out = json.loads(f.readline())
        assert out["error_type"] == "bad_request" and out["kind"] == "oversized"
        assert f.readline() == b""
        assert counter_total(run, "photon_serving_bad_request_total", kind="oversized") == 1
        assert serving.MAX_REQUEST_LINE_BYTES == ref_serving.MAX_REQUEST_LINE_BYTES
    finally:
        conn.close()


def test_mid_line_disconnect_counted_clean_close(tcp_server):
    _, addr, run = tcp_server
    conn = socket.create_connection(tuple(addr))
    conn.sendall(b'{"features": {"g": ')
    conn.close()
    deadline = time.time() + 5.0
    while time.time() < deadline and not counter_total(run, "photon_serving_bad_request_total", kind="disconnect"):
        time.sleep(0.01)
    assert counter_total(run, "photon_serving_bad_request_total", kind="disconnect") == 1


def test_shed_surfaces_as_typed_socket_error(run_telemetry):
    server = serving.ScoringServer(engine=FakeEngine(delay_s=0.2), max_batch=4, max_latency_ms=0.1)
    addr, stop, t = _tcp_front(serving, server)
    try:
        conn, f = _connect(addr)
        try:
            assert "score" in _roundtrip(f, make_request())
            out = _roundtrip(f, make_request(deadline_ms=1))
            assert out["error_type"] == "shed" and out["reason"] == "deadline"
            assert counter_total(run_telemetry, "photon_serving_shed_total", reason="deadline") == 1
            assert "score" in _roundtrip(f, make_request(deadline_ms=60_000))
        finally:
            conn.close()
    finally:
        stop.set()
        t.join(timeout=10.0)
        server.close()


def test_af_unix_front_unchanged(run_telemetry, tmp_path):
    server = serving.ScoringServer(engine=FakeEngine(), max_latency_ms=0.5)
    stop, ready = threading.Event(), threading.Event()
    sock_path = str(tmp_path / "serve.sock")
    t = threading.Thread(target=serving.serve_socket, kwargs=dict(
        server=server, path=sock_path, stop_event=stop, on_bound=lambda a: ready.set()))
    t.start()
    assert ready.wait(10.0)
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(sock_path)
        f = c.makefile("rwb")
        assert _roundtrip(f, make_request(value=2.0)) == {"score": 2.0}
        c.close()
    finally:
        stop.set()
        t.join(timeout=10.0)
        server.close()
    assert not os.path.exists(sock_path)


def test_serve_socket_needs_exactly_one_front(run_telemetry, tmp_path):
    server = serving.ScoringServer(engine=FakeEngine())
    try:
        with pytest.raises(ValueError, match="exactly one of path"):
            serving.serve_socket(server)
        with pytest.raises(ValueError, match="exactly one of path"):
            serving.serve_socket(server, path=str(tmp_path / "s.sock"), listen="127.0.0.1:0")
    finally:
        server.close()


def test_stop_event_closes_open_connections_deterministically(run_telemetry):
    """A connection sitting in a blocked read is shut down at stop time and
    its handler thread joined before serve_socket returns."""
    server = serving.ScoringServer(engine=FakeEngine(), max_latency_ms=0.5)
    addr, stop, t = _tcp_front(serving, server)
    conn = socket.create_connection(tuple(addr))
    try:
        deadline = time.time() + 5.0
        while time.time() < deadline and not [h for h in serving_threads() if "_handle_conn" in h.name]:
            time.sleep(0.01)
        handlers = [h for h in serving_threads() if "_handle_conn" in h.name]
        assert handlers
        stop.set()
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert not any(h.is_alive() for h in handlers)
        assert conn.recv(1) == b""  # the server shut the connection down
    finally:
        conn.close()
        server.close()


# -- /healthz overload + /statusz admission ----------------------------------


def test_healthz_overloaded_while_shed_rate_exceeds_threshold():
    import urllib.error
    import urllib.request

    run = obs.RunTelemetry()
    run.status.update(overload_shed_threshold=5.0)
    shed = run.registry.counter("photon_serving_shed_total", "test").labels(reason="deadline")
    srv = obs.IntrospectionServer(run, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=5) as r:
                return r.status, json.loads(r.read())

        assert get("/healthz") == (200, {"status": "ok"})
        shed.inc(1000)
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/healthz")
        assert e.value.code == 503 and json.loads(e.value.read()) == {"status": "overloaded"}
        time.sleep(0.05)
        assert get("/healthz") == (200, {"status": "ok"})
        run.status.update(refresh_in_progress=True)
        with pytest.raises(urllib.error.HTTPError) as e:
            get("/healthz")
        assert json.loads(e.value.read()) == {"status": "refreshing"}
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            assert b"photon_serving_shed_total" in r.read()
    finally:
        srv.stop()


def _statusz_registry(mod):
    run = mod.RunTelemetry()
    reg = run.registry
    reg.counter("photon_serving_requests_total", "t").inc(90)
    reg.counter("photon_serving_offered_total", "t").inc(100)
    reg.counter("photon_serving_shed_total", "t").labels(reason="deadline").inc(7)
    reg.counter("photon_serving_shed_total", "t").labels(reason="queue_full").inc(3)
    reg.counter("photon_serving_bad_request_total", "t").labels(kind="not_json").inc(2)
    reg.gauge("photon_serving_queue_depth", "t").set(4)
    reg.gauge("photon_serving_drain_estimate_seconds", "t").set(0.25)
    reg.counter("photon_serving_route_total", "t").labels(replica="a:1").inc(5)
    reg.gauge("photon_serving_replica_up", "t").labels(replica="a:1").set(1)
    run.status.update(serving_snapshot="v1")
    return run


def test_statusz_offered_served_shed_and_admission():
    run = _statusz_registry(obs)
    srv = obs.IntrospectionServer(run, port=0)
    try:
        doc = srv.statusz()
        s = doc["serving"]
        assert (s["requests_total"], s["offered_total"], s["shed_total"]) == (90, 100, 10)
        assert s["shed_by_reason"] == {"deadline": 7, "queue_full": 3}
        assert s["bad_requests"] == {"not_json": 2}
        assert s["admission"] == {"queue_depth": 4, "drain_estimate_seconds": 0.25}
        assert "qps" not in s
        # the JAX package composes the same document from the same counters
        ref_doc = ref_obs.compose_statusz(_statusz_registry(ref_obs))
        for d in (doc, ref_doc):
            d.pop("unix_time")
            d.pop("memory", None)
        assert doc == ref_doc
        run.registry.counter("photon_serving_requests_total", "t").inc(10)
        run.registry.counter("photon_serving_offered_total", "t").inc(20)
        run.registry.counter("photon_serving_shed_total", "t").labels(reason="deadline").inc(10)
        time.sleep(0.05)
        s2 = srv.statusz()["serving"]
        assert s2["qps"] > 0 and s2["offered_qps"] > s2["qps"] and s2["shed_qps"] > 0
    finally:
        srv.stop()


# -- fault sites + the chaos drill -------------------------------------------


def test_serving_score_delay_site_stalls_batch(run_telemetry):
    faults.configure("serving.score:delay120:1")
    b = MicroBatcher(lambda: FakeEngine(), max_batch=4, max_latency_ms=0.1)
    try:
        t0 = time.perf_counter()
        b.submit(score_request()).result(timeout=10.0)
        assert time.perf_counter() - t0 >= 0.12
        assert counter_total(run_telemetry, "photon_faults_injected_total", site="serving.score") == 1
        t0 = time.perf_counter()
        b.submit(score_request()).result(timeout=10.0)
        assert time.perf_counter() - t0 < 0.1
    finally:
        b.close()


def test_serving_score_io_site_is_counted_engine_error(run_telemetry):
    faults.configure("serving.score:io:1")
    eng = FakeEngine()
    b = MicroBatcher(lambda: eng, max_batch=4, max_latency_ms=0.1)
    try:
        with pytest.raises(faults.InjectedIOError):
            b.submit(score_request()).result(timeout=10.0)
        assert counter_total(run_telemetry, "photon_serving_request_errors_total") == 1
        assert eng.scored == []
        assert isinstance(b.submit(score_request()).result(timeout=10.0), float)
    finally:
        b.close()


D_FIXED = 6


def _game_parts(fe_shift=0.0, seed=0):
    rng = np.random.default_rng(seed)
    return {"task": "logistic_regression", "models": {"global": {
        "kind": "fixed", "feature_shard": "globalShard", "task": "logistic_regression",
        "means": rng.standard_normal(D_FIXED) + fe_shift, "variances": None,
    }}}


def _game_model(fe_shift=0.0):
    return convert.game_model_from_numpy(_game_parts(fe_shift), device="cpu")


def _drill_request(rng):
    idx = np.sort(rng.choice(D_FIXED, size=4, replace=False))
    return serving.ScoreRequest(
        features={"globalShard": (tuple(int(i) for i in idx), tuple(rng.standard_normal(4).tolist()))},
        offset=float(rng.standard_normal()),
    )


def test_chaos_drill_slow_engine_storm_with_live_flip(run_telemetry, tmp_path):
    """A seeded serving.score delay storm under open-loop load, with a
    snapshot published and flipped mid-storm: nothing without a response,
    every refusal counted, the flip lands, and the server scores on the new
    coefficients afterwards (float32 tables, as the card serves)."""
    root = str(tmp_path / "serving")
    serving.publish_snapshot(root, "v1", game_model=_game_model(0.0))
    server = serving.ScoringServer(serving_root=root, max_batch=32, max_latency_ms=1.0, max_pending=64,
                                   poll_seconds=3600.0, device="cpu")
    try:
        rng = np.random.default_rng(0)
        requests = [_drill_request(rng) for _ in range(64)]
        server.submit(requests[0], deadline_s=60.0).result(timeout=60.0)
        faults.configure("serving.score:delay80:p0.5", seed=4)
        flip_err = []

        def flip_mid_storm():
            try:
                time.sleep(0.4)
                serving.publish_snapshot(root, "v2", game_model=_game_model(2.0))
                server.poke_refresh()
            except Exception as exc:  # surfaced below
                flip_err.append(exc)

        flipper = threading.Thread(target=flip_mid_storm)
        flipper.start()
        res = loadgen.run_open_loop(server.submit, requests, offered_qps=120.0, duration_s=1.5, seed=11,
                                    deadline_s=0.06)
        flipper.join(timeout=30.0)
        faults.clear()
        assert not flip_err, flip_err
        assert res.sent == res.completed + res.shed_total + res.errors
        assert res.errors == 0
        assert counter_total(run_telemetry, "photon_faults_injected_total", site="serving.score") > 0
        assert res.shed_total > 0
        assert counter_total(run_telemetry, "photon_serving_shed_total") >= res.shed_total
        assert server.snapshot_name == "v2"
        assert counter_total(run_telemetry, "photon_serving_refresh_total") == 1
        req = requests[0]
        w = _game_parts(2.0)["models"]["global"]["means"]
        gi, gv = req.features["globalShard"]
        want = req.offset + float(np.dot(w[np.asarray(gi)], np.asarray(gv)))
        assert server.score(req, deadline_s=None) == pytest.approx(want, rel=1e-5)
    finally:
        faults.clear()
        server.close()


def test_serving_refresh_fault_swallowed_then_recovers(run_telemetry, tmp_path, monkeypatch):
    root = str(tmp_path / "serving")
    serving.publish_snapshot(root, "v1", game_model=_game_model(0.0))
    # the watcher's thread checks once as it starts: v2 is published only
    # after that check has ended, so the first check that can see v2 is the
    # first poke below, with the fault armed
    first_check = threading.Event()
    check = serving.RefreshWatcher._check

    def watched_check(self):
        check(self)
        if threading.current_thread() is self._thread:
            first_check.set()

    monkeypatch.setattr(serving.RefreshWatcher, "_check", watched_check)
    server = serving.ScoringServer(serving_root=root, max_latency_ms=0.5, poll_seconds=3600.0, device="cpu")
    try:
        assert first_check.wait(timeout=30.0)
        serving.publish_snapshot(root, "v2", game_model=_game_model(1.0))
        faults.configure("serving.refresh:io:1")
        server.poke_refresh()  # the injected IO error: swallowed, still on v1
        assert server.snapshot_name == "v1"
        assert counter_total(run_telemetry, "photon_swallowed_errors_total", site="serving.refresh") == 1
        server.poke_refresh()  # the spec is spent: this check flips
        assert server.snapshot_name == "v2"
        assert counter_total(run_telemetry, "photon_serving_refresh_total") == 1
    finally:
        server.close()


def test_faults_delay_grammar():
    for mod in (faults, ref_faults):
        (spec,) = mod.parse_faults("serving.score:delay:1")
        assert spec.kind == "delay" and spec.delay_s == pytest.approx(0.05)
        (spec,) = mod.parse_faults("serving.score:delay250:2x3")
        assert spec.kind == "delay" and spec.delay_s == pytest.approx(0.25)
        assert spec.at == 2 and spec.times == 3
        with pytest.raises(ValueError):
            mod.parse_faults("site:delayXX:1")
        with pytest.raises(ValueError, match="io|kill|nan|delay"):
            mod.parse_faults("site:bogus:1")


def test_zz_no_serving_thread_outlives_the_file():
    deadline = time.time() + 10
    while time.time() < deadline and serving_threads() - _THREADS_AT_START:
        time.sleep(0.05)
    assert not serving_threads() - _THREADS_AT_START
