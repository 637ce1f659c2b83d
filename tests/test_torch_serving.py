"""The port's resident scoring service (``photon_ml_tpu_torch.serving``)
against the JAX package's, on the CPU: every case of tests/test_serving.py,
each run through the port and, where the case computes a score or a
response, through the JAX package on the same model and requests.

Bounds: the port's own paths are held to each other bitwise in float64, as
the reference holds its own (per-row scores are row-independent, and the
plain fixed-effect product adds a padded row's trailing zeros last, so
neither row nor width padding moves a bit). Against the JAX package a score
may differ in its last bits: the port's plain product sums each row's terms
one by one (``index_add_``), XLA's fused reduction may contract a multiply
and an add into one rounding. Those holds are rtol 1e-12 of
max(|score|, 1). Responses on the wire are compared whole, apart from the
trace ids.
"""

from __future__ import annotations

import gc
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving_common import (
    D_FIXED,
    D_RE,
    make_request,
    model_parts,
    oracle_score,
    port_model,
    ref_model,
    serving_threads,
    to_doc,
    to_ref,
)
from photon_ml_tpu import obs as ref_obs
from photon_ml_tpu import serving as ref_serving
from photon_ml_tpu.estimators.game_estimator import GameTransformer as RefGameTransformer
from photon_ml_tpu.testing import generate_mixed_effect_data as ref_generate
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as ref_to_raw
from photon_ml_tpu_torch import obs, serving
from photon_ml_tpu_torch.estimators.game_estimator import GameTransformer
from photon_ml_tpu_torch.serving.batcher import RequestTrace
from photon_ml_tpu_torch.serving.engine import _ladder_rows, _ladder_width
from photon_ml_tpu_torch.testing import generate_mixed_effect_data
from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THREADS_AT_START = set()


def assert_close_to_ref(ours, theirs):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape
    assert np.all(np.abs(ours - theirs) <= 1e-12 * np.maximum(np.abs(theirs), 1.0)), (ours, theirs)


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


def engine_pair(parts=None):
    parts = parts or model_parts()
    return (serving.ScoreEngine.from_model(port_model(parts), dtype=F64),
            ref_serving.ScoreEngine.from_model(ref_model(parts), dtype=jnp.float64))


# -- store ------------------------------------------------------------------


def test_store_roundtrip_bitwise(tmp_path):
    parts = model_parts()
    store_dir = serving.build_store_from_model(port_model(parts), str(tmp_path / "store"))
    for opened in (serving.ModelStore.open(store_dir), ref_serving.ModelStore.open(store_dir)):
        assert opened.task == "logistic_regression"
        by_name = {c.name: c for c in opened.coords}
        fe, re = by_name["global"], by_name["per-user"]
        np.testing.assert_array_equal(np.asarray(fe.weights), parts["models"]["global"]["means"])
        np.testing.assert_array_equal(np.asarray(re.coef_indices), parts["models"]["per-user"]["coef_indices"])
        np.testing.assert_array_equal(np.asarray(re.coef_values), parts["models"]["per-user"]["coef_values"])
        assert np.asarray(re.coef_values).dtype == np.float64
        np.testing.assert_array_equal(re.rows_for(["uA", "uC", "nobody", None]), [0, 2, -1, -1])


def test_store_meta_written_last_certifies(tmp_path):
    store_dir = serving.build_store_from_model(port_model(model_parts()), str(tmp_path / "store"))
    os.unlink(os.path.join(store_dir, "store-meta.json"))
    with pytest.raises(Exception):
        serving.ModelStore.open(store_dir)
    with pytest.raises(Exception):
        ref_serving.ModelStore.open(store_dir)


def test_store_version_refused(tmp_path):
    d = tmp_path / "store"
    d.mkdir()
    (d / "store-meta.json").write_text(json.dumps({"version": 99, "task": "x", "coordinates": []}))
    for mod in (serving, ref_serving):
        with pytest.raises(ValueError, match="unsupported serving store version"):
            mod.ModelStore.open(str(d))


# -- engine: cold start + oracle --------------------------------------------


def test_cold_start_fallback_and_oracle(run_telemetry):
    parts = model_parts()
    ours, theirs = engine_pair(parts)
    rng = np.random.default_rng(7)
    reqs = [
        make_request(rng, "uA"),
        make_request(rng, "stranger"),
        make_request(rng, "uC"),
        serving.ScoreRequest(features={"globalShard": ((0, 1), (1.0, 2.0)), "userShard": ((0,), (5.0,))}),
    ]
    ref_run = ref_obs.RunTelemetry()
    with ref_obs.use_run(ref_run):
        ref_scores = theirs.score_requests([to_ref(r) for r in reqs])
    scores = ours.score_requests(reqs)
    np.testing.assert_allclose(scores, [oracle_score(parts, r) for r in reqs], rtol=0, atol=1e-12)
    assert_close_to_ref(scores, ref_scores)
    cold = [m for m in run_telemetry.registry.snapshot() if m["name"] == "photon_serving_cold_start_total"]
    ref_cold = [m for m in ref_run.registry.snapshot() if m["name"] == "photon_serving_cold_start_total"]
    assert cold == ref_cold
    assert cold[0]["labels"] == {"coordinate": "per-user"} and cold[0]["value"] == 2


def test_warmup_does_not_count_cold_starts(run_telemetry):
    engine = serving.ScoreEngine.from_model(port_model(model_parts()), dtype=F64)
    engine.warm()
    assert engine.random_effect_types == ["userId"]
    snap = run_telemetry.registry.snapshot()
    assert not [m for m in snap if m["name"] == "photon_serving_cold_start_total"]


def test_ladder_shapes():
    from photon_ml_tpu.serving.engine import _ladder_rows as ref_rows
    from photon_ml_tpu.serving.engine import _ladder_width as ref_width

    assert serving.LADDER_ROWS == ref_serving.LADDER_ROWS
    assert serving.LADDER_WIDTH == ref_serving.LADDER_WIDTH
    for n in (1, 2, 8, 9, 64, 65, 4096, 4097, 16384, 10**9):
        assert _ladder_rows(n) == ref_rows(n)
    for f in (0, 1, 3, 4, 5, 16, 65, 256, 512):
        assert _ladder_width(f) == ref_width(f)
    assert _ladder_rows(9) == 64 and _ladder_width(65) == 256
    with pytest.raises(ValueError, match="padded feature-width ladder"):
        _ladder_width(serving.LADDER_WIDTH[-1] + 1)


def test_store_engine_stages_tables_in_its_dtype_and_refuses_no_card(tmp_path, monkeypatch):
    """``from_store`` copies the read-only maps onto the device in the
    engine's dtype; with no card and no ``device``, it raises."""
    parts = model_parts()
    store = serving.ModelStore.open(serving.build_store_from_model(port_model(parts), str(tmp_path / "s")))
    engine = serving.ScoreEngine.from_store(store, dtype=torch.float32, device="cpu")
    fe = engine._coords[0]
    assert fe.weights.dtype == torch.float32 and fe.weights.device.type == "cpu"
    np.testing.assert_array_equal(fe.weights.numpy(), parts["models"]["global"]["means"].astype(np.float32))
    fe.weights.add_(1.0)  # a copy: the store's read-only map is untouched
    np.testing.assert_array_equal(np.asarray(store.coords[0].weights), parts["models"]["global"]["means"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ScoreEngine.from_store(store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ScoringServer(store=store)


# -- parity ------------------------------------------------------------------


def _rename_shards(raw):
    mapping = {"global": "globalShard", "userId": "userShard"}
    raw.shard_coo = {mapping.get(k, k): v for k, v in raw.shard_coo.items()}
    if getattr(raw, "shard_dims", None):
        raw.shard_dims = {mapping.get(k, k): v for k, v in raw.shard_dims.items()}
    return raw


def test_transform_and_engine_bitwise_parity():
    """GameTransformer.transform and the engine's batch path give the same
    bits (transform delegates to the engine), and both hold against the
    JAX package's transform on the same rows."""
    kw = dict(n=60, d_fixed=D_FIXED, re_specs={"userId": (3, D_RE)}, seed=5)
    raw = _rename_shards(mixed_data_to_raw_dataset(generate_mixed_effect_data(**kw)))
    ref_raw = _rename_shards(ref_to_raw(ref_generate(**kw)))
    parts = model_parts()
    ours, _ = engine_pair(parts)
    s_t, _ = GameTransformer(model=port_model(parts), dtype=F64, device="cpu").transform(raw)
    s_e = ours.score_dataset(raw)
    np.testing.assert_array_equal(s_t, s_e)
    ref_t, _ = RefGameTransformer(model=ref_model(parts), dtype=jnp.float64).transform(ref_raw)
    assert_close_to_ref(s_t, ref_t)


def test_resident_vs_batch_bitwise_parity(run_telemetry):
    """The same rows through the resident ladder-padded path and the batch
    path (``score_ell`` at their natural widths, 4 and 2) are bitwise
    equal: in the port, unlike the JAX package, the user shard needs no
    padding to the rung for that."""
    parts = model_parts()
    ours, theirs = engine_pair(parts)
    rng = np.random.default_rng(11)
    reqs = [make_request(rng, uid) for uid in ["uA", "uB", "nobody", "uC", "uA", None, "uB"]]
    resident = ours.score_requests(reqs)
    n = len(reqs)
    offsets = np.array([r.offset for r in reqs])
    shard_ell = {}
    for shard, width in (("globalShard", 4), ("userShard", 2)):
        idx = np.zeros((n, width), dtype=np.int32)
        val = np.zeros((n, width), dtype=np.float64)
        for i, r in enumerate(reqs):
            fi, fv = r.features[shard]
            idx[i, : len(fi)] = fi
            val[i, : len(fv)] = fv
        shard_ell[shard] = (idx, val)
    erow = port_model(parts).models["per-user"].rows_for([r.ids.get("userId") for r in reqs]).astype(np.int32)
    np.testing.assert_array_equal(resident, ours.score_ell(offsets, shard_ell, {"per-user": erow}))
    with ref_obs.use_run(ref_obs.RunTelemetry()):
        assert_close_to_ref(resident, theirs.score_requests([to_ref(r) for r in reqs]))


# -- microbatcher ------------------------------------------------------------


def test_batcher_batches_and_scores(run_telemetry):
    parts = model_parts()
    engine, _ = engine_pair(parts)
    engine.warm()
    b = serving.MicroBatcher(lambda: engine, max_batch=64, max_latency_ms=20.0)
    rng = np.random.default_rng(3)
    reqs = [make_request(rng, "uA") for _ in range(16)]
    try:
        got = [f.result(timeout=30.0) for f in [b.submit(r) for r in reqs]]
    finally:
        b.close()
    np.testing.assert_array_equal(got, engine.score_requests(reqs))
    np.testing.assert_allclose(got, [oracle_score(parts, r) for r in reqs], rtol=0, atol=1e-12)
    by_name = {m["name"]: m for m in run_telemetry.registry.snapshot() if "count" in m or "value" in m}
    assert by_name["photon_serving_requests_total"]["value"] == 16
    assert by_name["photon_serving_request_latency_seconds"]["count"] == 16
    assert by_name["photon_serving_request_latency_seconds"]["buckets"][0][0] == ref_serving.SERVING_LATENCY_BUCKETS[0]
    assert serving.SERVING_LATENCY_BUCKETS == ref_serving.SERVING_LATENCY_BUCKETS
    assert by_name["photon_serving_batch_size"]["sum"] == 16
    assert by_name["photon_serving_batch_size"]["count"] < 16


def test_batcher_error_propagates_and_counts(run_telemetry):
    class _Broken:
        def score_requests(self, reqs, count_cold=True):
            raise RuntimeError("engine exploded")

    b = serving.MicroBatcher(lambda: _Broken(), max_batch=4, max_latency_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="engine exploded"):
            b.submit(serving.ScoreRequest(features={})).result(timeout=30.0)
    finally:
        b.close()
    errs = [m for m in run_telemetry.registry.snapshot() if m["name"] == "photon_serving_request_errors_total"]
    assert errs and errs[0]["value"] == 1 and errs[0]["labels"] == {"model": "default"}


def test_batcher_rejects_after_close():
    engine, _ = engine_pair()
    b = serving.MicroBatcher(lambda: engine)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(serving.ScoreRequest(features={}))


# -- refresh + server: the kill-and-keep-serving drill -----------------------


def test_publish_and_open_current(tmp_path, run_telemetry):
    root = str(tmp_path / "root")
    assert serving.current_snapshot(root) is None
    serving.publish_snapshot(root, "v1", game_model=port_model(model_parts()))
    name, store = serving.open_current(root)
    assert name == "v1" and store.task == "logistic_regression"
    assert ref_serving.open_current(root)[0] == "v1"
    with pytest.raises(FileExistsError):
        serving.publish_snapshot(root, "v1", game_model=port_model(model_parts()))
    with pytest.raises(ValueError, match="exactly one"):
        serving.publish_snapshot(root, "v2")


def test_refresh_survives_torn_publish(tmp_path, run_telemetry):
    root = tmp_path / "root"
    serving.publish_snapshot(str(root), "v1", game_model=port_model(model_parts()))
    flips = []
    w = serving.RefreshWatcher(str(root), lambda n, s: flips.append(n), poll_seconds=3600.0, live="v1")
    try:
        (root / "CURRENT").write_text("v2\n")  # names a snapshot that never landed
        w.poke()
        assert flips == []
        swallowed = [m for m in run_telemetry.registry.snapshot()
                     if m["name"] == "photon_swallowed_errors_total" and m["labels"].get("site") == "serving.refresh"]
        assert swallowed and swallowed[0]["value"] >= 1
        serving.publish_snapshot(str(root), "v3", game_model=port_model(model_parts(1.0)))
        w.poke()
        assert flips == ["v3"]
    finally:
        w.stop()


def _drill(server, root, reqs, flips, publish):
    """Submit ``reqs`` one by one; at each index in ``flips`` publish the
    next snapshot and poke the watcher. Returns every response."""
    futs = []
    for i, r in enumerate(reqs):
        futs.append(server.submit(r))
        if i in flips:
            publish(flips.index(i))
            server.poke_refresh()
        time.sleep(0.001)
    return np.array([f.result(timeout=30.0) for f in futs])


def test_kill_and_keep_serving_drill(tmp_path, run_telemetry):
    """Publish a new snapshot mid-stream: no request errors, every response
    comes from exactly one snapshot (v1 before the flip, v2 after), and the
    post-flip scores equal a fresh load of the new snapshot bit for bit."""
    root = str(tmp_path / "root")
    p1, p2 = model_parts(0.0), model_parts(100.0)
    serving.publish_snapshot(root, "v1", game_model=port_model(p1))
    server = serving.ScoringServer(serving_root=root, max_batch=8, max_latency_ms=1.0, poll_seconds=3600.0,
                                   dtype=F64, device="cpu")
    rng = np.random.default_rng(23)
    reqs = [make_request(rng, ["uA", "uB", "uC"][i % 3]) for i in range(60)]
    exp1 = np.array([oracle_score(p1, r) for r in reqs])
    exp2 = np.array([oracle_score(p2, r) for r in reqs])
    assert np.min(np.abs(exp1 - exp2)) > 1.0
    try:
        got = _drill(server, root, reqs, [20],
                     lambda k: serving.publish_snapshot(root, "v2", game_model=port_model(p2)))
        from_v1 = np.isclose(got, exp1, rtol=0, atol=1e-9)
        from_v2 = np.isclose(got, exp2, rtol=0, atol=1e-9)
        assert np.all(from_v1 ^ from_v2)
        first_v2 = int(np.argmax(from_v2))
        assert from_v2.any() and np.all(from_v2[first_v2:])
        assert server.snapshot_name == "v2"
        fresh = serving.ScoreEngine.from_store(
            serving.ModelStore.open(serving.snapshot_path(root, "v2")), dtype=F64, device="cpu")
        tail = [r for r, v2 in zip(reqs, from_v2) if v2]
        np.testing.assert_array_equal(got[from_v2], fresh.score_requests(tail))
        snap = run_telemetry.registry.snapshot()
        refreshes = [m for m in snap if m["name"] == "photon_serving_refresh_total"]
        assert refreshes and refreshes[0]["value"] == 1
        assert not [m for m in snap if m["name"] == "photon_serving_request_errors_total"]
    finally:
        server.close()


def test_snapshot_published_by_one_package_served_by_the_other(tmp_path, run_telemetry):
    """A snapshot the JAX package publishes is served by the port, and one
    the port publishes by the JAX package, with the same scores."""
    parts = model_parts(seed=4)
    rng = np.random.default_rng(31)
    reqs = [make_request(rng, uid) for uid in ["uA", "uB", "uC", "ghost", None]]
    ref_root, our_root = str(tmp_path / "theirs"), str(tmp_path / "ours")
    ref_serving.publish_snapshot(ref_root, "v1", game_model=ref_model(parts))
    serving.publish_snapshot(our_root, "v1", game_model=port_model(parts))
    ours = serving.ScoringServer(serving_root=ref_root, poll_seconds=3600.0, dtype=F64, device="cpu",
                                 max_latency_ms=0.5)
    with ref_obs.use_run(ref_obs.RunTelemetry()):
        theirs = ref_serving.ScoringServer(serving_root=our_root, poll_seconds=3600.0, dtype=jnp.float64,
                                           max_latency_ms=0.5)
        try:
            got = [ours.score(r) for r in reqs]
            want = [theirs.score(to_ref(r)) for r in reqs]
        finally:
            theirs.close()
            ours.close()
    assert_close_to_ref(got, want)
    np.testing.assert_allclose(got, [oracle_score(parts, r) for r in reqs], rtol=0, atol=1e-12)


# -- the socket fronts -------------------------------------------------------


def _wait_for(path):
    deadline = time.time() + 10
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.01)
    assert os.path.exists(path)


def _store_server(mod, tmp_path, name, **kw):
    parts = model_parts()
    if mod is serving:
        d = serving.build_store_from_model(port_model(parts), str(tmp_path / name))
        return parts, serving.ScoringServer(store=serving.ModelStore.open(d), dtype=F64, device="cpu", **kw)
    d = ref_serving.build_store_from_model(ref_model(parts), str(tmp_path / name))
    return parts, ref_serving.ScoringServer(store=ref_serving.ModelStore.open(d), dtype=jnp.float64, **kw)


def test_socket_server_roundtrip(tmp_path, run_telemetry):
    """The AF_UNIX front: a score, a malformed line that leaves the
    connection up, a client trace id echoed; and the same lines sent to the
    JAX package's server answer the same documents, trace ids apart."""
    answers = {}
    for mod in (serving, ref_serving):
        with ref_obs.use_run(ref_obs.RunTelemetry()):
            parts, server = _store_server(mod, tmp_path, f"store-{mod.__name__}", max_latency_ms=1.0)
            sock_path = str(tmp_path / f"{mod.__name__}.sock")
            stop = threading.Event()
            t = threading.Thread(target=mod.serve_socket, args=(server, sock_path, stop), daemon=True)
            t.start()
            try:
                _wait_for(sock_path)
                req = make_request(np.random.default_rng(9), "uB")
                payload = to_doc(req)
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                    c.connect(sock_path)
                    f = c.makefile("rwb")
                    lines = [json.dumps(payload).encode() + b"\n", b'{"features": "nonsense"}\n',
                             json.dumps({**payload, "trace_id": "client-abc-123"}).encode() + b"\n"]
                    out = []
                    for line in lines:
                        f.write(line)
                        f.flush()
                        out.append(json.loads(f.readline()))
            finally:
                stop.set()
                t.join(timeout=10)
                server.close()
        answers[mod] = out
        resp, resp2, resp3 = out
        assert abs(resp["score"] - oracle_score(parts, req)) < 1e-12
        assert resp["trace_id"] and resp2["trace_id"] and resp2["trace_id"] != resp["trace_id"]
        assert "error" in resp2 and resp2["error_type"] == "bad_request"
        assert resp3["trace_id"] == "client-abc-123"
    ours, theirs = answers[serving], answers[ref_serving]
    for a, b in zip(ours, theirs):
        if "score" in a:
            assert_close_to_ref(a.pop("score"), b.pop("score"))
        ta, tb = a.pop("trace_id"), b.pop("trace_id")
        assert (ta == "client-abc-123") == (tb == "client-abc-123")
        assert a == b


def test_shed_response_carries_trace_id(tmp_path, run_telemetry):
    """Sheds are responses too: the AF_UNIX front echoes the trace_id."""
    _, server = _store_server(serving, tmp_path, "store", max_latency_ms=1.0, default_deadline_ms=1e-6)
    sock_path = str(tmp_path / "serve.sock")
    stop = threading.Event()
    t = threading.Thread(target=serving.serve_socket, args=(server, sock_path, stop), daemon=True)
    t.start()
    try:
        _wait_for(sock_path)
        req = make_request(np.random.default_rng(11), "uA")
        payload = {"features": to_doc(req)["features"], "trace_id": "shed-trace-9"}
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(sock_path)
            f = c.makefile("rwb")
            f.write((json.dumps(payload) + "\n").encode())
            f.flush()
            resp = json.loads(f.readline())
        assert resp["error_type"] == "shed" and resp["trace_id"] == "shed-trace-9" and resp["reason"]
        assert resp["model"] == "default"
    finally:
        stop.set()
        t.join(timeout=10)
        server.close()
    sheds = [m for m in run_telemetry.registry.snapshot() if m["name"] == "photon_serving_shed_total"]
    assert sheds and sum(m["value"] for m in sheds) >= 1


def test_request_stage_spans_and_slow_counter(tmp_path, run_telemetry):
    """A traced request lands its admit / batch / score spans under its
    serving.request root, each stamped with the trace id; a sub-millisecond
    slow threshold trips the slow-request counter."""
    spans = []

    class _SpanTap:
        def handle(self, event):
            if isinstance(event, obs.SpanEvent):
                spans.append(event.span)

        def close(self):
            pass

    run_telemetry.register_listener(_SpanTap())
    parts, server = _store_server(serving, tmp_path, "store", max_latency_ms=1.0, slow_request_ms=1e-4)
    try:
        req = make_request(np.random.default_rng(13), "uB")
        with obs.span("serving.request", trace_id="t-42") as root:
            score = server.score(req, trace=RequestTrace(trace_id="t-42", parent=root))
        assert abs(score - oracle_score(parts, req)) < 1e-12
    finally:
        server.close()
    by_name = {s.name: s for s in spans}
    for stage in ("serving.admit", "serving.batch", "serving.score"):
        assert by_name[stage].parent_id == root.span_id
        assert by_name[stage].attrs["trace_id"] == "t-42"
    assert by_name["serving.request"].attrs["trace_id"] == "t-42"
    slow = [m for m in run_telemetry.registry.snapshot() if m["name"] == "photon_serving_slow_requests_total"]
    assert slow and slow[0]["value"] >= 1


def test_shed_storm_one_flight_dump_zero_requests_lost(tmp_path, run_telemetry):
    """A shed storm triggers exactly one flight-recorder dump (the cooldown
    latch holds) and every submitted request resolves, scored or shed."""
    rec = obs.FlightRecorder(str(tmp_path / "flight"), run=run_telemetry, shed_rate_threshold=5.0,
                             poll_interval_s=0.0, cooldown_s=60.0)
    run_telemetry.register_listener(rec)
    _, server = _store_server(serving, tmp_path, "store", max_latency_ms=20.0, max_pending=2)
    try:
        rng = np.random.default_rng(17)
        server.score(make_request(rng, "uA"))
        assert rec.poll(force=True) is None
        time.sleep(0.05)
        futs = []
        for _ in range(200):
            try:
                futs.append(server.submit(make_request(rng, "uC")))
            except serving.ShedError:
                futs.append(None)
        scored = shed = 0
        for fut in futs:
            if fut is None:
                shed += 1
                continue
            try:
                fut.result(timeout=30.0)
                scored += 1
            except serving.ShedError:
                shed += 1
        assert scored + shed == 200 and shed >= 1
        first = rec.poll(force=True)
        assert first is not None
        for _ in range(5):
            try:
                server.submit(make_request(rng, "uC")).result(timeout=30.0)
            except serving.ShedError:
                pass
            assert rec.poll(force=True) is None
        assert len(rec.dump_paths) == 1
        doc = json.load(open(first))
        assert doc["trigger"]["kind"] == "shed_spike"
        assert set(doc) == {"trigger", "window_seconds", "identity", "events", "metrics"}
    finally:
        server.close()


def test_cli_serve_store_dir_socket(tmp_path):
    """``python -m photon_ml_tpu_torch.cli.serve`` in a subprocess on the
    CPU: serve a store over the socket with the introspection endpoints,
    score one request, stop it with SIGTERM, and find the Prometheus
    exposition (with the serving quantiles and the replica id) and the
    flight recorder's directory in --metrics-out."""
    import urllib.request

    parts = model_parts()
    store_dir = serving.build_store_from_model(port_model(parts), str(tmp_path / "store"))
    sock_path = str(tmp_path / "serve.sock")
    metrics_dir = str(tmp_path / "metrics")
    log = str(tmp_path / "serve.log")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", "--store-dir", store_dir, "--socket", sock_path,
         "--max-latency-ms", "1.0", "--metrics-out", metrics_dir, "--replica-id", "r3", "--status-port", "0",
         "--device", "cpu", "--log-file", log],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )
    try:
        deadline = time.time() + 60
        while not os.path.exists(sock_path) and time.time() < deadline and proc.poll() is None:
            time.sleep(0.02)
        assert os.path.exists(sock_path), proc.stderr.read().decode() if proc.poll() is not None else "no socket"
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(sock_path)
            f = c.makefile("rwb")
            f.write(b'{"features": {"globalShard": [[0], [1.0]]}}\n')
            f.flush()
            resp = json.loads(f.readline())
        assert abs(resp["score"] - float(np.float32(parts["models"]["global"]["means"][0]))) < 1e-6
        assert resp["trace_id"] and resp["model"] == "default"
        port = [int(line.rsplit(":", 1)[1].split("/")[0]) for line in open(log) if "introspection" in line][0]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert (r.status, json.loads(r.read())) == (200, {"status": "ok"})
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz", timeout=10) as r:
            status = json.loads(r.read())
        assert status["replica"] == "r3" and status["serving"]["requests_total"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0
    text = open(os.path.join(metrics_dir, "metrics.prom")).read()
    assert "photon_serving_request_latency_seconds_p99" in text
    assert "photon_serving_requests_total" in text
    assert "photon_build_info{" in text and 'replica="r3"' in text
    assert os.path.isdir(os.path.join(metrics_dir, "flight"))
    lines = [json.loads(line) for line in open(os.path.join(metrics_dir, "metrics.jsonl"))]
    assert any(line.get("name") == "serving.request" and line.get("replica") == "r3" for line in lines)


# -- prometheus quantiles ----------------------------------------------------


def test_serving_quantiles_in_prometheus(run_telemetry):
    texts = []
    for mod, srv in ((obs, serving), (ref_obs, ref_serving)):
        reg = mod.MetricsRegistry()
        h = reg.histogram("photon_serving_request_latency_seconds", "t", buckets=srv.SERVING_LATENCY_BUCKETS)
        for v in [0.001] * 50 + [0.004] * 45 + [0.2] * 5:
            h.observe(v)
        reg.histogram("photon_other", "t").observe(1.0)
        texts.append(mod.render_prometheus(reg.snapshot()))
    for q in ("p50", "p95", "p99"):
        assert f"photon_serving_request_latency_seconds_{q}" in texts[0]
    assert "# TYPE photon_other_p50 gauge" in texts[0]
    assert texts[0] == texts[1]


def test_histogram_quantile_interpolation():
    buckets = [(1.0, 50), (5.0, 95)]
    assert obs.histogram_quantile(buckets, 100, 0.5) == 1.0
    assert abs(obs.histogram_quantile(buckets, 100, 0.9) - (1 + 4 * 40 / 45)) < 1e-12
    assert obs.histogram_quantile(buckets, 100, 0.99) == 5.0
    assert obs.histogram_quantile(buckets, 0, 0.5) == 0.0
    assert obs.histogram_quantile([], 10, 0.5) == 0.0
    for q in (0.1, 0.5, 0.9, 0.99):
        assert obs.histogram_quantile(buckets, 100, q) == ref_obs.histogram_quantile(buckets, 100, q)


def test_retrain_publish_three_daily_flips_drill(tmp_path, run_telemetry):
    """Three daily publishes through the chain's own publish path
    (``incremental._ensure_published``) flip a live server mid-stream:
    nothing lost, every response from exactly one published model, and
    the served model never goes back a day."""
    from photon_ml_tpu_torch.game import incremental

    root = str(tmp_path / "root")
    all_parts = [model_parts(fe_shift=100.0 * k, seed=5) for k in range(4)]
    serving.publish_snapshot(root, "retrain-20260101", game_model=port_model(all_parts[0]))
    server = serving.ScoringServer(serving_root=root, max_batch=8, max_latency_ms=1.0, poll_seconds=3600.0,
                                   dtype=F64, device="cpu")
    rng = np.random.default_rng(41)
    reqs = [make_request(rng, ["uA", "uB", "uC"][i % 3]) for i in range(80)]
    exp = np.stack([[oracle_score(p, r) for r in reqs] for p in all_parts])
    for a in range(4):
        for b in range(a + 1, 4):
            assert np.min(np.abs(exp[a] - exp[b])) > 1.0

    def _publish(k):
        day = f"2026010{k + 2}"
        rec = incremental.DayRecord(day=day, index=k + 1, accepted=True, reason="accepted", rows=0,
                                    touched_entities={}, snapshot=f"retrain-{day}")
        assert incremental._ensure_published(root, rec, port_model(all_parts[k + 1]))

    try:
        got = _drill(server, root, reqs, [20, 40, 60], _publish)
        source = np.full(len(reqs), -1)
        for k in range(4):
            hit = np.isclose(got, exp[k], rtol=0, atol=1e-9)
            assert np.all(source[hit] == -1)
            source[hit] = k
        assert np.all(source >= 0) and np.all(np.diff(source) >= 0)
        assert source[-1] == 3 and server.snapshot_name == "retrain-20260104"
        snap = run_telemetry.registry.snapshot()
        assert [m["value"] for m in snap if m["name"] == "photon_serving_refresh_total"] == [3]
        assert [m["value"] for m in snap if m["name"] == "photon_retrain_published_total"] == [3]
        assert not [m for m in snap if m["name"] == "photon_serving_request_errors_total"]
    finally:
        server.close()


def test_zz_no_serving_thread_outlives_the_file():
    """Every batcher, watcher, server and listener this file started was
    closed: no serving thread is alive that was not alive when it began."""
    deadline = time.time() + 10
    while time.time() < deadline and serving_threads() - _THREADS_AT_START:
        time.sleep(0.05)
    assert not serving_threads() - _THREADS_AT_START
