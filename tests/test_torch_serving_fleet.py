"""The port's multi-model serving fleet (``serving/fleet.py``) and replica
front (``serving/front.py``) on the CPU: every case of
tests/test_serving_fleet.py, run through the port. Where a case scores a
stored model, the JAX package's fleet scores the same model and requests
beside it (rtol 1e-12 of max(|score|, 1): the port's plain fixed-effect
product sums term by term, XLA may fuse a multiply and an add); the front
is driven over a mix of the port's replicas and the JAX package's, which
speak one protocol.

The two chaos claims: a ``serving.score.<model>`` delay storm keyed to one
resident model sheds against that model alone, and a replica killed under
open-loop load through the front leaves no request without a response.
"""

from __future__ import annotations

import gc
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving_common import (
    D_FIXED,
    counter_total,
    model_parts,
    port_model,
    ref_model,
    rpc,
    serve_tcp,
    serving_threads,
    to_ref,
)
from photon_ml_tpu import obs as ref_obs
from photon_ml_tpu import serving as ref_serving
from photon_ml_tpu.plan import PlanError as RefPlanError
from photon_ml_tpu_torch import obs, serving
from photon_ml_tpu_torch.obs.http import compose_statusz
from photon_ml_tpu_torch.ops import cuda_lib
from photon_ml_tpu_torch.plan import PlanError
from photon_ml_tpu_torch.robust import faults
from photon_ml_tpu_torch.serving.fleet import ModelSet
from photon_ml_tpu_torch.serving.front import LeastLoadedFront, serve_front_socket

F64 = torch.float64
_THREADS_AT_START = set()


@pytest.fixture(scope="module", autouse=True)
def _thread_census():
    _THREADS_AT_START.update(serving_threads())
    yield
    # the servers, sockets and futures of this file leave cyclic garbage;
    # collect it here, so that the full collection it would set off does
    # not fall inside a later file's timed window in this worker
    gc.collect()


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.clear()


@pytest.fixture
def run_telemetry():
    run = obs.RunTelemetry()
    with obs.use_run(run):
        yield run


class FakeEngine:
    """A stand-in for ScoreEngine: score = value + offset, with an optional
    per-batch service delay (duck-typed into ModelSet like the real one)."""

    def __init__(self, value=0.0, delay_s=0.0):
        self.value = float(value)
        self.delay_s = delay_s
        self.batches = 0

    def warm(self):
        pass

    def score_requests(self, requests):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.batches += 1
        return [self.value + r.offset for r in requests]


def fake_request(model=None, offset=0.0):
    return serving.ScoreRequest(features={"g": ((0,), (1.0,))}, offset=offset, model=model)


def store_request(rng, uid="uA", model=None):
    gidx = np.sort(rng.choice(D_FIXED, size=4, replace=False))
    return serving.ScoreRequest(
        features={"globalShard": (tuple(int(i) for i in gidx), tuple(rng.standard_normal(4).tolist()))},
        ids={"userId": uid}, offset=float(rng.standard_normal()), model=model,
    )


def _close_tcp(stops, threads, servers):
    for stop in stops:
        stop.set()
    for t in threads:
        t.join(timeout=10.0)
    for srv in servers:
        srv.close()


# -- composition refusals ----------------------------------------------------


def test_duplicate_model_name_refused():
    with pytest.raises(PlanError, match="duplicate model name"):
        ModelSet([("a", FakeEngine()), ("a", FakeEngine())])
    with pytest.raises(RefPlanError, match="duplicate model name"):
        ref_serving.ModelSet([("a", FakeEngine()), ("a", FakeEngine())])


def test_front_refuses_af_unix_replicas():
    with pytest.raises(PlanError, match="not composable with AF_UNIX"):
        LeastLoadedFront(["/tmp/photon-serve.sock"])


def test_unknown_default_model_refused():
    with pytest.raises(ValueError, match="not in the fleet"):
        ModelSet({"a": FakeEngine()}, default_model="b")


def test_store_models_need_a_device_fake_engines_do_not(tmp_path, monkeypatch):
    """A set that builds engines from stores resolves its device up front
    (the card if None: it raises without one); ready-made engines need
    none."""
    root = str(tmp_path / "a")
    serving.publish_snapshot(root, "v1", game_model=port_model(model_parts()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelSet({"a": root})
    ms = ModelSet({"a": FakeEngine(value=2.0)}, max_latency_ms=0.5)
    try:
        assert ms.submit(fake_request()).result(5.0) == 2.0
    finally:
        ms.close()


def test_a_set_pins_the_callers_card_for_its_watcher_flips(monkeypatch):
    """``device=None`` resolves once, at construction, to the calling
    thread's current card with its index, so that engines built later on
    a watcher thread (whose current card may differ) land on that card."""
    from photon_ml_tpu_torch.device import pin_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert pin_device(None) == torch.device("cuda", 1)
    assert pin_device("cuda:0") == torch.device("cuda", 0)
    assert pin_device("cpu") == torch.device("cpu")
    seen = []
    monkeypatch.setattr(ModelSet, "_open_entry", lambda self, entry, source: seen.append(self.device))
    ms = ModelSet({"a": "unopened-root"})
    try:
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        assert seen == [torch.device("cuda", 1)] and ms.device == torch.device("cuda", 1)
    finally:
        ms.close()


# -- routing + bulkheads -----------------------------------------------------


def test_model_routing_and_unknown_model(run_telemetry):
    ms = ModelSet({"alpha": FakeEngine(value=1.0), "beta": FakeEngine(value=100.0)},
                  default_model="alpha", max_latency_ms=0.5)
    try:
        assert ms.submit(fake_request()).result(5.0) == 1.0
        assert ms.submit(fake_request(model="beta")).result(5.0) == 100.0
        assert ms.submit(fake_request(model="beta"), model="alpha").result(5.0) == 1.0
        with pytest.raises(serving.UnknownModelError) as exc:
            ms.resolve("gamma")
        assert exc.value.kind == "unknown_model"
        assert "this fleet holds ['alpha', 'beta']" in str(exc.value)
        assert ms.queue_stats()["models"].keys() == {"alpha", "beta"}
    finally:
        ms.close()


def test_ten_model_storm_isolates_to_one_bulkhead(run_telemetry):
    """A delay storm keyed to one of ten resident models sheds that model
    past its deadline budget while a victim model in the same process
    completes every request at untouched latency."""
    engines = {f"m{i}": FakeEngine(value=i) for i in range(10)}
    ms = ModelSet(engines, max_latency_ms=0.5, max_pending=64)
    try:
        faults.configure("serving.score.m3:delay50:p1", seed=1)
        results = serving.run_mixed_open_loop(
            ms.submit,
            {
                "storm": {"requests": [fake_request(model="m3")], "offered_qps": 120.0, "deadline_s": 0.02},
                "victim": {"requests": [fake_request(model="m5")], "offered_qps": 60.0},
            },
            duration_s=1.0,
        )
        storm, victim = results["storm"], results["victim"]
        for r in (storm, victim):
            assert r.sent == r.completed + sum(r.shed_admission.values()) + r.shed_expired + r.errors
        assert storm.shed_total > 0 and storm.errors == 0
        assert victim.errors == 0 and victim.shed_total == 0 and victim.completed == victim.sent
        assert victim.latency_p99_s < 0.04
        assert counter_total(run_telemetry, "photon_serving_shed_total", model="m3") == storm.shed_total
        assert counter_total(run_telemetry, "photon_serving_shed_total", model="m5") == 0
        models = compose_statusz(run_telemetry)["serving"]["models"]
        assert models["m3"]["shed_total"] > 0
        assert "shed_by_reason" not in models["m5"]
        assert models["m5"]["latency_p99_seconds"] < 0.04
    finally:
        ms.close()


# -- staggered refresh over real stores --------------------------------------


def test_staggered_refresh_flips_models_independently(run_telemetry, tmp_path):
    """Each model flips on its own watcher; the JAX package's fleet over the
    same roots scores every step alike."""
    rng = np.random.default_rng(0)
    root_a, root_b = str(tmp_path / "a"), str(tmp_path / "b")
    serving.publish_snapshot(root_a, "v1", game_model=port_model(model_parts(0.0)))
    serving.publish_snapshot(root_b, "v1", game_model=port_model(model_parts(5.0)))
    ms = ModelSet({"a": root_a, "b": root_b}, max_latency_ms=0.5, poll_seconds=3600.0, dtype=F64, device="cpu")
    ref_run = ref_obs.RunTelemetry()
    with ref_obs.use_run(ref_run):
        ref_ms = ref_serving.ModelSet({"a": root_a, "b": root_b}, max_latency_ms=0.5, poll_seconds=3600.0,
                                      dtype=jnp.float64)
    req = store_request(rng)

    def both(model):
        ours = ms.submit(req, model=model).result(10.0)
        with ref_obs.use_run(ref_run):
            theirs = ref_ms.submit(to_ref(req), model=model).result(10.0)
        assert abs(ours - theirs) <= 1e-12 * max(abs(theirs), 1.0)
        return ours

    def poke(model):
        ms.poke_refresh(model)
        with ref_obs.use_run(ref_run):
            ref_ms.poke_refresh(model)
        assert ms.snapshot_names == ref_ms.snapshot_names

    try:
        s_a1, s_b1 = both("a"), both("b")
        assert ms.snapshot_names == {"a": "v1", "b": "v1"}
        serving.publish_snapshot(root_a, "v2", game_model=port_model(model_parts(2.0)))
        poke("a")
        assert ms.snapshot_names == {"a": "v2", "b": "v1"}
        assert both("a") != s_a1 and both("b") == s_b1
        (tmp_path / "b" / "CURRENT").write_text("v9-missing\n")
        poke("b")
        assert ms.snapshot_names == {"a": "v2", "b": "v1"}
        assert both("b") == s_b1
        assert counter_total(run_telemetry, "photon_swallowed_errors_total", site="serving.refresh") >= 1
        serving.publish_snapshot(root_b, "v2", game_model=port_model(model_parts(7.0)))
        poke("b")
        assert ms.snapshot_names == {"a": "v2", "b": "v2"}
        assert both("b") != s_b1
        assert counter_total(run_telemetry, "photon_serving_refresh_total", model="a") == 1
        assert counter_total(run_telemetry, "photon_serving_refresh_total", model="b") == 1
    finally:
        ms.close()
        ref_ms.close()


def test_same_shape_models_share_compiled_executables(run_telemetry, tmp_path, monkeypatch):
    """The port's counterpart of the JAX package's shared executables:
    warming the Nth same-shape model loads no library and builds no
    kernel, and every ladder batch's fixed-effect rows are uniform
    segments, with no host pointer build (the card's half of this is
    ``test_torch_cuda.py``'s ``test_same_shape_models_load_s1_once``)."""
    from photon_ml_tpu_torch.serving import engine as engine_mod

    sa = serving.build_store_from_model(port_model(model_parts(0.0)), str(tmp_path / "a"))
    sb = serving.build_store_from_model(port_model(model_parts(3.0)), str(tmp_path / "b"))
    e1 = serving.ScoreEngine.from_store(serving.ModelStore.open(sa), device="cpu")
    e1.warm()
    loads, segments = [], []
    real_rows = engine_mod.row_segments
    monkeypatch.setattr(cuda_lib, "load", lambda name: loads.append(name))
    monkeypatch.setattr(cuda_lib, "build", lambda names: loads.extend(names))
    monkeypatch.setattr(engine_mod, "row_segments",
                        lambda *a, **k: segments.append(real_rows(*a, **k)) or segments[-1])
    e2 = serving.ScoreEngine.from_store(serving.ModelStore.open(sb), device="cpu")
    e2.warm()
    e2.score_requests([store_request(np.random.default_rng(1)) for _ in range(9)])
    assert loads == []
    assert segments and all(s.ptr is None and s.keys is None for s in segments)


# -- the protocol's model field over a real socket ---------------------------


def test_model_echo_on_every_response_shape(run_telemetry):
    """Every response shape echoes the resolved model; the JAX package's
    server answers the same lines with the same documents."""
    answers = []
    for mod, o in ((serving, obs), (ref_serving, ref_obs)):
        run = o.RunTelemetry()
        with o.use_run(run):
            server = mod.ScoringServer(models={"alpha": FakeEngine(value=1.0), "beta": FakeEngine(value=2.0)},
                                       default_model="alpha", max_latency_ms=0.5)
            addr, stop, t = serve_tcp(server, mod.serve_socket)
            try:
                doc = {"features": {"g": [[0], [1.0]]}, "offset": 0.5}
                out = [rpc(addr, doc), rpc(addr, {**doc, "model": "beta"}), rpc(addr, {**doc, "model": "gamma"}),
                       rpc(addr, {**doc, "model": 7}), rpc(addr, raw=b"not json\n")]
            finally:
                _close_tcp([stop], [t], [server])
        for d in out:
            assert d.pop("trace_id")
        answers.append(out)
        ok, ok2, bad, bad2, nj = out
        assert (ok["score"], ok["model"]) == (1.5, "alpha")
        assert (ok2["score"], ok2["model"]) == (2.5, "beta")
        assert (bad["error_type"], bad["kind"], bad["model"]) == ("bad_request", "unknown_model", "gamma")
        assert "this fleet holds" in bad["error"]
        assert counter_total(run, "photon_serving_bad_request_total", kind="unknown_model") == 1
        assert (bad2["kind"], bad2["model"]) == ("bad_fields", "alpha")
        assert (nj["kind"], nj["model"]) == ("not_json", "alpha")
    assert answers[0] == answers[1]


# -- the replica front -------------------------------------------------------


def _two_replica_fleet(value=1.0, packages=(serving, serving)):
    """Two single-model TCP replicas over fake engines (of the given
    packages) and their stops."""
    servers, stops, threads, addrs = [], [], [], []
    for mod in packages:
        srv = mod.ScoringServer(engine=FakeEngine(value=value), max_latency_ms=0.5)
        addr, stop, t = serve_tcp(srv, mod.serve_socket)
        servers.append(srv)
        stops.append(stop)
        threads.append(t)
        addrs.append(addr)
    return servers, stops, threads, addrs


def test_front_routes_least_loaded_and_fails_over(run_telemetry):
    """The replica-kill drill: open-loop load through the front over a port
    replica and a JAX replica, the first killed mid-run; no request ends
    without a response."""
    servers, stops, threads, addrs = _two_replica_fleet(packages=(serving, ref_serving))
    front = LeastLoadedFront(addrs, health_poll_seconds=0.1)
    try:
        assert front.score(fake_request(offset=0.25)) == 1.25
        reqs = [fake_request(offset=float(i)) for i in range(8)]
        holder = {}
        killed = threading.Event()

        def drive():
            holder["r"] = serving.run_open_loop(front.submit, reqs, offered_qps=250.0, duration_s=1.2)

        dt = threading.Thread(target=drive)
        dt.start()
        # kill replica 0 once both replicas have carried traffic
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not killed.is_set():
            if all(counter_total(run_telemetry, "photon_serving_route_total", replica=a) > 0 for a in addrs):
                stops[0].set()
                killed.set()
            time.sleep(0.01)
        dt.join()
        r = holder["r"]
        assert killed.is_set()
        assert r.sent == r.completed + sum(r.shed_admission.values()) + r.shed_expired + r.errors
        assert r.errors == 0, "a request ended without a typed response"
        assert r.completed > 0
        assert all(counter_total(run_telemetry, "photon_serving_route_total", replica=a) > 0 for a in addrs)
        threads[0].join(timeout=10.0)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and front.replica_states()[addrs[0]]["up"]:
            front.score(fake_request())
        states = front.replica_states()
        assert not states[addrs[0]]["up"] and states[addrs[1]]["up"]
    finally:
        front.close()
        _close_tcp(stops, threads, servers)


def test_front_fault_sites_shed_typed(run_telemetry):
    """``serving.route`` sheds the request (typed, counted); ``serving.replica``
    on a single-replica fleet ends in a typed ``no_replica`` shed; then the
    maintenance thread brings the replica back."""
    servers, stops, threads, addrs = _two_replica_fleet()
    front = LeastLoadedFront(addrs[:1], health_poll_seconds=0.1)
    try:
        faults.configure("serving.route:io:1")
        with pytest.raises(serving.ShedError) as exc:
            front.score(fake_request())
        assert exc.value.reason == "route"
        faults.configure("serving.replica:io:1")
        with pytest.raises(serving.ShedError) as exc:
            front.score(fake_request())
        assert exc.value.reason == "no_replica"
        assert counter_total(run_telemetry, "photon_serving_front_sheds_total", reason="route") == 1
        assert counter_total(run_telemetry, "photon_serving_front_sheds_total", reason="no_replica") == 1
        faults.clear()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                assert front.score(fake_request(offset=1.0)) == 2.0
                break
            except serving.ShedError:
                time.sleep(0.05)
        else:
            pytest.fail("replica never rejoined the rotation")
    finally:
        front.close()
        _close_tcp(stops, threads, servers)


def test_front_connection_pool_channels(run_telemetry):
    servers, stops, threads, addrs = _two_replica_fleet()
    front = LeastLoadedFront(addrs, health_poll_seconds=0.1, connections_per_replica=2)
    try:
        expected = {addrs[0], f"{addrs[0]}#1", addrs[1], f"{addrs[1]}#1"}
        assert set(front.replica_states()) == expected
        assert front.score(fake_request(offset=0.25)) == 1.25
        reqs = [fake_request(offset=float(i)) for i in range(8)]
        r = serving.run_open_loop(front.submit, reqs, offered_qps=200.0, duration_s=0.6)
        assert r.errors == 0 and r.completed > 0
        routed = {a: counter_total(run_telemetry, "photon_serving_route_total", replica=a) for a in expected}
        assert sum(v > 0 for v in routed.values()) >= 3
        assert sum(routed.values()) >= r.completed
    finally:
        front.close()
        _close_tcp(stops, threads, servers)


def test_front_connection_pool_rejects_nonpositive():
    with pytest.raises(ValueError):
        LeastLoadedFront(["127.0.0.1:1"], connections_per_replica=0)


def test_front_socket_passthrough(run_telemetry):
    """Clients speak the replica protocol to the front; responses relay back
    verbatim, from a port replica or a JAX one alike."""
    servers, stops, threads, addrs = _two_replica_fleet(value=3.0, packages=(serving, ref_serving))
    front = LeastLoadedFront(addrs, health_poll_seconds=0.1)
    faddr, fstop, ft = serve_tcp(front, serve_front_socket)
    try:
        for _ in range(4):
            out = rpc(faddr, {"features": {"g": [[0], [1.0]]}, "offset": 1.0})
            assert out["score"] == 4.0 and out["model"] == "default" and out["trace_id"]
        out = rpc(faddr, {"features": "nonsense"})
        assert out["error_type"] == "bad_request"
        # requests in flight together spread over both replicas
        futs = [front.submit_doc({"features": {"g": [[0], [1.0]]}, "offset": 1.0}) for _ in range(16)]
        assert all(f.result(timeout=30.0)["score"] == 4.0 for f in futs)
        assert all(counter_total(run_telemetry, "photon_serving_route_total", replica=a) > 0 for a in addrs)
    finally:
        fstop.set()
        ft.join(timeout=10.0)
        front.close()
        _close_tcp(stops, threads, servers)


def test_zz_no_serving_thread_outlives_the_file():
    deadline = time.time() + 10
    while time.time() < deadline and serving_threads() - _THREADS_AT_START:
        time.sleep(0.05)
    assert not serving_threads() - _THREADS_AT_START
