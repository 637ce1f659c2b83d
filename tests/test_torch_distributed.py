"""The port's liveness plane and two-phase checkpoints
(``photon_ml_tpu_torch.robust.distributed``, ``robust.checkpoint``) against
the JAX package's, on the cases of tests/test_distributed.py, and the
kill-a-worker drill on two gloo CPU ranks.

- Heartbeats: the same records (each package reads the other's), ages,
  stale-peer errors, the fault site and the writer thread's swallow and
  kill paths.
- Barriers: ids, arming, and the translation of a failed barrier into the
  typed ``DistributedTimeoutError``, on a fake barrier client as the JAX
  tests use ``_FakeClient`` (the port's real client is gloo's
  ``monitored_barrier``, exercised by the drill).
- Two-phase saves: commit, torn and killed-at-commit saves and a corrupt
  shard falling back, each package's shard confirmations equal (the same
  pickles, so the same digests), topology refusals in the JAX package's
  words.
- The drill (tier-1, not ``slow``): rank 1 dies at its second sweep
  boundary (``dist.collective:kill:2``); rank 0 fails with a typed error
  naming process 1 within the budget plus 5 s and dumps a ``peer_lost``
  postmortem; both ranks resume from the last committed two-phase
  checkpoint and end within 1e-9 of the uninterrupted run (the JAX drill's
  bound), which is itself held against the JAX package's single-process
  fit at ROADMAP's solve bounds (rtol 1e-3 / atol 1e-5).
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import pytest

from _torch_mp_common import assert_ok, build_index, launch, write_logistic_avro
from photon_ml_tpu.cli import train as ref_train
from photon_ml_tpu.io.index_map import load_partitioned as ref_load_partitioned
from photon_ml_tpu.io.model_io import load_game_model as ref_load_game_model
from photon_ml_tpu.plan import PlanError as RefPlanError
from photon_ml_tpu.plan import planner as ref_planner
from photon_ml_tpu.robust import distributed as ref_rd
from photon_ml_tpu.robust.checkpoint import CheckpointManager as RefCheckpointManager
from photon_ml_tpu_torch import obs
from photon_ml_tpu_torch.cli import train
from photon_ml_tpu_torch.io.index_map import load_partitioned
from photon_ml_tpu_torch.io.model_io import load_game_model
from photon_ml_tpu_torch.plan import PlanError, planner
from photon_ml_tpu_torch.robust import distributed as rd
from photon_ml_tpu_torch.robust import faults
from photon_ml_tpu_torch.robust.checkpoint import CheckpointIncompatibleError, CheckpointManager
from photon_ml_tpu_torch.robust.faults import InjectedIOError, SimulatedKill


@pytest.fixture(autouse=True)
def _no_leaked_state(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    yield
    faults.clear()
    rd.clear_collectives()


@pytest.fixture
def run():
    r = obs.RunTelemetry()
    with obs.use_run(r):
        yield r


def counter_value(run, name, **labels):
    return run.registry.counter(name, "").labels(**labels).value


def _wait_until(predicate, timeout_s=10.0, interval_s=0.01):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


# ---------------------------------------------------------------- heartbeats


def test_heartbeat_write_read_roundtrip(tmp_path):
    d = str(tmp_path)
    rd.write_heartbeat(d, 0, 1)
    rd.write_heartbeat(d, 1, 7)
    recs = rd.read_heartbeats(d)
    assert set(recs) == {0, 1}
    assert recs[1]["seq"] == 7 and recs[1]["pid"] == os.getpid()
    # a torn record reads as a missing peer, not a crash
    with open(rd.heartbeat_path(d, 2), "w") as f:
        f.write('{"process": 2, "se')
    assert set(rd.read_heartbeats(d)) == {0, 1}
    # the records are the JAX package's: each package reads the other's
    assert ref_rd.read_heartbeats(d) == recs
    ref_rd.write_heartbeat(d, 3, 2)
    assert rd.read_heartbeats(d)[3] == ref_rd.read_heartbeats(d)[3]


def test_heartbeat_ages_and_gauge(tmp_path, run):
    d = str(tmp_path)
    rd.write_heartbeat(d, 0, 1)
    now = time.time() + 5.0
    ages = rd.heartbeat_ages(d, now=now)
    assert ages[0] == pytest.approx(5.0, abs=1.0)
    assert ages == ref_rd.heartbeat_ages(d, now=now, record_metric=False)
    gauge = run.registry.gauge("photon_dist_heartbeat_age_seconds", "").labels(process="0")
    assert gauge.value == pytest.approx(ages[0])


def test_stale_and_missing_peers_raise_typed_error(tmp_path):
    d = str(tmp_path)
    now = time.time()
    rd.write_heartbeat(d, 0, 1)
    rd.write_heartbeat(d, 1, 1)
    rd.check_peers(d, 2, stale_after_s=30.0, self_process=0, now=now)
    with pytest.raises(rd.PeerLostError, match=r"presumed lost") as ours:
        rd.check_peers(d, 3, 5.0, self_process=0, now=now + 60.0)
    assert "p2=never" in str(ours.value) and "[1, 2]" in str(ours.value)
    with pytest.raises(ref_rd.PeerLostError) as theirs:
        ref_rd.check_peers(d, 3, 5.0, self_process=0, now=now + 60.0)
    assert str(ours.value) == str(theirs.value)


def test_heartbeat_fault_site_fires(tmp_path, run):
    faults.configure("dist.heartbeat:io:1")
    with pytest.raises(InjectedIOError):
        rd.write_heartbeat(str(tmp_path), 0, 1)
    assert counter_value(run, "photon_faults_injected_total", site="dist.heartbeat", kind="io") == 1


def test_heartbeat_writer_beats_and_swallows_transient_io(tmp_path, run):
    d = str(tmp_path)
    w = rd.HeartbeatWriter(d, 0, interval_s=0.02).start()
    try:
        assert _wait_until(lambda: rd.read_heartbeats(d).get(0, {}).get("seq", 0) >= 3)
        # two transient write failures: swallowed and counted, then the next
        # beat repairs the record and seq keeps advancing
        faults.configure("dist.heartbeat:io:1x2")
        assert _wait_until(
            lambda: counter_value(run, "photon_swallowed_errors_total", site="dist.heartbeat") >= 2
        )
        seq_after_fault = rd.read_heartbeats(d)[0]["seq"]
        assert _wait_until(lambda: rd.read_heartbeats(d)[0]["seq"] > seq_after_fault)
    finally:
        w.stop()
    assert not w._thread.is_alive()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_heartbeat_kill_takes_down_the_writer_thread(tmp_path):
    """dist.heartbeat:kill: the process runs on but its beats stop, so its
    peers see a growing age."""
    d = str(tmp_path)
    w = rd.HeartbeatWriter(d, 1, interval_s=0.02)
    w.start()  # beat 1 lands synchronously
    faults.configure("dist.heartbeat:kill:1")
    assert _wait_until(lambda: not w._thread.is_alive())
    seq_frozen = rd.read_heartbeats(d)[1]["seq"]
    time.sleep(0.1)
    assert rd.read_heartbeats(d)[1]["seq"] == seq_frozen


def test_heartbeat_writer_rejects_bad_interval(tmp_path):
    with pytest.raises(ValueError, match="interval must be > 0"):
        rd.HeartbeatWriter(str(tmp_path), 0, interval_s=0.0)


# --------------------------------------------------------------- barriers


def test_sweep_barrier_fires_fault_site_once_per_sweep(run):
    faults.configure("dist.collective:kill:2")
    rd.sweep_barrier(0)  # sweep 1 survives
    with pytest.raises(SimulatedKill):
        rd.sweep_barrier(1)
    assert counter_value(run, "photon_faults_injected_total", site="dist.collective", kind="kill") == 1


def test_barrier_delay_fault_holds_the_process(run):
    faults.configure("dist.collective:delay80:1")
    t0 = time.perf_counter()
    rd.sweep_barrier(0)
    assert time.perf_counter() - t0 >= 0.06


def test_configure_collectives_arm_and_disarm():
    assert rd.collective_timeout() is None
    rd.configure_collectives(12.5, run_dir="/tmp/x", stale_after_s=3.0)
    assert rd.collective_timeout() == 12.5
    rd.configure_collectives(0)  # <= 0 disarms
    assert rd.collective_timeout() is None


class _FakeClient:
    """Stands in for the monitored-barrier client (the JAX tests' stand-in
    for its coordination service)."""

    def __init__(self, error=None):
        self.error = error
        self.calls = []

    def wait_at_barrier(self, barrier_id, timeout_in_ms):
        self.calls.append((barrier_id, timeout_in_ms))
        if self.error is not None:
            raise self.error


def _fake_two_process(monkeypatch, client):
    monkeypatch.setattr(rd, "_process_count", lambda: 2)
    monkeypatch.setattr(rd, "_barrier_client", lambda: client)


def test_barrier_ids_are_spmd_ordered_per_name(monkeypatch):
    client = _FakeClient()
    _fake_two_process(monkeypatch, client)
    rd.configure_collectives(5.0)
    rd.sweep_barrier(0)
    rd.sweep_barrier(1)
    rd.guard_collective("allgather_object")
    rd.sweep_barrier(1)  # same name again -> next sequence number
    assert [c[0] for c in client.calls] == [
        "photon:cd.sweep.0:1",
        "photon:cd.sweep.1:1",
        "photon:pre:allgather_object:1",
        "photon:cd.sweep.1:2",
    ]
    assert all(ms == 5000 for _, ms in client.calls)


def test_guard_collective_is_noop_unarmed(monkeypatch):
    client = _FakeClient()
    _fake_two_process(monkeypatch, client)
    rd.guard_collective("allgather_object")
    assert client.calls == []


@pytest.mark.parametrize("error", [
    "DEADLINE_EXCEEDED: barrier timed out",
    "[Rank 0]: Ranks 1 failed to pass monitoredBarrier in 250 ms",
])
def test_barrier_deadline_translates_to_typed_timeout(monkeypatch, tmp_path, run, error):
    d = str(tmp_path)
    rd.write_heartbeat(d, 0, 1)  # peer 1 never beats -> named in the error
    client = _FakeClient(error=RuntimeError(error))
    _fake_two_process(monkeypatch, client)
    rd.configure_collectives(0.25, run_dir=d, stale_after_s=5.0)
    with pytest.raises(rd.DistributedTimeoutError) as ei:
        rd.sweep_barrier(3)
    msg = str(ei.value)
    assert "a peer process never arrived" in msg
    assert "budget 0.2s" in msg or "budget 0.3s" in msg
    assert "heartbeat-stale peers: [1]" in msg
    if "monitoredBarrier" in error:
        assert "peers that never arrived: [1]" in msg
    assert counter_value(run, "photon_dist_collective_timeouts_total", barrier="cd.sweep.3") == 1
    assert isinstance(ei.value, rd.DistributedError)


@pytest.mark.parametrize("error", [
    "UNAVAILABLE: connection to peer task closed",
    "Connection closed by peer [127.0.0.1]:41234",
])
def test_barrier_peer_abort_also_translates(monkeypatch, error):
    client = _FakeClient(error=RuntimeError(error))
    _fake_two_process(monkeypatch, client)
    rd.configure_collectives(5.0)
    with pytest.raises(rd.DistributedTimeoutError):
        rd.sweep_barrier(0)


def test_barrier_unrelated_error_is_not_translated(monkeypatch):
    client = _FakeClient(error=RuntimeError("PERMISSION_DENIED: bad token"))
    _fake_two_process(monkeypatch, client)
    rd.configure_collectives(5.0)
    with pytest.raises(RuntimeError, match="PERMISSION_DENIED"):
        rd.sweep_barrier(0)


def test_barrier_unarmed_multiprocess_is_blocking_shape(monkeypatch):
    client = _FakeClient()
    _fake_two_process(monkeypatch, client)
    rd.sweep_barrier(0)
    assert client.calls == []


# ------------------------------------- two-phase topology-aware checkpoints


class _State:
    """A minimal CDBoundaryState (tests/test_distributed.py's)."""

    def __init__(self, iteration=0, summed_scores=None):
        self.iteration = iteration
        self.coordinate_index = 0
        self.coordinate = "global"
        self.coordinate_order = ("global",)
        self.n_iterations = 3
        self.models = {"global": np.arange(3.0)}
        self.summed_scores = np.ones(4) if summed_scores is None else summed_scores
        self.best_eval = None
        self.best_models = {}
        self.evaluations = []
        self.trackers = {}
        self.train_losses = {}


class _FakeExchange:
    """Sequential stand-in for the confirmation allgather: the last caller
    (the coordinator here) sees every confirmation."""

    def __init__(self):
        self.confirms = []

    def __call__(self, confirm):
        self.confirms.append(confirm)
        return list(self.confirms)

    def reset(self):
        self.confirms = []


_TOPOLOGY = {"mesh_axes": {"data": 8, "model": 1}, "plan_fingerprint": "fp-aaaa"}


def _pair(tmp_path, exchange, cls=CheckpointManager):
    mgrs = [
        cls(str(tmp_path), fsync=False, process=i, n_processes=2, topology=dict(_TOPOLOGY), exchange=exchange)
        for i in range(2)
    ]
    return mgrs[0], mgrs[1]


def _save_step(mgr0, mgr1, exchange, iteration):
    exchange.reset()
    # local row shards: p0 owns [it*10 .. it*10+4), p1 the next 4 rows
    base = float(iteration * 10)
    s1 = mgr1.save(_State(iteration, np.arange(4.0) + base + 4.0))
    s0 = mgr0.save(_State(iteration, np.arange(4.0) + base))
    assert s0 == s1  # sequence numbers agree across processes
    return s0


def test_two_phase_save_commits_shards_and_topology(tmp_path, run):
    ex = _FakeExchange()
    mgr0, mgr1 = _pair(tmp_path / "port", ex)
    ckpt = _save_step(mgr0, mgr1, ex, iteration=0)
    port_confirms = list(ex.confirms)
    assert sorted(os.listdir(ckpt)) == ["MANIFEST.json", "shard-p0.pkl", "shard-p1.pkl", "state.pkl"]
    with open(os.path.join(ckpt, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert [s["process"] for s in manifest["shards"]] == [0, 1]
    assert manifest["topology"] == {**_TOPOLOGY, "n_processes": 2, "global_rows": 8}
    snap = CheckpointManager(str(tmp_path / "port")).latest_valid()
    np.testing.assert_array_equal(snap.summed_scores, np.arange(8.0))
    assert counter_value(run, "photon_checkpoint_saves_total") == 1
    # the JAX package's save of the same states: the same shard pickles,
    # so the same confirmations (digests included) and the same topology
    ref_ex = _FakeExchange()
    r0, r1 = _pair(tmp_path / "ref", ref_ex, cls=RefCheckpointManager)
    ref_ckpt = _save_step(r0, r1, ref_ex, iteration=0)
    assert ref_ex.confirms == port_confirms
    with open(os.path.join(ref_ckpt, "MANIFEST.json")) as f:
        assert json.load(f)["topology"] == manifest["topology"]


def test_two_phase_torn_before_coordinator_phase_falls_back(tmp_path, run):
    ex = _FakeExchange()
    mgr0, mgr1 = _pair(tmp_path, ex)
    _save_step(mgr0, mgr1, ex, iteration=0)
    ex.reset()
    faults.configure("dist.commit:io:2")
    mgr1.save(_State(1, np.arange(4.0) + 14.0))  # call 1: p1's shard lands
    with pytest.raises(InjectedIOError):
        mgr0.save(_State(1, np.arange(4.0) + 10.0))  # call 2: p0 dies
    torn = os.path.join(str(tmp_path), "ckpt-000001")
    assert os.path.exists(os.path.join(torn, "shard-p1.pkl"))
    assert not os.path.exists(os.path.join(torn, "MANIFEST.json"))
    snap = CheckpointManager(str(tmp_path)).latest_valid()
    assert snap.iteration == 0
    np.testing.assert_array_equal(snap.summed_scores, np.arange(8.0))
    assert counter_value(run, "photon_checkpoint_skipped_total", reason="corrupt") == 1


def test_two_phase_killed_at_commit_point_falls_back(tmp_path, run):
    ex = _FakeExchange()
    mgr0, mgr1 = _pair(tmp_path, ex)
    _save_step(mgr0, mgr1, ex, iteration=0)
    ex.reset()
    faults.configure("dist.commit:kill:3")  # p1 phase-1, p0 phase-1, COMMIT
    mgr1.save(_State(1, np.arange(4.0) + 14.0))
    with pytest.raises(SimulatedKill):
        mgr0.save(_State(1, np.arange(4.0) + 10.0))
    torn = os.path.join(str(tmp_path), "ckpt-000001")
    assert os.path.exists(os.path.join(torn, "state.pkl"))
    assert os.path.exists(os.path.join(torn, "shard-p0.pkl"))
    assert not os.path.exists(os.path.join(torn, "MANIFEST.json"))
    assert CheckpointManager(str(tmp_path)).latest_valid().iteration == 0


def test_two_phase_corrupt_shard_digest_falls_back(tmp_path, run):
    ex = _FakeExchange()
    mgr0, mgr1 = _pair(tmp_path, ex)
    _save_step(mgr0, mgr1, ex, iteration=0)
    ckpt1 = _save_step(mgr0, mgr1, ex, iteration=1)
    shard = os.path.join(ckpt1, "shard-p1.pkl")
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    assert CheckpointManager(str(tmp_path)).latest_valid().iteration == 0
    assert counter_value(run, "photon_checkpoint_skipped_total", reason="corrupt") == 1


def test_restore_topology_same_reshape_and_refusals(tmp_path, run):
    ex = _FakeExchange()
    mgr0, mgr1 = _pair(tmp_path, ex)
    _save_step(mgr0, mgr1, ex, iteration=0)
    reader = CheckpointManager(str(tmp_path))
    same = {**_TOPOLOGY, "n_processes": 2, "global_rows": 8}
    assert reader.latest_valid(expect_topology=same).iteration == 0
    reshaped = {**_TOPOLOGY, "n_processes": 1, "global_rows": 8}
    np.testing.assert_array_equal(reader.latest_valid(expect_topology=reshaped).summed_scores, np.arange(8.0))
    with pytest.raises(CheckpointIncompatibleError, match="the process count changed and no legal reshape exists"):
        reader.latest_valid(expect_topology={**_TOPOLOGY, "n_processes": 4, "global_rows": 12})
    with pytest.raises(CheckpointIncompatibleError, match="mesh reshape across the model axis is not supported"):
        reader.latest_valid(expect_topology={
            "mesh_axes": {"data": 4, "model": 2}, "plan_fingerprint": "fp-aaaa", "n_processes": 2, "global_rows": 8,
        })
    with pytest.raises(CheckpointIncompatibleError, match="changed execution plan is not supported"):
        reader.latest_valid(expect_topology={**_TOPOLOGY, "plan_fingerprint": "fp-bbbb", "n_processes": 2,
                                             "global_rows": 8})


def test_manager_validates_process_arguments(tmp_path):
    with pytest.raises(ValueError, match="n_processes must be >= 1"):
        CheckpointManager(str(tmp_path), n_processes=0)
    with pytest.raises(ValueError, match="process must be in"):
        CheckpointManager(str(tmp_path), process=2, n_processes=2)


# --------------------------------------------- planner topology unit checks


@pytest.mark.parametrize("saved,current", [
    ({}, {"n_processes": 4, "global_rows": 9}),
    ({"n_processes": 2}, {}),
    ({"n_processes": 2, "global_rows": 8}, {"n_processes": 2, "global_rows": 10}),
    ({"n_processes": 2, "global_rows": 8, "mesh_axes": {"data": 8}},
     {"n_processes": 4, "global_rows": 8, "mesh_axes": {"data": 8}}),
])
def test_check_checkpoint_topology_accepts_what_the_jax_package_accepts(saved, current):
    planner.check_checkpoint_topology(saved, current)
    ref_planner.check_checkpoint_topology(saved, current)


def test_check_checkpoint_topology_refuses_row_mismatch():
    args = ({"n_processes": 2, "global_rows": 8}, {"n_processes": 3, "global_rows": 9})
    with pytest.raises(PlanError, match="the process count changed and no legal reshape exists") as ours:
        planner.check_checkpoint_topology(*args)
    with pytest.raises(RefPlanError) as theirs:
        ref_planner.check_checkpoint_topology(*args)
    assert str(ours.value) == str(theirs.value)


def test_plan_fingerprint_is_topology_independent():
    """The fingerprint pins what the model is, never where it runs: a legal
    process reshape keeps it, a changed layout does not; equal to the JAX
    package's for the same plan."""
    import dataclasses as dc

    @dc.dataclass
    class _Reg:
        reg_type: str = "L2"

    @dc.dataclass
    class _Cfg:
        variance_type: str = "NONE"
        down_sampling_rate: float = 1.0
        regularization: _Reg = dc.field(default_factory=_Reg)

    @dc.dataclass
    class _CC:
        name: str = "c0"
        feature_shard: str = "global"
        layout: str = "auto"
        feature_dtype: object = None
        hbm_budget_mb: object = None
        is_random_effect: bool = False
        config: _Cfg = dc.field(default_factory=_Cfg)
        normalization: object = None
        regularize_by_prior: bool = False

    def _fp(mod, layout="auto", mesh=None, n_processes=1):
        plan = mod.resolve([_CC(layout=layout)], mesh=mesh, n_processes=n_processes, distributed=n_processes > 1)
        return mod.plan_fingerprint(plan)

    fp = _fp(planner)
    assert fp == _fp(planner) and len(fp) == 16
    assert _fp(planner, mesh={"data": 2, "model": 1}, n_processes=2) == fp == _fp(planner, n_processes=2)
    assert _fp(planner, layout="dense") != fp
    assert fp == _fp(ref_planner, mesh={"data": 8, "model": 1})


# ------------------------------------------------------ CLI resume refusal


def _cli_common(data, ckpt):
    return [
        "--input-data", data, "--task", "logistic_regression", "--feature-shard", "name=global,bags=features",
        "--coordinate", "name=global,shard=global,optimizer=LBFGS,tolerance=1e-8,max.iter=30,reg.type=L2,reg.weights=1",
        "--coordinate-descent-iterations", "2", "--checkpoint-dir", ckpt, "--checkpoint-every", "1",
    ]


def test_cli_resume_refuses_unsound_process_count_change(tmp_path):
    data = write_logistic_avro(tmp_path / "train.avro", n=64, d=4, seed=5)
    ckpt = str(tmp_path / "ckpt")
    common = _cli_common(data, ckpt) + ["--device", "cpu"]
    train.run(common + ["--output-dir", str(tmp_path / "out1")])
    manifests = sorted(glob.glob(os.path.join(ckpt, "cd-boundaries", "ckpt-*", "MANIFEST.json")))
    assert manifests
    with open(manifests[-1]) as f:
        manifest = json.load(f)
    assert manifest["topology"]["n_processes"] == 1
    manifest["topology"]["n_processes"] = 2
    manifest["topology"]["global_rows"] = 999_999
    with open(manifests[-1], "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointIncompatibleError, match="the process count changed and no legal reshape exists"):
        train.run(common + ["--resume", "--output-dir", str(tmp_path / "out2")])


def test_cli_distributed_flags_parse():
    from photon_ml_tpu.cli.train import build_parser as ref_build_parser

    flags = ["--input-data", "in", "--output-dir", "out", "--collective-timeout", "30",
             "--heartbeat-interval", "0.5", "--heartbeat-timeout", "7", "--mesh-shape", "data=2",
             "--distributed", "coordinator=h:1,process=0,n=2"]
    for argv in (flags, ["--input-data", "i", "--output-dir", "o"]):
        ours, theirs = train.build_parser().parse_args(argv), ref_build_parser().parse_args(argv)
        for key in ("collective_timeout", "heartbeat_interval", "heartbeat_timeout", "mesh_shape", "distributed"):
            assert getattr(ours, key) == getattr(theirs, key), key
    args = train.build_parser().parse_args(flags)
    assert (args.collective_timeout, args.heartbeat_interval, args.heartbeat_timeout) == (30.0, 0.5, 7.0)


# ------------------------------------------------- the kill-a-worker drill

DRILL_BUDGET_S = 10.0


def _drill_argv(data, index_dir, ckpt, out, metrics):
    return [
        "--input-data", data, "--feature-shard", "name=global,bags=features", "--task", "logistic_regression",
        "--coordinate", "name=global,shard=global,optimizer=LBFGS,tolerance=1e-13,max.iter=400,reg.type=L2,"
        "reg.weights=1",
        "--coordinate-descent-iterations", "3", "--feature-index-dir", index_dir, "--checkpoint-dir", ckpt,
        "--checkpoint-every", "1", "--collective-timeout", str(DRILL_BUDGET_S), "--heartbeat-interval", "0.5",
        "--heartbeat-timeout", "3", "--output-dir", out, "--device", "cpu", "--dtype", "float64",
        "--metrics-out", metrics,
    ]


def test_kill_a_worker_drill(tmp_path):
    data = write_logistic_avro(tmp_path / "train.avro", n=320, d=6, seed=7)
    index_dir = build_index(data, ["--feature-shard", "name=global,bags=features"], tmp_path / "index")

    def round_(name, ckpt, out, extra=(), env_by_rank=None):
        return launch("train", _drill_argv(data, index_dir, str(tmp_path / ckpt), str(tmp_path / out),
                                           str(tmp_path / name)) + list(extra), env_by_rank=env_by_rank)

    assert_ok(round_("ref", "ckpt-ref", "out-ref"))
    t0 = time.monotonic()
    (rc0, out0, err0), (rc1, out1, err1) = round_(
        "drill", "ckpt-drill", "out-drill", env_by_rank={1: {"PHOTON_FAULTS": "dist.collective:kill:2"}})
    wall = time.monotonic() - t0
    assert rc1 != 0 and "SimulatedKill" in err1, err1[-3000:]
    # the survivor's failure is typed, names the dead peer and is bounded
    assert rc0 == 70, err0[-3000:]
    assert "DistributedTimeoutError" in err0 or "PeerLostError" in err0, err0[-3000:]
    assert "a peer process never arrived" in err0 and "[1]" in err0, err0[-3000:]
    assert wall < 60 + DRILL_BUDGET_S + 5, f"detection not bounded: {wall:.0f}s"
    dumps = glob.glob(str(tmp_path / "drill" / "flight" / "flight-peer_lost-*.json"))
    assert dumps, "no peer_lost flight-recorder dump on the survivor"
    with open(dumps[0]) as f:
        assert json.load(f)["trigger"]["kind"] == "peer_lost"
    manifests = sorted(glob.glob(str(tmp_path / "ckpt-drill" / "cd-boundaries" / "ckpt-*" / "MANIFEST.json")))
    assert manifests, "no committed checkpoint before the kill"
    with open(manifests[-1]) as f:
        manifest = json.load(f)
    assert manifest["topology"]["n_processes"] == 2 and len(manifest["shards"]) == 2

    outs = round_("resume", "ckpt-drill", "out-drill", extra=("--resume",))
    assert_ok(outs)
    assert "resuming from checkpoint" in outs[0][2]

    maps = {"global": load_partitioned(index_dir, "global")}

    def means(out):
        m = load_game_model(str(tmp_path / out / "models" / "best"), maps, task="logistic_regression", device="cpu")
        return m.models["global"].model.coefficients.means.numpy()

    w_ref = means("out-ref")
    np.testing.assert_allclose(means("out-drill"), w_ref, rtol=1e-9, atol=1e-9)

    # the uninterrupted two-rank run against the JAX package's one process
    jax_out = str(tmp_path / "jax")
    ref_train.run([
        "--input-data", data, "--feature-shard", "name=global,bags=features", "--task", "logistic_regression",
        "--coordinate", "name=global,shard=global,optimizer=LBFGS,tolerance=1e-13,max.iter=400,reg.type=L2,"
        "reg.weights=1", "--coordinate-descent-iterations", "3", "--feature-index-dir", index_dir,
        "--output-dir", jax_out,
    ])
    ref_maps = {"global": ref_load_partitioned(index_dir, "global")}
    w_jax = np.asarray(ref_load_game_model(os.path.join(jax_out, "models", "best"), ref_maps,
                                           task="logistic_regression").models["global"].coefficients.means)
    np.testing.assert_allclose(w_ref, w_jax, rtol=1e-3, atol=1e-5)
