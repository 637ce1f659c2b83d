"""The port's fault tolerance (``photon_ml_tpu_torch.robust``), held against
the JAX package's (``photon_ml_tpu.robust``) where the two compute the same
thing: the fault grammar and the injectors' schedules (same specs and seeds,
same firings), then the port's checkpoint manager (round trip, rotation,
corrupt-newest fallback, incompatible configurations, payloads with no
device tensors) and its headline guarantee: a coordinate descent killed at
any coordinate-update boundary and resumed from its checkpoint reproduces
the straight run bit for bit, across a rejected update and with flaky
checkpoint IO. The divergence guard's cases of tests/test_robust.py run
through the port as well."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from photon_ml_tpu.robust import faults as ref_faults
from photon_ml_tpu.robust import parse_faults as ref_parse_faults
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
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import ConvergenceReason, OptimizerConfig, OptimizerType
from photon_ml_tpu_torch.robust import (
    CheckpointIncompatibleError,
    CheckpointManager,
    FaultSpec,
    InjectedIOError,
    SimulatedKill,
    faults,
    io_call,
    parse_faults,
)
from photon_ml_tpu_torch.robust.checkpoint import MANIFEST_NAME, PAYLOAD_NAME, to_device
from photon_ml_tpu_torch.testing import generate_mixed_effect_data
from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.clear()
    ref_faults.clear()


@pytest.fixture
def run():
    """Fresh telemetry scope so counter assertions see only this test."""
    r = obs.RunTelemetry()
    with obs.use_run(r):
        yield r


def counter_value(run, name, **labels):
    return run.registry.counter(name, "").labels(**labels).value


# ---------------------------------------------------------------- faults


@pytest.mark.parametrize("spec", [
    "a.b:io:3, c.d:kill:2x4, e.f:io:p0.25",
    "solver.value_and_grad:nan:3, coordinate.scores:nan:p0.5",
    "serving.score:delay:p0.5, x.y:delay200:2",
])
def test_parse_faults_matches_the_reference(spec):
    ours = [dataclasses.asdict(s) for s in parse_faults(spec)]
    assert ours == [dataclasses.asdict(s) for s in ref_parse_faults(spec)]


def test_parse_faults_grammar():
    specs = parse_faults("a.b:io:3, c.d:kill:2x4, e.f:io:p0.25")
    assert specs[0] == FaultSpec(site="a.b", kind="io", at=3)
    assert specs[1] == FaultSpec(site="c.d", kind="kill", at=2, times=4)
    assert specs[2].prob == 0.25
    with pytest.raises(ValueError, match="SITE:KIND:WHEN"):
        parse_faults("just-a-site")
    with pytest.raises(ValueError, match="nan"):
        parse_faults("a:explode:1")


def _schedule(mod, spec, seed, calls=60, site="s"):
    mod.configure(spec, seed=seed)
    fired = []
    for _ in range(calls):
        try:
            mod.check(site)
            fired.append(None)
        except mod.InjectedIOError:
            fired.append("io")
        except mod.SimulatedKill:
            fired.append("kill")
    return fired


@pytest.mark.parametrize("spec,seed", [
    ("s:io:p0.3", 7), ("s:io:p0.3", 8), ("s:kill:p0.1", 3), ("s:io:2x3", 0), ("s:kill:5", 0),
    ("s:io:p0.3, t:io:p0.9", 11),
])
def test_injector_schedules_match_the_reference(spec, seed):
    ours = _schedule(faults, spec, seed)
    assert ours == _schedule(ref_faults, spec, seed)
    assert any(ours)


def test_probability_schedule_is_seed_deterministic():
    assert _schedule(faults, "s:io:p0.3", 7) == _schedule(faults, "s:io:p0.3", 7)
    assert _schedule(faults, "s:io:p0.3", 7) != _schedule(faults, "s:io:p0.3", 8)


def test_injector_fires_on_exact_call_index_and_check_is_noop_when_off():
    faults.clear()
    assert not faults.active()
    faults.check("anything.at.all")
    inj = faults.configure("s:io:2")
    faults.check("s")
    with pytest.raises(InjectedIOError):
        faults.check("s")
    faults.check("s")
    assert inj.calls("s") == 3
    faults.check("other.site")


def test_kill_is_not_an_exception():
    faults.configure("s:kill:1")
    with pytest.raises(SimulatedKill) as exc_info:
        faults.check("s")
    assert not isinstance(exc_info.value, Exception)


def test_corrupt_plants_nan_on_exact_call_only(run):
    faults.configure("s:nan:2")
    x = np.arange(4.0)
    assert faults.corrupt("s", x) is x
    out = faults.corrupt("s", x)
    assert np.isnan(out[0]) and np.all(out[1:] == x[1:])
    assert not np.isnan(x).any()  # copied, never mutated in place
    assert faults.corrupt("s", x) is x
    assert counter_value(run, "photon_faults_injected_total", site="s", kind="nan") == 1


def test_corrupt_walks_tensors_and_trees_and_skips_non_float():
    faults.configure("s:nan:1")
    t = torch.ones((2, 3))
    tree = {"f": t, "i": np.arange(3), "ti": torch.arange(3), "empty": np.zeros(0), "l": [torch.ones(2)]}
    out = faults.corrupt("s", tree)
    assert torch.isnan(out["f"].reshape(-1)[0]) and torch.isfinite(out["f"].reshape(-1)[1:]).all()
    assert out["f"].shape == (2, 3) and torch.isfinite(t).all()  # the input tensor is untouched
    assert out["i"] is tree["i"] and out["ti"] is tree["ti"] and out["empty"] is tree["empty"]
    assert torch.isnan(out["l"][0][0])
    # the same element as the JAX package's planting, on the same input
    ref_faults.configure("s:nan:1")
    ref = ref_faults.corrupt("s", {"f": np.ones((2, 3))})
    np.testing.assert_array_equal(np.isnan(ref["f"]), torch.isnan(out["f"]).numpy())


def test_nan_spec_never_raises_at_check_sites_and_io_kill_raise_at_corrupt():
    faults.configure("s:nan:1")
    faults.check("s")
    faults.configure("s:io:1")
    with pytest.raises(InjectedIOError):
        faults.corrupt("s", torch.ones(2))
    faults.configure("s:kill:1")
    with pytest.raises(SimulatedKill):
        faults.corrupt("s", torch.ones(2))
    faults.clear()
    x = torch.ones(3)
    assert faults.corrupt("anything", x) is x


def test_install_from_env_installs_and_clears():
    inj = faults.install_from_env({"PHOTON_FAULTS": "s:io:1", "PHOTON_FAULTS_SEED": "4"})
    assert inj is not None and faults.active() and inj.seed == 4
    assert faults.install_from_env({}) is None
    assert not faults.active()


def test_io_call_retries_injected_transients(run):
    faults.configure("site.x:io:1x2")
    assert io_call(lambda: "ok", site="site.x") == "ok"
    assert counter_value(run, "photon_retry_attempts_total", site="site.x") == 2
    assert counter_value(run, "photon_faults_injected_total", site="site.x", kind="io") == 2
    faults.configure("site.y:io:1x5")
    with pytest.raises(InjectedIOError):
        io_call(lambda: "ok", site="site.y")


def test_io_call_never_retries_a_kill():
    calls = []

    def killed():
        calls.append(1)
        raise SimulatedKill("like SIGKILL")

    with pytest.raises(SimulatedKill):
        io_call(killed, site="t")
    assert len(calls) == 1


def test_fault_site_list_names_every_site_in_the_sources():
    """robust/fault_sites.json lists every literal site the port's sources
    check, corrupt or retry, with the modules that hold it."""
    import json
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    pkg = root / "photon_ml_tpu_torch"
    found = {}
    pattern = re.compile(r'(?:faults\.(?:check|corrupt)\(\s*|site=)"([a-z_.]+)"')
    for path in sorted(pkg.rglob("*.py")):
        for site in pattern.findall(path.read_text()):
            found.setdefault(site, set()).add(str(path.relative_to(root)))
    listed = json.loads((pkg / "robust" / "fault_sites.json").read_text())
    assert {s["site"]: set(s["modules"]) for s in listed["sites"]} == found


# ---------------------------------------------------------------- checkpoint


@dataclasses.dataclass
class _State:
    """Minimal stand-in for descent's CDBoundaryState."""

    iteration: int = 0
    coordinate_index: int = 0
    coordinate: str = "global"
    coordinate_order: tuple = ("global", "per-user")
    n_iterations: int = 2
    models: dict = dataclasses.field(default_factory=lambda: {"global": torch.arange(3.0)})
    summed_scores: object = dataclasses.field(default_factory=lambda: torch.ones(4, dtype=torch.float64))
    best_eval: object = None
    best_models: dict = dataclasses.field(default_factory=dict)
    evaluations: list = dataclasses.field(default_factory=list)
    trackers: dict = dataclasses.field(default_factory=dict)


def _corrupt(ckpt_dir, what="truncate"):
    payload = os.path.join(ckpt_dir, PAYLOAD_NAME)
    if what == "truncate":
        with open(payload, "r+b") as f:
            f.truncate(max(os.path.getsize(payload) // 2, 1))
    elif what == "flip":
        with open(payload, "r+b") as f:
            first = f.read(1)
            f.seek(0)
            f.write(bytes([first[0] ^ 0xFF]))
    elif what == "manifest":
        with open(os.path.join(ckpt_dir, MANIFEST_NAME), "w") as f:
            f.write('{"version": 1, "torn')


def test_checkpoint_roundtrip(tmp_path, run):
    mgr = CheckpointManager(str(tmp_path), fsync=False)
    mgr.save(_State(iteration=1, coordinate_index=1, coordinate="per-user"), meta={"combo_index": 3})
    snap = mgr.latest_valid(expect_coordinate_order=["global", "per-user"], expect_n_iterations=2)
    assert snap.iteration == 1 and snap.coordinate_index == 1 and snap.coordinate == "per-user"
    assert snap.summed_scores.dtype == torch.float64  # round-trips in its own dtype
    assert torch.equal(snap.summed_scores, torch.ones(4, dtype=torch.float64))
    assert torch.equal(snap.models["global"], torch.arange(3.0))
    assert snap.manifest["combo_index"] == 3
    assert snap.manifest["topology"] == {"n_processes": 1, "global_rows": 4}
    assert counter_value(run, "photon_checkpoint_saves_total") == 1
    assert counter_value(run, "photon_checkpoint_restore_total") == 1
    assert counter_value(run, "photon_checkpoint_bytes_total") > 0


def test_checkpoint_every_n_boundaries(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=3, fsync=False)
    saved = [mgr.on_boundary(_State()) for _ in range(7)]
    assert [s is not None for s in saved] == [False, False, True] * 2 + [False]
    assert len(mgr.checkpoints()) == 2


def test_checkpoint_rotation_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, fsync=False)
    for i in range(5):
        mgr.save(_State(iteration=i))
    assert [os.path.basename(p) for p in mgr.checkpoints()] == ["ckpt-000003", "ckpt-000004"]
    assert mgr.latest_valid().iteration == 4


def test_checkpoint_sequence_survives_manager_restart(tmp_path):
    CheckpointManager(str(tmp_path), fsync=False).save(_State(iteration=0))
    CheckpointManager(str(tmp_path), fsync=False).save(_State(iteration=1))
    names = [os.path.basename(p) for p in CheckpointManager(str(tmp_path)).checkpoints()]
    assert names == ["ckpt-000000", "ckpt-000001"]


@pytest.mark.parametrize("what", ["truncate", "flip", "manifest"])
def test_corrupt_newest_falls_back_to_older(tmp_path, run, what):
    mgr = CheckpointManager(str(tmp_path), fsync=False)
    mgr.save(_State(iteration=0))
    mgr.save(_State(iteration=1))
    _corrupt(mgr.checkpoints()[-1], what)
    assert mgr.latest_valid().iteration == 0
    assert counter_value(run, "photon_checkpoint_skipped_total", reason="corrupt") == 1


def test_all_corrupt_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), fsync=False)
    mgr.save(_State())
    _corrupt(mgr.checkpoints()[0])
    assert mgr.latest_valid() is None
    assert CheckpointManager(str(tmp_path / "empty")).latest_valid() is None


def test_incompatible_config_rejected_not_half_loaded(tmp_path):
    mgr = CheckpointManager(str(tmp_path), fsync=False, topology={"plan_fingerprint": "aaaa"})
    mgr.save(_State())
    with pytest.raises(CheckpointIncompatibleError, match="refusing to resume"):
        mgr.latest_valid(expect_coordinate_order=["global", "per-item"])
    with pytest.raises(CheckpointIncompatibleError, match="iterations"):
        mgr.latest_valid(expect_coordinate_order=["global", "per-user"], expect_n_iterations=5)
    with pytest.raises(CheckpointIncompatibleError, match="plan fingerprint"):
        mgr.latest_valid(expect_topology={"plan_fingerprint": "bbbb", "n_processes": 1})
    assert mgr.latest_valid(expect_topology={"plan_fingerprint": "aaaa", "n_processes": 1}) is not None


def test_incompatible_beats_stale_compatible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), fsync=False)
    mgr.save(_State(coordinate_order=("global", "per-user")))
    mgr.save(_State(coordinate_order=("global", "per-user", "per-item")))
    with pytest.raises(CheckpointIncompatibleError):
        mgr.latest_valid(expect_coordinate_order=["global", "per-user"])


def test_checkpoint_manager_validation(tmp_path):
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep_last=0)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), every=0)
    with pytest.raises(NotImplementedError, match="A10"):
        CheckpointManager(str(tmp_path), n_processes=2)


def test_save_survives_transient_write_faults(tmp_path, run):
    faults.configure("checkpoint.write:io:1x2")
    mgr = CheckpointManager(str(tmp_path), fsync=False)
    mgr.save(_State())
    assert mgr.latest_valid().iteration == 0
    assert counter_value(run, "photon_retry_attempts_total", site="checkpoint.write") == 2


# -------------------------------------------------- kill-and-resume (CD)


def _cfg(l2=1.0):
    return GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType.LBFGS, tolerance=1e-9, max_iterations=100),
        regularization=RegularizationContext("L2"),
        reg_weight=l2,
    )


@pytest.fixture(scope="module")
def cd_factory():
    data = generate_mixed_effect_data(n=400, d_fixed=5, re_specs={"userId": (12, 3)}, seed=3)
    raw = mixed_data_to_raw_dataset(data)

    def make(dtype=torch.float64):
        fe_ds = build_fixed_effect_dataset(raw, "global", "global", dtype=dtype, device="cpu")
        re_ds = build_random_effect_dataset(raw, "per-user", "userShard", "userId", dtype=dtype, device="cpu")
        coords = {
            "global": FixedEffectCoordinate(dataset=fe_ds, task="logistic_regression", config=_cfg()),
            "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression", config=_cfg()),
        }
        validation = ValidationContext(
            suite=build_suite(["LOGISTIC_LOSS"], raw.labels),
            score_fns={n: coords[n].score for n in coords},
            offsets=raw.offsets,
        )
        return coords, validation

    return make


def _model_tensors(model):
    fe, re_model = model["global"], model["per-user"]
    return [fe.model.coefficients.means, re_model.coef_indices, re_model.coef_values]


def _assert_bitwise(ref, resumed):
    """The resumed run equals the straight one bit for bit: the evaluation
    ledger, the best evaluation, and every model tensor."""
    assert [(n, r.metrics) for n, r in ref.evaluations] == [(n, r.metrics) for n, r in resumed.evaluations]
    assert ref.best_evaluation == resumed.best_evaluation
    for a, b in zip(_model_tensors(ref.model), _model_tensors(resumed.model)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _kill_and_resume(cd_factory, tmp_path, spec, n_iterations=2, dtype=torch.float64):
    ckpt_dir = str(tmp_path)
    coords, val = cd_factory(dtype)
    mgr = CheckpointManager(ckpt_dir, fsync=False)
    faults.configure(spec)
    with pytest.raises(SimulatedKill):
        CoordinateDescent(coords, n_iterations=n_iterations, validation=val, boundary_fn=mgr.on_boundary).run()
    faults.clear()
    # "new process": a fresh manager over the same directory, fresh coordinates
    snap = CheckpointManager(ckpt_dir, fsync=False).latest_valid(
        expect_coordinate_order=list(coords), expect_n_iterations=n_iterations
    )
    coords2, val2 = cd_factory(dtype)
    return snap, CoordinateDescent(coords2, n_iterations=n_iterations, validation=val2, resume_state=snap).run()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_kill_at_every_boundary_resumes_bitwise(cd_factory, tmp_path, k, dtype):
    coords, val = cd_factory(dtype)
    ref = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    snap, resumed = _kill_and_resume(cd_factory, tmp_path, f"cd.boundary_saved:kill:{k}", dtype=dtype)
    assert (snap.iteration, snap.coordinate_index) == divmod(k - 1, 2)
    assert snap.summed_scores.dtype == dtype
    _assert_bitwise(ref, resumed)


def test_kill_before_save_resumes_from_the_previous_boundary(cd_factory, tmp_path):
    coords, val = cd_factory()
    ref = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    snap, resumed = _kill_and_resume(cd_factory, tmp_path, "cd.boundary:kill:3")
    assert (snap.iteration, snap.coordinate_index) == (0, 1)
    _assert_bitwise(ref, resumed)


def test_checkpoint_payload_holds_no_device_tensor(cd_factory, tmp_path):
    coords, val = cd_factory()
    mgr = CheckpointManager(str(tmp_path), fsync=False)
    CoordinateDescent(coords, n_iterations=1, validation=val, boundary_fn=mgr.on_boundary).run()
    with open(os.path.join(mgr.checkpoints()[-1], PAYLOAD_NAME), "rb") as f:
        payload = pickle.loads(f.read())
    seen = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            seen.append(obj.device.type)
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))

    walk(payload)
    assert seen and set(seen) == {"cpu"}
    # the meta device: the restore moves models and scores where it is told
    snap = mgr.latest_valid(device="meta")
    assert snap.summed_scores.device.type == "meta"
    assert snap.models["per-user"].coef_values.device.type == "meta"
    moved = to_device({"a": [torch.ones(2)], "b": np.ones(2)}, "meta")
    assert moved["a"][0].device.type == "meta" and isinstance(moved["b"], np.ndarray)


def test_resume_falls_back_past_corrupt_newest(cd_factory, tmp_path):
    coords, val = cd_factory()
    ref = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    coords2, val2 = cd_factory()
    mgr = CheckpointManager(str(tmp_path), keep_last=10, fsync=False)
    CoordinateDescent(coords2, n_iterations=2, validation=val2, boundary_fn=mgr.on_boundary).run()
    saved = mgr.checkpoints()
    assert len(saved) == 4  # 2 sweeps x 2 coordinates
    _corrupt(saved[-1], "truncate")
    snap = CheckpointManager(str(tmp_path), fsync=False).latest_valid(
        expect_coordinate_order=list(coords2), expect_n_iterations=2
    )
    assert (snap.iteration, snap.coordinate_index) == (1, 0)
    coords3, val3 = cd_factory()
    _assert_bitwise(ref, CoordinateDescent(coords3, n_iterations=2, validation=val3, resume_state=snap).run())


def test_training_survives_flaky_checkpoint_io(cd_factory, tmp_path, run):
    """Seeded probabilistic transient faults on the checkpoint write path:
    training completes (retry absorbs them), every boundary checkpoints, and
    the models equal the fault-free run's."""
    coords, val = cd_factory()
    ref = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    coords2, val2 = cd_factory()
    mgr = CheckpointManager(str(tmp_path), keep_last=10, fsync=False)
    # seed chosen so the deterministic schedule fires within the run's
    # writes but never 3 in a row (which would exhaust the retry budget)
    faults.configure("checkpoint.write:io:p0.3", seed=3)
    got = CoordinateDescent(coords2, n_iterations=2, validation=val2, boundary_fn=mgr.on_boundary).run()
    faults.clear()
    assert len(mgr.checkpoints()) == 4
    assert counter_value(run, "photon_retry_attempts_total", site="checkpoint.write") >= 1
    _assert_bitwise(ref, got)


def test_kill_and_resume_across_rejected_boundary(cd_factory, tmp_path, run):
    """A rejected coordinate update sits between the checkpoint and the kill:
    the resumed run makes the same accept/reject decisions (the accepted-loss
    ledger rides in the checkpoint) and reproduces the faulted straight run
    bit for bit."""
    coords, val = cd_factory()
    faults.configure("coordinate.scores:nan:2")  # it0 per-user rejected
    ref = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    faults.clear()
    assert ref.rejections == {"global": 0, "per-user": 1}
    snap, resumed = _kill_and_resume(cd_factory, tmp_path, "coordinate.scores:nan:2, cd.boundary_saved:kill:3")
    assert (snap.iteration, snap.coordinate_index) == (1, 0)
    assert "per-user" not in snap.models  # the rejected first update left no model
    _assert_bitwise(ref, resumed)


def test_kill_before_any_accepted_update_resumes(cd_factory, tmp_path):
    """The first update rejected and the kill at its boundary: the snapshot
    holds no summed scores yet, and the resumed run still equals the
    faulted straight run."""
    coords, val = cd_factory()
    faults.configure("coordinate.scores:nan:1")
    ref = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    faults.clear()
    snap, resumed = _kill_and_resume(cd_factory, tmp_path, "coordinate.scores:nan:1, cd.boundary_saved:kill:1")
    assert snap.summed_scores is None and snap.models == {}
    _assert_bitwise(ref, resumed)


# ------------------------------------------------- divergence defense (CD)


def test_coordinate_rejection_when_first_update_corrupt(cd_factory, run):
    coords, val = cd_factory()
    faults.configure("coordinate.scores:nan:1")  # it0 global
    result = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    assert counter_value(run, "photon_coordinate_rejections_total", coordinate="global") == 1
    for name in coords:
        assert torch.isfinite(coords[name].score(result.model[name])).all()


def test_coordinate_rejection_keeps_previous_model(cd_factory, run):
    coords, val = cd_factory()
    states = []
    faults.configure("coordinate.scores:nan:3")  # it1 global (call 3)
    result = CoordinateDescent(coords, n_iterations=2, validation=val, boundary_fn=states.append).run()
    assert counter_value(run, "photon_coordinate_rejections_total", coordinate="global") == 1
    assert torch.equal(coords["global"].score(result.model["global"]),
                       coords["global"].score(states[0].models["global"]))


def test_solver_nan_injection_diverges_and_rejects(cd_factory, run, tmp_path):
    run.register_listener(obs.JsonlSink(str(tmp_path / "m.jsonl")))
    coords, val = cd_factory()
    faults.configure("solver.value_and_grad:nan:1")  # it0 global FE solve
    result = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    assert counter_value(run, "photon_coordinate_rejections_total", coordinate="global") == 1
    assert counter_value(run, "photon_solver_diverged_lanes_total", solver="lbfgs") >= 1
    for name in coords:
        assert torch.isfinite(coords[name].score(result.model[name])).all()


def test_divergence_guard_off_lets_nan_poison_downstream(cd_factory, run):
    coords, val = cd_factory()
    faults.configure("coordinate.scores:nan:1")
    result = CoordinateDescent(coords, n_iterations=1, validation=None, divergence_guard=False).run()
    assert counter_value(run, "photon_coordinate_rejections_total", coordinate="global") == 0
    reasons = result.solver_results["per-user"].reason
    assert (reasons == int(ConvergenceReason.NUMERICAL_DIVERGENCE)).any()


def test_descent_refuses_pipelining_and_bad_tolerance(cd_factory):
    coords, _ = cd_factory()
    with pytest.raises(NotImplementedError, match="A7"):
        CoordinateDescent(coords, pipeline_depth=2)
    with pytest.raises(ValueError, match="rejection_tolerance"):
        CoordinateDescent(coords, rejection_tolerance=-0.5)
