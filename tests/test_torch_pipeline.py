"""Parity of the port's sweep pipelining with the JAX package, on the CPU.

The cases are tests/test_pipeline.py's: the bounded prefetch queue and the
worker pool (``utils/futures.py``, which the streamed stagers run on), the
eval lane and the depth contextvar (``game/pipeline.py``), the overlap
helpers, and depth 2 against depth 1 in coordinate descent. Each scenario
runs through both packages and the observations are held equal; the
coordinate-descent cases hold depth 2 bitwise equal to depth 1 in the port
(models, ledgers, boundary states), with resident and with streamed
coordinates, and the port's ledger against the JAX package's at rtol
1e-12 (float64). The JAX file's ``bench_diff`` case belongs to the port's
benchmark (ROADMAP A14).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import build_suite as jax_build_suite
from photon_ml_tpu.game import CoordinateDescent as JaxCD
from photon_ml_tpu.game import FixedEffectCoordinate as JaxFEC
from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game import RandomEffectCoordinate as JaxREC
from photon_ml_tpu.game import ValidationContext as JaxValidation
from photon_ml_tpu.game import build_fixed_effect_dataset as jax_build_fe
from photon_ml_tpu.game import build_random_effect_dataset as jax_build_re
from photon_ml_tpu.game import pipeline as jax_pipeline
from photon_ml_tpu.obs import interval_overlap_seconds as jax_interval_overlap
from photon_ml_tpu.obs import overlap_ratio as jax_overlap_ratio
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOptConfig
from photon_ml_tpu.optimize import OptimizerType as JaxOptType
from photon_ml_tpu.testing.generators import generate_mixed_effect_data as jax_generate
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as jax_to_raw
from photon_ml_tpu.utils import futures as jax_futures
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
    pipeline,
)
from photon_ml_tpu_torch.obs import interval_overlap_seconds, overlap_ratio
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType
from photon_ml_tpu_torch.robust import CheckpointManager, SimulatedKill, faults
from photon_ml_tpu_torch.testing.generators import generate_mixed_effect_data, mixed_data_to_raw_dataset
from photon_ml_tpu_torch.utils import futures

BOTH = (futures, jax_futures)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.clear()


@pytest.fixture
def run():
    r = obs.RunTelemetry()
    with obs.use_run(r):
        yield r


def _both(scenario):
    """``scenario(module)`` for the port's futures and the JAX package's:
    the two observations, which must agree."""
    ours, theirs = (scenario(m) for m in BOTH)
    assert ours == theirs
    return ours


# ------------------------------------------------------------ PrefetchQueue


def test_prefetch_queue_orders_and_exhausts():
    def scenario(m):
        q = m.PrefetchQueue(lambda i: i * i, count=5, depth=2)
        got = [q.get() for _ in range(5)]
        with pytest.raises(RuntimeError, match="exhausted"):
            q.get()
        q.close()
        with pytest.raises(RuntimeError, match="closed"):
            q.get()
        return got

    assert _both(scenario) == [(i, i * i) for i in range(5)]


def test_prefetch_queue_budget_bounds_inflight():
    def scenario(m):
        q = m.PrefetchQueue(lambda i: i, count=8, depth=4, cost=lambda i: 10, budget=15)
        got = [q.get()[0] for _ in range(8)]
        peak = q.peak_inflight
        q.close()
        return got, peak <= 20

    assert _both(scenario) == (list(range(8)), True)


def test_prefetch_queue_deep_when_budget_allows():
    def scenario(m):
        q = m.PrefetchQueue(lambda i: i, count=6, depth=3, cost=lambda i: 10, budget=1000)
        time.sleep(0.05)  # let the worker run ahead
        size = q.qsize()
        got = [q.get()[0] for _ in range(6)]
        q.close()
        return size, got

    assert _both(scenario) == (3, list(range(6)))


def test_prefetch_queue_cyclic_wraps():
    def scenario(m):
        q = m.PrefetchQueue(lambda i: i, count=3, depth=2, cyclic=True)
        got = [q.get()[0] for _ in range(7)]
        q.close()
        return got

    assert _both(scenario) == [0, 1, 2, 0, 1, 2, 0]


def test_prefetch_queue_reraises_producer_error_in_order():
    def scenario(m):
        def produce(i):
            if i == 2:
                raise ValueError("boom at 2")
            return i

        q = m.PrefetchQueue(produce, count=5, depth=2)
        got = [q.get(), q.get()]
        with pytest.raises(ValueError, match="boom at 2"):
            q.get()
        with pytest.raises(RuntimeError, match="closed"):
            q.get()
        return got

    assert _both(scenario) == [(0, 0), (1, 1)]


def test_prefetch_queue_validates_args():
    def scenario(m):
        messages = []
        for kw in (dict(count=1, depth=0), dict(count=0), dict(count=1, workers=0)):
            with pytest.raises(ValueError) as e:
                m.PrefetchQueue(lambda i: i, **kw)
            messages.append(str(e.value))
        return messages

    assert len(_both(scenario)) == 3


def test_worker_pool_futures_and_drain_on_close():
    def scenario(m):
        pool = m.WorkerPool(2, name="t-pool")
        futs = [pool.submit(lambda k=k: k * k) for k in range(5)]
        pool.close()  # stop accepting; already-queued tasks still drain
        got = [f.result(timeout=5) for f in futs]
        with pytest.raises(RuntimeError, match="closed"):
            pool.submit(lambda: None)

        def _boom():
            raise ValueError("pool boom")

        err_pool = m.WorkerPool(1)
        f = err_pool.submit(_boom)
        with pytest.raises(ValueError, match="pool boom"):
            f.result(timeout=5)
        err_pool.close()
        with pytest.raises(ValueError, match="pool size"):
            m.WorkerPool(0)
        return got

    assert _both(scenario) == [0, 1, 4, 9, 16]


def test_prefetch_queue_pooled_emits_in_order():
    def scenario(m):
        def produce(i):
            time.sleep(0.002 * ((7 - i) % 4))  # later items often finish first
            return i * 7

        q = m.PrefetchQueue(produce, count=12, depth=6, workers=4)
        got = [q.get() for _ in range(12)]
        with pytest.raises(RuntimeError, match="exhausted"):
            q.get()
        q.close()
        return got

    assert _both(scenario) == [(i, i * 7) for i in range(12)]


def test_prefetch_queue_pooled_error_reraises_in_order():
    def scenario(m):
        def produce(i):
            if i == 3:
                raise ValueError("boom at 3")
            time.sleep(0.002 * (8 - i))
            return i

        q = m.PrefetchQueue(produce, count=8, depth=8, workers=4)
        got = [q.get()[1] for _ in range(3)]
        with pytest.raises(ValueError, match="boom at 3"):
            q.get()
        with pytest.raises(RuntimeError, match="closed"):
            q.get()
        return got

    assert _both(scenario) == [0, 1, 2]


def test_prefetch_queue_budget_counts_producing_items():
    def scenario(m):
        lock = threading.Lock()
        active = peak_active = 0

        def produce(i):
            nonlocal active, peak_active
            with lock:
                active += 1
                peak_active = max(peak_active, active)
            time.sleep(0.01)
            with lock:
                active -= 1
            return i

        q = m.PrefetchQueue(produce, count=6, depth=4, cost=lambda i: 10, budget=15, workers=3)
        got = [q.get()[0] for _ in range(6)]
        out = (got, peak_active, q.peak_inflight <= 20, q.budget_stalls > 0)
        q.close()
        return out

    assert _both(scenario) == (list(range(6)), 1, True, True)


def test_prefetch_queue_shared_pool_not_closed():
    def scenario(m):
        pool = m.WorkerPool(2, name="t-shared")
        q = m.PrefetchQueue(lambda i: i, count=4, depth=2, pool=pool)
        got = [q.get()[0] for _ in range(4)]
        q.close()
        f = pool.submit(lambda: 11)  # still accepting: close() was the queue's
        out = (got, f.result(timeout=5))
        pool.close()
        return out

    assert _both(scenario) == ([0, 1, 2, 3], 11)


# ----------------------------------------------------------------- EvalLane


LANES = (pipeline, jax_pipeline)


def test_eval_lane_drains_in_submit_order():
    def fn(snapshot):
        # later submissions finish their work sooner: the order must hold
        time.sleep(0.02 / (snapshot["k"] + 1))
        return snapshot["k"] * 10

    outs = []
    for mod in LANES:
        lane = mod.EvalLane(fn, capacity=3)
        for k in range(3):
            lane.submit(0, f"c{k}", {"k": k})
        outs.append(lane.drain_all())
        lane.close()
    assert outs[0] == outs[1] == [(0, "c0", 0), (0, "c1", 10), (0, "c2", 20)]


def test_eval_lane_reraises_worker_error_at_drain():
    def fn(snapshot):
        if snapshot["k"] == 1:
            raise RuntimeError("eval exploded")
        return snapshot["k"]

    for mod in LANES:
        lane = mod.EvalLane(fn, capacity=2)
        lane.submit(0, "a", {"k": 0})
        lane.submit(0, "b", {"k": 1})
        with pytest.raises(RuntimeError, match="eval exploded"):
            lane.drain_all()
        lane.close()


def test_eval_lane_validates_capacity():
    for mod in LANES:
        with pytest.raises(ValueError, match="capacity"):
            mod.EvalLane(lambda s: s, capacity=0)


# ------------------------------------------------------- context plumbing


def test_pipelined_context_scopes_depth():
    for mod in LANES:
        assert mod.active_depth() == 1 and mod.stage_anchor() is None
        with mod.pipelined(3):
            assert mod.active_depth() == 3
            with mod.pipelined(2):
                assert mod.active_depth() == 2
            assert mod.active_depth() == 3
        assert mod.active_depth() == 1
        with pytest.raises(ValueError, match="depth"):
            with mod.pipelined(0):
                pass


def test_pipelined_context_carries_anchor():
    with obs.span("cd.sweep", iteration=0) as sweep:
        with pipeline.pipelined(2, anchor=sweep):
            assert pipeline.stage_anchor() is sweep
            assert pipeline.active_depth() == 2
    assert pipeline.stage_anchor() is None


# -------------------------------------------------------- overlap helpers


OVERLAPS = [
    ([(0.0, 1.0)], [(2.0, 3.0)]),
    ([(0.0, 2.0)], [(1.0, 3.0)]),
    ([(0.0, 1.0)], [(1.0, 2.0)]),  # touching endpoints: no overlap
    ([], [(0.0, 1.0)]),
    ([(0.0, 1.0)], [(0.0, 1.0)]),
    ([(0.0, 1.0), (1.5, 3.0)], [(0.5, 2.0), (2.5, 2.75)]),
]


def test_interval_overlap_seconds():
    for a, b in OVERLAPS:
        assert interval_overlap_seconds(a, b) == pytest.approx(jax_interval_overlap(a, b), abs=1e-15)
    assert interval_overlap_seconds([(0.0, 2.0)], [(1.0, 3.0)]) == pytest.approx(1.0)


def test_overlap_ratio():
    for a, b in OVERLAPS:
        assert overlap_ratio(a, b) == pytest.approx(jax_overlap_ratio(a, b), abs=1e-15)
    assert overlap_ratio([(0.0, 1.0)], [(1.0, 2.0)]) == 0.0


# ----------------------------------------------- CD depth-2 bit identity


GEN = dict(n=400, d_fixed=5, re_specs={"userId": (12, 3)}, seed=3)


def _cfg(l2=1.0):
    return GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType("LBFGS"), tolerance=1e-9, max_iterations=100),
        regularization=RegularizationContext("L2"),
        reg_weight=l2,
    )


@pytest.fixture(scope="module", params=[None, 1 << 10], ids=["resident", "streamed"])
def cd_factory(request):
    """Fresh coordinates and validation over one dataset: resident, or with
    both coordinates streamed under a 1 KiB budget."""
    raw = mixed_data_to_raw_dataset(generate_mixed_effect_data(**GEN))
    budget = request.param

    def make():
        fe_ds = build_fixed_effect_dataset(raw, "global", "global", dtype=torch.float64, hbm_budget_bytes=budget,
                                           device="cpu")
        re_ds = build_random_effect_dataset(raw, "per-user", "userShard", "userId", dtype=torch.float64,
                                            hbm_budget_bytes=budget, device="cpu")
        assert fe_ds.streamed == re_ds.streamed == (budget is not None)
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


def _assert_bit_identical(coords, ref, other):
    for name in coords:
        assert torch.equal(coords[name].score(ref.model[name]), coords[name].score(other.model[name]))
    assert [n for n, _ in ref.evaluations] == [n for n, _ in other.evaluations]
    for (_, r1), (_, r2) in zip(ref.evaluations, other.evaluations):
        assert r1.primary_metric == r2.primary_metric


def test_depth2_bit_identical_models_and_ledger(cd_factory):
    """Depth 2 gives depth 1's bits: final scores, the evaluation ledger and
    the best evaluation; and the ledger is the JAX package's depth-2 run's."""
    coords1, val1 = cd_factory()
    ref = CoordinateDescent(coords1, n_iterations=2, validation=val1).run()
    coords2, val2 = cd_factory()
    piped = CoordinateDescent(coords2, n_iterations=2, validation=val2, pipeline_depth=2).run()
    _assert_bit_identical(coords1, ref, piped)
    assert ref.best_evaluation.primary_metric == piped.best_evaluation.primary_metric
    jraw = jax_to_raw(jax_generate(**GEN))
    jcfg = JaxConfig(optimizer=JaxOptConfig(optimizer_type=JaxOptType("LBFGS"), tolerance=1e-9, max_iterations=100),
                     regularization=JaxReg("L2"), reg_weight=1.0)
    streamed = coords1["global"].dataset.streamed
    budget = 1 << 10 if streamed else None
    jc = {
        "global": JaxFEC(dataset=jax_build_fe(jraw, "global", "global", dtype=jnp.float64, hbm_budget_bytes=budget),
                         task="logistic_regression", config=jcfg),
        "per-user": JaxREC(dataset=jax_build_re(jraw, "per-user", "userShard", "userId", dtype=jnp.float64,
                                                hbm_budget_bytes=budget),
                           task="logistic_regression", config=jcfg),
    }
    jval = JaxValidation(suite=jax_build_suite(["LOGISTIC_LOSS"], jraw.labels),
                         score_fns={n: jc[n].score for n in jc}, offsets=jraw.offsets)
    jref = JaxCD(jc, n_iterations=2, validation=jval, pipeline_depth=2).run()
    assert [n for n, _ in jref.evaluations] == [n for n, _ in piped.evaluations]
    for (_, r1), (_, r2) in zip(jref.evaluations, piped.evaluations):
        np.testing.assert_allclose(r2.primary_metric, r1.primary_metric, rtol=1e-12)


def test_depth2_eval_lane_runs_off_main_thread(cd_factory, run):
    """At depth 2 the cd.eval spans run on the lane's worker thread, parented
    on the sweep span, and a streamed coordinate's slices stage there too
    (on the CPU the stager thread starts only where a pass has two slices)."""
    from photon_ml_tpu_torch.obs.timeline import TimelineRecorder

    rec = TimelineRecorder()
    run.register_listener(rec)
    coords, val = cd_factory()
    CoordinateDescent(coords, n_iterations=2, validation=val, pipeline_depth=2).run()
    evals = [s for s in rec.spans() if s.name == "cd.eval"]
    assert evals, "no cd.eval spans recorded"
    assert all(s.thread_name.startswith("photon-eval") for s in evals)
    main = threading.main_thread().ident
    assert all(s.thread_id != main for s in evals)
    sweeps = {s.span_id for s in rec.spans() if s.name == "cd.sweep"}
    assert all(s.parent_id in sweeps for s in evals)
    stages = [s for s in rec.spans() if s.name == "fe_stream.stage"]
    if coords["global"].dataset.streamed:
        assert stages and all(s.thread_name.startswith("photon-fe-stage") for s in stages)
        assert all(s.parent_id in sweeps for s in stages)
    else:
        assert not stages


def test_depth_validation():
    with pytest.raises(ValueError, match="pipeline_depth"):
        CoordinateDescent({"x": object()}, pipeline_depth=0)
    with pytest.raises(ValueError, match="pipeline_depth"):
        JaxCD({"x": object()}, pipeline_depth=0)


def test_depth2_nan_storm_ledger_matches(cd_factory):
    """Two consecutive corrupted score updates: the rejection counters and
    final bits match depth 1 exactly."""
    results, rejections = {}, {}
    for depth in (1, 2):
        coords, val = cd_factory()
        r = obs.RunTelemetry()
        faults.configure("coordinate.scores:nan:1x2")
        with obs.use_run(r):
            results[depth] = CoordinateDescent(coords, n_iterations=2, validation=val, pipeline_depth=depth).run()
        faults.clear()
        rejections[depth] = {
            name: r.registry.counter("photon_coordinate_rejections_total", "").labels(coordinate=name).value
            for name in coords
        }
        results[f"coords{depth}"] = coords
    assert rejections[1] == rejections[2]
    assert sum(rejections[1].values()) == 2
    _assert_bit_identical(results["coords1"], results[1], results[2])


def test_depth2_boundary_states_match_serial(cd_factory, tmp_path):
    """The boundary states a depth-2 run hands to the checkpointer carry
    depth 1's models, summed scores, evaluation ledger and train losses (the
    lane drains before every boundary)."""
    snaps = {}
    for depth in (1, 2):
        coords, val = cd_factory()
        mgr = CheckpointManager(str(tmp_path / f"d{depth}"), keep_last=10, fsync=False)
        CoordinateDescent(coords, n_iterations=2, validation=val, boundary_fn=mgr.on_boundary,
                          pipeline_depth=depth).run()
        assert len(mgr.checkpoints()) == 4  # 2 sweeps x 2 coordinates
        snaps[depth] = mgr.latest_valid(expect_coordinate_order=list(coords), expect_n_iterations=2)
    s1, s2 = snaps[1], snaps[2]
    assert (s1.iteration, s1.coordinate_index) == (s2.iteration, s2.coordinate_index)
    np.testing.assert_array_equal(np.asarray(s1.summed_scores), np.asarray(s2.summed_scores))
    assert [n for n, _ in s1.evaluations] == [n for n, _ in s2.evaluations]
    for (_, r1), (_, r2) in zip(s1.evaluations, s2.evaluations):
        assert r1.primary_metric == r2.primary_metric
    assert s1.train_losses == s2.train_losses


def test_depth2_kill_and_resume_across_pipelined_boundary(cd_factory, tmp_path):
    """Killed right after the second boundary save of a depth-2 run, resumed
    at depth 2: the uninterrupted depth-1 run's bits."""
    coords, val = cd_factory()
    ref = CoordinateDescent(coords, n_iterations=2, validation=val).run()
    ckpt_dir = str(tmp_path / "ck")
    coords2, val2 = cd_factory()
    mgr = CheckpointManager(ckpt_dir, fsync=False)
    faults.configure("cd.boundary_saved:kill:2")
    with pytest.raises(SimulatedKill):
        CoordinateDescent(coords2, n_iterations=2, validation=val2, boundary_fn=mgr.on_boundary,
                          pipeline_depth=2).run()
    faults.clear()
    snap = CheckpointManager(ckpt_dir, fsync=False).latest_valid(
        expect_coordinate_order=list(coords2), expect_n_iterations=2)
    assert snap is not None and (snap.iteration, snap.coordinate_index) == (0, 1)
    coords3, val3 = cd_factory()
    resumed = CoordinateDescent(coords3, n_iterations=2, validation=val3, resume_state=snap, pipeline_depth=2).run()
    _assert_bit_identical(coords, ref, resumed)
