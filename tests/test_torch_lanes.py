"""The port's lambda-lane sweeps against the JAX package, on the CPU.

- The lane products ``FeatureMatrix.matmat`` / ``rmatmat`` (dense, ELL,
  sorted COO; L = 1, 3, 4, 7, 8, 16, 40) against the JAX package's at rtol 1e-5
  (max-abs <= 1e-5 * max(|ref|, 1), as tests/test_torch_ops.py holds the
  single-lane products);
- S2's plain version, column by column, against S1's plain version, bitwise
  in float64, for every segment form (uniform ELL rows, COO row pointers,
  the key walk, the key form of a long row) and for bfloat16 values;
- the 9 cases of tests/test_sweep_lanes.py (n = 900, d = 6, 12 users)
  through the port: each lane against its sequential fit and against the
  JAX package's ``fit_lanes`` at the packed solve's bound (coefficients
  atol 5e-3, validation AUC within 1e-3), with L-BFGS and TRON; a NaN lane
  frozen with its neighbours bitwise clean; the batched proposals and the
  Sobol resume bitwise the JAX package's;
- the sparse fixed-effect lane solve (``GLMProblem.run_lanes`` on ELL and
  COO) against its single-lane solves: loss rtol 1e-5, coefficients atol
  5e-3;
- ``cli.train`` with ``BAYESIAN`` and with ``RANDOM --trial-lanes 4``
  against the JAX driver (tests/test_cli.py:278, tests/test_sweep_lanes.py's
  kill-and-resume case): candidates bitwise, trial metrics within 1e-4
  (logistic loss) or, for AUC over 150 validation rows, within the lane
  bound 1e-3; the resumed run's metrics within 1e-4 of the straight run's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import train as ref_train
from photon_ml_tpu.estimators import CoordinateConfig as RefCoordinateConfig
from photon_ml_tpu.estimators import GameEstimator as RefGameEstimator
from photon_ml_tpu.game.problem import GLMOptimizationConfig as RefOptimizationConfig
from photon_ml_tpu.ops.features import batch_from_coo as ref_batch_from_coo
from photon_ml_tpu.ops.features import batch_from_dense as ref_batch_from_dense
from photon_ml_tpu.ops.regularization import RegularizationContext as RefRegularization
from photon_ml_tpu.optimize import OptimizerConfig as RefOptimizerConfig
from photon_ml_tpu.plan import check_lane_composition as ref_check_lane_composition
from photon_ml_tpu.testing import generate_mixed_effect_data as ref_generate_mixed_effect_data
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as ref_mixed_data_to_raw_dataset
from photon_ml_tpu.tuning import criteria as ref_criteria
from photon_ml_tpu.tuning import search as ref_search
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.cli import train
from photon_ml_tpu_torch.estimators import CoordinateConfig, GameEstimator
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.io import write_avro_file
from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
from photon_ml_tpu_torch.ops import sparse
from photon_ml_tpu_torch.ops.features import batch_from_coo, batch_from_dense
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import ConvergenceReason, OptimizerConfig
from photon_ml_tpu_torch.plan import PlanError, check_lane_composition
from photon_ml_tpu_torch.robust import faults
from photon_ml_tpu_torch.testing import generate_game_records, generate_mixed_effect_data
from photon_ml_tpu_torch.testing.generators import mixed_data_to_raw_dataset
from photon_ml_tpu_torch.tuning import criteria
from photon_ml_tpu_torch.tuning.search import GaussianProcessSearch, Observation, RandomSearch

COEF_TOL = 5e-3  # the packed solve's bound (tests/test_sweep_lanes.py:40)
LAMBDAS = (0.01, 0.1, 1.0, 10.0)
LANE_WIDTHS = (1, 3, 4, 7, 8, 16, 40)  # 7: a tail sub-chunk; 40: past the panel


@pytest.fixture(autouse=True)
def _no_leaked_injector(monkeypatch):
    monkeypatch.delenv("PHOTON_FAULTS", raising=False)
    yield
    faults.clear()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) if got.size else 0.0
    assert err <= rtol * max(np.max(np.abs(ref)) if ref.size else 0.0, 1.0), err


# ----------------------------------------------------------- lane products


def _triplets(rng, n, d, long_row=False):
    """Ragged COO triplets in shuffled order: 0-7 entries a row, some rows
    empty, a full column, repeated pairs; ``long_row`` adds a row longer
    than sparse.LONG_SEGMENT (its matrix's matvec takes the key form)."""
    counts = rng.integers(0, 8, size=n)
    counts[::7] = 0
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, d - 2, size=len(rows))
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.full(n, 3)])
    if long_row:
        rows = np.concatenate([rows, np.full(sparse.LONG_SEGMENT + 40, 5)])
        cols = np.concatenate([cols, rng.integers(0, d, size=sparse.LONG_SEGMENT + 40)])
    pick = rng.integers(0, len(rows), size=len(rows) // 10)
    rows, cols = np.concatenate([rows, rows[pick]]), np.concatenate([cols, cols[pick]])
    vals = rng.normal(size=len(rows))
    order = rng.permutation(len(rows))
    return rows[order].astype(np.int64), cols[order].astype(np.int64), vals[order]


def _batches(rng, layout, n=70, d=600):
    rows, cols, vals = _triplets(rng, n, d)
    y = (rng.random(n) > 0.5).astype(np.float64)
    if layout == "dense":
        x = np.zeros((n, d))
        np.add.at(x, (rows, cols), vals)
        return batch_from_dense(x, y, device="cpu"), ref_batch_from_dense(x, y, dtype=jnp.float32)
    return (batch_from_coo(rows, cols, vals, y, d, layout=layout, device="cpu"),
            ref_batch_from_coo(rows, cols, vals, y, d, dtype=jnp.float32, layout=layout))


@pytest.mark.parametrize("L", LANE_WIDTHS)
@pytest.mark.parametrize("layout", ("dense", "ell", "coo"))
def test_lane_products_match_the_jax_package(layout, L):
    rng = np.random.default_rng(100 + L)
    tb, jb = _batches(rng, layout)
    W = rng.standard_normal((tb.dim, L)).astype(np.float32)
    C = rng.standard_normal((tb.n_rows, L)).astype(np.float32)
    got = tb.features.matmat(_t(W))
    assert got.shape == (tb.n_rows, L) and got.dtype == torch.float32
    _close(got.numpy(), jb.features.matmat(jnp.asarray(W)))
    _close(tb.features.rmatmat(_t(C)).numpy(), jb.features.rmatmat(jnp.asarray(C)))
    # column l of a lane product is the single-lane product of column l
    if layout != "dense":
        for l in range(L):
            assert torch.equal(got[:, l], tb.features.matvec(_t(W[:, l])))


def _forms(rng, value_dtype):
    """(name, Segments, n_seg, n_src) for each segment form."""
    n, d = 70, 600
    out = []
    for long_row in (False, True):
        rows, cols, vals = _triplets(rng, n, d, long_row=long_row)
        y = np.zeros(n)
        for layout in ("ell", "coo"):
            if layout == "ell" and long_row:
                continue
            f = batch_from_coo(rows, cols, vals, y, d, layout=layout, feature_dtype=value_dtype, device="cpu").features
            tag = f"{layout}{'_long' if long_row else ''}"
            out.append((f"{tag}_rows", f.row_segments, n, d))
            out.append((f"{tag}_keys", f.col_segments, d, n))
    return out


@pytest.mark.parametrize("value_dtype", (torch.float64, torch.bfloat16))
@pytest.mark.parametrize("L", LANE_WIDTHS)
def test_s2_plain_columns_are_s1_plain_bitwise(L, value_dtype):
    rng = np.random.default_rng(7 + L)
    forms = _forms(rng, value_dtype)
    assert {name for name, seg, *_ in forms if seg.keys is not None} >= {"ell_keys", "coo_keys", "coo_long_rows"}
    for name, seg, n_seg, n_src in forms:
        src = _t(rng.standard_normal((n_src, L)))
        lanes = sparse.segment_dot_lanes(f"coo_{'matmat' if 'rows' in name else 'rmatmat'}", seg, n_seg, src)
        assert lanes.shape == (n_seg, L) and lanes.dtype == torch.float64
        for l in range(L):
            single = sparse.segment_dot_plain(seg, n_seg, src[:, l].contiguous())
            assert torch.equal(lanes[:, l], single), (name, l)


def test_segment_dot_lanes_runs_on_cuda_or_cpu_only():
    f = batch_from_coo(np.array([0, 1]), np.array([0, 1]), np.ones(2), np.zeros(2), 3, layout="coo",
                       device="cpu").features
    with pytest.raises(ValueError, match="CUDA tensors"):
        sparse.segment_dot_lanes("coo_matmat", f.row_segments, 2, torch.zeros((3, 2), device="meta"))
    assert set(sparse.LANE_PRODUCTS) == {"ell_matmat", "ell_rmatmat", "coo_matmat", "coo_rmatmat"}
    assert set(sparse.LANE_PRODUCTS) <= set(sparse.SPARSE_LAUNCHES)
    # the full panels go on the kernel's grid y axis (at most 65,535)
    assert sparse._MAX_LANES == 65535 * sparse.PANEL
    assert sum(p.width == sparse.PANEL for p in sparse.lane_plan(sparse._MAX_LANES)) == 65535
    for bad in (0, sparse._MAX_LANES + 1):
        with pytest.raises(ValueError, match="lanes"):
            sparse.lane_plan(bad)


@pytest.mark.parametrize("L", range(1, 71))
def test_lane_plan_covers_every_column_once_in_pieces_the_kernel_takes(L):
    """S2's panels and sub-chunks (the mirror of csrc/sparse_glm.cu's
    run_panels): every column once, in order; full panels of PANEL columns,
    then at most one narrower; each panel in the kernel of the narrowest
    capacity that holds it (1, or a multiple of SUB up to PANEL), walked in
    sub-chunks of SUB columns, only the last narrower (the width mod SUB)."""
    plan = sparse.lane_plan(L)
    subs = [s for p in plan for s in p.subs]
    assert [c for first, width in subs for c in range(first, first + width)] == list(range(L))
    assert [p.width for p in plan[:-1]] == [sparse.PANEL] * (L // sparse.PANEL if L % sparse.PANEL else
                                                             L // sparse.PANEL - 1)
    assert len(plan) == -(-L // sparse.PANEL)
    for p in plan:
        assert 1 <= p.width <= p.capacity <= sparse.PANEL
        assert p.capacity == (1 if p.width == 1 else -(-p.width // sparse.SUB) * sparse.SUB)
        assert p.capacity == sparse.panel_capacity(p.width)
        assert p.subs[0][0] == p.first and sum(w for _, w in p.subs) == p.width
        assert all(w == sparse.SUB for _, w in p.subs[:-1])
        assert p.subs[-1][1] == (p.width % sparse.SUB or min(sparse.SUB, p.width))


def test_lane_state_carries_across_packages():
    rng = np.random.default_rng(3)
    for shape in ((6, 4), (5, 3, 4)):
        a = rng.standard_normal(shape).astype(np.float32)
        t = convert.lanes_from_numpy(a, device="cpu")
        assert t.shape == shape and np.array_equal(convert.lanes_to_numpy(t), a)
    with pytest.raises(ValueError):
        convert.lanes_from_numpy(np.zeros(3), device="cpu")
    ref_obs = [ref_search.Observation(candidate=rng.random(2), value=float(rng.random())) for _ in range(3)]
    pairs = convert.observations_to_numpy(ref_obs)
    back = convert.observations_from_numpy(pairs)
    assert all(isinstance(o, Observation) for o in back)
    for o, r in zip(back, ref_obs):
        assert np.array_equal(o.candidate, r.candidate) and o.value == r.value


# ------------------------------------------------------ sparse lane solve


@pytest.mark.parametrize("optimizer", ("LBFGS", "TRON"))
@pytest.mark.parametrize("layout", ("ell", "coo"))
def test_sparse_lane_solve_matches_single_lane_solves(layout, optimizer):
    rng = np.random.default_rng(11)
    n, d = 300, 50
    rows, cols, vals = _triplets(rng, n, d)
    x_true = rng.standard_normal(d) * 0.5
    dense = np.zeros((n, d))
    np.add.at(dense, (rows, cols), vals)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-dense @ x_true))).astype(np.float64)
    off = rng.standard_normal(n) * 0.1
    batch = batch_from_coo(rows, cols, vals, y, d, off, layout=layout, dtype=torch.float64, device="cpu")
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=optimizer, tolerance=1e-9, max_iterations=50),
        regularization=RegularizationContext("L2"),
    )
    problem = GLMProblem("logistic_regression", cfg)
    lambdas = (0.1, 1.0, 10.0, 100.0)
    W, res = problem.run_lanes(batch, batch.offsets[:, None].repeat(1, 4), torch.tensor(lambdas, dtype=torch.float64))
    assert W.shape == (d, 4) and res.loss.shape == (4,)
    for k, lam in enumerate(lambdas):
        model, single = GLMProblem("logistic_regression", cfg.with_reg_weight(lam)).run(batch)
        np.testing.assert_allclose(W[:, k].numpy(), model.coefficients.means.numpy(), atol=COEF_TOL, rtol=0)
        np.testing.assert_allclose(float(res.loss[k]), float(single.loss), rtol=1e-5)


def test_lane_composition_refusals_are_the_jax_packages():
    ccs = _configs(RefCoordinateConfig, RefOptimizationConfig, RefRegularization, RefOptimizerConfig)
    ours = _configs(CoordinateConfig, GLMOptimizationConfig, RegularizationContext, OptimizerConfig)
    import dataclasses

    cases = [
        dict(mesh={"data": 2}), dict(n_processes=2), dict(distributed=True), dict(pipeline_depth=2),
        dict(partial_retrain_locked=("global",)),
    ]
    for kw in cases:
        with pytest.raises(PlanError) as got:
            check_lane_composition(ours, 4, **kw)
        with pytest.raises(ValueError) as want:
            ref_check_lane_composition(ccs, 4, **kw)
        # lanes over processes: the JAX package's words, naming ROADMAP A10
        over_processes = "n_processes" in kw or "distributed" in kw
        assert str(got.value) == str(want.value) + (" (ROADMAP A10)" if over_processes else "")
    edits = [
        lambda c: dataclasses.replace(c, hbm_budget_mb=64),
        lambda c: dataclasses.replace(c, config=dataclasses.replace(c.config, regularization=type(c.config.regularization)("L1"))),
        lambda c: dataclasses.replace(c, config=dataclasses.replace(c.config, variance_type="SIMPLE")),
        lambda c: dataclasses.replace(c, config=dataclasses.replace(c.config, down_sampling_rate=0.5)),
        lambda c: dataclasses.replace(c, normalization=object()),
        lambda c: dataclasses.replace(c, regularize_by_prior=True),
    ]
    for edit in edits:
        with pytest.raises(PlanError) as got:
            check_lane_composition([edit(ours[0]), ours[1]], 4)
        with pytest.raises(ValueError) as want:
            ref_check_lane_composition([edit(ccs[0]), ccs[1]], 4)
        assert str(got.value) == str(want.value)
    check_lane_composition(ours, 4)


# ------------------------------------------------- tests/test_sweep_lanes.py


@pytest.fixture(scope="module")
def game_data():
    full = mixed_data_to_raw_dataset(generate_mixed_effect_data(n=900, d_fixed=6, re_specs={"userId": (12, 3)}, seed=29))
    ref = ref_mixed_data_to_raw_dataset(
        ref_generate_mixed_effect_data(n=900, d_fixed=6, re_specs={"userId": (12, 3)}, seed=29)
    )
    return (full.subset(np.arange(600)), full.subset(np.arange(600, 900)),
            ref.subset(np.arange(600)), ref.subset(np.arange(600, 900)))


def _configs(CC, OC, RC, OptC, fe_w=1.0, re_w=1.0, optimizer="LBFGS"):
    opt = OptC(optimizer_type=optimizer, tolerance=1e-8, max_iterations=100)
    return [
        CC(name="global", feature_shard="global", config=OC(optimizer=opt, regularization=RC("L2")),
           reg_weights=(fe_w,)),
        CC(name="per-user", feature_shard="userShard", random_effect_type="userId",
           config=OC(optimizer=opt, regularization=RC("L2")), reg_weights=(re_w,)),
    ]


def _estimator(fe_w=1.0, re_w=1.0, optimizer="LBFGS", **kw):
    kw.setdefault("n_cd_iterations", 2)
    kw.setdefault("evaluator_specs", ["AUC"])
    ccs = _configs(CoordinateConfig, GLMOptimizationConfig, RegularizationContext, OptimizerConfig, fe_w, re_w,
                   optimizer)
    return GameEstimator(task="logistic_regression", coordinate_configs=ccs, device="cpu", **kw)


def _ref_estimator(optimizer="LBFGS", **kw):
    kw.setdefault("n_cd_iterations", 2)
    kw.setdefault("evaluator_specs", ["AUC"])
    ccs = _configs(RefCoordinateConfig, RefOptimizationConfig, RefRegularization, RefOptimizerConfig,
                   optimizer=optimizer)
    return RefGameEstimator(task="logistic_regression", coordinate_configs=ccs, **kw)


def _fe(result):
    return np.asarray(result.model["global"].model.coefficients.means)


def _re(result):
    return np.asarray(result.model["per-user"].coef_values)


def test_lane_parity_vs_sequential_fit(game_data):
    train_raw, val_raw, ref_train_raw, ref_val_raw = game_data
    combos = [{"global": l, "per-user": l} for l in LAMBDAS]
    lanes = _estimator().fit_lanes(train_raw, combos, validation=val_raw)
    ref_lanes = _ref_estimator().fit_lanes(ref_train_raw, combos, validation=ref_val_raw)
    assert len(lanes) == len(LAMBDAS)
    for lane, lam in enumerate(LAMBDAS):
        seq = _estimator(lam, lam).fit(train_raw, validation=val_raw)[0]
        r = lanes[lane]
        assert r.config == {"global": lam, "per-user": lam}
        assert r.trackers["lane"]["index"] == lane and r.trackers["lane"]["n_lanes"] == len(LAMBDAS)
        for other in (seq, ref_lanes[lane]):
            np.testing.assert_allclose(_fe(r), _fe(other), atol=COEF_TOL, rtol=0)
            np.testing.assert_allclose(_re(r), _re(other), atol=COEF_TOL, rtol=0)
            assert abs(r.evaluation.metrics["AUC"] - other.evaluation.metrics["AUC"]) < 1e-3


def test_lane_parity_tron(game_data):
    train_raw, _, ref_train_raw, _ = game_data
    combos = [{"global": l, "per-user": l} for l in (0.1, 10.0)]
    lanes = _estimator(optimizer="TRON", n_cd_iterations=1).fit_lanes(train_raw, combos)
    ref_lanes = _ref_estimator(optimizer="TRON", n_cd_iterations=1).fit_lanes(ref_train_raw, combos)
    for lane, lam in enumerate((0.1, 10.0)):
        seq = _estimator(lam, lam, optimizer="TRON", n_cd_iterations=1).fit(train_raw)[0]
        np.testing.assert_allclose(_fe(lanes[lane]), _fe(seq), atol=COEF_TOL, rtol=0)
        np.testing.assert_allclose(_fe(lanes[lane]), _fe(ref_lanes[lane]), atol=COEF_TOL, rtol=0)
        np.testing.assert_allclose(_re(lanes[lane]), _re(ref_lanes[lane]), atol=COEF_TOL, rtol=0)


def test_nan_lane_freezes_without_perturbing_neighbors(game_data):
    train_raw = game_data[0]
    combos = [{"global": l, "per-user": l} for l in LAMBDAS]
    clean = _estimator(n_cd_iterations=1).fit_lanes(train_raw, combos)
    faults.configure("solver.value_and_grad:nan:1")
    try:
        poisoned = _estimator(n_cd_iterations=1).fit_lanes(train_raw, combos)
    finally:
        faults.clear()
    diverged = int(ConvergenceReason.NUMERICAL_DIVERGENCE.value)
    assert poisoned[0].trackers["lane"]["reasons"]["global"] == diverged
    assert not np.array_equal(_fe(poisoned[0]), _fe(clean[0]))
    for lane in range(1, len(LAMBDAS)):
        assert poisoned[lane].trackers["lane"]["reasons"]["global"] != diverged
        assert np.array_equal(_fe(poisoned[lane]), _fe(clean[lane]))
        assert np.array_equal(_re(poisoned[lane]), _re(clean[lane]))


def test_constant_liar_strategies():
    v = np.asarray([3.0, 1.0, 2.0])
    for mod in (criteria, ref_criteria):
        assert (mod.constant_liar(v, "min"), mod.constant_liar(v, "max"), mod.constant_liar(v, "mean")) == (1.0, 3.0, 2.0)
        with pytest.raises(ValueError, match="at least one observed value"):
            mod.constant_liar(np.asarray([]))
        with pytest.raises(ValueError, match="min|max|mean"):
            mod.constant_liar(v, "median")


def _obs_grid(mod, n, d, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Observation(candidate=rng.random(d), value=float(rng.random())) for _ in range(n)]


def test_gp_propose_batch_distinct_past_cold_start():
    d = 2
    ours = GaussianProcessSearch(d, lambda c: (0.0, None), seed=0)
    theirs = ref_search.GaussianProcessSearch(d, lambda c: (0.0, None), seed=0)
    for k in (4, 8):
        batch = ours.propose_batch(k, _obs_grid(ref_search, 8, d), [])
        assert np.array_equal(batch, theirs.propose_batch(k, _obs_grid(ref_search, 8, d), []))
        assert batch.shape == (k, d)
        for i in range(k):
            for j in range(i + 1, k):
                assert not np.allclose(batch[i], batch[j], atol=1e-9)


def test_gp_propose_batch_cold_start_uses_sobol():
    d = 3
    batch = GaussianProcessSearch(d, lambda c: (0.0, None), seed=0).propose_batch(4, _obs_grid(ref_search, 2, d), [])
    want = ref_search.GaussianProcessSearch(d, lambda c: (0.0, None), seed=0).propose_batch(
        4, _obs_grid(ref_search, 2, d), [])
    assert batch.shape == (4, d) and np.array_equal(batch, want)
    assert len({tuple(np.round(c, 12)) for c in batch}) == 4


def test_find_batched_bookkeeping():
    d = 2
    sizes = []

    def evaluate_batch(cands):
        sizes.append(len(cands))
        return [(float(np.sum(c)), None) for c in cands]

    out = RandomSearch(d, lambda c: (0.0, None), seed=1).find_batched(10, 4, evaluate_batch)
    ref = ref_search.RandomSearch(d, lambda c: (0.0, None), seed=1).find_batched(10, 4, evaluate_batch)
    assert sizes == [4, 4, 2, 4, 4, 2] and len(out) == 10
    assert all(isinstance(o, Observation) for o in out)
    assert np.array_equal(np.stack([o.candidate for o in out]), np.stack([o.candidate for o in ref]))
    with pytest.raises(ValueError, match="evaluate_batch returned"):
        RandomSearch(d, lambda c: (0.0, None), seed=1).find_batched(4, 4, lambda cands: [(0.0, None)])


def test_random_batched_resume_continues_sequence():
    d = 3

    def evaluate_batch(cands):
        return [(float(np.sum(c)), None) for c in cands]

    straight = RandomSearch(d, lambda c: (0.0, None), seed=7).find_batched(8, 4, evaluate_batch)
    first = RandomSearch(d, lambda c: (0.0, None), seed=7).find_batched(4, 4, evaluate_batch)
    resumed_search = RandomSearch(d, lambda c: (0.0, None), seed=7)
    resumed_search.draw_candidates(4)  # the tuner's skip= burn
    resumed = resumed_search.find_batched(4, 2, evaluate_batch, observations=first)
    got = np.stack([o.candidate for o in first + resumed])
    want = np.stack([o.candidate for o in straight])
    np.testing.assert_allclose(got, want, atol=0)
    ref = ref_search.RandomSearch(d, lambda c: (0.0, None), seed=7).find_batched(8, 4, evaluate_batch)
    assert np.array_equal(got, np.stack([o.candidate for o in ref]))


# ------------------------------------------------------------------ cli.train


def _write_avro(tmp_path, re_specs, n, n_train, seed):
    data = generate_mixed_effect_data(n=n, d_fixed=5, re_specs=re_specs, seed=seed)
    recs = generate_game_records(data)
    schema = TRAINING_EXAMPLE_AVRO
    if re_specs:
        schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
            {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    train_p, val_p = str(tmp_path / "train.avro"), str(tmp_path / "val.avro")
    write_avro_file(train_p, schema, recs[:n_train])
    write_avro_file(val_p, schema, recs[n_train:])
    return train_p, val_p


def _trial_units(ckpt_dir):
    with open(os.path.join(ckpt_dir, "checkpoint-state.json")) as f:
        state = json.load(f)
    return [tuple(rec["unit"]) for rec in state["tuning_trials"]]


def test_cli_bayesian_matches_the_jax_driver(tmp_path):
    """tests/test_cli.py:278 through both drivers: the tuned best beats a
    deliberately over-regularized grid, the prior file holds grid + trials
    and shrinks a later search; candidates bitwise, metrics within 1e-4."""
    train_p, val_p = _write_avro(tmp_path, {"userId": (15, 3)}, 900, 600, 31)
    common = [
        "--input-data", train_p, "--validation-data", val_p, "--task", "logistic_regression",
        "--feature-shard", "name=globalShard,bags=features",
        "--coordinate", "name=global,shard=globalShard,optimizer=LBFGS,tolerance=1e-7,reg.type=L2,reg.weights=5000",
        "--evaluators", "LOGISTIC_LOSS", "--log-level", "WARNING",
    ]
    tune = ["--hyper-parameter-tuning", "BAYESIAN", "--hyper-parameter-tuning-iter", "4", "--output-mode", "TUNED"]
    grid = train.run(common + ["--output-dir", str(tmp_path / "grid"), "--device", "cpu"])
    tuned = train.run(common + tune + ["--output-dir", str(tmp_path / "tuned"), "--device", "cpu"])
    ref = ref_train.run(common + tune + ["--output-dir", str(tmp_path / "ref")])
    assert tuned["best"]["metrics"]["LOGISTIC_LOSS"] < grid["best"]["metrics"]["LOGISTIC_LOSS"] - 0.01
    assert len(tuned["configs"]) == len(ref["configs"]) == 5
    for got, want in zip(tuned["configs"], ref["configs"]):
        assert got["reg_weights"] == want["reg_weights"]
        assert abs(got["metrics"]["LOGISTIC_LOSS"] - want["metrics"]["LOGISTIC_LOSS"]) <= 1e-4
    prior_path = os.path.join(str(tmp_path / "tuned"), "hyperparameter-prior.json")
    with open(prior_path) as f:
        prior = json.load(f)
    assert len(prior["records"]) == 1 + 4 and all("global.reg_weight" in r for r in prior["records"])
    shrunk = train.run(common + ["--output-dir", str(tmp_path / "shrunk"), "--device", "cpu",
                                 "--hyper-parameter-tuning", "BAYESIAN", "--hyper-parameter-tuning-iter", "2",
                                 "--hyper-parameter-prior", prior_path, "--output-mode", "TUNED"])
    assert len(shrunk["configs"]) == 3


def _lane_args(train_p, val_p, out, ckpt, lanes=4):
    return [
        "--input-data", train_p, "--validation-data", val_p, "--task", "logistic_regression",
        "--feature-shard", "name=globalShard,bags=features",
        "--coordinate", "name=global,shard=globalShard,optimizer=LBFGS,tolerance=1e-7,reg.type=L2,reg.weights=1",
        "--coordinate-descent-iterations", "1", "--evaluators", "AUC",
        "--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter", "4", "--trial-lanes", str(lanes),
        "--output-mode", "TUNED", "--output-dir", out, "--checkpoint-dir", ckpt, "--log-level", "WARNING",
    ]


def test_cli_mid_batch_kill_resumes_same_candidates(tmp_path, monkeypatch):
    """RANDOM --trial-lanes 4, killed while it records the lanes of a batch:
    the rerun resumes from the recorded prefix and the trials match an
    uninterrupted run, and the JAX driver's, bitwise in their candidates."""
    train_p, val_p = _write_avro(tmp_path, {}, 500, 350, 13)
    straight_ckpt, ref_ckpt = str(tmp_path / "ckpt_straight"), str(tmp_path / "ckpt_ref")
    straight = train.run(_lane_args(train_p, val_p, str(tmp_path / "out_straight"), straight_ckpt) + ["--device", "cpu"])
    ref = ref_train.run(_lane_args(train_p, val_p, str(tmp_path / "out_ref"), ref_ckpt))
    want = _trial_units(straight_ckpt)
    assert len(want) == 4 and want == _trial_units(ref_ckpt)
    for got, theirs in zip(straight["configs"], ref["configs"]):
        # across packages at the lane bound: 150 validation rows quantize
        # AUC in steps of ~1.8e-4, and the grid's sequential fit already
        # lands one or two pairs apart
        assert got["reg_weights"] == theirs["reg_weights"]
        assert abs(got["metrics"]["AUC"] - theirs["metrics"]["AUC"]) < 1e-3

    killed_ckpt = str(tmp_path / "ckpt_killed")
    args = _lane_args(train_p, val_p, str(tmp_path / "out_killed"), killed_ckpt) + ["--device", "cpu"]
    monkeypatch.setenv("PHOTON_FAULTS", "tuning.trial:kill:2")
    with pytest.raises(faults.SimulatedKill, match="injected kill"):
        train.run(args)
    monkeypatch.delenv("PHOTON_FAULTS")
    recorded = _trial_units(killed_ckpt)
    assert 1 <= len(recorded) < 4 and recorded == want[: len(recorded)]
    with open(os.path.join(killed_ckpt, "checkpoint-state.json")) as f:
        assert json.load(f)["tuning_trials"][0]["lane"] == {"index": 0, "n_lanes": 4}
    resumed = train.run(args)
    assert _trial_units(killed_ckpt) == want
    assert resumed["best"]["metrics"]["AUC"] > 0.5
    for got, theirs in zip(resumed["configs"], straight["configs"]):
        assert got["reg_weights"] == theirs["reg_weights"]
        assert abs(got["metrics"]["AUC"] - theirs["metrics"]["AUC"]) <= 1e-4
