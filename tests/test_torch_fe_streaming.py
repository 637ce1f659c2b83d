"""Parity of the port's out-of-core fixed effect with the JAX package, on the CPU.

The same data, made from a seed by both packages' generators (the port's is
a copy), go through the JAX package's streamed path and the port's
(``game/fe_streaming.py``, ``device="cpu"``: the plain versions of the
kernels). The cases are tests/test_fe_streaming.py's, each also held
against the JAX package's streamed run. Bounds are ROADMAP's ground rules:

- float64 solves (streamed against resident, port against the JAX
  package): coefficients at 1e-9, losses at rtol 1e-12;
- the streamed objective against the resident one: value rtol 2e-6, grad
  and Hv max-abs <= 3e-5 * max(|ref|, 1) in float32; rtol 1e-12 in float64;
- host planes, scores of one model and repeated passes: equal bits.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game import FixedEffectCoordinate as JaxFEC
from photon_ml_tpu.game import GLMOptimizationConfig as JaxConfig
from photon_ml_tpu.game import build_fixed_effect_dataset as jax_build_fe
from photon_ml_tpu.game.fe_streaming import StreamedFEObjective as JaxStreamedObjective
from photon_ml_tpu.game.fe_streaming import estimate_fe_batch_bytes as jax_estimate
from photon_ml_tpu.game.fe_streaming import rows_per_slice as jax_rows_per_slice
from photon_ml_tpu.ops import glm as jax_glm
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch_from_dense
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu.ops.regularization import RegularizationContext as JaxReg
from photon_ml_tpu.optimize import OptimizerConfig as JaxOptConfig
from photon_ml_tpu.optimize import OptimizerType as JaxOptType
from photon_ml_tpu.testing.generators import generate_mixed_effect_data as jax_generate
from photon_ml_tpu.testing.generators import mixed_data_to_raw_dataset as jax_to_raw
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
from photon_ml_tpu_torch.game.fe_streaming import (
    StreamedFEObjective,
    estimate_fe_batch_bytes,
    rows_per_slice,
    score_streamed_fe,
)
from photon_ml_tpu_torch.ops import fused_glm
from photon_ml_tpu_torch.ops.features import FeatureMatrix, LabeledBatch, batch_from_dense
from photon_ml_tpu_torch.ops.glm import (
    GLMObjective,
    finalize_hessian_vector,
    finalize_value_grad,
    slice_hessian_vector_partials,
    slice_value_grad_partials,
)
from photon_ml_tpu_torch.ops.losses import get_loss
from photon_ml_tpu_torch.ops.normalization import identity_normalization
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType
from photon_ml_tpu_torch.robust import faults
from photon_ml_tpu_torch.testing.generators import generate_mixed_effect_data, mixed_data_to_raw_dataset

BUDGET = 16 << 10
SOLVE_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    faults.clear()


def _cfg(l2=0.8, optimizer="LBFGS", reg="L2"):
    return GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType(optimizer), tolerance=1e-9, max_iterations=80),
        regularization=RegularizationContext(reg),
        reg_weight=l2,
    )


def _jcfg(l2=0.8, optimizer="LBFGS", reg="L2"):
    return JaxConfig(
        optimizer=JaxOptConfig(optimizer_type=JaxOptType(optimizer), tolerance=1e-9, max_iterations=80),
        regularization=JaxReg(reg),
        reg_weight=l2,
    )


GEN = dict(n=700, d_fixed=6, re_specs={"userId": (20, 4)}, seed=11)


@pytest.fixture(scope="module")
def raw():
    return mixed_data_to_raw_dataset(generate_mixed_effect_data(**GEN))


@pytest.fixture(scope="module")
def jraw():
    return jax_to_raw(jax_generate(**GEN))


def _pair(raw, budget_bytes=BUDGET, layout="auto", dtype=torch.float64):
    mem = build_fixed_effect_dataset(raw, "global", "global", dtype=dtype, layout=layout, device="cpu")
    streamed = build_fixed_effect_dataset(
        raw, "global", "global", dtype=dtype, layout=layout, hbm_budget_bytes=budget_bytes, device="cpu"
    )
    assert streamed.streamed, "budget should force the streamed build"
    assert streamed.batch is None and streamed.host_batch is not None
    return mem, streamed


def _jstreamed(jraw, layout="auto", budget_bytes=BUDGET):
    ds = jax_build_fe(jraw, "global", "global", dtype=jnp.float64, layout=layout, hbm_budget_bytes=budget_bytes)
    assert ds.streamed
    return ds


def _means(model):
    return np.asarray(model.model.coefficients.means)


# ---------------------------------------------------------------- sizing


def test_estimate_and_rows_per_slice():
    for args in ((100, 10, "dense"), (100, 10, "ell", 3), (7, 5, "dense", 0, 2, 8), (9, 4, "ell", 2, 2, 8)):
        assert estimate_fe_batch_bytes(*args) == jax_estimate(*args)
    assert estimate_fe_batch_bytes(100, 10, "dense") == 100 * 10 * 4 + 3 * 100 * 4
    with pytest.raises(ValueError, match="dense|ell"):
        estimate_fe_batch_bytes(1, 1, "coo")
    for budget, row in ((8000, 100), (0, 100), (1 << 20, 24), (123457, 96)):
        assert rows_per_slice(budget, row) == jax_rows_per_slice(budget, row)
    assert rows_per_slice(8000, 100) == 40 and rows_per_slice(0, 100) == 8


def test_budget_decision(raw, jraw):
    big = build_fixed_effect_dataset(raw, "global", "global", hbm_budget_bytes=1 << 30, device="cpu")
    assert not big.streamed and big.batch is not None
    _, streamed = _pair(raw)
    assert streamed.hbm_budget_bytes == BUDGET
    # the host planes are the JAX package's, bit for bit
    jhb = _jstreamed(jraw).host_batch
    hb = streamed.host_batch
    assert hb.dense.numpy().tobytes() == np.asarray(jhb.dense).tobytes()
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(hb, name).numpy(), getattr(jhb, name))
    with pytest.raises(ValueError, match="row-sliceable layout"):
        build_fixed_effect_dataset(raw, "global", "global", layout="coo", hbm_budget_bytes=0, device="cpu")


def test_streamed_ell_build(raw, jraw):
    _, streamed = _pair(raw, layout="ell")
    hb = streamed.host_batch
    assert hb.layout == "ell"
    assert hb.ell_idx is not None and hb.ell_val.shape == hb.ell_idx.shape
    jhb = _jstreamed(jraw, layout="ell").host_batch
    np.testing.assert_array_equal(hb.ell_idx.numpy(), jhb.ell_idx)
    np.testing.assert_array_equal(hb.ell_val.numpy(), jhb.ell_val)


def test_slice_rows_and_slice_partials_match_jax(rng):
    """FeatureMatrix.slice_rows (dense and ELL; COO refuses) and the slice
    partial sums and finalizes against the JAX package's ops/glm.py."""
    n, d = 48, 7
    x = rng.standard_normal((n, d))
    x[rng.random((n, d)) < 0.5] = 0.0
    y = (rng.random(n) > 0.5).astype(np.float64)
    off = rng.standard_normal(n) * 0.1
    wt = rng.random(n) + 0.5
    w = rng.standard_normal(d) * 0.2
    v = rng.standard_normal(d)
    pb = batch_from_dense(x, y, off, wt, dtype=torch.float64, device="cpu")
    jb = jax_batch_from_dense(x, y, offsets=off, weights=wt, dtype=jnp.float64)
    ell = FeatureMatrix(dim=d, idx=torch.from_numpy(np.tile(np.arange(d, dtype=np.int32), (n, 1))),
                        val=torch.from_numpy(x))
    for feats in (pb.features, ell):
        sl = feats.slice_rows(40, 16)  # clamped, as dynamic_slice clamps
        jsl = jb.features.slice_rows(40, 16)
        assert sl.n_rows == 16
        np.testing.assert_array_equal(sl.to_dense().numpy(), np.asarray(jsl.to_dense()))
    coo = FeatureMatrix(dim=d, coo_cols=torch.zeros(1, dtype=torch.int32), coo_rows=torch.zeros(1, dtype=torch.int32),
                        coo_vals=torch.zeros(1, dtype=torch.float64), coo_n_rows=n)
    with pytest.raises(ValueError, match="row-sliceable layout"):
        coo.slice_rows(0, 8)
    loss, jloss = get_loss("logistic_regression"), JAX_LOSSES["logistic"]
    mshift = torch.tensor(0.05, dtype=torch.float64)
    for feats in (pb.features, ell):
        for start in (0, 16, 32):
            b = LabeledBatch(feats.slice_rows(start, 16), *(t[start:start + 16] for t in (pb.labels, pb.offsets, pb.weights)))
            jsb = dataclasses.replace(jb, features=jb.features.slice_rows(start, 16), labels=jb.labels[start:start + 16],
                                      offsets=jb.offsets[start:start + 16], weights=jb.weights[start:start + 16])
            got = slice_value_grad_partials(loss, b, torch.from_numpy(w), mshift)
            want = jax_glm.slice_value_grad_partials(jloss, jsb, jnp.asarray(w), jnp.asarray(0.05))
            for g, r in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-13)
            got = slice_hessian_vector_partials(loss, b, torch.from_numpy(w), mshift, torch.from_numpy(v), 0.1)
            want = jax_glm.slice_hessian_vector_partials(jloss, jsb, jnp.asarray(w), jnp.asarray(0.05),
                                                          jnp.asarray(v), jnp.asarray(0.1))
            for g, r in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-13)
    from photon_ml_tpu.ops.normalization import identity_normalization as jax_identity

    pm, pp = rng.standard_normal(d), rng.random(d) + 0.5
    g_sum, csum = rng.standard_normal(d), 0.7
    got = finalize_value_grad(torch.from_numpy(w), torch.tensor(3.0, dtype=torch.float64), torch.from_numpy(g_sum),
                              torch.tensor(csum, dtype=torch.float64), identity_normalization(), 0.3,
                              torch.from_numpy(pm), torch.from_numpy(pp))
    want = jax_glm.finalize_value_grad(jnp.asarray(w), jnp.asarray(3.0), jnp.asarray(g_sum), jnp.asarray(csum),
                                       jax_identity(), jnp.asarray(0.3), jnp.asarray(pm), jnp.asarray(pp))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-14)
    got = finalize_hessian_vector(torch.from_numpy(v), torch.from_numpy(g_sum), torch.tensor(csum, dtype=torch.float64),
                                  identity_normalization(), 0.3, torch.from_numpy(pp))
    want = jax_glm.finalize_hessian_vector(jnp.asarray(v), jnp.asarray(g_sum), jnp.asarray(csum), jax_identity(),
                                           jnp.asarray(0.3), jnp.asarray(pp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_streamed_objective_matches_resident(raw, layout, dtype):
    """One streamed value+grad and Hv against the resident objective, at
    the kernel bounds in float32 (the slots add in float64) and at 1e-12 in
    float64; the slot buffer carries one row per slice."""
    mem, streamed = _pair(raw, layout=layout, dtype=dtype)
    obj = StreamedFEObjective(get_loss("logistic_regression"), streamed.host_batch, BUDGET, l2_weight=0.3, device="cpu")
    ref = GLMObjective(loss=get_loss("logistic_regression"), batch=mem.batch, l2=0.3)
    assert obj.n_slices > 1 and obj.route == "plain_cpu"
    w = torch.linspace(-0.2, 0.2, streamed.host_batch.dim, dtype=dtype)
    (v, g), (rv, rg) = obj.value_and_grad(w), ref.value_and_grad(w)
    hv, rhv = obj.hessian_vector(w, w), ref.hessian_vector(w, w)
    if dtype == torch.float64:
        np.testing.assert_allclose(float(v), float(rv), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), rg.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(hv.numpy(), rhv.numpy(), rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(float(v), float(rv), rtol=2e-6)
        for got, want in ((g, rg), (hv, rhv)):
            assert float((got - want).abs().max()) <= 3e-5 * max(float(want.abs().max()), 1.0)
    assert obj._slots[fused_glm.VG].shape == (obj.n_slices, streamed.host_batch.dim + 2)


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("layout", ["dense", "ell"])
@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_streamed_train_matches_resident(raw, jraw, layout, optimizer):
    mem, streamed = _pair(raw, layout=layout)
    cm = FixedEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg(optimizer=optimizer))
    cs = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg(optimizer=optimizer))
    m_mem, r_mem = cm.train(None)
    m_str, r_str = cs.train(None)
    np.testing.assert_allclose(_means(m_str), _means(m_mem), atol=SOLVE_ATOL)
    assert abs(float(r_str.loss) - float(r_mem.loss)) < 1e-12 * max(1.0, abs(float(r_mem.loss)))
    jc = JaxFEC(dataset=_jstreamed(jraw, layout=layout), task="logistic_regression", config=_jcfg(optimizer=optimizer))
    j_str, jr_str = jc.train(None)
    np.testing.assert_allclose(_means(m_str), _means(j_str), atol=SOLVE_ATOL)
    np.testing.assert_allclose(float(r_str.loss), float(jr_str.loss), rtol=1e-12)


def test_streamed_owlqn_l1_parity(raw, jraw):
    mem, streamed = _pair(raw)
    cfg = _cfg(l2=0.5, reg="ELASTIC_NET")
    m_mem, _ = FixedEffectCoordinate(dataset=mem, task="logistic_regression", config=cfg).train(None)
    m_str, _ = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=cfg).train(None)
    np.testing.assert_allclose(_means(m_str), _means(m_mem), atol=SOLVE_ATOL)
    j_str, _ = JaxFEC(dataset=_jstreamed(jraw), task="logistic_regression",
                      config=_jcfg(l2=0.5, reg="ELASTIC_NET")).train(None)
    np.testing.assert_allclose(_means(m_str), _means(j_str), atol=SOLVE_ATOL)


def test_streamed_residual_and_warm_start_parity(raw, jraw):
    mem, streamed = _pair(raw)
    cm = FixedEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg())
    cs = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg())
    residual = np.linspace(-0.5, 0.5, raw.n_rows)
    m0, _ = cm.train(None)
    m_mem, _ = cm.train(torch.from_numpy(residual), initial_model=m0)
    m_str, _ = cs.train(torch.from_numpy(residual), initial_model=m0)
    np.testing.assert_allclose(_means(m_str), _means(m_mem), atol=SOLVE_ATOL)
    jc = JaxFEC(dataset=_jstreamed(jraw), task="logistic_regression", config=_jcfg())
    j0, _ = jc.train(None)
    j_str, _ = jc.train(jnp.asarray(residual), initial_model=j0)
    np.testing.assert_allclose(_means(m_str), _means(j_str), atol=SOLVE_ATOL)


def test_streamed_normalization_parity(raw, jraw):
    from photon_ml_tpu.ops.normalization import build_normalization as jax_build_norm
    from photon_ml_tpu.utils.stats import compute_feature_statistics as jax_stats
    from photon_ml_tpu_torch.ops.normalization import build_normalization
    from photon_ml_tpu_torch.utils.stats import compute_feature_statistics

    st = compute_feature_statistics(raw, "global")
    norm = build_normalization("SCALE_WITH_STANDARD_DEVIATION", st["mean"], st["variance"], st["max_magnitude"],
                               intercept_index=None, dtype=torch.float64, device="cpu")
    mem, streamed = _pair(raw)
    m_mem, _ = FixedEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg(),
                                     normalization=norm).train(None)
    m_str, _ = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg(),
                                     normalization=norm).train(None)
    np.testing.assert_allclose(_means(m_str), _means(m_mem), atol=SOLVE_ATOL)
    jst = jax_stats(jraw, "global")
    jnorm = jax_build_norm("SCALE_WITH_STANDARD_DEVIATION", jst["mean"], jst["variance"], jst["max_magnitude"],
                           intercept_index=None, dtype=jnp.float64)
    j_str, _ = JaxFEC(dataset=_jstreamed(jraw), task="logistic_regression", config=_jcfg(),
                      normalization=jnorm).train(None)
    np.testing.assert_allclose(_means(m_str), _means(j_str), atol=SOLVE_ATOL)


@pytest.mark.parametrize("change,match", [
    ({"variance_type": "SIMPLE"}, "variance"), ({"down_sampling_rate": 0.5}, "down_sampling_rate"),
], ids=["variance", "down_sampling"])
def test_streamed_refusals_match_jax(raw, jraw, change, match):
    """test_streamed_variance_refused and test_streamed_down_sampling_refused:
    both packages refuse, with the same message."""
    _, streamed = _pair(raw)
    cs = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=dataclasses.replace(_cfg(), **change))
    jc = JaxFEC(dataset=_jstreamed(jraw), task="logistic_regression", config=dataclasses.replace(_jcfg(), **change))
    with pytest.raises(ValueError, match=match) as ours:
        cs.train(None)
    with pytest.raises(ValueError, match=match) as theirs:
        jc.train(None)
    assert str(ours.value) == str(theirs.value)


def test_streamed_score_matches_resident(raw, jraw):
    mem, streamed = _pair(raw)
    cm = FixedEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg())
    cs = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg())
    model, _ = cm.train(None)
    np.testing.assert_array_equal(cs.score(model).numpy(), cm.score(model).numpy())
    jc = JaxFEC(dataset=_jstreamed(jraw), task="logistic_regression", config=_jcfg())
    jmodel, _ = jc.train(None)
    np.testing.assert_allclose(cs.score(model).numpy(), np.asarray(jc.score(jmodel)), atol=1e-8)


# ---------------------------------------------------------------- stability


def test_streamed_objective_bitwise_stable(raw):
    """The slots add in slice order: repeated passes and a repeated whole
    solve are bitwise equal."""
    _, streamed = _pair(raw)
    hb = streamed.host_batch
    obj = StreamedFEObjective(get_loss("logistic_regression"), hb, BUDGET, l2_weight=0.3, device="cpu")
    assert obj.n_slices > 1
    w = torch.linspace(-0.2, 0.2, hb.dim, dtype=torch.float64)
    v1, g1 = obj.value_and_grad(w)
    v2, g2 = obj.value_and_grad(w)
    assert float(v1) == float(v2) and torch.equal(g1, g2)
    assert torch.equal(obj.hessian_vector(w, w), obj.hessian_vector(w, w))
    cs = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg())
    ma, _ = cs.train(None)
    mb, _ = cs.train(None)
    assert torch.equal(ma.model.coefficients.means, mb.model.coefficients.means)
    jobj = JaxStreamedObjective(JAX_LOSSES["logistic"], _jhb_from(hb), BUDGET, l2_weight=0.3)
    jv, jg = jobj.value_and_grad(w.numpy())
    np.testing.assert_allclose(float(v1), float(jv), rtol=1e-13)
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg), rtol=1e-12, atol=1e-12)


def _jhb_from(hb):
    from photon_ml_tpu.game.data import HostRowBatch as JaxHostRowBatch

    return JaxHostRowBatch(dim=hb.dim, labels=hb.labels.numpy(), offsets=hb.offsets.numpy(),
                           weights=hb.weights.numpy(), dense=hb.dense.numpy())


# ---------------------------------------------------------------- telemetry


def test_streamed_metrics_recorded(raw):
    _, streamed = _pair(raw)
    run = obs.RunTelemetry()
    with obs.use_run(run):
        _, result = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg()).train(None)
    snap = {(m["name"], m["labels"].get("site"), m["labels"].get("kind")): m for m in run.registry.snapshot()}
    assert snap[("photon_stream_staged_bytes_total", "fe.train", None)]["value"] > 0
    assert snap[("photon_stream_slices_total", "fe.train", None)]["value"] >= 2
    assert snap[("photon_stream_passes_total", "fe.train", "vg")]["value"] >= result.iterations
    actual = snap[("photon_stream_actual_slice_bytes", "fe.train", None)]["value"]
    assert 0 < 2 * actual <= BUDGET
    stage_s = snap[("photon_stream_stage_seconds", "fe.train", None)]["value"]
    solve_s = snap[("photon_stream_solve_seconds", "fe.train", None)]["value"]
    assert 0 <= stage_s <= solve_s
    # depth 1: staging is serial with the compute it feeds
    assert snap[("photon_stream_overlap_ratio", "fe.train", None)]["value"] == 0.0


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_counters_are_slices_times_passes(raw, depth):
    """The stream counters count each slice a pass reads, whatever the
    depth: the background stager's look-ahead copy past the last pass does
    not show in them. A pass stages the batch's real rows only: the short
    tail is not padded to the step."""
    _, streamed = _pair(raw)
    hb = streamed.host_batch
    step = rows_per_slice(BUDGET, hb.feature_row_nbytes())
    n_slices = -(-hb.n_rows // step)
    assert hb.n_rows % step, "the shape should leave a short tail"
    run = obs.RunTelemetry()
    with obs.use_run(run), pipeline.pipelined(depth):
        FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg()).train(None)
    snap = {(m["name"], m["labels"].get("site"), m["labels"].get("kind")): m for m in run.registry.snapshot()}
    passes = sum(snap[("photon_stream_passes_total", "fe.train", k)]["value"] for k in ("vg", "hvp"))
    assert passes > 1
    assert snap[("photon_stream_slices_total", "fe.train", None)]["value"] == n_slices * passes
    assert snap[("photon_stream_staged_bytes_total", "fe.train", None)]["value"] == (
        passes * hb.n_rows * hb.feature_row_nbytes())
    assert snap[("photon_stream_slice_stage_seconds", None, None)]["count"] == n_slices * passes


def test_ell_key_segments_built_once_and_only_for_training(raw):
    """An ELL slice's column segments are built on the host once per batch
    and slice size, however many solves read them; scoring, whose matvec
    reads the row segments alone, builds none."""
    _, streamed = _pair(raw, layout="ell")
    hb = streamed.host_batch
    coord = FixedEffectCoordinate(dataset=streamed, task="logistic_regression", config=_cfg())
    model, _ = coord.train(None)
    (segs,) = hb.cache().values()
    obj = StreamedFEObjective(get_loss("logistic_regression"), hb, BUDGET, device="cpu")
    assert len(segs) == obj.n_slices > 1 and obj._stager._keys is segs
    coord.train(None, initial_model=model)
    assert len(hb.cache()) == 1 and next(iter(hb.cache().values())) is segs
    _, fresh = _pair(raw, layout="ell")
    coord_fresh = FixedEffectCoordinate(dataset=fresh, task="logistic_regression", config=_cfg())
    np.testing.assert_array_equal(coord_fresh.score(model).numpy(), coord.score(model).numpy())
    assert fresh.host_batch.cache() == {}


# ---------------------------------------------------- satellite: RE scoring


def test_re_streamed_score_work_flat_in_slice_count(raw):
    kw = dict(active_cap=64, dtype=torch.float64, device="cpu")
    mem = build_random_effect_dataset(raw, "re", "userShard", "userId", **kw)
    cm = RandomEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg())
    model, _ = cm.train(None)
    ref = cm.score(model).numpy()
    n = raw.n_rows
    for budget in (16 << 10, 1 << 10):  # few slices, then many
        ds = build_random_effect_dataset(raw, "re", "userShard", "userId", hbm_budget_bytes=budget, **kw)
        assert ds.streamed
        cs = RandomEffectCoordinate(dataset=ds, task="logistic_regression", config=_cfg())
        np.testing.assert_array_equal(cs.score(model).numpy(), ref)
        cache = ds._stream_xsub_cache
        assert 0 < cache.device_rows <= 2 * n


# ---------------------------------------------------------------- defense


def _coords(raw, streamed_fe):
    re_ds = build_random_effect_dataset(raw, "per-user", "userShard", "userId", dtype=torch.float64, device="cpu")
    return {
        "global": FixedEffectCoordinate(dataset=streamed_fe, task="logistic_regression", config=_cfg()),
        "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression", config=_cfg()),
    }


def test_streamed_fe_divergence_rejection(raw):
    _, streamed = _pair(raw)
    run = obs.RunTelemetry()
    with obs.use_run(run):
        coords = _coords(raw, streamed)
        validation = ValidationContext(
            suite=build_suite(["LOGISTIC_LOSS"], raw.labels),
            score_fns={name: coords[name].score for name in coords}, offsets=raw.offsets,
        )
        faults.configure("solver.value_and_grad:nan:1")
        result = CoordinateDescent(coords, n_iterations=2, validation=validation).run()
        rejected = run.registry.counter("photon_coordinate_rejections_total", "").labels(coordinate="global").value
    assert rejected == 1
    for name in coords:
        assert torch.isfinite(coords[name].score(result.model[name])).all()


def test_streamed_fe_checkpoint_resume(raw, tmp_path):
    from photon_ml_tpu_torch.robust import CheckpointManager

    def make():
        return _coords(raw, _pair(raw)[1])

    coords = make()
    ref = CoordinateDescent(coords, n_iterations=2, validation=None).run()
    ckpt = str(tmp_path / "ck")
    coords2 = make()
    CoordinateDescent(coords2, n_iterations=2, validation=None,
                      boundary_fn=CheckpointManager(ckpt, fsync=False).on_boundary).run()
    snap = CheckpointManager(ckpt, fsync=False).latest_valid(expect_coordinate_order=list(coords2),
                                                             expect_n_iterations=2)
    assert snap is not None
    resumed = CoordinateDescent(make(), n_iterations=2, validation=None, resume_state=snap).run()
    for name in coords:
        np.testing.assert_array_equal(coords[name].score(ref.model[name]).numpy(),
                                      coords[name].score(resumed.model[name]).numpy())


# ---------------------------------------------------------------- e2e CLI


def _records_and_schema(**gen):
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing.generators import generate_game_records

    data = generate_mixed_effect_data(**gen)
    schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    return generate_game_records(data), schema


def test_cli_trains_streamed_fe_with_parity(tmp_path):
    """An FE coordinate over a zero budget trains streamed through
    cli.train (three part files), as the JAX package's cli.train does, and
    the port's streamed run matches its resident run and the JAX package's
    streamed run."""
    from photon_ml_tpu.cli.train import run as jax_train_run
    from photon_ml_tpu_torch.cli.train import run as train_run
    from photon_ml_tpu_torch.io import write_avro_file

    recs, schema = _records_and_schema(n=600, d_fixed=6, re_specs={"userId": (24, 5)}, seed=4, entity_skew=1.4)
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    for i in range(3):
        write_avro_file(str(train_dir / f"part-{i:05d}.avro"), schema, recs[i * 200:(i + 1) * 200])
    args = [
        "--input-data", str(train_dir), "--validation-data", str(train_dir), "--task", "logistic_regression",
        "--feature-shard", "name=global,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
        "--coordinate", "name=per-user,shard=userShard,re.type=userId,reg.type=L2,reg.weights=1",
        "--evaluators", "AUC",
    ]
    fe = "name=global,shard=global,optimizer=LBFGS,reg.type=L2,reg.weights=1"
    s_mem = train_run(args + ["--coordinate", fe, "--output-dir", str(tmp_path / "m"), "--device", "cpu"])
    s_str = train_run(args + ["--coordinate", fe + ",hbm.budget.mb=0", "--output-dir", str(tmp_path / "s"),
                              "--device", "cpu", "--metrics-out", str(tmp_path / "metrics")])
    j_str = jax_train_run(args + ["--coordinate", fe + ",hbm.budget.mb=0", "--output-dir", str(tmp_path / "j")])
    auc = s_str["best"]["metrics"]["AUC"]
    assert abs(auc - s_mem["best"]["metrics"]["AUC"]) < 1e-6
    assert abs(auc - j_str["best"]["metrics"]["AUC"]) < 1e-4
    prom = (tmp_path / "metrics" / "metrics.prom").read_text()
    assert 'photon_stream_slices_total{site="fe.train"}' in prom


def test_score_streamed_fe_direct(raw, jraw):
    mem, streamed = _pair(raw)
    w = torch.linspace(-0.3, 0.3, streamed.host_batch.dim, dtype=torch.float64)
    out = score_streamed_fe(streamed.host_batch, w, BUDGET, torch.float64, device="cpu")
    np.testing.assert_array_equal(out.numpy(), mem.batch.features.matvec(w).numpy())
    from photon_ml_tpu.game.fe_streaming import score_streamed_fe as jax_score

    ref = np.asarray(jax_score(_jstreamed(jraw).host_batch, jnp.asarray(w.numpy()), BUDGET, jnp.float64))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-12)


def _disk_fixture(tmp_path, n_parts, n, seed):
    from photon_ml_tpu_torch.io import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing.generators import generate_game_records

    recs = generate_game_records(generate_mixed_effect_data(n=n, d_fixed=6 if n > 40 else 4, re_specs={}, seed=seed))
    train_dir = tmp_path / "train"
    train_dir.mkdir()
    per = len(recs) // n_parts
    for i in range(n_parts):
        write_avro_file(str(train_dir / f"part-{i:05d}.avro"), TRAINING_EXAMPLE_AVRO, recs[i * per:(i + 1) * per])
    return str(train_dir)


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_disk_to_slice_streamed_fit_matches_memory_path(tmp_path, layout):
    """Part files decoded across the ingest pool straight into host planes:
    the in-memory builder's planes bit for bit, and the same coefficients
    bit for bit; the planes are the JAX package's disk path's too."""
    from photon_ml_tpu.game.data import build_fixed_effect_dataset_from_disk as jax_from_disk
    from photon_ml_tpu.io import FeatureShardConfig as JaxShard
    from photon_ml_tpu_torch.game.data import build_fixed_effect_dataset_from_disk
    from photon_ml_tpu_torch.io import FeatureShardConfig, read_avro_dataset_chunked

    train_dir = _disk_fixture(tmp_path, 4, 240, 7)
    shards = {"global": FeatureShardConfig(feature_bags=("features",))}
    raw, maps = read_avro_dataset_chunked(train_dir, shards, engine="python")
    budget = 4 << 10
    mem = build_fixed_effect_dataset(raw, "global", "global", dtype=torch.float64, layout=layout,
                                     hbm_budget_bytes=budget, device="cpu")
    assert mem.streamed
    disk, _ = build_fixed_effect_dataset_from_disk(train_dir, shards, "global", "global", budget, index_maps=maps,
                                                   dtype=torch.float64, layout=layout, workers=3, device="cpu")
    assert disk.streamed
    planes = ("dense",) if layout == "dense" else ("ell_idx", "ell_val")
    for name in planes + ("labels", "offsets", "weights"):
        assert getattr(mem.host_batch, name).numpy().tobytes() == getattr(disk.host_batch, name).numpy().tobytes()
    jdisk, _ = jax_from_disk(train_dir, {"global": JaxShard(feature_bags=("features",))}, "global", "global", budget,
                             dtype=jnp.float64, layout=layout, workers=2)
    for name in planes:
        np.testing.assert_array_equal(getattr(disk.host_batch, name).numpy(), np.asarray(getattr(jdisk.host_batch, name)))
    m_mem, _ = FixedEffectCoordinate(dataset=mem, task="logistic_regression", config=_cfg()).train(None)
    m_disk, _ = FixedEffectCoordinate(dataset=disk, task="logistic_regression", config=_cfg()).train(None)
    assert torch.equal(m_mem.model.coefficients.means, m_disk.model.coefficients.means)


def test_disk_to_slice_refuses_non_row_sliceable_layout(tmp_path):
    from photon_ml_tpu.game.data import build_fixed_effect_dataset_from_disk as jax_from_disk
    from photon_ml_tpu.io import FeatureShardConfig as JaxShard
    from photon_ml_tpu_torch.game.data import build_fixed_effect_dataset_from_disk
    from photon_ml_tpu_torch.io import FeatureShardConfig

    train_dir = _disk_fixture(tmp_path, 1, 40, 9)
    with pytest.raises(ValueError, match="requires a row-sliceable layout") as ours:
        build_fixed_effect_dataset_from_disk(train_dir, {"global": FeatureShardConfig(feature_bags=("features",))},
                                             "global", "global", 1 << 20, layout="coo", device="cpu")
    with pytest.raises(ValueError, match="requires a row-sliceable layout") as theirs:
        jax_from_disk(train_dir, {"global": JaxShard(feature_bags=("features",))}, "global", "global", 1 << 20,
                      layout="coo")
    assert str(ours.value) == str(theirs.value)
