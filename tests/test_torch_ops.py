"""Parity of the PyTorch port's objective layer with the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``photon_ml_tpu_torch`` (``device="cpu"``, which takes the
plain PyTorch versions of the CUDA kernels). Where the JAX side reaches a
Pallas kernel it runs in interpret mode, as tests/test_pallas_glm.py runs
it. Bounds are the reference suite's own (tests/test_pallas_glm.py):
value rtol 2e-6; gradient and Hv max-abs error <= 3e-5 * max(|ref|, 1).
Every array is built float32 on both sides (the conftest enables x64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu.ops.features import FeatureMatrix as JaxFeatureMatrix
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch
from photon_ml_tpu.ops.glm import GLMObjective as JaxObjective
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu.ops.normalization import build_normalization as jax_build_normalization
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.ops import fused_glm
from photon_ml_tpu_torch.ops.features import FeatureMatrix, batch_from_dense, pad_batch
from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances
from photon_ml_tpu_torch.ops.losses import LOSSES, TASK_LOSSES, get_loss
from photon_ml_tpu_torch.ops.normalization import build_normalization

D = 256
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_vec(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref))
    bound = 3e-5 * max(np.max(np.abs(ref)), 1.0)
    assert err <= bound, f"{what}: max-abs error {err:.3e} > bound {bound:.3e}"


def _data(rng, n, d=D, poisson=False):
    x = rng.standard_normal((n, d)).astype(F32)
    y = (rng.random(n) > 0.5).astype(F32)
    if poisson:
        y = y * 2
    off = (rng.standard_normal(n) * 0.1).astype(F32)
    wt = (rng.random(n) + 0.5).astype(F32)
    return x, y, off, wt


def _norm_arrays(rng, d=D):
    factors = (rng.random(d) + 0.5).astype(F32)
    shifts = ((rng.random(d) - 0.5) * 0.2).astype(F32)
    factors[0], shifts[0] = 1.0, 0.0
    return factors, shifts


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_reference(name):
    """l, dl/dz and d2l/dz2 of all four losses, at margins that cross every
    branch boundary (smoothed hinge's m = 0 and m = 1 included), f32 both
    sides."""
    z = np.concatenate([np.linspace(-30, 30, 241), [-1.0, 0.0, 1.0, 0.5, -0.5]]).astype(F32)
    labels = (0.0, 1.0, 0.5, 0.51) if name != "poisson" else (0.0, 1.0, 3.0)
    for yv in labels:
        y = np.full_like(z, yv)
        jl, jdz = JAX_LOSSES[name].loss_and_dz(jnp.asarray(z), jnp.asarray(y))
        jd2 = JAX_LOSSES[name].d2z(jnp.asarray(z), jnp.asarray(y))
        tl, tdz = LOSSES[name].loss_and_dz(_t(z), _t(y))
        td2 = LOSSES[name].d2z(_t(z), _t(y))
        for got, ref in ((tl, jl), (tdz, jdz), (td2, jd2)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6, atol=1e-6)


def test_loss_dispatch_matches_reference():
    from photon_ml_tpu.ops.losses import TASK_LOSSES as JAX_TASKS

    assert sorted(TASK_LOSSES) == sorted(JAX_TASKS)
    for task, loss in JAX_TASKS.items():
        assert get_loss(task).name == loss.name
    assert [LOSSES[k].code for k in ("logistic", "squared", "poisson", "smoothed_hinge")] == [0, 1, 2, 3]
    with pytest.raises(KeyError):
        get_loss("hinge")


@pytest.mark.parametrize("loss_name", sorted(LOSSES))
@pytest.mark.parametrize("with_norm", [False, True])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_plain_sweeps_match_pallas_kernels(rng, loss_name, with_norm, xdt):
    """The plain B1 and B2 under the port's GLMObjective against the JAX
    objective driving pallas_glm.fused_value_grad / fused_hessian_vector in
    interpret mode: 4 losses x normalization x f32/bf16 X, with a ragged last
    tile (n = one tile + 7 rows), prior-centred L2 on."""
    tn = pallas_glm.tile_rows(D, 2 if xdt == "bfloat16" else 4)
    n = tn + 7
    x, y, off, wt = _data(rng, n, poisson=loss_name == "poisson")
    pm = (rng.standard_normal(D) * 0.01).astype(F32)
    pp = (rng.random(D) + 0.5).astype(F32)
    w = (rng.standard_normal(D) * 0.1).astype(F32)
    v = rng.standard_normal(D).astype(F32)
    factors, shifts = _norm_arrays(rng)

    jdt = jnp.bfloat16 if xdt == "bfloat16" else jnp.float32
    jnorm = JaxNorm(jnp.asarray(factors), jnp.asarray(shifts), 0) if with_norm else None
    jobj = JaxObjective(
        loss=JAX_LOSSES[loss_name],
        batch=jax_batch(x, y, offsets=off, weights=wt, dtype=jnp.float32, feature_dtype=jdt),
        l2=0.3, norm=jnorm, prior_mean=jnp.asarray(pm), prior_precision=jnp.asarray(pp),
        fused="interpret",
    )
    tdt = torch.bfloat16 if xdt == "bfloat16" else torch.float32
    tnorm = (
        convert.normalization_from_numpy(factors, shifts, 0, device="cpu") if with_norm else None
    )
    tobj = GLMObjective(
        loss=LOSSES[loss_name],
        batch=batch_from_dense(x, y, offsets=off, weights=wt, feature_dtype=tdt, device="cpu"),
        l2=0.3, norm=tnorm, prior_mean=_t(pm), prior_precision=_t(pp),
    )
    jv, jg = jobj.value_and_grad(jnp.asarray(w))
    tv, tg = tobj.value_and_grad(_t(w))
    assert tv.dtype == torch.float32 and tg.dtype == torch.float32
    np.testing.assert_allclose(float(tv), float(jv), rtol=2e-6)
    _close_vec(tg.numpy(), jg, "gradient")
    jh = jobj.hessian_vector(jnp.asarray(w), jnp.asarray(v))
    th = tobj.hessian_vector(_t(w), _t(v))
    _close_vec(th.numpy(), jh, "Hv")


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_plain_sweeps_raw_aggregates(rng, xdt):
    """The raw aggregates of the plain versions against the Pallas kernels
    called directly (interpret mode), on a ragged tile."""
    n = pallas_glm.tile_rows(D, 2 if xdt == torch.bfloat16 else 4) + 3
    x, y, off, wt = _data(rng, n)
    coef = (rng.standard_normal(D) * 0.1).astype(F32)
    v = rng.standard_normal(D).astype(F32)
    jdt = jnp.bfloat16 if xdt == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x, jdt)
    loss = "logistic"
    jv, jg, jw = pallas_glm.fused_value_grad(
        jx, jnp.asarray(coef), jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt),
        JAX_LOSSES[loss], interpret=True,
    )
    tx = _t(x).to(xdt)
    tv, tg, tw = fused_glm.fused_value_grad(tx, _t(coef), _t(y), _t(off), _t(wt), LOSSES[loss])
    np.testing.assert_allclose(float(tv), float(jv), rtol=2e-6)
    _close_vec(tg.numpy(), jg, "raw gradient")
    np.testing.assert_allclose(float(tw), float(jw), rtol=2e-5, atol=1e-4)
    jh, jc = pallas_glm.fused_hessian_vector(
        jx, jnp.asarray(coef), jnp.asarray(v), jnp.asarray(y), jnp.asarray(off),
        jnp.asarray(wt), jnp.asarray(0.25, jnp.float32), JAX_LOSSES[loss], interpret=True,
    )
    th, tc = fused_glm.fused_hessian_vector(
        tx, _t(coef), _t(v), _t(y), _t(off), _t(wt), torch.tensor(0.25), LOSSES[loss]
    )
    _close_vec(th.numpy(), jh, "raw Hv")
    np.testing.assert_allclose(float(tc), float(jc), rtol=2e-5, atol=1e-4)
    # on the CPU the wrappers take the plain versions and launch nothing
    assert fused_glm.LAUNCHES == {
        "fused_value_grad": 0, "fused_hessian_vector": 0, "fused_hessian_stats": 0
    }


def test_plain_float64_reference_agrees(rng):
    """compute_dtype=float64 widens the same rounded inputs: it agrees with
    the f32 plain version within the kernel bounds (the reference that
    chip_smoke.py holds the kernels against)."""
    x, y, off, wt = _data(rng, 1000)
    coef = (rng.standard_normal(D) * 0.1).astype(F32)
    tx = _t(x).to(torch.bfloat16)
    a = fused_glm.value_grad_plain(tx, _t(coef), _t(y), _t(off), _t(wt), LOSSES["poisson"])
    b = fused_glm.value_grad_plain(
        tx, _t(coef), _t(y), _t(off), _t(wt), LOSSES["poisson"], compute_dtype=torch.float64
    )
    assert b[1].dtype == torch.float64
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=2e-6)
    _close_vec(a[1].numpy(), b[1].numpy(), "f32 vs f64 gradient")


def test_objective_with_normalization_matches_unfused_reference(rng):
    """f32 X: the port's objective equals the JAX package's two-pass jnp
    objective too (no kernel on either side), with normalization and plain
    L2."""
    x, y, off, wt = _data(rng, 500)
    factors, shifts = _norm_arrays(rng)
    w = (rng.standard_normal(D) * 0.1).astype(F32)
    v = rng.standard_normal(D).astype(F32)
    jobj = JaxObjective(
        loss=JAX_LOSSES["squared"],
        batch=jax_batch(x, y, offsets=off, weights=wt, dtype=jnp.float32),
        l2=0.7, norm=JaxNorm(jnp.asarray(factors), jnp.asarray(shifts), 0),
    )
    tobj = GLMObjective(
        loss=LOSSES["squared"],
        batch=batch_from_dense(x, y, offsets=off, weights=wt, device="cpu"),
        l2=0.7, norm=convert.normalization_from_numpy(factors, shifts, 0, device="cpu"),
    )
    np.testing.assert_allclose(float(tobj.value(_t(w))), float(jobj.value(jnp.asarray(w))), rtol=2e-6)
    _close_vec(tobj.gradient(_t(w)).numpy(), jobj.gradient(jnp.asarray(w)), "gradient")
    _close_vec(
        tobj.hessian_vector(_t(w), _t(v)).numpy(),
        jobj.hessian_vector(jnp.asarray(w), jnp.asarray(v)),
        "Hv",
    )


@pytest.mark.parametrize("norm_type", ["SCALE_WITH_STANDARD_DEVIATION", "SCALE_WITH_MAX_MAGNITUDE", "STANDARDIZATION"])
def test_normalization_matches_reference(rng, norm_type):
    means = rng.standard_normal(D)
    variances = rng.random(D) * 2
    variances[5] = 0.0
    mags = rng.random(D) * 3
    jn = jax_build_normalization(norm_type, means, variances, mags, 0, dtype=jnp.float32)
    tn = build_normalization(norm_type, means, variances, mags, 0, device="cpu")
    jf, js = jn.factors, jn.shifts
    tf, ts, ti = convert.normalization_to_numpy(tn)
    assert ti == jn.intercept_index
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=1e-7)
    if js is None:
        assert ts is None
    else:
        np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-7)
    coef = rng.standard_normal(D).astype(F32)
    for jfn, tfn in (
        (jn.model_to_original_space, tn.model_to_original_space),
        (jn.model_to_transformed_space, tn.model_to_transformed_space),
    ):
        np.testing.assert_allclose(tfn(_t(coef)).numpy(), np.asarray(jfn(jnp.asarray(coef))), rtol=1e-5, atol=1e-6)
    je, jsh = jn.effective_coefficients(jnp.asarray(coef))
    te, tsh = tn.effective_coefficients(_t(coef))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(float(tsh), float(jsh), rtol=1e-5, atol=1e-6)
    padded = tn.padded(D + 4)
    jpadded = jn.padded(D + 4)
    np.testing.assert_allclose(padded.factors.numpy(), np.asarray(jpadded.factors))
    with pytest.raises(ValueError):
        build_normalization("STANDARDIZATION", means, variances, mags, None, device="cpu")


def test_features_dense_only(rng):
    x, y, off, wt = _data(rng, 37, d=8)
    b = batch_from_dense(x, y, offsets=off, weights=wt, device="cpu")
    jb = jax_batch(x, y, offsets=off, weights=wt, dtype=jnp.float32)
    c = rng.standard_normal(8).astype(F32)
    r = rng.standard_normal(37).astype(F32)
    np.testing.assert_allclose(b.features.matvec(_t(c)).numpy(), np.asarray(jb.features.matvec(jnp.asarray(c))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.features.rmatvec(_t(r)).numpy(), np.asarray(jb.features.rmatvec(jnp.asarray(r))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.features.sq_rmatvec(_t(r)).numpy(), np.asarray(jb.features.sq_rmatvec(jnp.asarray(r))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.margins(_t(c)).numpy(), np.asarray(jb.margins(jnp.asarray(c))), rtol=1e-5, atol=1e-6)
    p = pad_batch(b, 40)
    assert p.n_rows == 40 and float(p.weights[37:].abs().sum()) == 0.0
    bf = batch_from_dense(x, y, feature_dtype=torch.bfloat16, device="cpu")
    assert bf.features.dense.dtype == torch.bfloat16 and bf.labels.dtype == torch.float32
    # the sparse layouts are ported (tests/test_torch_sparse.py), the
    # streamed row slice with them. The lane products are
    # held against the JAX package's, dense here and sparse in
    # tests/test_torch_lanes.py
    W = rng.standard_normal((8, 3)).astype(F32)
    C = rng.standard_normal((37, 3)).astype(F32)
    np.testing.assert_allclose(b.features.matmat(_t(W)).numpy(), np.asarray(jb.features.matmat(jnp.asarray(W))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.features.rmatmat(_t(C)).numpy(), np.asarray(jb.features.rmatmat(jnp.asarray(C))),
                               rtol=1e-5, atol=1e-5)
    ell = FeatureMatrix(dim=8, idx=torch.zeros((2, 1), dtype=torch.int32), val=torch.zeros((2, 1)))
    assert ell.layout == "ell" and ell.n_rows == 2
    jell = JaxFeatureMatrix(dim=8, idx=jnp.zeros((2, 1), jnp.int32), val=jnp.zeros((2, 1), jnp.float32))
    # the streamed row slice is ported: an ELL window, as the JAX package's
    np.testing.assert_array_equal(ell.slice_rows(1, 1).to_dense().numpy(),
                                  np.asarray(jell.slice_rows(1, 1).to_dense()))
    np.testing.assert_array_equal(ell.matmat(_t(W)).numpy(), np.asarray(jell.matmat(jnp.asarray(W))))
    coo = FeatureMatrix(dim=8, coo_cols=torch.zeros(1, dtype=torch.int32), coo_rows=torch.zeros(1, dtype=torch.int32),
                        coo_vals=torch.zeros(1), coo_n_rows=2)
    assert coo.layout == "coo" and coo.n_rows == 2
    jcoo = JaxFeatureMatrix(dim=8, coo_cols=jnp.zeros(1, jnp.int32), coo_rows=jnp.zeros(1, jnp.int32),
                            coo_vals=jnp.zeros(1, jnp.float32), coo_n_rows=2)
    np.testing.assert_array_equal(coo.rmatmat(_t(C[:2])).numpy(), np.asarray(jcoo.rmatmat(jnp.asarray(C[:2]))))


def test_variances_and_hessian_matrix_name_next_slice(rng):
    x, y, off, wt = _data(rng, 20, d=4)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, device="cpu"))
    w = torch.zeros(4)
    assert compute_variances(obj, w, "none") is None
    # SIMPLE landed with kernel B3, FULL (the dense Hessian) later
    # (tests/test_torch_variance.py holds it against the JAX package)
    simple = compute_variances(obj, w, "SIMPLE")
    assert simple.shape == (4,) and bool(torch.isfinite(simple).all())
    full = compute_variances(obj, w, "FULL")
    h = obj.hessian_matrix(w)
    assert h.shape == (4, 4) and full.shape == (4,) and bool(torch.isfinite(full).all())
    torch.testing.assert_close(full, torch.diagonal(torch.linalg.inv(h.double())).float(), rtol=1e-4, atol=0)
    with pytest.raises(ValueError):
        compute_variances(obj, w, "BOGUS")


def test_wrappers_refuse_non_cpu_non_cuda_tensors(rng):
    """A wrapper given a tensor that is neither on the CPU nor on a CUDA
    device raises instead of computing anywhere else."""
    x = torch.zeros((4, 3), device="meta")
    vec = torch.zeros(3, device="meta")
    rows = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_glm.fused_value_grad(x, vec, rows, rows, rows, LOSSES["logistic"])
    with pytest.raises(ValueError, match="CUDA"):
        fused_glm.fused_hessian_vector(x, vec, vec, rows, rows, rows, 0.0, LOSSES["logistic"])
    with pytest.raises(ValueError, match="CUDA"):
        fused_glm.fused_hessian_stats(x, vec, rows, rows, rows, LOSSES["logistic"], True)


def test_sweep_byte_and_flop_counts():
    n, d = 500_000, 1024
    b1 = fused_glm.sweep_bytes(n, d, torch.float32, fused_glm.VG)
    b2 = fused_glm.sweep_bytes(n, d, torch.float32, fused_glm.HV)
    b3 = fused_glm.sweep_bytes(n, d, torch.float32, fused_glm.HD)
    b3s = fused_glm.sweep_bytes(n, d, torch.float32, fused_glm.HD_SHIFTS)
    assert b1 == n * d * 4 + d * 4 + 12 * n + 4 * (d + 2)
    assert b2 == n * d * 4 + 2 * d * 4 + 12 * n + 4 + 4 * (d + 1)
    assert b3 == n * d * 4 + d * 4 + 12 * n + 4 * d
    assert b3s == n * d * 4 + d * 4 + 12 * n + 4 * (2 * d + 1)
    assert fused_glm.sweep_bytes(n, d, torch.bfloat16, fused_glm.VG) < b1 * 0.51
    assert fused_glm.sweep_flops(n, d, fused_glm.VG) == 4 * n * d
    assert fused_glm.sweep_flops(n, d, fused_glm.HV) == 6 * n * d
    assert fused_glm.sweep_flops(n, d, fused_glm.HD) == 5 * n * d
    assert fused_glm.sweep_flops(n, d, fused_glm.HD_SHIFTS) == 7 * n * d


@pytest.mark.parametrize(
    "mode,d,body",
    [
        (fused_glm.VG, 1, fused_glm.RING), (fused_glm.VG, 1024, fused_glm.RING),
        (fused_glm.HV, 1024, fused_glm.RING), (fused_glm.VG, 1025, fused_glm.STAGED),
        (fused_glm.HV, 4096, fused_glm.STAGED), (fused_glm.HD, 64, fused_glm.STAGED),
        (fused_glm.HD_SHIFTS, 1024, fused_glm.STAGED),
    ],
)
def test_body_choice(mode, d, body):
    """Value+grad and Hv take the ring body up to RING_MAX_D columns, every
    other sweep the staged body; each launch counts under its route."""
    assert fused_glm.body_for(mode, d) == body
    assert fused_glm.route_name(fused_glm.STAGED, 1) == "staged"
    assert fused_glm.route_name(fused_glm.RING, 1) == "ring_bulk_copy"
    assert fused_glm.route_name(fused_glm.RING, 0) == "ring_plain_loads"
    assert set(fused_glm.ROUTES) == {"ring_bulk_copy", "ring_plain_loads", "staged"}


class _PlanLibrary:
    """Stands in for the CUDA library's fused_glm_plan: records each call
    and writes a plan made from its arguments."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def fused_glm_plan(self, mode, bf16, n, d, body, vec16, grid, rows, stages, smem):
        self.calls.append((mode, bf16, n, d, body, vec16))
        grid._obj.value, rows._obj.value = 100 + len(self.calls), 8
        stages._obj.value, smem._obj.value = 14 if body else 1, 1000 * d
        return self.rc


def test_launch_plans_are_cached_per_shape_and_device(monkeypatch):
    """The plan of a (device, mode, dtype, n, d, alignment, body) is asked of
    the library once; any other key plans anew; a failed plan raises naming
    the shape and is not cached."""
    monkeypatch.setattr(fused_glm, "_PLANS", {})
    lib = _PlanLibrary()
    key = (0, fused_glm.VG, 0, 500_000, 1024, 1, fused_glm.RING)
    first = fused_glm._plan(lib, key)
    assert first == (101, 8, 14, 1_024_000)
    assert fused_glm._plan(lib, key) == first and len(lib.calls) == 1
    others = [
        (1,) + key[1:], (0, fused_glm.HV) + key[2:], key[:2] + (1,) + key[3:],
        key[:3] + (499_999,) + key[4:], key[:5] + (0, fused_glm.RING), key[:6] + (fused_glm.STAGED,),
    ]
    for other in others:
        fused_glm._plan(lib, other)
    assert len(lib.calls) == 1 + len(others)
    assert fused_glm._plan(lib, key) == first and len(lib.calls) == 1 + len(others)
    bad = _PlanLibrary(rc=1)
    with pytest.raises(RuntimeError, match="fused_glm_plan failed for n=2, d=20000"):
        fused_glm._plan(bad, (0, fused_glm.HV, 0, 2, 20_000, 1, fused_glm.STAGED))
    assert (0, fused_glm.HV, 0, 2, 20_000, 1, fused_glm.STAGED) not in fused_glm._PLANS


def test_plan_cache_is_bounded(monkeypatch):
    monkeypatch.setattr(fused_glm, "_PLANS", {})
    lib = _PlanLibrary()
    for n in range(fused_glm._PLAN_CACHE_SIZE + 3):
        fused_glm._plan(lib, (0, fused_glm.VG, 0, n + 1, 64, 1, fused_glm.RING))
    assert 0 < len(fused_glm._PLANS) <= fused_glm._PLAN_CACHE_SIZE


def test_reset_launch_counts_clears_routes():
    fused_glm.ROUTES["staged"] += 3
    fused_glm.reset_launch_counts()
    assert fused_glm.ROUTES == {"ring_bulk_copy": 0, "ring_plain_loads": 0, "staged": 0}


def test_reset_launch_counts_clears_the_rank_order_sums():
    fused_glm.SUM_LAUNCHES["rank_order_sum"] += 2
    fused_glm.reset_launch_counts()
    assert fused_glm.SUM_LAUNCHES == {"rank_order_sum": 0}


def test_rank_order_sum_refuses_non_cpu_non_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_glm.rank_order_sum(torch.zeros((2, 3), dtype=torch.float64, device="meta"))
    assert fused_glm.SUM_LAUNCHES == {"rank_order_sum": 0}
