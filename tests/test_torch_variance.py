"""FULL variance in the port against the JAX package, on the CPU: the dense
Hessian (``GLMObjective.hessian_matrix``), the diagonal of its inverse
(``_diag_of_inverse``) and ``compute_variances("FULL")``.

Inputs are made from numpy seeds and go through both packages: dense, ELL
and COO batches, with and without the normalization's shifts and factors.
Bounds: float64 rtol 1e-9; float32 max-abs error <= 3e-5 * max(|ref|, 1),
the reference suite's bound on its fused-vs-plain Hessian products
(tests/test_pallas_glm.py).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from photon_ml_tpu.ops import glm as jax_glm
from photon_ml_tpu.ops.features import batch_from_coo as jax_batch_from_coo
from photon_ml_tpu.ops.features import batch_from_dense as jax_batch
from photon_ml_tpu.ops.losses import LOSSES as JAX_LOSSES
from photon_ml_tpu.ops.normalization import NormalizationContext as JaxNorm
from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.ops import glm
from photon_ml_tpu_torch.ops.features import batch_from_coo, batch_from_dense
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel import spawn

DTYPES = {"f64": (np.float64, jnp.float64, torch.float64), "f32": (np.float32, jnp.float32, torch.float32)}


def _hold(got, ref, dt):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if dt == "f64":
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    else:
        err = np.max(np.abs(got - ref))
        assert err <= 3e-5 * max(np.max(np.abs(ref)), 1.0), err


def _norm(rng, d, kind, npdt):
    if kind == "none":
        return None, None
    factors = (rng.random(d) + 0.5).astype(npdt)
    shifts = ((rng.random(d) - 0.5) * 0.4).astype(npdt) if kind == "shifts" else None
    factors[0] = 1.0
    if shifts is not None:
        shifts[0] = 0.0
    jn = JaxNorm(factors=jnp.asarray(factors), shifts=None if shifts is None else jnp.asarray(shifts),
                 intercept_index=0)
    tn = NormalizationContext(factors=torch.from_numpy(factors),
                              shifts=None if shifts is None else torch.from_numpy(shifts), intercept_index=0)
    return jn, tn


def _batches(rng, layout, dt, n=90, d=12):
    """The same batch in both packages: dense X with an intercept column
    0, or sparse triplets (an intercept column 0 in every row)."""
    npdt, jdt, tdt = DTYPES[dt]
    y = (rng.random(n) > 0.5).astype(np.float64)
    off = rng.standard_normal(n) * 0.1
    wt = rng.random(n) + 0.5
    if layout == "dense":
        x = rng.standard_normal((n, d))
        x[:, 0] = 1.0
        return (jax_batch(x.astype(npdt), y, off, wt, dtype=jdt),
                batch_from_dense(x.astype(npdt), y, off, wt, dtype=tdt, device="cpu"))
    counts = rng.integers(1, 6, size=n)
    rows = np.concatenate([np.arange(n), np.repeat(np.arange(n), counts)])
    cols = np.concatenate([np.zeros(n, np.int64), rng.integers(1, d, size=counts.sum())])
    vals = np.concatenate([np.ones(n), rng.normal(size=counts.sum())])
    order = rng.permutation(len(rows))
    args = (rows[order], cols[order], vals[order], y, d, off, wt)
    return (jax_batch_from_coo(*args, dtype=jdt, layout=layout),
            batch_from_coo(*args, dtype=tdt, layout=layout, device="cpu"))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("norm_kind", ["none", "factors", "shifts"])
@pytest.mark.parametrize("layout", ["dense", "ell", "coo"])
def test_hessian_matrix_and_full_variances_match_jax(layout, norm_kind, dt):
    rng = np.random.default_rng(zlib.crc32(f"{layout}-{norm_kind}-{dt}".encode()))
    jb, tb = _batches(rng, layout, dt)
    npdt = DTYPES[dt][0]
    jn, tn = _norm(rng, tb.dim, norm_kind, npdt)
    jo = jax_glm.GLMObjective(loss=JAX_LOSSES["logistic"], batch=jb, l2=0.7, norm=jn)
    to = glm.GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=0.7, norm=tn)
    w = (rng.standard_normal(tb.dim) * 0.3).astype(npdt)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    h = to.hessian_matrix(tw)
    assert h.dtype == DTYPES[dt][2] and h.shape == (tb.dim, tb.dim)
    _hold(h.numpy(), jo.hessian_matrix(jw), dt)
    var = glm.compute_variances(to, tw, "FULL")
    _hold(var.numpy(), jax_glm.compute_variances(jo, jw, "FULL"), dt)
    if layout == "dense":
        # SIMPLE reads the same Hessian's diagonal (a sparse batch's SIMPLE
        # squares each entry, repeated (row, column) pairs apart)
        _hold(glm.compute_variances(to, tw, "SIMPLE").numpy(), 1.0 / np.diag(h.double().numpy()), dt)


def test_zero_activity_column_is_pinned_and_collinear_columns_give_nan():
    """tests/test_glm_objective.py:215-237: with l2 = 0 a column that no row
    touches is pinned to variance 1 and leaves the others alone. Two equal
    columns make the Hessian singular: the Cholesky fails in both packages
    and every variance is NaN (the columns are +-1 and the margins 0, so the
    Hessian is exact and its failing pivot is exactly 0)."""
    rng = np.random.default_rng(21)
    n, d = 200, 4
    x = rng.standard_normal((n, d))
    x[:, 2] = 0.0
    y = (rng.random(n) > 0.5).astype(np.float64)
    jo = jax_glm.GLMObjective(loss=JAX_LOSSES["logistic"], batch=jax_batch(x, y, dtype=jnp.float64))
    to = glm.GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, dtype=torch.float64, device="cpu"))
    full = glm.compute_variances(to, torch.zeros(d, dtype=torch.float64), "FULL").numpy()
    ref = np.asarray(jax_glm.compute_variances(jo, jnp.zeros(d), "FULL"))
    assert full[2] == 1.0 and np.all(np.isfinite(full))
    np.testing.assert_allclose(full, ref, rtol=1e-9)

    x = rng.standard_normal((16, d))
    x[:, 0] = np.where(rng.random(16) > 0.5, 1.0, -1.0)
    x[:, 1] = x[:, 0]
    y = (rng.random(16) > 0.5).astype(np.float64)
    for dtype, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        jo = jax_glm.GLMObjective(loss=JAX_LOSSES["logistic"], batch=jax_batch(x, y, dtype=jdt))
        to = glm.GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, dtype=dtype, device="cpu"))
        ref = np.asarray(jax_glm.compute_variances(jo, jnp.zeros(d, jdt), "FULL"))
        got = glm.compute_variances(to, torch.zeros(d, dtype=dtype), "FULL").numpy()
        assert np.all(np.isnan(ref)) and np.all(np.isnan(got))


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_diag_of_inverse_in_two_chunks(dt):
    """d = 2,500 > the 2,048-column chunk: both chunks of the triangular
    solves, against the JAX package's and against numpy's inverse."""
    npdt = DTYPES[dt][0]
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2500, 300)) / 20
    m = (a @ a.T + np.diag(rng.random(2500) + 0.5)).astype(npdt)
    got = glm._diag_of_inverse(torch.from_numpy(m)).numpy()
    _hold(got, jax_glm._diag_of_inverse(jnp.asarray(m)), dt)
    _hold(got, np.diag(np.linalg.inv(m.astype(np.float64))), dt)
    # an indefinite matrix: NaN everywhere, no exception
    assert np.all(np.isnan(glm._diag_of_inverse(torch.tensor([[1.0, 2.0], [2.0, 1.0]])).numpy()))


def test_full_above_the_ceiling_raises_before_the_solve(monkeypatch):
    """The reference's ValueError, from GLMProblem.run before any
    objective evaluation, and from the direct entry points."""
    monkeypatch.setattr(glm, "MAX_FULL_VARIANCE_DIM", 8)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 9))
    batch = batch_from_dense(x, (rng.random(40) > 0.5).astype(np.float64), device="cpu")
    calls = []
    real = glm.GLMObjective.value_and_grad
    monkeypatch.setattr(glm.GLMObjective, "value_and_grad", lambda *a: calls.append(1) or real(*a))
    problem = GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=3), variance_type="FULL"))
    with pytest.raises(ValueError, match="exceeds the supported ceiling 8"):
        problem.run(batch)
    assert calls == []
    obj = glm.GLMObjective(loss=LOSSES["logistic"], batch=batch)
    with pytest.raises(ValueError, match="variance=SIMPLE"):
        glm.compute_variances(obj, torch.zeros(9, dtype=torch.float64), "FULL")
    # at the ceiling it runs
    monkeypatch.setattr(glm, "MAX_FULL_VARIANCE_DIM", 9)
    model, _ = problem.run(batch)
    assert bool(torch.isfinite(model.coefficients.variances).all())


def test_hessian_matrix_ignores_the_tf32_setting():
    """The product runs in float64, which no TF32 setting touches: the same
    bits with matmul precision 'highest' and 'high'."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    obj = glm.GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, (rng.random(300) > 0.5), device="cpu"))
    w = torch.from_numpy(rng.standard_normal(16).astype(np.float32)) * 0.1
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        a = obj.hessian_matrix(w)
        torch.set_float32_matmul_precision("high")
        b = obj.hessian_matrix(w)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(a, b)


@pytest.mark.parametrize("chunk_rows", [None, 3], ids=["one_chunk", "chunks_of_3_rows"])
def test_full_variance_over_two_ranks(tmp_path, chunk_rows):
    """A row-sharded batch on 2 gloo ranks: each rank's float64 partial in
    its slot, the slots added in rank order (in one piece, or in pieces of
    3 rows of the Hessian, X's rows then also taken 3 at a time). Both
    ranks get the same bits, and the Hessian and variances equal the whole
    batch's (built in one chunk) at rtol 1e-12."""
    rng = np.random.default_rng(13)
    n, d = 101, 7
    payload = dict(x=rng.standard_normal((n, d)), y=(rng.random(n) > 0.5).astype(np.float64),
                   w=rng.standard_normal(d) * 0.2, chunk_bytes=chunk_rows and 8 * d * chunk_rows)
    out = spawn("test_torch_parallel_ranks:full_variance", 2, "gloo", "cpu", args=(payload,),
                timeout_s=120.0, store_dir=tmp_path)
    whole = ranks.full_variance(None, payload)
    for key in ("hessian", "variances"):
        assert np.array_equal(out[0][key], out[1][key])
        np.testing.assert_allclose(out[0][key], whole[key], rtol=1e-12)
