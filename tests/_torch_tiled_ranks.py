"""Rank bodies of the tiled (data x model) tests of the PyTorch port.

``photon_ml_tpu_torch.parallel.spawn`` starts each rank in a fresh process
that imports this module by name; it imports neither JAX nor the JAX
package. ``grid_checks`` lays the ranks out as every grid the payload
names (one world of 8 ranks takes (8, 1), (1, 8), (4, 2) and (2, 4) in
turn, each with subgroups of its own) and runs that grid's checks; every
rank returns numpy results and its grid position, and the caller holds them
against the JAX package and across ranks. The module defines no test.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.normalization import build_normalization
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig, optimize
from photon_ml_tpu_torch.parallel.mesh import make_mesh
from photon_ml_tpu_torch.parallel.sparse import (
    replicated_coefficients,
    tile_sparse_matrix,
    tiled_sparse_batch,
)

F64 = torch.float64


def _np(t):
    return t.detach().cpu().numpy()


def _w_pad(w, dim):
    out = np.zeros(dim)
    out[: len(w)] = w
    return out


def _products(mesh, case):
    rows, cols, vals, n, d, w, c = (case[k] for k in ("rows", "cols", "vals", "n", "d", "w", "c"))
    fm = tile_sparse_matrix(rows, cols, vals, n, d, mesh, dtype=F64)
    w_t = replicated_coefficients(_w_pad(w, fm.dim), mesh, F64)
    c_whole = np.zeros(fm.n_rows)
    c_whole[:n] = c
    lo = mesh.data_index * fm.n_local_rows
    c_t = torch.as_tensor(c_whole[lo : lo + fm.n_local_rows])
    return dict(
        dim=fm.dim, n_rows=fm.n_rows, z=_np(fm.matvec(w_t)), g=_np(fm.rmatvec(c_t)), g2=_np(fm.sq_rmatvec(c_t)),
    )


def _solve(mesh, case):
    tb = tiled_sparse_batch(case["rows"], case["cols"], case["vals"], case["y"], case["d"], mesh, dtype=F64)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=case["lam"])
    w0 = replicated_coefficients(np.zeros(tb.dim), mesh, F64)
    res = optimize(obj.value_and_grad, w0, OptimizerConfig(tolerance=1e-10, max_iterations=200),
                   axis=obj.coefficient_axis)
    return dict(w=_np(res.coefficients), iterations=int(res.iterations), reason=int(res.reason),
                loss=float(res.loss))


def _value_grad(mesh, case):
    tb = tiled_sparse_batch(case["rows"], case["cols"], case["vals"], case["y"], case["d"], mesh, dtype=F64)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=0.25)
    w_t = replicated_coefficients(_w_pad(case["w"], tb.dim), mesh, F64)
    v, g = obj.value_and_grad(w_t)
    v_t = replicated_coefficients(_w_pad(case["v"], tb.dim), mesh, F64)
    return dict(value=float(v), g=_np(g), hd=_np(obj.hessian_diagonal(w_t)), hv=_np(obj.hessian_vector(w_t, v_t)))


def _full(mesh, case):
    tb = tiled_sparse_batch(case["rows"], case["cols"], case["vals"], case["y"], case["d"], mesh, dtype=F64)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=0.25)
    w_t = replicated_coefficients(_w_pad(case["w"], tb.dim), mesh, F64)
    h = obj.hessian_matrix(w_t)
    var = compute_variances(obj, w_t, "FULL")
    chunked = tb.features.xtcx(obj._d2z_weights(w_t), row_chunk=16)
    simple = compute_variances(obj, w_t, "SIMPLE")
    return dict(dim=tb.dim, h=_np(h), var=_np(var), chunked=_np(chunked), simple=_np(simple))


def _normalized(mesh, case):
    d = case["d"]
    norm = build_normalization(
        "STANDARDIZATION", case["mean"], case["var"], case["absmax"], intercept_index=d - 1, dtype=F64,
        device="cpu",
    )
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=1e-10, max_iterations=200),
        regularization=RegularizationContext("L2"), reg_weight=0.5, variance_type="FULL",
    )
    tb = tiled_sparse_batch(case["rows"], case["cols"], case["vals"], case["y"], d, mesh, dtype=F64)
    model, res = GLMProblem(task="logistic_regression", config=cfg, normalization=norm).run(tb)
    return dict(means=_np(model.coefficients.means), var=_np(model.coefficients.variances),
                iterations=int(res.iterations), reason=int(res.reason))


def _ceiling(mesh, case):
    """The FULL ceiling raises before the solve and from hessian_matrix."""
    from photon_ml_tpu_torch.ops.glm import MAX_FULL_VARIANCE_DIM

    d_over = MAX_FULL_VARIANCE_DIM + 8
    tb = tiled_sparse_batch(case["rows"], case["cols"], case["vals"], case["y"], d_over, mesh, dtype=F64)
    problem = GLMProblem(task="logistic_regression", config=GLMOptimizationConfig(
        optimizer=OptimizerConfig(max_iterations=1), regularization=RegularizationContext("L2"), reg_weight=1.0,
        variance_type="FULL",
    ))
    out = {}
    for name, call in (("run", lambda: problem.run(tb)),
                       ("hessian_matrix", lambda: GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=1.0)
                        .hessian_matrix(torch.zeros(tb.dim // mesh.n_model, dtype=F64)))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


CHECKS = {
    "products": _products, "solve": _solve, "value_grad": _value_grad, "full": _full,
    "normalized": _normalized, "ceiling": _ceiling,
}


def grid_checks(group, payload):
    """For each ``(shape, checks)`` of ``payload["grids"]``: the grid, then
    each named check on its case of ``payload["cases"]``; returns
    ``{shape: {"pos": (i, j), check: result}}``."""
    torch.manual_seed(0)
    out = {}
    for shape, checks in payload["grids"]:
        mesh = make_mesh(*shape, group=group)
        res = {"pos": (mesh.data_index, mesh.model_index)}
        for name in checks:
            res[name] = CHECKS[name](mesh, payload["cases"][name])
        out[tuple(shape)] = res
    if "estimator" in payload:
        out["estimator"] = estimator_fit(group, payload["estimator"])
    return out


def estimator_fit(group, payload):
    """tests/test_scale_paths.py's estimator case on the port's grid:
    GameEstimator with a tiled fixed effect and two random effects on a
    (4 x 2) grid, each rank holding its data row's rows (a per-host read);
    returns the fixed effect's means and each random effect's coefficients
    keyed by entity id."""
    from photon_ml_tpu_torch.estimators.game_estimator import CoordinateConfig, GameEstimator
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.parallel.multihost import equal_host_share, host_row_range

    raw = RawDataset(**payload["raw"])
    mesh = make_mesh(*payload["grid"], group=group)
    lo, hi = host_row_range(raw.n_rows, index=mesh.data_index, count=mesh.n_data)
    local = raw.subset(np.arange(lo, hi))
    local.global_row_start = lo
    local = local.pad_rows(equal_host_share(raw.n_rows, mesh.n_data))
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=1e-8, max_iterations=40),
        regularization=RegularizationContext("L2"), reg_weight=1.0,
    )
    coords = [CoordinateConfig(name="global", feature_shard="global", config=cfg, layout="tiled")] + [
        CoordinateConfig(name=name, feature_shard=shard, config=cfg, random_effect_type=tag)
        for name, shard, tag in (("per-user", "userShard", "userId"), ("per-item", "itemShard", "itemId"))
    ]
    est = GameEstimator(task="logistic_regression", coordinate_configs=coords, n_cd_iterations=2, mesh=mesh,
                        dtype=F64, device="cpu")
    model = est.fit(local)[-1].model
    out = {"pos": (mesh.data_index, mesh.model_index),
           "global": _np(model["global"].model.coefficients.means)}
    for name, shard in (("per-user", "userShard"), ("per-item", "itemShard")):
        re = model[name]
        ids = [str(e) for e in re.entity_ids if not str(e).startswith("__pad")]
        dense = np.asarray(re.dense_coefficients(raw.shard_dims[shard]))
        out[name] = {e: dense[r] for e, r in zip(ids, re.rows_for(ids))}
    return out
