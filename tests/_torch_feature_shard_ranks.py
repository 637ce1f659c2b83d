"""Rank bodies of the dense feature-axis shard tests of the PyTorch port.

``photon_ml_tpu_torch.parallel.spawn`` starts each rank in a fresh process
that imports this module by name; it imports neither JAX nor the JAX
package. ``grid_checks`` lays the ranks out as every grid the payload
names (one world of 8 ranks takes (2, 4), (4, 2), (1, 8) and (8, 1) in
turn) and runs that grid's checks on the dense tiles of
``shard_batch(shard_features_dim=True)``; ``estimator_fit`` runs
tests/test_scale_paths.py's estimator case with a dense fixed effect
replicated over the model axis; ``dense_tiles_on_card`` is the card
test's (tests/test_torch_cuda.py). Every rank returns its results and its
grid position, and the caller holds them against the JAX package, the
float64 CPU pass and across ranks. The module defines no test.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
from photon_ml_tpu_torch.ops.features import batch_from_dense
from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances
from photon_ml_tpu_torch.ops.losses import LOSSES
from photon_ml_tpu_torch.ops.normalization import build_normalization
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optimize import OptimizerConfig
from photon_ml_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_coefficients

F64 = torch.float64


def _np(t):
    return t.detach().cpu().numpy()


def _tiles(mesh, case):
    batch = batch_from_dense(case["x"], case["y"], dtype=F64, device="cpu")
    return shard_batch(batch, mesh, shard_features_dim=True)


def _norm(case, mesh):
    if "mean" not in case:
        return None
    d = case["x"].shape[1]
    return build_normalization(
        "STANDARDIZATION", case["mean"], case["var"], case["absmax"], intercept_index=d - 1, dtype=F64,
        device=mesh.device,
    )


def _feature_dim(mesh, case):
    """tests/test_parallel.py:93: value and gradient at one point, the
    tile's products and the tile layout."""
    tb = _tiles(mesh, case)
    f = tb.features
    obj = GLMObjective(loss=LOSSES["logistic"], batch=tb)
    w = shard_coefficients(torch.as_tensor(case["w"]), mesh)
    v, g = obj.value_and_grad(w)
    c = torch.as_tensor(case["c"])
    lo = mesh.data_index * f.n_local_rows
    c_blk = torch.zeros(f.n_local_rows, dtype=F64)
    part = c[lo : lo + f.n_local_rows]
    c_blk[: part.shape[0]] = part
    return dict(
        value=float(v), g=_np(g), z=_np(f.matvec(w)), xtc=_np(f.rmatvec(c_blk)), x2tc=_np(f.sq_rmatvec(c_blk)),
        dense=_np(f.to_dense()), tile_shape=tuple(f.tile.dense.shape), dim=f.dim, n_rows=f.n_rows,
        group=None if tb.group is None else tb.group.world_size,
    )


def _second_order(mesh, case):
    """Hv, the Hessian diagonal and SIMPLE with the normalization's shifts
    and factors, d not a multiple of the model axis."""
    tb = _tiles(mesh, case)
    problem = GLMProblem(task="logistic_regression", config=GLMOptimizationConfig(
        regularization=RegularizationContext("L2"), reg_weight=0.3,
    ), normalization=_norm(case, mesh))
    obj = problem.objective(tb)
    w = shard_coefficients(torch.as_tensor(case["w"]), mesh)
    v = shard_coefficients(torch.as_tensor(case["v"]), mesh)
    value, g = obj.value_and_grad(w)
    return dict(
        value=float(value), g=_np(g), hv=_np(obj.hessian_vector(w, v)), hd=_np(obj.hessian_diagonal(w)),
        simple=_np(compute_variances(obj, w, "SIMPLE")),
    )


def _full(mesh, case):
    """FULL on dense tiles: the whole Hessian and its variances on every
    rank, and a chunked X^T C X."""
    tb = _tiles(mesh, case)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=0.25)
    w = shard_coefficients(torch.as_tensor(case["w"]), mesh)
    chunked = tb.features.xtcx(obj._d2z_weights(w), row_chunk=5)
    return dict(
        h=_np(obj.hessian_matrix(w)), var=_np(compute_variances(obj, w, "FULL")), chunked=_np(chunked), dim=tb.dim,
    )


def _solves(mesh, case):
    """TRON with SIMPLE variances and L-BFGS through GLMProblem.run on the
    dense tiles, float64 at tolerance 1e-9."""
    tb = _tiles(mesh, case)
    out = {}
    for name in ("TRON", "LBFGS"):
        cfg = GLMOptimizationConfig(
            optimizer=OptimizerConfig(optimizer_type=name, tolerance=1e-9, max_iterations=200),
            regularization=RegularizationContext("L2"), reg_weight=0.5,
            variance_type="SIMPLE" if name == "TRON" else "NONE",
        )
        model, res = GLMProblem(task="logistic_regression", config=cfg).run(tb)
        co = model.coefficients
        out[name] = dict(
            means=_np(co.means), var=None if co.variances is None else _np(co.variances),
            iterations=int(res.iterations), reason=int(res.reason), loss=float(res.loss),
        )
    return out


CHECKS = {"feature_dim": _feature_dim, "second_order": _second_order, "full": _full, "solves": _solves}


def grid_checks(group, payload):
    """For each ``(shape, checks)`` of ``payload["grids"]``: the grid, then
    each named check on its case of ``payload["cases"]``; returns
    ``{shape: {"pos": (i, j), check: result}}``, and the estimator case's
    under ``"estimator"``."""
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
    """tests/test_scale_paths.py's estimator case with ``coords("dense")`` on
    the port's (4 x 2) grid: the dense fixed effect replicated over the
    model axis (each model column solves over its data subgroup), two
    random effects over the data axis, each rank holding its data row's
    rows (a per-host read), validated on the whole batch; returns the
    fixed effect's means, each random effect's coefficients keyed by entity
    id, the metrics, the plan's sharding labels and the routes taken."""
    from photon_ml_tpu_torch.estimators.game_estimator import CoordinateConfig, GameEstimator
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import fused_glm
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
    coords = [CoordinateConfig(name="global", feature_shard="global", config=cfg, layout="dense")] + [
        CoordinateConfig(name=name, feature_shard=shard, config=cfg, random_effect_type=tag)
        for name, shard, tag in (("per-user", "userShard", "userId"), ("per-item", "itemShard", "itemId"))
    ]
    est = GameEstimator(task="logistic_regression", coordinate_configs=coords, n_cd_iterations=2, mesh=mesh,
                        evaluator_specs=["AUC", "LOGISTIC_LOSS"], dtype=F64, device="cpu")
    fused_glm.reset_launch_counts()
    result = est.fit(local, validation=raw)[-1]
    model = result.model
    out = {"pos": (mesh.data_index, mesh.model_index), "routes": dict(fused_glm.OBJECTIVE_ROUTES),
           "plan": [c.sharding for c in est.execution_plan.coordinates],
           "metrics": dict(result.evaluation.metrics),
           "global": _np(model["global"].model.coefficients.means)}
    for name, shard in (("per-user", "userShard"), ("per-item", "itemShard")):
        re = model[name]
        ids = [str(e) for e in re.entity_ids if not str(e).startswith("__pad")]
        dense = np.asarray(re.dense_coefficients(raw.shard_dims[shard]))
        out[name] = {e: dense[r] for e, r in zip(ids, re.rows_for(ids))}
    return out


def dense_tiles_on_card(group, payload):
    """The dense feature-axis shard on a (2 x 2) grid of ranks on
    ``payload["device"]`` in ``payload["dtype"]``: the tile's products,
    value, gradient, Hv and the Hessian diagonal at one point (value and
    gradient twice: the same bits for the same input), and a TRON solve
    with SIMPLE variances; with the route taken and the kernel launches."""
    from photon_ml_tpu_torch.ops import fused_glm

    dtype = getattr(torch, payload["dtype"])
    mesh = make_mesh(2, 2, group=group)
    batch = batch_from_dense(payload["x"], payload["y"], dtype=dtype, device="cpu")
    tb = shard_batch(batch, mesh, shard_features_dim=True)
    f = tb.features
    obj = GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=payload["l2"])
    w = shard_coefficients(torch.as_tensor(payload["w"]), mesh, dtype=dtype)
    v = shard_coefficients(torch.as_tensor(payload["v"]), mesh, dtype=dtype)
    value, g = obj.value_and_grad(w)
    value2, g2 = obj.value_and_grad(w)
    cfg = GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type="TRON", tolerance=payload["tolerance"], max_iterations=100),
        regularization=RegularizationContext("L2"), reg_weight=payload["l2"], variance_type="SIMPLE",
    )
    fused_glm.reset_launch_counts()
    model, res = GLMProblem(task="logistic_regression", config=cfg).run(tb)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    return dict(
        pos=(mesh.data_index, mesh.model_index), device=str(f.tile.dense.device),
        z=cpu(f.matvec(w)), value=cpu(value), g=cpu(g), hv=cpu(obj.hessian_vector(w, v)),
        hd=cpu(obj.hessian_diagonal(w)), same_bits=bool(torch.equal(value, value2) and torch.equal(g, g2)),
        means=cpu(model.coefficients.means), var=cpu(model.coefficients.variances), iterations=int(res.iterations),
        routes=dict(fused_glm.OBJECTIVE_ROUTES), sums=dict(fused_glm.SUM_LAUNCHES),
    )
