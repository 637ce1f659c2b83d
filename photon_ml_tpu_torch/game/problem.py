"""GLM optimization problems: objective + optimizer + regularization in one unit.

Counterpart of the JAX package's ``game/problem.py``: ``GLMProblem.run``
trains one GLM over a batch (warm start and prior mapped into the
normalization's transformed space, the solve there, the coefficients mapped
back). ``run_lanes`` solves L regularization candidates of one batch at
once: the ``[d, L]`` objective on the lane-generic batched TRON and L-BFGS,
its products one ``matmat`` / ``rmatmat`` for all lanes (S2 on a sparse
batch on the card), the per-lane L2 weight a tensor operand.
``run_streamed`` trains out of core: the fixed effect's rows stay in host
memory and every evaluation streams them through the card in row slices
(``game/fe_streaming.py``).

Over a batch that ``parallel.mesh.shard_batch`` cut to one rank's rows,
``run`` is the same call on every rank of the batch's group: every sweep is
summed across the ranks bitwise alike (ops/fused_glm.py's ``sharded_*``),
every rank starts from rank 0's ``w0``, and the solver's host loop then
fetches the same scalars and takes the same decisions on every rank.

Over a (data x model)-tiled batch (the sparse tiles of
``parallel/sparse.py`` or the dense tiles of
``parallel.mesh.shard_batch(shard_features_dim=True)``) ``run`` is the same
call on every rank of the grid: the warm start and the prior are padded to
the batch's padded dim and cut to the rank's model slice, the solver state
is ``[d_loc]`` (its reductions summed over the data row,
``GLMObjective.coefficient_axis``), and the model comes back whole on every
rank, in the original space, still padded (the coordinate trims it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..models.coefficients import Coefficients
from ..models.glm import GeneralizedLinearModel, model_for_task
from ..device import resolve_device
from ..ops.features import LabeledBatch
from ..ops.fused_glm import OBJECTIVE_ROUTES
from ..ops.glm import GLMObjective, check_full_variance_dim, compute_variances
from ..ops.losses import get_loss
from ..ops.normalization import NormalizationContext
from ..ops.regularization import NO_REGULARIZATION, RegularizationContext
from ..optimize import OptimizerConfig, OptimizerType, SolverResult, optimize, solve_lbfgs, solve_tron
from ..optimize.common import SyncCounter, abs_tolerances

Tensor = torch.Tensor

_KERNEL_X_DTYPES = (torch.float32, torch.bfloat16)


def batch_route(batch: LabeledBatch) -> str:
    """The route a batch's sweeps take, not counted (``_fusion_mode``
    counts it once per solve):

    - ``"dense_kernel"``: a dense float32/bfloat16 batch on a CUDA device
      (kernels B1-B3 of ops/fused_glm.py);
    - ``"sparse_kernel"``: an ELL or sorted-COO float32/bfloat16 batch on a
      CUDA device (the segment kernel of ops/sparse.py);
    - ``"tiled_kernel"``: a (data x model)-tiled sparse float32 batch on a
      CUDA device (the segment kernel on the rank's tile, the rank-order
      sum over the grid's subgroups);
    - ``"tiled_dense"``: a dense tile of the feature-axis shard on a CUDA
      device (``torch.mv`` on the rank's tile, as the JAX package sends
      such a batch down its jnp path, and the rank-order sum);
    - ``"plain_cpu"``: a batch on the CPU (the plain versions);
    - ``"plain_float64"``: a float64 batch on a CUDA device takes the plain
      versions on the card, as the JAX package sends float64 to its XLA
      path (``pallas_glm.eligible``).

    Anything else raises: nothing on the card falls back to the plain
    versions. A row-sharded sparse batch is refused in the JAX package's
    words (``parallel.mesh``'s ``SHARD_COO_REFUSAL`` / ``MULTI_ELL_REFUSAL``)."""
    f = batch.features
    x = f.values
    dev = x.device
    group = batch.group
    tiled = f.layout == "tiled"
    if group is not None:
        if group.device != dev:
            raise ValueError(f"a shard on {dev} for a rank whose device is {group.device}")
        if not f.is_dense and not tiled:
            from ..parallel.mesh import MULTI_ELL_REFUSAL, SHARD_COO_REFUSAL

            raise NotImplementedError(SHARD_COO_REFUSAL if f.layout == "coo" else MULTI_ELL_REFUSAL)
    for name in ("labels", "offsets", "weights"):
        if getattr(batch, name).device != dev:
            raise ValueError(f"batch.{name} is not on the features' device {dev}")
    if dev.type == "cpu":
        route = "plain_cpu"
    elif dev.type != "cuda":
        raise ValueError(f"batches run on a CUDA device or the CPU, got {dev}")
    elif torch.float64 in (x.dtype, batch.labels.dtype):
        route = "plain_float64"
    elif x.dtype not in _KERNEL_X_DTYPES:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16 features, got {x.dtype}"
        )
    else:
        if tiled:
            route = "tiled_dense" if f.tile.is_dense else "tiled_kernel"
        else:
            route = "dense_kernel" if f.is_dense else "sparse_kernel"
    return route


def _fusion_mode(batch: LabeledBatch):
    """``(route, group)`` of a solve over ``batch``: its ``batch_route``,
    counted in ``fused_glm.OBJECTIVE_ROUTES``, and its data-parallel group
    (None for a whole batch), over which every sweep is summed."""
    route = batch_route(batch)
    OBJECTIVE_ROUTES[route] += 1
    return route, batch.group


def _pad_dim(v: Tensor, dim: int, fill: float) -> Tensor:
    if v.shape[0] >= dim:
        return v
    return torch.cat([v, torch.full((dim - v.shape[0],), fill, dtype=v.dtype, device=v.device)])


def _mesh_of(batch: LabeledBatch):
    """The grid of a tiled batch (``parallel.mesh.MeshGroup``), else None."""
    return batch.features.mesh if batch.features.layout == "tiled" else None


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfig:
    """Per-coordinate optimization settings."""

    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    regularization: RegularizationContext = NO_REGULARIZATION
    reg_weight: float = 0.0
    # fixed-effect down-sampling (game/sampling.py): 1.0 keeps every row
    down_sampling_rate: float = 1.0
    variance_type: str = "NONE"  # NONE | SIMPLE | FULL

    def with_reg_weight(self, w: float) -> "GLMOptimizationConfig":
        return dataclasses.replace(self, reg_weight=w)

    def solver_config(self) -> OptimizerConfig:
        """OptimizerConfig with the regularization split applied (L1 /
        elastic net -> the OWL-QN l1 weight)."""
        return dataclasses.replace(
            self.optimizer,
            l1_weight=self.regularization.l1_weight(self.reg_weight),
        )


@dataclasses.dataclass(frozen=True)
class GLMProblem:
    """A ready-to-run training problem over one batch."""

    task: str
    config: GLMOptimizationConfig
    normalization: Optional[NormalizationContext] = None
    # incremental training: L2 centred on a prior model's means, weighted by
    # its precisions
    prior: Optional[Coefficients] = None

    def _norm_for(self, batch: LabeledBatch, whole: bool = False) -> Optional[NormalizationContext]:
        """The normalization padded to the batch's dim (identity entries on
        the padding); a tiled batch's objective takes its model slice of it
        (``whole=False``)."""
        if self.normalization is None:
            return None
        norm = self.normalization.to(batch.device).padded(batch.dim)
        mesh = _mesh_of(batch)
        if mesh is not None and not whole:
            d_loc = batch.dim // mesh.n_model
            norm = norm.sliced(mesh.model_index * d_loc, (mesh.model_index + 1) * d_loc)
        return norm

    def objective(self, batch: LabeledBatch, plain: bool = False) -> GLMObjective:
        norm = self._norm_for(batch)
        prior_mean = prior_precision = None
        if self.prior is not None:
            dtype, dev = batch.labels.dtype, batch.device
            prior_mean = self.prior.means.to(device=dev, dtype=dtype)
            if self.normalization is not None:
                prior_mean = self._norm_for(batch, whole=True).model_to_transformed_space(
                    _pad_dim(prior_mean, batch.dim, 0.0)
                )
            if self.prior.variances is not None:
                var = self.prior.variances.to(device=dev, dtype=dtype)
                prior_precision = 1.0 / torch.clamp(var, min=1e-12)
            else:
                prior_precision = torch.ones_like(prior_mean)
            # padded coordinates have no data: prior mean 0, precision 1
            # pins them at zero
            prior_mean = _pad_dim(prior_mean, batch.dim, 0.0)
            prior_precision = _pad_dim(prior_precision, batch.dim, 1.0)
            mesh = _mesh_of(batch)
            if mesh is not None:
                prior_mean, prior_precision = mesh.model_slice(prior_mean), mesh.model_slice(prior_precision)
        return GLMObjective(
            loss=get_loss(self.task),
            batch=batch,
            l2=self.config.regularization.l2_weight(self.config.reg_weight),
            norm=norm,
            prior_mean=prior_mean,
            prior_precision=prior_precision,
            plain=plain,
        )

    def run(
        self,
        batch: LabeledBatch,
        initial_model: Optional[GeneralizedLinearModel] = None,
        plain: bool = False,
    ) -> Tuple[GeneralizedLinearModel, SolverResult]:
        """Train; returns (model in ORIGINAL space, solver result).

        A dense or sparse float32/bfloat16 batch on the card runs the CUDA
        kernels; a CPU batch, and a float64 batch on the card, their plain
        versions (``_fusion_mode``). ``plain=True`` runs the plain versions on
        the card as well: a reference solve to hold the kernels' solve
        against. A row-sharded batch solves on every rank of its group at
        once, a tiled batch on every rank of its grid.
        """
        vt = self.config.variance_type.upper()
        # fail before the solve, not after it
        if vt == "FULL":
            check_full_variance_dim(batch.dim)
        elif vt not in ("NONE", "SIMPLE"):
            compute_variances(None, None, vt)
        if not plain:
            plain = _fusion_mode(batch)[0] == "plain_float64"
        obj = self.objective(batch, plain=plain)
        dtype, dev = batch.labels.dtype, batch.device
        norm = self._norm_for(batch, whole=True)
        if initial_model is not None:
            w0 = initial_model.coefficients.means.to(device=dev, dtype=dtype)
            w0 = _pad_dim(w0, batch.dim, 0.0)
            if norm is not None:
                w0 = norm.model_to_transformed_space(w0)
        else:
            w0 = torch.zeros(batch.dim, dtype=dtype, device=dev)
        if batch.group is not None:
            w0 = batch.group.broadcast(w0)
        mesh = _mesh_of(batch)
        solver_config = self.config.solver_config()
        if mesh is not None:
            w0 = mesh.model_slice(w0).clone()
            box = solver_config.box_constraints
            if box is not None:
                lower, upper = (_pad_dim(b.to(device=dev, dtype=dtype), batch.dim, fill)
                                for b, fill in zip(box, (-math.inf, math.inf)))
                solver_config = dataclasses.replace(
                    solver_config, box_constraints=(mesh.model_slice(lower), mesh.model_slice(upper))
                )

        result = optimize(
            obj.value_and_grad, w0, solver_config, hvp=obj.hessian_vector, axis=obj.coefficient_axis
        )
        # variances stay in the transformed space, as in the reference
        variances = compute_variances(obj, result.coefficients, vt)
        if mesh is not None:
            # the model-sharded solution whole on every rank of the grid
            coef, grad = mesh.gather_model([result.coefficients, result.gradient])
            result = dataclasses.replace(result, coefficients=coef, gradient=grad)
        means = result.coefficients
        if norm is not None:
            means = norm.model_to_original_space(means)
        model = model_for_task(self.task, Coefficients(means=means, variances=variances))
        return model, result

    def zero_model(self, dim: int, dtype=torch.float32, device="cuda") -> GeneralizedLinearModel:
        return model_for_task(self.task, Coefficients.zeros(dim, dtype, device))

    def run_streamed(
        self,
        host_batch,  # game.data.HostRowBatch
        budget_bytes: int,
        residual_scores: Optional[Tensor] = None,  # device f[n] or None
        initial_model: Optional[GeneralizedLinearModel] = None,
        device=None,
        plain: bool = False,
        group=None,
    ) -> Tuple[GeneralizedLinearModel, SolverResult]:
        """Train out of core: row slices of the host batch stream through
        ``device`` double-buffered (``game/fe_streaming.py``) while the
        port's host-loop optimizer takes one streamed pass per evaluation.
        The normalization, warm start and prior as in ``run``; variances are
        refused (a streamed pass never forms the Hessian). The route counts
        in ``OBJECTIVE_ROUTES`` once per solve, as ``run``'s does;
        ``plain=True`` runs the plain versions on the card. ``group`` (a
        ``parallel.mesh.DataParallelGroup``): ``host_batch`` and
        ``residual_scores`` are this rank's rows and each pass sums every
        rank's, so the solver's loop, unchanged, sees the same numbers on
        every rank."""
        from .. import obs
        from .fe_streaming import StreamedFEObjective

        vt = self.config.variance_type.upper()
        if vt != "NONE":
            raise ValueError(
                f"variance={vt} is not supported on the streamed fixed-effect"
                " path (out-of-core row slices never materialize the Hessian);"
                " use variance=NONE or raise hbm.budget.mb so the batch is"
                " HBM-resident"
            )
        dim = host_batch.dim
        dtype = host_batch.labels.dtype
        dev = resolve_device(device)
        norm = None
        if self.normalization is not None:
            norm = self.normalization.to(dev).padded(dim)
        prior_mean = prior_precision = None
        if self.prior is not None:
            prior_mean = self.prior.means.to(device=dev, dtype=dtype)
            if norm is not None:
                prior_mean = norm.model_to_transformed_space(prior_mean)
            if self.prior.variances is not None:
                var = self.prior.variances.to(device=dev, dtype=dtype)
                prior_precision = 1.0 / torch.clamp(var, min=1e-12)
            else:
                prior_precision = torch.ones_like(prior_mean)
        if initial_model is not None:
            w0 = initial_model.coefficients.means.to(device=dev, dtype=dtype)
            if norm is not None:
                w0 = norm.model_to_transformed_space(w0)
        else:
            w0 = torch.zeros(dim, dtype=dtype, device=dev)

        obj = StreamedFEObjective(
            get_loss(self.task), host_batch, budget_bytes, norm=norm,
            l2_weight=self.config.regularization.l2_weight(self.config.reg_weight),
            prior_mean=prior_mean, prior_precision=prior_precision,
            residual_scores=residual_scores, device=dev, plain=plain, group=group,
        )
        OBJECTIVE_ROUTES[obj.route] += 1
        try:
            with obs.span(
                "fe_stream.solve", phase="solve", n_slices=obj.n_slices, budget_bytes=int(budget_bytes)
            ) as solve_span:
                result = optimize(obj.value_and_grad, w0, self.config.solver_config(), hvp=obj.hessian_vector)
            obj.record_metrics("fe.train", solve_span.duration_s)
        finally:
            obj.close()
        means = result.coefficients
        if norm is not None:
            means = norm.model_to_original_space(means)
        model = model_for_task(self.task, Coefficients(means=means, variances=None))
        return model, result

    def run_lanes(
        self,
        batch: LabeledBatch,
        offsets_lanes: Tensor,  # f[n, L] effective offsets per lambda lane
        l2_lanes,  # f[L] per-lane L2 weights (a tensor operand)
        w0: Optional[Tensor] = None,  # f[d, L] warm start; None = zeros
        plain: bool = False,
    ) -> Tuple[Tensor, SolverResult]:
        """Lane-stacked solve: L regularization candidates share one data
        residency and one solve. Returns (coefficients f[d, L], per-lane
        SolverResult: loss, reason and iterations ``[L]``). A lane that is
        born corrupt or diverges freezes at its warm start with
        ``NUMERICAL_DIVERGENCE`` without stalling its neighbours (the batched
        solvers' masked commit).

        Composition limits (the JAX package's, with its messages): L2 only,
        variance NONE, no normalization, no prior. ``plain=True`` (and a
        float64 batch on the card) runs the plain versions of the sparse
        products."""
        solver_cfg = self.config.solver_config()
        if solver_cfg.l1_weight > 0.0:
            raise ValueError(
                "trial-lanes sweeps support L2 regularization only (the "
                "OWL-QN l1 weight is compile-time static, not a per-lane "
                "operand)"
            )
        if self.config.variance_type.upper() != "NONE":
            raise ValueError(
                "trial-lanes sweeps require variance=NONE (per-lane "
                "Hessian inversion is not lane-stacked)"
            )
        if self.normalization is not None:
            raise ValueError("feature normalization is not supported with trial-lanes")
        if self.prior is not None:
            raise ValueError("regularize-by-prior is not supported with trial-lanes")
        if batch.group is not None:
            raise ValueError("trial-lanes sweeps are single-process: a row-sharded batch takes no lanes")
        if not plain:
            plain = batch_route(batch) == "plain_float64"
        dtype, dev = batch.labels.dtype, batch.device
        L = offsets_lanes.shape[1]
        w0 = torch.zeros((batch.dim, L), dtype=dtype, device=dev) if w0 is None else w0.to(device=dev, dtype=dtype)
        result = _train_fe_lanes(
            batch.features, batch.labels, offsets_lanes.to(dtype), batch.weights, w0,
            torch.as_tensor(l2_lanes, dtype=dtype, device=dev),
            task=self.task,
            optimizer_type=OptimizerType(solver_cfg.normalized_type()).value,
            tolerance=solver_cfg.tolerance,
            max_iterations=solver_cfg.max_iterations,
            num_corrections=solver_cfg.num_corrections,
            max_cg_iterations=solver_cfg.max_cg_iterations,
            max_improvement_failures=solver_cfg.max_improvement_failures,
            plain=plain,
        )
        return result.coefficients, result


def _train_fe_lanes(
    features,  # FeatureMatrix
    labels: Tensor,  # f[n]
    offsets_lanes: Tensor,  # f[n, L]
    weights: Tensor,  # f[n]
    w0: Tensor,  # f[d, L]
    l2_lanes: Tensor,  # f[L]
    *,
    task: str,
    optimizer_type: str,
    tolerance: float,
    max_iterations: int,
    num_corrections: int,
    max_cg_iterations: int,
    max_improvement_failures: int,
    plain: bool = False,
) -> SolverResult:
    """The fixed-effect objective widened over the lambda-lane axis (the
    JAX package's ``_train_fe_lanes``): margins are one ``matmat``
    (``[n, L]``), the gradient one ``rmatmat`` (``[d, L]``), the L2 term
    broadcasts the per-lane weights, and every solver reduction is axis 0,
    so the lanes ride through the batched TRON / L-BFGS (entity-minor
    layout, ``optimize.common.MINOR``). Each lane's value sums in the
    batch's dtype, as the JAX package's lane objective and the port's
    single-lane sparse objective do, so that a lane's line search compares
    values at the single-lane solve's resolution."""
    loss = get_loss(task)
    y = labels[:, None]
    wt = weights[:, None]

    def value_and_grad(w):  # [d, L] -> ([L], [d, L])
        z = features.matmat(w, plain=plain) + offsets_lanes
        lvals, dz = loss.loss_and_dz(z, y)
        value = torch.sum(wt * lvals, dim=0) + 0.5 * l2_lanes * torch.sum(w * w, dim=0)
        grad = features.rmatmat(wt * dz, plain=plain) + l2_lanes * w
        return value, grad

    def hessian_vector(w, v):
        z = features.matmat(w, plain=plain) + offsets_lanes
        c = wt * loss.d2z(z, y) * features.matmat(v, plain=plain)
        return features.rmatmat(c, plain=plain) + l2_lanes * v

    syncs = SyncCounter()
    loss_tol, grad_tol = abs_tolerances(value_and_grad, w0, tolerance)
    if optimizer_type == OptimizerType.TRON.value:
        return solve_tron(
            value_and_grad, hessian_vector, w0, loss_tol, grad_tol,
            max_iterations=max_iterations, max_cg_iterations=max_cg_iterations,
            max_improvement_failures=max_improvement_failures, syncs=syncs,
        )
    return solve_lbfgs(
        value_and_grad, w0, loss_tol, grad_tol,
        max_iterations=max_iterations, num_corrections=num_corrections, syncs=syncs, batched=True,
    )
