"""GLM optimization problems: objective + optimizer + regularization in one unit.

Counterpart of the JAX package's ``game/problem.py``: ``GLMProblem.run``
trains one GLM over a batch (warm start and prior mapped into the
normalization's transformed space, the solve there, the coefficients mapped
back). ``run_streamed`` and ``run_lanes`` are not ported yet.

Over a batch that ``parallel.mesh.shard_batch`` cut to one rank's rows,
``run`` is the same call on every rank of the batch's group: every sweep is
summed across the ranks bitwise alike (ops/fused_glm.py's ``sharded_*``),
every rank starts from rank 0's ``w0``, and the solver's host loop then
fetches the same scalars and takes the same decisions on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models.coefficients import Coefficients
from ..models.glm import GeneralizedLinearModel, model_for_task
from ..ops.features import LabeledBatch
from ..ops.glm import GLMObjective, compute_variances
from ..ops.losses import get_loss
from ..ops.normalization import NormalizationContext
from ..ops.regularization import NO_REGULARIZATION, RegularizationContext
from ..optimize import OptimizerConfig, SolverResult, optimize

Tensor = torch.Tensor

_KERNEL_X_DTYPES = (torch.float32, torch.bfloat16)


def _fusion_mode(batch: LabeledBatch):
    """Which sweeps a batch takes, as ``(mode, group)``: mode ``"kernel"`` for
    a dense batch on a CUDA device (the CUDA kernels of ops/fused_glm.py),
    ``"plain"`` for a batch on the CPU (their plain versions); ``group`` is
    the batch's data-parallel group (None for a whole batch), over which
    every sweep is summed. Anything else raises: nothing on the card falls
    back to the plain versions."""
    f = batch.features
    dev = f.dense.device
    group = batch.group
    if group is not None and group.device != dev:
        raise ValueError(f"a shard on {dev} for a rank whose device is {group.device}")
    if dev.type == "cpu":
        return "plain", group
    if dev.type != "cuda":
        raise ValueError(f"batches run on a CUDA device or the CPU, got {dev}")
    if f.dense.dtype not in _KERNEL_X_DTYPES:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16 features, got {f.dense.dtype}"
        )
    for name in ("labels", "offsets", "weights"):
        if getattr(batch, name).device != dev:
            raise ValueError(f"batch.{name} is not on the features' device {dev}")
    return "kernel", group


def _pad_dim(v: Tensor, dim: int, fill: float) -> Tensor:
    if v.shape[0] >= dim:
        return v
    return torch.cat([v, torch.full((dim - v.shape[0],), fill, dtype=v.dtype, device=v.device)])


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfig:
    """Per-coordinate optimization settings."""

    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    regularization: RegularizationContext = NO_REGULARIZATION
    reg_weight: float = 0.0
    # fixed-effect down-sampling (game/sampling.py) is ROADMAP A4: 1.0 only
    down_sampling_rate: float = 1.0
    variance_type: str = "NONE"  # NONE | SIMPLE (FULL is ROADMAP A6)

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

    def _norm_for(self, batch: LabeledBatch) -> Optional[NormalizationContext]:
        if self.normalization is None:
            return None
        return self.normalization.to(batch.device).padded(batch.dim)

    def objective(self, batch: LabeledBatch, plain: bool = False) -> GLMObjective:
        norm = self._norm_for(batch)
        prior_mean = prior_precision = None
        if self.prior is not None:
            dtype, dev = batch.labels.dtype, batch.device
            prior_mean = self.prior.means.to(device=dev, dtype=dtype)
            if norm is not None:
                prior_mean = norm.model_to_transformed_space(prior_mean)
            if self.prior.variances is not None:
                var = self.prior.variances.to(device=dev, dtype=dtype)
                prior_precision = 1.0 / torch.clamp(var, min=1e-12)
            else:
                prior_precision = torch.ones_like(prior_mean)
            prior_mean = _pad_dim(prior_mean, batch.dim, 0.0)
            prior_precision = _pad_dim(prior_precision, batch.dim, 1.0)
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

        A dense batch on the card runs the CUDA kernels; a CPU batch their
        plain versions. ``plain=True`` runs the plain versions on the card as
        well: a reference solve to hold the kernels' solve against. A
        row-sharded batch solves on every rank of its group at once.
        """
        vt = self.config.variance_type.upper()
        if vt not in ("NONE", "SIMPLE"):
            # fail before the solve, not after it
            compute_variances(None, None, vt)
        if not plain:
            _fusion_mode(batch)
        obj = self.objective(batch, plain=plain)
        dtype, dev = batch.labels.dtype, batch.device
        if initial_model is not None:
            w0 = initial_model.coefficients.means.to(device=dev, dtype=dtype)
            if obj.norm is not None:
                w0 = obj.norm.model_to_transformed_space(w0)
            w0 = _pad_dim(w0, batch.dim, 0.0)
        else:
            w0 = torch.zeros(batch.dim, dtype=dtype, device=dev)
        if batch.group is not None:
            w0 = batch.group.broadcast(w0)

        result = optimize(
            obj.value_and_grad, w0, self.config.solver_config(), hvp=obj.hessian_vector
        )
        # variances stay in the transformed space, as in the reference
        variances = compute_variances(obj, result.coefficients, vt)
        means = result.coefficients
        if obj.norm is not None:
            means = obj.norm.model_to_original_space(means)
        model = model_for_task(self.task, Coefficients(means=means, variances=variances))
        return model, result

    def zero_model(self, dim: int, dtype=torch.float32, device="cuda") -> GeneralizedLinearModel:
        return model_for_task(self.task, Coefficients.zeros(dim, dtype, device))

    def run_streamed(self, *args, **kwargs):
        raise NotImplementedError(
            "run_streamed (out-of-core fixed effect) is not ported yet (ROADMAP A7)"
        )

    def run_lanes(self, *args, **kwargs):
        raise NotImplementedError(
            "run_lanes (lane-stacked sweeps) is not ported yet (ROADMAP A8)"
        )
