"""The GLM objective over a fixed batch: value, gradient, Hessian-vector.

Counterpart of the JAX package's ``ops/glm.py``. The objective is a sum, not
a mean:

    F(w') = sum_i weight_i * l(margin_i, y_i) + (l2/2) * (w' - m)^T P (w' - m)
    margin_i = effective_coef . x_i + margin_shift + offset_i

with effective_coef = w' .* factor and margin_shift = -effective_coef.shift
from the NormalizationContext, and the prior-centred L2 of incremental
training (mean m, precision P; plain L2 when both are absent).

Every sweep of a dense X goes through ``ops/fused_glm.py``'s ``sharded_*``
functions: on the card the CUDA kernels, on the CPU their plain versions,
and over a batch sharded across ranks (``group``, set from ``batch.group``)
each rank's sweep of its rows summed across the ranks in rank order. A
sparse batch (ELL or sorted COO) takes the JAX package's unfused branch:
margins by ``matvec``, the loss terms as torch ops, the accumulations by
``rmatvec`` / ``sq_rmatvec``, each product one launch of the segment kernel
of ``ops/sparse.py`` on the card (2 launches per value+grad, 3 per
Hessian-vector product). ``plain=True`` sends a CUDA batch to the plain
versions too, for a reference run beside the kernels, and is how a float64
batch runs on the card (``game/problem.py``'s ``plain_float64`` route).
Variances: NONE and SIMPLE (``1 / diag H``); FULL is ROADMAP A6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .features import LabeledBatch
from .fused_glm import sharded_hessian_stats, sharded_hessian_vector, sharded_value_grad
from .losses import PointwiseLoss
from .normalization import NormalizationContext, identity_normalization

Tensor = torch.Tensor

_FULL_TODO = (
    "{} is not ported yet: FULL variance (the dense Hessian and its inverse's "
    "diagonal) is ROADMAP A6"
)


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    loss: PointwiseLoss
    batch: LabeledBatch
    l2: float = 0.0
    norm: Optional[NormalizationContext] = None
    prior_mean: Optional[Tensor] = None
    prior_precision: Optional[Tensor] = None
    plain: bool = False

    @property
    def group(self):
        """The batch's data-parallel group (``parallel.mesh.DataParallelGroup``):
        every sweep is summed across its ranks. None for a whole batch."""
        return self.batch.group

    def _norm(self) -> NormalizationContext:
        return self.norm if self.norm is not None else identity_normalization()

    def _reg_delta(self, coef: Tensor) -> Tensor:
        return coef if self.prior_mean is None else coef - self.prior_mean

    def _precision(self, like: Tensor) -> Tensor:
        return torch.ones_like(like) if self.prior_precision is None else self.prior_precision

    def value(self, coef: Tensor) -> Tensor:
        return self.value_and_grad(coef)[0]

    def gradient(self, coef: Tensor) -> Tensor:
        return self.value_and_grad(coef)[1]

    def _margins(self, coef: Tensor) -> Tensor:
        """A sparse batch's margins, ``X.eff + mshift + offsets``."""
        eff, mshift = self._norm().effective_coefficients(coef)
        return self.batch.features.matvec(eff, plain=self.plain) + mshift + self.batch.offsets

    def _d2z_weights(self, coef: Tensor) -> Tensor:
        b = self.batch
        return b.weights * self.loss.d2z(self._margins(coef), b.labels)

    def value_and_grad(self, coef: Tensor) -> Tuple[Tensor, Tensor]:
        b = self.batch
        norm = self._norm()
        if b.features.is_dense:
            eff, mshift = norm.effective_coefficients(coef)
            value, grad, wdz_sum = sharded_value_grad(
                self.group, b.features.dense, eff, b.labels, b.offsets + mshift, b.weights,
                self.loss, plain=self.plain,
            )
        else:
            loss, dz = self.loss.loss_and_dz(self._margins(coef), b.labels)
            wdz = b.weights * dz
            value = torch.sum(b.weights * loss)
            grad = b.features.rmatvec(wdz, plain=self.plain)
            wdz_sum = torch.sum(wdz) if norm.shifts is not None else None
        # grad_j = factor_j * (raw_grad_j - shift_j * sum_i w_i dz_i)
        if norm.shifts is not None:
            grad = grad - norm.shifts * wdz_sum
        if norm.factors is not None:
            grad = grad * norm.factors
        delta = self._reg_delta(coef)
        prec = self._precision(coef)
        value = value + 0.5 * self.l2 * torch.dot(delta, prec * delta)
        grad = grad + self.l2 * prec * delta
        return value, grad

    def hessian_vector(self, coef: Tensor, v: Tensor) -> Tensor:
        """H(w') v:
        hv_j = factor_j * (sum_i x_ji c_i u_i - shift_j * sum_i c_i u_i) + l2 P v
        with c_i = w_i l''_i and u_i = (x_i - shift) .* factor . v."""
        b = self.batch
        norm = self._norm()
        eff_v, vshift = norm.effective_coefficients(v)
        if b.features.is_dense:
            eff, mshift = norm.effective_coefficients(coef)
            hv, csum = sharded_hessian_vector(
                self.group, b.features.dense, eff, eff_v, b.labels, b.offsets + mshift,
                b.weights, vshift, self.loss, plain=self.plain,
            )
        else:
            c = self._d2z_weights(coef) * (b.features.matvec(eff_v, plain=self.plain) + vshift)
            hv = b.features.rmatvec(c, plain=self.plain)
            csum = torch.sum(c) if norm.shifts is not None else None
        if norm.shifts is not None:
            hv = hv - norm.shifts * csum
        if norm.factors is not None:
            hv = hv * norm.factors
        return hv + self.l2 * self._precision(v) * v

    def hessian_diagonal(self, coef: Tensor) -> Tensor:
        """diag H = sum_i w_i l''_i x'_ji^2 (+ l2 P), expanded for the
        normalization: f_j^2 (S2_j - 2 s_j S1_j + s_j^2 S0) with S2 = sum c x^2,
        S1 = sum c x and S0 = sum c, all from one sweep of X."""
        b = self.batch
        norm = self._norm()
        need_shifts = norm.shifts is not None
        if b.features.is_dense:
            eff, mshift = norm.effective_coefficients(coef)
            s2, s1, s0 = sharded_hessian_stats(
                self.group, b.features.dense, eff, b.labels, b.offsets + mshift, b.weights,
                self.loss, need_shifts, plain=self.plain,
            )
        else:
            c = self._d2z_weights(coef)
            s2 = b.features.sq_rmatvec(c, plain=self.plain)
            s1 = b.features.rmatvec(c, plain=self.plain) if need_shifts else None
            s0 = torch.sum(c) if need_shifts else None
        diag = s2
        if need_shifts:
            diag = s2 - 2.0 * norm.shifts * s1 + norm.shifts**2 * s0
        if norm.factors is not None:
            diag = diag * norm.factors**2
        return diag + self.l2 * self._precision(diag)

    def hessian_matrix(self, coef: Tensor) -> Tensor:
        raise NotImplementedError(_FULL_TODO.format("hessian_matrix"))


def compute_variances(
    objective: GLMObjective, coef: Tensor, variance_type: str
) -> Optional[Tensor]:
    """Coefficient variances: NONE -> None; SIMPLE -> 1 / diag(H), a zero
    diagonal entry (no data, no L2) pinned to variance 1. FULL raises."""
    vt = variance_type.upper()
    if vt == "NONE":
        return None
    if vt == "SIMPLE":
        d = objective.hessian_diagonal(coef)
        return 1.0 / torch.where(d == 0, torch.ones_like(d), d)
    if vt == "FULL":
        raise NotImplementedError(_FULL_TODO.format("variance FULL"))
    raise ValueError(f"Unknown variance computation type: {variance_type!r}")
