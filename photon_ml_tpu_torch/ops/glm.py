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

Variances: NONE, SIMPLE (``1 / diag H``) and FULL (``diag H^-1``). FULL
builds the dense Hessian ``X'^T diag(c) X'`` in row chunks, each chunk's
product in float64 (exact whatever the TF32 settings; the chunks added in
row order, and over a row-sharded batch the ranks' float64 partials added
in rank order, B4's pattern), and inverts its Cholesky factor in column
chunks. A matrix that is not positive definite gives NaN variances, as the
JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .features import LabeledBatch
from .fused_glm import (
    rank_order_sum,
    rank_order_sum_plain,
    sharded_hessian_stats,
    sharded_hessian_vector,
    sharded_value_grad,
)
from .losses import PointwiseLoss
from .normalization import NormalizationContext, identity_normalization

Tensor = torch.Tensor

# FULL variance factors a [d, d] Hessian on one device: the ceiling is that
# device's memory. Measured on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py phase 10 (c)): compute_variances("FULL"), the Hessian's
# build included, runs at d = 65,536 on 4,096 rows, peaking at 51.8 GiB for
# a float32 batch and 72.8 GiB for a float64 one; the next power of two
# needs four times the memory. Beyond the ceiling, SIMPLE is the answer.
MAX_FULL_VARIANCE_DIM = 65536
# bytes of each float64 chunk of the Hessian's build: a row chunk of X'
# (and its product with c) in _xtcx, and a rank's piece of the [d, d] sum
# over ranks in hessian_matrix
HESSIAN_CHUNK_BYTES = 1 << 29
# columns of the identity per triangular solve of _diag_of_inverse
INVERSE_COL_CHUNK = 2048


def check_full_variance_dim(dim: int) -> None:
    """The FULL-variance ceiling: every entry point (the check before the
    solve, hessian_matrix, compute_variances) raises the same ValueError."""
    if dim > MAX_FULL_VARIANCE_DIM:
        raise ValueError(
            f"variance=FULL needs a [d, d] Hessian factorization; d={dim} "
            f"exceeds the supported ceiling {MAX_FULL_VARIANCE_DIM} — use "
            "variance=SIMPLE"
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
        """The dense ``[d, d]`` Hessian ``X'^T diag(w l'') X' + l2 diag(P)``
        in the batch's dtype, with X' = (X - shift) .* factor (a sparse
        batch densified, as the JAX package does), and exact-zero diagonal
        entries pinned to 1 (``_pin_zero_diagonal``). (The JAX package's
        model-axis-tiled branch has no batch here: tiled batches are ROADMAP
        A10.)"""
        b = self.batch
        check_full_variance_dim(b.dim)
        c = self._d2z_weights(coef)
        h = _xtcx(b.features.to_dense(), c, self._norm())
        if self.group is not None:
            h = self._sum_over_ranks(h, c.dtype)
        else:
            h = h.to(c.dtype)
        dg = h.diagonal()
        dg.add_(self.l2 * self._precision(dg))
        _pin_zero_diagonal(h)
        return h

    def _sum_over_ranks(self, h: Tensor, dtype: torch.dtype) -> Tensor:
        """B4's pattern for this rank's float64 partial ``h``: a piece of
        whole rows at a time into this rank's slot, the slots gathered and
        added in rank order into a new ``[d, d]`` tensor of ``dtype``, so
        that every rank gets the same bits and the slots take
        ``HESSIAN_CHUNK_BYTES`` a rank whatever the world size. The sum is
        the CUDA kernel on the card (float32 only: a float64 batch on the
        card comes with ``plain``) and its plain version on the CPU."""
        group = self.group
        d = h.shape[0]
        plain = self.plain or h.device.type == "cpu"
        out = torch.empty((d, d), dtype=dtype, device=h.device)
        rows = max(1, HESSIAN_CHUNK_BYTES // (8 * d))
        for lo in range(0, d, rows):
            piece = h[lo : lo + rows].reshape(-1)
            slots = torch.empty((group.world_size, piece.numel()), dtype=torch.float64, device=h.device)
            slots[group.rank] = piece
            group.gather_slots(slots)
            total = rank_order_sum_plain(slots, dtype) if plain else rank_order_sum(slots, dtype)
            out[lo : lo + rows] = total.view(-1, d)
        return out


def _xtcx(x: Tensor, c: Tensor, norm: NormalizationContext) -> Tensor:
    """``X'^T diag(c) X'`` in float64: row chunks of ``HESSIAN_CHUNK_BYTES``
    in float64, each normalized, multiplied and added into the accumulator
    in place (``addmm_``), in row order. A float64 product takes no TF32
    path, so the result does not depend on ``torch.backends.cuda.matmul``
    settings."""
    n, d = x.shape
    h = torch.zeros((d, d), dtype=torch.float64, device=x.device)
    shifts = None if norm.shifts is None else norm.shifts.to(torch.float64)
    factors = None if norm.factors is None else norm.factors.to(torch.float64)
    rows = max(1, HESSIAN_CHUNK_BYTES // (8 * d))
    for lo in range(0, n, rows):
        xc = x[lo : lo + rows].to(torch.float64)
        if shifts is not None:
            xc = xc - shifts
        if factors is not None:
            xc = xc * factors
        h.addmm_(xc.T, c[lo : lo + rows, None].to(torch.float64) * xc)
    return h


def _pin_zero_diagonal(h: Tensor) -> Tensor:
    """Exact-zero diagonal entries of ``h`` pinned to 1, in place, so a
    zero-activity column with l2 = 0 keeps FULL variances finite: its row
    and column are zero, so it becomes an isolated unit basis vector with
    variance 1 and leaves the others alone (SIMPLE's convention for zero
    diagonals). Returns ``h``."""
    dg = h.diagonal()
    dg.masked_fill_(dg == 0, 1.0)
    return h


def _diag_of_inverse(m: Tensor) -> Tensor:
    """diag(m^-1) for SPD m through its Cholesky factor m = L L^T:
    diag(m^-1)_j = ||column j of L^-1||^2, the columns of L^-1 from
    triangular solves against ``INVERSE_COL_CHUNK`` columns of the identity
    at a time (the peak stays at m, L and one chunk). A matrix that is not
    positive definite gives NaN everywhere, as ``jnp.linalg.cholesky`` does:
    the factorization's ``info`` turns L into NaN on the device, with no
    host synchronize and no exception."""
    d = m.shape[0]
    L, info = torch.linalg.cholesky_ex(m)
    L.masked_fill_(info != 0, float("nan"))
    chunk = min(d, INVERSE_COL_CHUNK)
    out = torch.empty(d, dtype=m.dtype, device=m.device)
    for lo in range(0, d, chunk):
        hi = min(d, lo + chunk)
        rhs = torch.zeros((d, hi - lo), dtype=m.dtype, device=m.device)
        cols = torch.arange(hi - lo, device=m.device)
        rhs[lo + cols, cols] = 1.0
        x = torch.linalg.solve_triangular(L, rhs, upper=False)
        out[lo:hi] = torch.sum(x * x, dim=0)
    return out


def compute_variances(
    objective: GLMObjective, coef: Tensor, variance_type: str
) -> Optional[Tensor]:
    """Coefficient variances: NONE -> None; SIMPLE -> 1 / diag(H), a zero
    diagonal entry (no data, no L2) pinned to variance 1; FULL ->
    diag(H^-1) through the Cholesky factor."""
    vt = variance_type.upper()
    if vt == "NONE":
        return None
    if vt == "SIMPLE":
        d = objective.hessian_diagonal(coef)
        return 1.0 / torch.where(d == 0, torch.ones_like(d), d)
    if vt == "FULL":
        return _diag_of_inverse(objective.hessian_matrix(coef))
    raise ValueError(f"Unknown variance computation type: {variance_type!r}")
