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

The out-of-core fixed effect (``game/fe_streaming.py``) splits the objective
into per-row-slice partial sums (``slice_value_grad_into`` /
``slice_hessian_vector_into``) and one finalize of the accumulated
totals (``finalize_value_grad`` / ``finalize_hessian_vector``): value,
``X^T(w dz)``, ``sum w dz``, ``X^T c`` and ``sum c`` are plain row sums,
while the normalization algebra, the prior delta and the L2 term depend on
the coefficients alone, so they apply once to the totals. Each slice's
sums go into its row of the pass's slot buffer: a dense slice's sweep
writes its totals there (``fused_glm.slice_*``: the kernel's slot mode on
the card), a sparse slice's products (the segment kernel) are copied there.
``slice_*_partials`` are the JAX package's signatures over the same route:
a one-slice pass, its totals returned.

Variances: NONE, SIMPLE (``1 / diag H``) and FULL (``diag H^-1``). FULL
builds the dense Hessian ``X'^T diag(c) X'`` in row chunks, each chunk's
product in float64 (exact whatever the TF32 settings; the chunks added in
row order, and over a row-sharded batch the ranks' float64 partials added
in rank order, B4's pattern), and inverts its Cholesky factor in column
chunks. A matrix that is not positive definite gives NaN variances, as the
JAX package's does.

A (data x model)-tiled batch (``parallel.mesh.TiledMatrix``: the sparse
tiles of ``parallel/sparse.py``, or the dense tiles of the feature-axis
shard, whose products are ``torch.mv`` on the tile as the JAX package sends
that batch down its jnp path) takes the JAX package's unfused branch over
its tile: the coefficients, gradient and normalization stats are this
rank's ``[d_loc]`` model slice, the margins
its data row's ``[n_loc]`` block. Each evaluation sums over the grid's
subgroups in two collectives, the reductions that do not depend on each
other gathered into one: the tile's margins with the coefficient dots
(``eff . shift``, the L2 term) over the data row, then the tile's
``X^T c`` with the row sums (the loss, ``sum w dz``) over the model column.
``hessian_matrix`` adds each rank's float64 ``[d_loc, dim]`` block over its
model column (the normalization's rank-one terms applied to the rank's
share first, as they are linear in its rows), pins only the structural
padding (``>= dim_true``) and gathers the whole ``[dim, dim]`` matrix onto
every rank for the inversion; ``compute_variances`` returns the whole
``[dim]`` vector on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .features import LabeledBatch
from .fused_glm import (
    HV,
    VG,
    fill_slot,
    rank_order_sum,
    rank_order_sum_plain,
    sharded_hessian_stats,
    sharded_hessian_vector,
    sharded_value_grad,
    slice_hessian_vector,
    slice_slots,
    slice_value_grad,
    slices_total,
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

    @property
    def tiled(self) -> bool:
        """The batch is a (data x model)-tiled one (``parallel.mesh.TiledMatrix``:
        sparse or dense tiles)."""
        return self.batch.features.layout == "tiled"

    @property
    def coefficient_axis(self):
        """Where the solver's coefficient vector lies (``optimize.common``):
        a tiled batch's model slice (``ModelAxis`` over its data row), else
        ``LOCAL``."""
        from ..optimize.common import LOCAL, ModelAxis

        return ModelAxis(self.batch.features.mesh.model) if self.tiled else LOCAL

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
        if self.tiled:
            (z,), _ = self._tiled_margins((coef,))
        else:
            z = self._margins(coef)
        return b.weights * self.loss.d2z(z, b.labels)

    def _tiled_margins(self, vecs, dots=()):
        """A tiled batch's margins ``X.eff(v) + vshift(v)`` of each
        coefficient slice in ``vecs`` (the first one's with the offsets)
        and the totals of the partial ``dots`` (0-dim tensors over this
        rank's slice), all summed over the data row in one collective."""
        b = self.batch
        f = b.features
        norm = self._norm()
        effs = [v if norm.factors is None else v * norm.factors for v in vecs]
        parts = [f.tile.matvec(e, plain=self.plain) for e in effs]
        extra = [-torch.dot(e, norm.shifts) for e in effs] if norm.shifts is not None else []
        extra += list(dots)
        n = parts[0].shape[0]
        flat = torch.cat(parts + [torch.stack(extra).to(parts[0].dtype)] if extra else parts)
        tot = f.mesh.model.sum(flat, plain=self.plain)
        k = len(vecs)
        zs = [tot[i * n : (i + 1) * n] for i in range(k)]
        rest = tot[k * n :]
        if norm.shifts is not None:
            zs = [z + rest[i] for i, z in enumerate(zs)]
            rest = rest[k:]
        zs[0] = zs[0] + b.offsets
        return zs, rest

    def _tiled_column_sum(self, vecs, scalars=()):
        """This rank's ``[d_loc]`` partials ``vecs`` and 0-dim partials
        ``scalars``, summed over the model column in one collective."""
        f = self.batch.features
        d = vecs[0].shape[0]
        parts = list(vecs) + ([torch.stack(list(scalars)).to(vecs[0].dtype)] if scalars else [])
        tot = f.mesh.data.sum(torch.cat(parts), plain=self.plain)
        return [tot[i * d : (i + 1) * d] for i in range(len(vecs))], tot[len(vecs) * d :]

    def _tiled_value_and_grad(self, coef: Tensor) -> Tuple[Tensor, Tensor]:
        b = self.batch
        norm = self._norm()
        delta = self._reg_delta(coef)
        prec = self._precision(coef)
        (z,), (reg,) = self._tiled_margins((coef,), (torch.dot(delta, prec * delta),))
        lvals, dz = self.loss.loss_and_dz(z, b.labels)
        wdz = b.weights * dz
        sums = [torch.sum(b.weights * lvals)] + ([torch.sum(wdz)] if norm.shifts is not None else [])
        (grad,), tot = self._tiled_column_sum((b.features.tile.rmatvec(wdz, plain=self.plain),), sums)
        if norm.shifts is not None:
            grad = grad - norm.shifts * tot[1]
        if norm.factors is not None:
            grad = grad * norm.factors
        return tot[0] + 0.5 * self.l2 * reg, grad + self.l2 * prec * delta

    def value_and_grad(self, coef: Tensor) -> Tuple[Tensor, Tensor]:
        b = self.batch
        norm = self._norm()
        if self.tiled:
            return self._tiled_value_and_grad(coef)
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
        if self.tiled:
            (z, u), _ = self._tiled_margins((coef, v))
            c = b.weights * self.loss.d2z(z, b.labels) * u
            sums = [torch.sum(c)] if norm.shifts is not None else []
            (hv,), tot = self._tiled_column_sum((b.features.tile.rmatvec(c, plain=self.plain),), sums)
            csum = tot[0] if sums else None
        elif b.features.is_dense:
            eff_v, vshift = norm.effective_coefficients(v)
            eff, mshift = norm.effective_coefficients(coef)
            hv, csum = sharded_hessian_vector(
                self.group, b.features.dense, eff, eff_v, b.labels, b.offsets + mshift,
                b.weights, vshift, self.loss, plain=self.plain,
            )
        else:
            eff_v, vshift = norm.effective_coefficients(v)
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
        if self.tiled:
            c = self._d2z_weights(coef)
            t = b.features.tile
            vecs = [t.sq_rmatvec(c, plain=self.plain)]
            if need_shifts:
                vecs.append(t.rmatvec(c, plain=self.plain))
            sums, tot = self._tiled_column_sum(vecs, [torch.sum(c)] if need_shifts else [])
            s2 = sums[0]
            s1, s0 = (sums[1], tot[0]) if need_shifts else (None, None)
        elif b.features.is_dense:
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
        entries pinned to 1 (``_pin_zero_diagonal``). A tiled batch takes
        ``_tiled_hessian_matrix``."""
        b = self.batch
        check_full_variance_dim(b.dim)
        c = self._d2z_weights(coef)
        if self.tiled:
            return self._tiled_hessian_matrix(c)
        h = _xtcx(b.features.to_dense(), c, self._norm())
        if self.group is not None:
            h = sum_over_ranks(self.group, h, c.dtype, plain=self.plain)
        else:
            h = h.to(c.dtype)
        dg = h.diagonal()
        dg.add_(self.l2 * self._precision(dg))
        _pin_zero_diagonal(h)
        return h

    def _tiled_hessian_matrix(self, c: Tensor) -> Tensor:
        """The JAX package's tiled branch, term by term: this rank's float64
        share of ``X^T diag(c) X`` (``xtcx_partial``), its normalization
        without densifying X, ``H' = F (H - s S1^T - S1 s^T + S0 s s^T) F``
        with ``S1 = X^T c`` and ``S0 = sum c`` of the rank's rows (linear in
        them, so it applies to each share), summed over the model column;
        then ``l2 P`` and a unit pin on the structural padding
        (``>= dim_true``) only, the whole matrix gathered over the data row,
        and ``_pin_zero_diagonal``."""
        b = self.batch
        f = b.features
        mesh = f.mesh
        norm = self._norm()
        d_loc, dim = f.d_local, f.dim
        h = f.xtcx_partial(c)
        if not norm.is_identity:
            f64 = lambda v: v.to(torch.float64)  # noqa: E731
            if norm.shifts is not None:
                s1 = f.tile.rmatvec(c, plain=self.plain).to(torch.float64)
                s0 = torch.sum(c).to(torch.float64)
                sh = f64(norm.shifts)
                s1_all, sh_all = mesh.gather_model([s1, sh])
                h = h - sh[:, None] * s1_all[None, :] - s1[:, None] * sh_all[None, :]
                h = h + s0 * sh[:, None] * sh_all[None, :]
            if norm.factors is not None:
                (fac_all,) = mesh.gather_model([f64(norm.factors)])
                h = h * f64(norm.factors)[:, None] * fac_all[None, :]
        h = h.to(c.dtype) if mesh.n_data == 1 else sum_over_ranks(mesh.data, h, c.dtype, plain=self.plain)
        lo = mesh.model_index * d_loc
        cols = torch.arange(lo, lo + d_loc, device=h.device)
        d_true = f.dim_true or dim
        pad_pin = (cols >= d_true).to(h.dtype)
        h[torch.arange(d_loc, device=h.device), cols] += self.l2 * self._precision(pad_pin) + pad_pin
        (whole,) = mesh.gather_model([h])
        return _pin_zero_diagonal(whole)


def sum_over_ranks(group, h: Tensor, dtype: torch.dtype, plain: bool = False) -> Tensor:
    """B4's pattern for this rank's float64 partial ``h`` (``[rows,
    width]``): a piece of whole rows at a time into this rank's slot, the
    slots gathered and added in rank order into a new tensor of ``dtype``,
    so that every rank gets the same bits and the slots take
    ``HESSIAN_CHUNK_BYTES`` a rank whatever the world size. The sum is the
    CUDA kernel on the card (float32 only: a float64 batch on the card
    comes with ``plain``) and its plain version on the CPU."""
    width = h.shape[1]
    plain = plain or h.device.type == "cpu"
    out = torch.empty(h.shape, dtype=dtype, device=h.device)
    rows = max(1, HESSIAN_CHUNK_BYTES // (8 * width))
    for lo in range(0, h.shape[0], rows):
        piece = h[lo : lo + rows].reshape(-1)
        slots = torch.empty((group.world_size, piece.numel()), dtype=torch.float64, device=h.device)
        slots[group.rank] = piece
        group.gather_slots(slots)
        total = rank_order_sum_plain(slots, dtype) if plain else rank_order_sum(slots, dtype)
        out[lo : lo + rows] = total.view(-1, width)
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
        var = 1.0 / torch.where(d == 0, torch.ones_like(d), d)
        if objective.tiled:
            # the whole vector on every rank, as the FULL branch gives it
            (var,) = objective.batch.features.mesh.gather_model([var])
        return var
    if vt == "FULL":
        return _diag_of_inverse(objective.hessian_matrix(coef))
    raise ValueError(f"Unknown variance computation type: {variance_type!r}")


# ---------------------------------------------------------------------------
# Sliced aggregators: the out-of-core fixed-effect objective


def slice_value_grad_into(
    slots: Tensor,
    k: int,
    loss: PointwiseLoss,
    batch_slice: LabeledBatch,
    eff: Tensor,
    mshift,
    plain: bool = False,
) -> None:
    """A row slice's partial sums of the objective, ``(sum w l, X^T(w dz),
    sum w dz)`` at the normalization-effective coefficients ``eff`` and
    margin shift ``mshift`` (computed once per evaluation), written into
    row k of the pass's slot buffer (``fused_glm.slice_slots(.., VG, ..)``):
    a dense slice's B1 writes them there, a sparse slice's S1 products are
    copied there."""
    b = batch_slice
    f = b.features
    if f.is_dense:
        slice_value_grad(slots, k, f.dense, eff, b.labels, b.offsets + mshift, b.weights, loss, plain=plain)
        return
    z = f.matvec(eff, plain=plain) + mshift + b.offsets
    lvals, dz = loss.loss_and_dz(z, b.labels)
    wdz = b.weights * dz
    fill_slot(slots, k, VG, (torch.sum(b.weights * lvals), f.rmatvec(wdz, plain=plain), torch.sum(wdz)))


def slice_hessian_vector_into(
    slots: Tensor,
    k: int,
    loss: PointwiseLoss,
    batch_slice: LabeledBatch,
    eff: Tensor,
    mshift,
    eff_v: Tensor,
    vshift,
    plain: bool = False,
) -> None:
    """A row slice's partial sums of H v, ``(X^T c, sum c)`` with
    ``c = w l''(z) u`` and ``u = x.eff_v + vshift``, written into row k of
    ``slots`` (see ``slice_value_grad_into``)."""
    b = batch_slice
    f = b.features
    if f.is_dense:
        slice_hessian_vector(slots, k, f.dense, eff, eff_v, b.labels, b.offsets + mshift, b.weights, vshift,
                             loss, plain=plain)
        return
    z = f.matvec(eff, plain=plain) + mshift + b.offsets
    c = b.weights * loss.d2z(z, b.labels) * (f.matvec(eff_v, plain=plain) + vshift)
    fill_slot(slots, k, HV, (f.rmatvec(c, plain=plain), torch.sum(c)))


def slice_value_grad_partials(
    loss: PointwiseLoss, batch_slice: LabeledBatch, eff: Tensor, mshift, plain: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """One slice's ``(sum w l, X^T(w dz), sum w dz)`` returned: a pass of
    one slice, through a one-row slot buffer and ``slices_total``, the
    streamed objective's route."""
    d = batch_slice.features.dim
    slots = slice_slots(1, VG, d, batch_slice.labels.device)
    slice_value_grad_into(slots, 0, loss, batch_slice, eff, mshift, plain=plain)
    value, grad, wdz = slices_total(slots, VG, d, batch_slice.labels.dtype)
    return value, grad, wdz


def slice_hessian_vector_partials(
    loss: PointwiseLoss, batch_slice: LabeledBatch, eff: Tensor, mshift, eff_v: Tensor, vshift,
    plain: bool = False,
) -> Tuple[Tensor, Tensor]:
    """One slice's ``(X^T c, sum c)`` returned (see
    ``slice_value_grad_partials``)."""
    d = batch_slice.features.dim
    slots = slice_slots(1, HV, d, batch_slice.labels.device)
    slice_hessian_vector_into(slots, 0, loss, batch_slice, eff, mshift, eff_v, vshift, plain=plain)
    hv, csum = slices_total(slots, HV, d, batch_slice.labels.dtype)
    return hv, csum


def finalize_value_grad(
    coef: Tensor,
    value_sum: Tensor,
    raw_grad_sum: Tensor,
    wdz_sum: Tensor,
    norm: NormalizationContext,
    l2,
    prior_mean: Optional[Tensor],
    prior_precision: Optional[Tensor],
) -> Tuple[Tensor, Tensor]:
    """``GLMObjective.value_and_grad``'s per-evaluation algebra applied to
    the accumulated slice partials."""
    grad = raw_grad_sum
    if norm.shifts is not None:
        grad = grad - norm.shifts * wdz_sum
    if norm.factors is not None:
        grad = grad * norm.factors
    delta = coef if prior_mean is None else coef - prior_mean
    prec = torch.ones_like(coef) if prior_precision is None else prior_precision
    value = value_sum + 0.5 * l2 * torch.dot(delta, prec * delta)
    return value, grad + l2 * prec * delta


def finalize_hessian_vector(
    v: Tensor,
    hv_sum: Tensor,
    csum: Tensor,
    norm: NormalizationContext,
    l2,
    prior_precision: Optional[Tensor],
) -> Tensor:
    """``GLMObjective.hessian_vector``'s post-accumulation algebra applied
    to the accumulated slice partials."""
    hv = hv_sum
    if norm.shifts is not None:
        hv = hv - norm.shifts * csum
    if norm.factors is not None:
        hv = hv * norm.factors
    prec = torch.ones_like(v) if prior_precision is None else prior_precision
    return hv + l2 * prec * v
