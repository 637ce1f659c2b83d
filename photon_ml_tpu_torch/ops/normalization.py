"""Feature normalization as an affine re-parameterization folded into the objective.

Training runs in the transformed space x' = (x - shift) .* factor while the
data stays raw, through the identities

    margin  = w'.x' = (w' .* factor).x - (w' .* factor).shift
    grad_j  = factor_j * (raw_grad_j - shift_j * sum_i w_i * dl/dz_i)

and models map between spaces with

    w  = w' .* factor ;  b  = b' - (w' .* factor).shift     (to original)
    w' = w ./ factor  ;  b' = b + w.shift                   (to transformed)

Counterpart of the JAX package's ``ops/normalization.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

NONE = "NONE"
SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
STANDARDIZATION = "STANDARDIZATION"

NORMALIZATION_TYPES = (
    NONE,
    SCALE_WITH_STANDARD_DEVIATION,
    SCALE_WITH_MAX_MAGNITUDE,
    STANDARDIZATION,
)


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Affine feature transform x' = (x - shift) .* factor.

    ``factors`` and ``shifts`` are ``[d]`` tensors or ``None``. A shift needs
    an intercept, whose factor is 1 and shift 0.
    """

    factors: Optional[Tensor] = None
    shifts: Optional[Tensor] = None
    intercept_index: Optional[int] = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def _need_intercept(self) -> int:
        if self.intercept_index is None:
            raise ValueError("a normalization shift requires an intercept")
        return self.intercept_index

    def model_to_original_space(self, coef: Tensor) -> Tensor:
        """w = w' .* factor; all shifts folded into the intercept."""
        if self.is_identity:
            return coef
        out = coef
        if self.factors is not None:
            out = out * self.factors
        if self.shifts is not None:
            out = out.clone()
            out[self._need_intercept()] -= torch.dot(out, self.shifts)
        return out

    def model_to_transformed_space(self, coef: Tensor) -> Tensor:
        """w' = w ./ factor; the intercept absorbs w.shift."""
        if self.is_identity:
            return coef
        out = coef
        if self.shifts is not None:
            out = out.clone()
            out[self._need_intercept()] += torch.dot(out, self.shifts)
        if self.factors is not None:
            out = out / self.factors
        return out

    def padded(self, dim: int) -> "NormalizationContext":
        """Pad the stats vectors to ``dim`` with identity entries (factor 1,
        shift 0)."""
        if self.is_identity:
            return self
        d_have = (self.factors if self.factors is not None else self.shifts).shape[0]
        if dim <= d_have:
            return self
        pad = dim - d_have

        def _pad(v, fill):
            if v is None:
                return None
            return torch.cat([v, torch.full((pad,), fill, dtype=v.dtype, device=v.device)])

        return NormalizationContext(
            factors=_pad(self.factors, 1.0),
            shifts=_pad(self.shifts, 0.0),
            intercept_index=self.intercept_index,
        )

    def sliced(self, lo: int, hi: int) -> "NormalizationContext":
        """The stats of coefficients ``[lo, hi)``: a model-axis slice of
        a (padded) context, as a tiled batch's objective takes it; the
        intercept index re-based where it falls inside, else None (the
        slice's objective never moves the intercept)."""
        if self.is_identity:
            return self
        cut = lambda v: None if v is None else v[lo:hi]  # noqa: E731
        ii = self.intercept_index
        inside = ii is not None and lo <= ii < hi
        return NormalizationContext(cut(self.factors), cut(self.shifts), ii - lo if inside else None)

    def effective_coefficients(self, coef: Tensor) -> tuple[Tensor, Tensor]:
        """(effective_coef, margin_shift) with margin = effective_coef.x + margin_shift:
        effective_coef = coef .* factor, margin_shift = -effective_coef.shift."""
        eff = coef if self.factors is None else coef * self.factors
        if self.shifts is None:
            shift = torch.zeros((), dtype=coef.dtype, device=coef.device)
        else:
            shift = -torch.dot(eff, self.shifts)
        return eff, shift

    def to(self, device) -> "NormalizationContext":
        move = lambda v: None if v is None else v.to(device)
        return NormalizationContext(move(self.factors), move(self.shifts), self.intercept_index)


def identity_normalization() -> NormalizationContext:
    return NormalizationContext(None, None, None)


def build_normalization(
    norm_type: str,
    feature_means: np.ndarray,
    feature_variances: np.ndarray,
    feature_max_magnitudes: np.ndarray,
    intercept_index: Optional[int],
    dtype=torch.float32,
    device="cuda",
) -> NormalizationContext:
    """Build a NormalizationContext from per-feature summary statistics:
    SCALE_WITH_STANDARD_DEVIATION -> factor 1/std; SCALE_WITH_MAX_MAGNITUDE ->
    factor 1/max|x|; STANDARDIZATION -> 1/std factor and mean shift. Zero or
    non-finite scales get factor 1; the intercept keeps factor 1 / shift 0."""
    if norm_type == NONE:
        return identity_normalization()

    std = np.sqrt(np.asarray(feature_variances, dtype=np.float64))
    safe = lambda v: np.where((v == 0) | ~np.isfinite(v), 1.0, v)

    factors = None
    shifts = None
    if norm_type == SCALE_WITH_STANDARD_DEVIATION:
        factors = 1.0 / safe(std)
    elif norm_type == SCALE_WITH_MAX_MAGNITUDE:
        factors = 1.0 / safe(np.abs(np.asarray(feature_max_magnitudes, np.float64)))
    elif norm_type == STANDARDIZATION:
        if intercept_index is None:
            raise ValueError("STANDARDIZATION requires an intercept term")
        factors = 1.0 / safe(std)
        shifts = np.asarray(feature_means, dtype=np.float64).copy()
    else:
        raise ValueError(f"Unknown normalization type: {norm_type!r}")

    if intercept_index is not None:
        if factors is not None:
            factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0

    from ..device import resolve_device

    dev = resolve_device(device)
    as_t = lambda v: None if v is None else torch.as_tensor(v, dtype=dtype, device=dev)
    return NormalizationContext(
        factors=as_t(factors), shifts=as_t(shifts), intercept_index=intercept_index
    )
