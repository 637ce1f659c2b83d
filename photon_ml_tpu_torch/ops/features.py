"""Columnar batch containers for GLM training data, dense layout.

Counterpart of the JAX package's ``ops/features.py``. This slice ports the
dense layout ``x[n, d]``; the ELL and sorted-COO layouts are ROADMAP item A1
and raise ``NotImplementedError`` here. Padded rows carry weight 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

Tensor = torch.Tensor

_SPARSE_TODO = (
    "the {} layout is not ported yet (ROADMAP A1); only the dense layout "
    "runs in photon_ml_tpu_torch"
)


@dataclasses.dataclass(frozen=True)
class FeatureMatrix:
    """A batch of feature vectors. Only ``dense`` ``[n, d]`` is ported."""

    dim: int
    dense: Optional[Tensor] = None
    idx: Optional[Tensor] = None
    val: Optional[Tensor] = None
    coo_cols: Optional[Tensor] = None
    coo_rows: Optional[Tensor] = None
    coo_vals: Optional[Tensor] = None
    coo_n_rows: int = 0

    def __post_init__(self):
        if self.idx is not None or self.val is not None:
            raise NotImplementedError(_SPARSE_TODO.format("ELL"))
        if self.coo_cols is not None or self.coo_rows is not None or self.coo_vals is not None:
            raise NotImplementedError(_SPARSE_TODO.format("sorted-COO"))
        if self.dense is None:
            raise ValueError("a dense FeatureMatrix needs its [n, d] matrix")
        if self.dense.ndim != 2 or self.dense.shape[1] != self.dim:
            raise ValueError(
                f"dense features of shape {tuple(self.dense.shape)} do not match dim {self.dim}"
            )

    @property
    def n_rows(self) -> int:
        return self.dense.shape[0]

    def matvec(self, w: Tensor) -> Tensor:
        """x @ w -> [n], in the wider of the two dtypes (a bf16 X is widened,
        as jnp's type promotion does in the reference)."""
        x = self.dense
        if x.dtype != w.dtype:
            x = x.to(torch.promote_types(x.dtype, w.dtype))
            w = w.to(x.dtype)
        return x @ w

    def rmatvec(self, c: Tensor) -> Tensor:
        """x^T @ c -> [d]."""
        x = self.dense
        if x.dtype != c.dtype:
            x = x.to(torch.promote_types(x.dtype, c.dtype))
            c = c.to(x.dtype)
        return x.T @ c

    def sq_rmatvec(self, c: Tensor) -> Tensor:
        """(x*x)^T @ c -> [d]."""
        x = self.dense
        if x.dtype != c.dtype:
            x = x.to(torch.promote_types(x.dtype, c.dtype))
            c = c.to(x.dtype)
        return (x * x).T @ c


@dataclasses.dataclass(frozen=True)
class LabeledBatch:
    """Label / features / offset / weight. Padded rows carry ``weight == 0``.

    ``group`` is set on a batch that ``parallel.mesh.shard_batch`` cut to one
    rank's rows: its sweeps then sum across the group's ranks."""

    features: FeatureMatrix
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    group: Optional[object] = None  # parallel.mesh.DataParallelGroup

    @property
    def n_rows(self) -> int:
        return self.features.n_rows

    @property
    def dim(self) -> int:
        return self.features.dim

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def margins(self, coef: Tensor) -> Tensor:
        """features.coef + offset."""
        return self.features.matvec(coef) + self.offsets


def _as_tensor(a, dtype, device) -> Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


def batch_from_dense(
    x,
    y,
    offsets=None,
    weights=None,
    dtype=torch.float32,
    feature_dtype=None,
    device: DeviceLike = None,
) -> LabeledBatch:
    """Build a dense batch on ``device`` (the card unless asked otherwise).

    ``feature_dtype`` (e.g. ``torch.bfloat16``) stores ONLY the feature
    matrix in a narrower type; labels, offsets, weights and all solver state
    stay ``dtype``. Inputs may be numpy arrays or tensors."""
    dev = resolve_device(device)
    n, d = x.shape
    feats = FeatureMatrix(dim=d, dense=_as_tensor(x, feature_dtype or dtype, dev).contiguous())
    return LabeledBatch(
        features=feats,
        labels=_as_tensor(y, dtype, dev),
        offsets=torch.zeros(n, dtype=dtype, device=dev) if offsets is None else _as_tensor(offsets, dtype, dev),
        weights=torch.ones(n, dtype=dtype, device=dev) if weights is None else _as_tensor(weights, dtype, dev),
    )


def batch_from_coo(*args, **kwargs) -> LabeledBatch:
    raise NotImplementedError(_SPARSE_TODO.format("ELL / sorted-COO"))


def pad_batch(batch: LabeledBatch, target_rows: int) -> LabeledBatch:
    """Pad a batch with zero-weight rows up to ``target_rows``."""
    n = batch.n_rows
    if n == target_rows:
        return batch
    if n > target_rows:
        raise ValueError(f"batch has {n} rows > target {target_rows}")
    extra = target_rows - n
    pad1 = lambda a: torch.cat([a, a.new_zeros(extra)])
    f = batch.features
    feats = FeatureMatrix(dim=f.dim, dense=torch.cat([f.dense, f.dense.new_zeros((extra, f.dim))]))
    return LabeledBatch(
        features=feats,
        labels=pad1(batch.labels),
        offsets=pad1(batch.offsets),
        weights=pad1(batch.weights),
        group=batch.group,
    )
