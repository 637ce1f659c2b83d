"""Columnar batch containers for GLM training data.

Counterpart of the JAX package's ``ops/features.py``, in its three layouts:

- ``dense``: ``x[n, d]``;
- ``ELL`` (padded sparse): ``idx[n, k]`` int32 + ``val[n, k]`` with per-row
  padding ``idx=0, val=0``;
- ``sorted COO``: flat ``(coo_cols, coo_rows, coo_vals)`` triplets sorted by
  column (padding entries ``col=dim-1, row=0, val=0``), for huge d.

The host builds (``batch_from_coo``, ``sorted_coo_matrix``, ``pad_batch``)
are the JAX package's numpy code, copied, and give its arrays bit for bit.

The sparse products run through the segmented gather-dot of ``ops/sparse.py``
(on the card its CUDA kernel; on the CPU its plain version). Each sparse
matrix builds, once and on the host, the segments its two product
directions need (``row_segments`` for ``matvec``, in the row-group form;
``col_segments`` for ``rmatvec`` and ``sq_rmatvec``, in the key form):

- ELL: the rows as they are (uniform segments of k); and the entries
  reordered by column (stable: rows in order within a column), their
  columns as int32 keys, rows and values copied in that order;
- COO: the entries reordered by row (stable: input order within a row),
  their columns and values copied in that order, with int32 row pointers;
  and the column-sorted entries as they are, ``coo_cols`` their keys.

The key form carries no per-column pointer, and a long column (an
intercept) is many lanes' runs; a row longer than ``sparse.LONG_SEGMENT``
entries sends its matrix's ``matvec`` to the key form too.

Padding entries stay in: they add ``src * 0`` as the reference does, so a
non-finite coefficient still turns the margins of padded rows non-finite.
Padded rows carry weight 0. Row slicing (``slice_rows``, the streamed
fixed effect's row windows) takes the dense and ELL layouts; COO, sorted by
column, refuses.

The lane-stacked products of the lambda-lane sweeps (``matmat`` ``X @ W``
and ``rmatmat`` ``X^T @ C`` over ``[d, L]`` / ``[n, L]`` operands) run on
the same segments through S2, the lane-wide segment kernel
(``sparse.segment_dot_lanes``), whose column l is the single-lane product
of column l bit for bit; on a dense matrix they are ``torch.matmul``, as
the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .sparse import (
    Segments,
    key_segments,
    row_segments,
    segment_dot,
    segment_dot_lanes,
    segment_dot_plain,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FeatureMatrix:
    """A batch of feature vectors: dense ``[n, d]``, padded-sparse (ELL), or
    column-sorted COO. Exactly one of ``dense`` / (``idx``, ``val``) /
    (``coo_cols``, ``coo_rows``, ``coo_vals``) is set; ``coo_n_rows`` is the
    COO layout's row count. ``row_segments`` / ``col_segments`` are built
    from the sparse layouts in ``__post_init__`` (see the module docstring)."""

    dim: int
    dense: Optional[Tensor] = None
    idx: Optional[Tensor] = None
    val: Optional[Tensor] = None
    coo_cols: Optional[Tensor] = None  # i32[m], sorted ascending (pad: dim-1)
    coo_rows: Optional[Tensor] = None  # i32[m] (pad: 0)
    coo_vals: Optional[Tensor] = None  # f[m] (pad: 0)
    coo_n_rows: int = 0
    row_segments: Optional[Segments] = dataclasses.field(default=None, init=False, repr=False, compare=False)
    col_segments: Optional[Segments] = dataclasses.field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        n_set = (self.dense is not None) + (self.idx is not None) + (self.coo_cols is not None)
        if n_set != 1:
            raise ValueError(
                "exactly one of dense / (idx, val) / (coo_cols, coo_rows, coo_vals) must be provided"
            )
        if self.dense is not None:
            if self.dense.ndim != 2 or self.dense.shape[1] != self.dim:
                raise ValueError(
                    f"dense features of shape {tuple(self.dense.shape)} do not match dim {self.dim}"
                )
            return
        if self.idx is not None:
            if self.val is None:
                raise ValueError("ELL layout requires both idx and val")
            self._build_ell_segments()
        else:
            if self.coo_rows is None or self.coo_vals is None:
                raise ValueError("COO layout requires coo_cols, coo_rows and coo_vals")
            self._build_coo_segments()

    def _build_ell_segments(self) -> None:
        idx, val = self.idx, self.val
        if idx.dim() != 2 or idx.shape != val.shape or idx.dtype != torch.int32:
            raise ValueError(
                f"ELL idx must be int32 [n, k] and val alike, got {idx.dtype} {tuple(idx.shape)} "
                f"and {tuple(val.shape)}"
            )
        k = idx.shape[1]
        flat = idx.reshape(-1).cpu().numpy()
        if flat.size and (flat.min() < 0 or flat.max() >= self.dim):
            raise ValueError(f"ELL column indices out of [0, {self.dim})")
        order = np.argsort(flat, kind="stable")
        perm = torch.from_numpy(order).to(idx.device)
        object.__setattr__(self, "row_segments", row_segments(
            np.full(idx.shape[0], k), idx.reshape(-1), val.reshape(-1), uniform=True,
        ))
        object.__setattr__(self, "col_segments", key_segments(
            flat[order], self.dim,
            torch.from_numpy((order // max(k, 1)).astype(np.int32)).to(idx.device),
            val.reshape(-1)[perm].contiguous(),
        ))

    def _build_coo_segments(self) -> None:
        cols, rows, vals = self.coo_cols, self.coo_rows, self.coo_vals
        if cols.dim() != 1 or cols.shape != rows.shape or cols.shape != vals.shape:
            raise ValueError("coo_cols, coo_rows and coo_vals must be 1-D of one length")
        if cols.dtype != torch.int32 or rows.dtype != torch.int32:
            raise ValueError(f"COO indices must be int32, got {cols.dtype} and {rows.dtype}")
        c = cols.cpu().numpy()
        r = rows.cpu().numpy()
        if c.size and (np.any(c[1:] < c[:-1]) or c[0] < 0 or c[-1] >= self.dim):
            raise ValueError(f"coo_cols must be sorted ascending within [0, {self.dim})")
        if r.size and (r.min() < 0 or r.max() >= self.coo_n_rows):
            raise ValueError(f"coo_rows out of [0, {self.coo_n_rows})")
        order = np.argsort(r, kind="stable")
        perm = torch.from_numpy(order).to(cols.device)
        object.__setattr__(self, "row_segments", row_segments(
            np.bincount(r, minlength=self.coo_n_rows), cols[perm].contiguous(), vals[perm].contiguous(),
        ))
        object.__setattr__(self, "col_segments", key_segments(c, self.dim, rows, vals, key_tensor=cols))

    @classmethod
    def from_segments(cls, dim: int, idx: Tensor, val: Tensor, row_segments: Segments,
                      col_segments: Segments) -> "FeatureMatrix":
        """An ELL matrix over ``idx`` / ``val`` whose segments were built
        elsewhere: a streamed slice's, built once on the host and copied to
        the card beside its planes (``game/fe_streaming.py``)."""
        m = object.__new__(cls)
        fields = dict(dim=int(dim), dense=None, idx=idx, val=val, coo_cols=None, coo_rows=None,
                      coo_vals=None, coo_n_rows=0, row_segments=row_segments, col_segments=col_segments)
        for name, value in fields.items():
            object.__setattr__(m, name, value)
        return m

    @property
    def layout(self) -> str:
        if self.dense is not None:
            return "dense"
        if self.idx is not None:
            return "ell"
        return "coo"

    @property
    def is_dense(self) -> bool:
        return self.dense is not None

    @property
    def n_rows(self) -> int:
        if self.dense is not None:
            return self.dense.shape[0]
        if self.idx is not None:
            return self.idx.shape[0]
        return self.coo_n_rows

    @property
    def values(self) -> Tensor:
        """The stored feature values: X, ``val`` or ``coo_vals``."""
        if self.dense is not None:
            return self.dense
        return self.val if self.idx is not None else self.coo_vals

    def _segment_product(self, direction: str, src: Tensor, square: bool, plain: bool) -> Tensor:
        rows = direction in ("matvec", "matmat")
        seg = self.row_segments if rows else self.col_segments
        n_seg = self.n_rows if rows else self.dim
        if plain:
            return segment_dot_plain(seg, n_seg, src, square)
        if direction.endswith("matmat"):
            return segment_dot_lanes(f"{self.layout}_{direction}", seg, n_seg, src.contiguous())
        name = f"{self.layout}_{'sq_rmatvec' if square else direction}"
        return segment_dot(name, seg, n_seg, src.contiguous(), square)

    @staticmethod
    def _promoted(x: Tensor, v: Tensor):
        if x.dtype != v.dtype:
            x = x.to(torch.promote_types(x.dtype, v.dtype))
            v = v.to(x.dtype)
        return x, v

    def matvec(self, w: Tensor, plain: bool = False) -> Tensor:
        """x @ w -> [n], in the wider of the two dtypes (a bf16 X is widened,
        as jnp's type promotion does in the reference). ``plain=True`` sends
        a sparse product on the card to the plain version; without it a
        float64 operand of a sparse product on the card raises, as the
        segment kernel takes float32 (``game/problem.py``'s
        ``plain_float64`` route passes it)."""
        if self.dense is None:
            return self._segment_product("matvec", w, False, plain)
        x, w = self._promoted(self.dense, w)
        return x @ w

    def rmatvec(self, c: Tensor, plain: bool = False) -> Tensor:
        """x^T @ c -> [d]: the gradient accumulation."""
        if self.dense is None:
            return self._segment_product("rmatvec", c, False, plain)
        x, c = self._promoted(self.dense, c)
        return x.T @ c

    def sq_rmatvec(self, c: Tensor, plain: bool = False) -> Tensor:
        """(x*x)^T @ c -> [d]: the Hessian-diagonal accumulation."""
        if self.dense is None:
            return self._segment_product("rmatvec", c, True, plain)
        x, c = self._promoted(self.dense, c)
        return (x * x).T @ c

    def to_dense(self) -> Tensor:
        """The ``[n, d]`` matrix, duplicates summed."""
        if self.dense is not None:
            return self.dense
        if self.idx is not None:
            n, k = self.idx.shape
            rows = torch.arange(n, device=self.idx.device).repeat_interleave(k)
            cols, vals = self.idx.reshape(-1), self.val.reshape(-1)
        else:
            rows, cols, vals = self.coo_rows, self.coo_cols, self.coo_vals
        out = torch.zeros((self.n_rows, self.dim), dtype=vals.dtype, device=vals.device)
        return out.index_put_((rows.long(), cols.long()), vals, accumulate=True)

    def slice_rows(self, start: int, size: int) -> "FeatureMatrix":
        """Rows ``[start, start + size)`` as a matrix of their own, ``start``
        clamped as the JAX package's ``dynamic_slice`` does: a view of the
        dense rows, or an ELL matrix over views of ``idx`` / ``val`` with
        its own segments. The column-sorted COO layout is not row-major
        and refuses, in the words of the streamed builders."""
        if self.dense is None and self.idx is None:
            raise ValueError(
                "FeatureMatrix.slice_rows requires a row-sliceable layout "
                "(dense|ell), got layout='coo'"
            )
        start = min(max(int(start), 0), max(self.n_rows - int(size), 0))
        stop = start + int(size)
        if self.dense is not None:
            return FeatureMatrix(dim=self.dim, dense=self.dense[start:stop])
        return FeatureMatrix(dim=self.dim, idx=self.idx[start:stop], val=self.val[start:stop])

    def matmat(self, w: Tensor, plain: bool = False) -> Tensor:
        """x @ w -> [n, L] for lane-stacked coefficients ``w[d, L]``: one
        product for all L lanes (S2 on a sparse matrix). ``plain`` as in
        :meth:`matvec`."""
        if self.dense is None:
            return self._segment_product("matmat", w, False, plain)
        x, w = self._promoted(self.dense, w)
        return x @ w

    def rmatmat(self, c: Tensor, plain: bool = False) -> Tensor:
        """x^T @ c -> [d, L] for lane-stacked per-row weights ``c[n, L]``: the
        gradient accumulation of the lane sweeps."""
        if self.dense is None:
            return self._segment_product("rmatmat", c, False, plain)
        x, c = self._promoted(self.dense, c)
        return x.T @ c


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
        """The rows this batch holds: the whole batch's, or a rank's shard's
        (a tiled batch's data row block; its ``features.n_rows`` is the
        padded global count)."""
        return self.labels.shape[0]

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


def _labeled(feats: FeatureMatrix, y, offsets, weights, dtype, dev) -> LabeledBatch:
    n = len(y)
    return LabeledBatch(
        features=feats,
        labels=_as_tensor(y, dtype, dev),
        offsets=torch.zeros(n, dtype=dtype, device=dev) if offsets is None else _as_tensor(offsets, dtype, dev),
        weights=torch.ones(n, dtype=dtype, device=dev) if weights is None else _as_tensor(weights, dtype, dev),
    )


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
    d = x.shape[1]
    feats = FeatureMatrix(dim=d, dense=_as_tensor(x, feature_dtype or dtype, dev).contiguous())
    return _labeled(feats, y, offsets, weights, dtype, dev)


def sorted_coo_matrix(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    dim: int,
    dtype=torch.float32,
    pad_to_multiple: int = 1,
    device: DeviceLike = None,
) -> FeatureMatrix:
    """Host-side build of the column-sorted COO layout (huge-d path).

    Sorts triplets by column (stable); padding entries (val=0) carry
    col=dim-1 so that the columns stay sorted."""
    dev = resolve_device(device)
    order = np.argsort(cols, kind="stable")
    m = len(order)
    m_pad = ((m + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    m_pad = max(m_pad, 1)
    sc = np.full(m_pad, dim - 1, dtype=np.int32)
    sr = np.zeros(m_pad, dtype=np.int32)
    sv = np.zeros(m_pad, dtype=np.float64)
    sc[:m] = cols[order]
    sr[:m] = rows[order]
    sv[:m] = vals[order]
    return FeatureMatrix(
        dim=dim,
        coo_cols=torch.from_numpy(sc).to(dev),
        coo_rows=torch.from_numpy(sr).to(dev),
        coo_vals=_as_tensor(sv, dtype, dev),
        coo_n_rows=n_rows,
    )


def batch_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    y: np.ndarray,
    dim: int,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    max_nnz: Optional[int] = None,
    dtype=torch.float32,
    layout: str = "ell",
    feature_dtype=None,
    device: DeviceLike = None,
) -> LabeledBatch:
    """Build a sparse batch from COO triplets (host-side, numpy), on
    ``device`` (the card unless asked otherwise).

    layout='ell' gives the row-major padded layout (moderate d), keeping at
    most ``max_nnz`` entries a row, the first in input order; layout='coo'
    gives column-sorted COO (huge d). ``feature_dtype`` (e.g. bfloat16)
    stores ONLY the feature values in a narrower type."""
    dev = resolve_device(device)
    n = len(y)
    vdt = feature_dtype or dtype
    if layout == "coo":
        feats = sorted_coo_matrix(rows, cols, vals, n_rows=n, dim=dim, dtype=vdt, device=dev)
    elif layout == "ell":
        counts = np.bincount(rows, minlength=n)
        k = int(max_nnz if max_nnz is not None else (counts.max() if n else 0))
        k = max(k, 1)
        idx = np.zeros((n, k), dtype=np.int32)
        val = np.zeros((n, k), dtype=np.float64)
        # a stable row sort keeps input order within each row, so max_nnz
        # truncation keeps the FIRST entries in input order
        order = np.argsort(rows, kind="stable")
        r_s, c_s, v_s = rows[order], cols[order], vals[order]
        starts = np.cumsum(np.concatenate([[0], np.bincount(r_s, minlength=n)[:-1]]))
        within = np.arange(len(r_s)) - starts[r_s]
        keep = within < k
        idx[r_s[keep], within[keep]] = c_s[keep]
        val[r_s[keep], within[keep]] = v_s[keep]
        feats = FeatureMatrix(dim=dim, idx=torch.from_numpy(idx).to(dev), val=_as_tensor(val, vdt, dev))
    else:
        raise ValueError(f"unknown sparse layout {layout!r}: expected 'ell' or 'coo'")
    return _labeled(feats, y, offsets, weights, dtype, dev)


def pad_batch(batch: LabeledBatch, target_rows: int) -> LabeledBatch:
    """Pad a batch with zero-weight rows up to ``target_rows`` (dense and
    ELL: zero rows; COO: the row count grows, the padded rows hold no
    entries)."""
    n = batch.n_rows
    if n == target_rows:
        return batch
    if n > target_rows:
        raise ValueError(f"batch has {n} rows > target {target_rows}")
    extra = target_rows - n
    pad1 = lambda a: torch.cat([a, a.new_zeros(extra)])  # noqa: E731
    f = batch.features
    if f.dense is not None:
        feats = FeatureMatrix(dim=f.dim, dense=torch.cat([f.dense, f.dense.new_zeros((extra, f.dim))]))
    elif f.idx is not None:
        k = f.idx.shape[1]
        feats = FeatureMatrix(
            dim=f.dim,
            idx=torch.cat([f.idx, f.idx.new_zeros((extra, k))]),
            val=torch.cat([f.val, f.val.new_zeros((extra, k))]),
        )
    else:
        feats = FeatureMatrix(
            dim=f.dim, coo_cols=f.coo_cols, coo_rows=f.coo_rows, coo_vals=f.coo_vals, coo_n_rows=target_rows
        )
    return LabeledBatch(
        features=feats,
        labels=pad1(batch.labels),
        offsets=pad1(batch.offsets),
        weights=pad1(batch.weights),
        group=batch.group,
    )
