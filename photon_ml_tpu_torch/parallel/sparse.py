"""(data x model)-tiled sparse feature matrix: the huge-d fixed effect.

Counterpart of the JAX package's ``parallel/sparse.py``: the coefficient
vector is sharded over the model axis of a ``MeshGroup`` (``parallel/mesh.py``)
and the rows over its data axis, so that every rank holds one tile of X and
one ``[d_loc]`` slice of every solver vector, and the batch gradient
``g = X^T c`` is the tile's product summed over the rank's model column.

Each tile is a sorted-COO ``FeatureMatrix`` of ``[n_loc, d_loc]`` (local
rows and columns), so its products run S1, the segment kernel of
``ops/sparse.py``, on the card (its plain version on the CPU). The product
interface is ``parallel/mesh.py``'s ``TiledMatrix``, which the dense tile
of ``shard_batch(shard_features_dim=True)`` shares:

- ``matvec``: the tile's ``[n_loc]`` partial margins, summed over the data
  row (the ranks sharing the rows; ``psum(..., "model")``);
- ``rmatvec`` / ``sq_rmatvec``: the tile's ``[d_loc]`` partial, summed over
  the model column (the ranks sharing the columns; ``psum(..., "data")``).

Every sum over a subgroup is ``DataParallelGroup.sum``: float64 slots, one
gather, the rank-order sum, so the ranks of a subgroup hold the same bits.

The host build (``tile_sparse_matrix``) pads the rows to a multiple of D and
the columns to a multiple of M (``mesh.tile_sizes``) (padded rows carry weight 0, padded columns
no entries); ``dim`` and ``n_rows`` are the padded global sizes and
``dim_true`` the real feature count. Each rank keeps the entries of its own
tile; its padding entries are the COO layout's (``col = d_loc - 1``,
``row = 0``, ``val = 0``). Ranks need not agree on a tile's entry count
(the JAX package's ``m_tile`` all-gather): every rank is a process with
shapes of its own.

The coefficient vector a rank passes and gets back is its ``[d_loc]``
slice (``replicated_coefficients`` cuts it from a whole vector); margins
and row weights are its data row's ``[n_loc]`` block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.features import FeatureMatrix, LabeledBatch, _as_tensor, sorted_coo_matrix
from .mesh import MeshGroup, TiledMatrix, shard_coefficients, tile_sizes

Tensor = torch.Tensor

@dataclasses.dataclass(frozen=True, eq=False)
class TiledSparseMatrix(TiledMatrix):
    """A ``TiledMatrix`` whose tile is a sorted-COO ``[n_loc, d_loc]``
    matrix: its products run S1 on the card."""

    def to_dense(self) -> Tensor:
        raise NotImplementedError(
            "TiledSparseMatrix is for huge d; densification is not supported "
            "(use variance_type SIMPLE, or FULL which runs the chunked "
            "sharded xtcx path without materializing X)"
        )

    def _float64_row_chunks(self, chunk: int):
        """Each window's entries (the tile's entries sorted by row once)
        densified into ``[chunk, d_loc]``."""
        n_loc = self.n_local_rows
        t = self.tile
        dev = t.coo_vals.device
        rows, order = torch.sort(t.coo_rows.long(), stable=True)
        cols = t.coo_cols.long()[order]
        vals = t.coo_vals[order].to(torch.float64)
        bounds = torch.searchsorted(rows, torch.arange(0, n_loc + chunk, chunk, device=dev)).tolist()
        for k, lo in enumerate(range(0, n_loc, chunk)):
            hi = min(lo + chunk, n_loc)
            a, b = bounds[k], bounds[k + 1]
            xt = torch.zeros((hi - lo, self.d_local), dtype=torch.float64, device=dev)
            xt.index_put_((rows[a:b] - lo, cols[a:b]), vals[a:b], accumulate=True)
            yield lo, hi, xt


def tile_sparse_matrix(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    dim: int,
    mesh: MeshGroup,
    dtype=torch.float32,
    local: bool = False,
) -> TiledSparseMatrix:
    """Host-side build of this rank's tile (the JAX package's
    ``tile_sparse_matrix``, one tile a rank). ``rows`` / ``cols`` / ``vals``
    are COO triplets over ``n_rows`` rows and ``dim`` columns: the whole
    batch (``local=False``: every rank passes the same, and keeps the rows
    of its data row's block), or this data row's own rows (``local=True``,
    a per-host read: ``n_rows`` local rows, the same count on every data
    row, and the global row space the data rows' blocks in order). The rank
    keeps the entries of its model slice's columns, in local coordinates,
    sorted by column (stable: input order within a column). The tile lives
    on the mesh's device."""
    n_loc, n_pad, d_loc, d_pad = tile_sizes(n_rows, dim, mesh, local)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    r0 = 0 if local else mesh.data_index * n_loc
    c0 = mesh.model_index * d_loc
    keep = (rows >= r0) & (rows < r0 + n_loc) & (cols >= c0) & (cols < c0 + d_loc)
    tile = sorted_coo_matrix(
        rows[keep] - r0, cols[keep] - c0, vals[keep], n_rows=n_loc, dim=d_loc, dtype=dtype, device=mesh.device,
    )
    return TiledSparseMatrix(dim=d_pad, n_rows=n_pad, mesh=mesh, tile=tile, dim_true=int(dim))


def tiled_sparse_batch(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    y: np.ndarray,
    dim: int,
    mesh: MeshGroup,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    dtype=torch.float32,
    local: bool = False,
) -> LabeledBatch:
    """A ``LabeledBatch`` whose features are this rank's tile
    (``tile_sparse_matrix``) and whose labels, offsets and weights are its
    data row's ``[n_loc]`` block, zero-padded (padded rows carry weight 0).
    ``group`` is the mesh's ``data`` subgroup when the grid spans ranks:
    the batch's rows are that group's shards, as a dense row shard's are."""
    n = len(y)
    feats = tile_sparse_matrix(rows, cols, vals, n, dim, mesh, dtype=dtype, local=local)
    n_loc = feats.n_local_rows
    r0 = 0 if local else mesh.data_index * n_loc

    def block(a, fill):
        out = np.full(n_loc, fill, dtype=np.float64)
        part = np.asarray(a, dtype=np.float64)[r0 : r0 + n_loc]
        out[: len(part)] = part
        return _as_tensor(out, dtype, mesh.device)

    return LabeledBatch(
        features=feats,
        labels=block(y, 0.0),
        offsets=block(np.zeros(n) if offsets is None else offsets, 0.0),
        weights=block(np.ones(n) if weights is None else weights, 0.0),
        group=None if mesh.world is None else mesh.data,
    )


def replicated_coefficients(w, mesh: MeshGroup, dtype=torch.float32) -> Tensor:
    """This rank's model-axis slice of a whole ``[dim]``-padded coefficient
    vector (every rank passes the whole vector, as every JAX process does),
    on the mesh's device: ``parallel.mesh.shard_coefficients`` in ``dtype``."""
    return shard_coefficients(w, mesh, dtype)
