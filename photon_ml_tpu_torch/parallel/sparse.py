"""(data x model)-tiled sparse feature matrix: the huge-d fixed effect.

Counterpart of the JAX package's ``parallel/sparse.py``: the coefficient
vector is sharded over the model axis of a ``MeshGroup`` (``parallel/mesh.py``)
and the rows over its data axis, so that every rank holds one tile of X and
one ``[d_loc]`` slice of every solver vector, and the batch gradient
``g = X^T c`` is the tile's product summed over the rank's model column.

Each tile is a sorted-COO ``FeatureMatrix`` of ``[n_loc, d_loc]`` (local
rows and columns), so its products run S1, the segment kernel of
``ops/sparse.py``, on the card (its plain version on the CPU):

- ``matvec``: the tile's ``[n_loc]`` partial margins, summed over the data
  row (the ranks sharing the rows; ``psum(..., "model")``);
- ``rmatvec`` / ``sq_rmatvec``: the tile's ``[d_loc]`` partial, summed over
  the model column (the ranks sharing the columns; ``psum(..., "data")``).

Every sum over a subgroup is ``DataParallelGroup.sum``: float64 slots, one
gather, the rank-order sum, so the ranks of a subgroup hold the same bits.

The host build (``tile_sparse_matrix``) pads the rows to a multiple of D and
the columns to a multiple of M (padded rows carry weight 0, padded columns
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
from .mesh import MeshGroup

Tensor = torch.Tensor

# the FULL Hessian's default row chunk (the JAX package's rule): at least
# 4,096 rows, at most 64 chunks while a chunk's gathered rows stay under
# 256 MiB
_XTCX_MIN_CHUNK = 4096
_XTCX_MAX_CHUNKS = 64
_XTCX_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True, eq=False)
class TiledSparseMatrix:
    """A ``FeatureMatrix``-shaped sparse matrix tiled over a (data, model)
    grid: this rank's tile ``tile`` (a sorted-COO ``[n_loc, d_loc]``
    matrix) at grid position ``(mesh.data_index, mesh.model_index)``.
    ``dim`` / ``n_rows`` are the padded global sizes (multiples of the
    axes); ``dim_true`` the unpadded feature count."""

    dim: int
    n_rows: int
    mesh: MeshGroup
    tile: FeatureMatrix
    dim_true: int = 0

    @property
    def layout(self) -> str:
        return "tiled"

    @property
    def is_dense(self) -> bool:
        return False

    @property
    def n_local_rows(self) -> int:
        return self.n_rows // self.mesh.n_data

    @property
    def d_local(self) -> int:
        return self.dim // self.mesh.n_model

    @property
    def values(self) -> Tensor:
        """The tile's stored values (``coo_vals``)."""
        return self.tile.coo_vals

    def matvec(self, w: Tensor, plain: bool = False) -> Tensor:
        """``X w`` -> this data row's ``[n_loc]`` margins, for this rank's
        ``[d_loc]`` slice ``w``: the tile's product summed over the data row."""
        return self.mesh.model.sum(self.tile.matvec(w, plain=plain), plain=plain)

    def rmatvec(self, c: Tensor, plain: bool = False) -> Tensor:
        """``X^T c`` -> this rank's ``[d_loc]`` slice, for its data row's
        ``[n_loc]`` block ``c``: the tile's product summed over the model column."""
        return self.mesh.data.sum(self.tile.rmatvec(c, plain=plain), plain=plain)

    def sq_rmatvec(self, c: Tensor, plain: bool = False) -> Tensor:
        """``(X * X)^T c`` -> this rank's ``[d_loc]`` slice."""
        return self.mesh.data.sum(self.tile.sq_rmatvec(c, plain=plain), plain=plain)

    def to_dense(self) -> Tensor:
        raise NotImplementedError(
            "TiledSparseMatrix is for huge d; densification is not supported "
            "(use variance_type SIMPLE, or FULL which runs the chunked "
            "sharded xtcx path without materializing X)"
        )

    def default_row_chunk(self) -> int:
        """The JAX package's default chunk of ``xtcx``: at least 4,096 rows,
        raised until there are at most 64 chunks as long as a chunk's
        gathered rows stay under 256 MiB."""
        itemsize = self.values.element_size()
        mem_cap_rows = max(_XTCX_CHUNK_BYTES // (itemsize * max(self.dim, 1)), 1024)
        return max(_XTCX_MIN_CHUNK, min(-(-self.n_local_rows // _XTCX_MAX_CHUNKS), mem_cap_rows))

    def xtcx(self, c: Tensor, row_chunk: Optional[int] = None) -> Tensor:
        """``X^T diag(c) X`` -> this rank's ``[d_loc, dim]`` row block in
        ``c``'s dtype, summed over the model column: the FULL-variance
        Hessian on tiles (``xtcx_partial`` summed as a B4 sum is, in
        pieces). The ceiling on ``dim`` is the caller's
        (``ops.glm.check_full_variance_dim``): the whole matrix is inverted
        on one device afterwards."""
        from ..ops.glm import sum_over_ranks

        h = self.xtcx_partial(c, row_chunk)
        return h.to(c.dtype) if self.mesh.n_data == 1 else sum_over_ranks(self.mesh.data, h, c.dtype)

    def xtcx_partial(self, c: Tensor, row_chunk: Optional[int] = None) -> Tensor:
        """This rank's float64 ``[d_loc, dim]`` share of ``X^T diag(c) X``
        over its data row's rows, not yet summed over the model column. The
        rank scans its rows in ``row_chunk`` windows (default
        ``default_row_chunk``): it densifies the chunk of its tile to
        ``[chunk, d_loc]``, gathers the chunk's full rows over its data row
        into ``[chunk, dim]`` and adds ``xt^T (c * xg)`` into its block, so
        the peak is one chunk's rows and the block, never ``n x dim``."""
        n_loc, d_loc = self.n_local_rows, self.d_local
        chunk = min(row_chunk or self.default_row_chunk(), n_loc)
        t = self.tile
        dev = c.device
        rows, order = torch.sort(t.coo_rows.long(), stable=True)
        cols = t.coo_cols.long()[order]
        vals = t.coo_vals[order].to(torch.float64)
        bounds = torch.searchsorted(rows, torch.arange(0, n_loc + chunk, chunk, device=dev)).tolist()
        h = torch.zeros((d_loc, self.dim), dtype=torch.float64, device=dev)
        c64 = c.to(torch.float64)
        for k, lo in enumerate(range(0, n_loc, chunk)):
            hi = min(lo + chunk, n_loc)
            a, b = bounds[k], bounds[k + 1]
            xt = torch.zeros((hi - lo, d_loc), dtype=torch.float64, device=dev)
            xt.index_put_((rows[a:b] - lo, cols[a:b]), vals[a:b], accumulate=True)
            # the chunk's full rows: every model slice's columns, in model order
            (xg_t,) = self.mesh.gather_model([xt.T.contiguous()])
            h.addmm_(xt.T, c64[lo:hi, None] * xg_t.T)
        return h


def _padded_sizes(n_rows: int, dim: int, mesh: MeshGroup, local: bool):
    """(n_loc, n_pad, d_loc, d_pad): a data row's rows and the padded global
    row count, a model slice's columns and the padded dim."""
    D, M = mesh.n_data, mesh.n_model
    if local:
        n_loc = max(int(n_rows), 1)
        n_pad = n_loc * D
    else:
        n_pad = max(-(-int(n_rows) // D) * D, D)
        n_loc = n_pad // D
    d_pad = max(-(-int(dim) // M) * M, M)
    return n_loc, n_pad, d_pad // M, d_pad


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
    n_loc, n_pad, d_loc, d_pad = _padded_sizes(n_rows, dim, mesh, local)
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
    on the mesh's device: the JAX package's placement sharded over the model
    axis."""
    return mesh.model_slice(_as_tensor(w, dtype, mesh.device)).clone()
