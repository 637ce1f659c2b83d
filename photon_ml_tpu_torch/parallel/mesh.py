"""Data-parallel groups, the (data x model) rank grid, and the sharding
helpers of the data axis.

Counterpart of the JAX package's ``parallel/mesh.py``. There one controller
places arrays on a device mesh and XLA inserts the collectives; here every
rank is a process of its own (SPMD over ``torch.distributed``) and a
``DataParallelGroup`` takes the place of one mesh axis. ``make_mesh(D, M)``
lays ``D * M`` ranks out as the JAX package's
``devices.reshape(n_data, n_model)`` does, row-major: rank r sits at data
index ``i = r // M`` and model index ``j = r % M``. Its ``MeshGroup`` holds
the rank's two subgroups, the ranks of its model column ``{i' * M + j}``
(``data``: the JAX ``psum(..., "data")``) and of its data row
``{i * M + j'}`` (``model``: ``psum(..., "model")``); the (data x model)
tiled sparse batch of ``parallel/sparse.py`` runs over it. Helpers of the
data axis alone:

- ``shard_batch``: a dense batch zero-weight-padded to a multiple of the
  world size, each rank keeping its contiguous row range (the JAX package's
  ``pad_rows_for_mesh`` + ``shard_batch``);
- ``shard_entity_blocks``: each rank keeps its contiguous entity range of
  the random effect's blocks (``E % world == 0``);
- ``replicate``: a broadcast from rank 0.

Everything ``[n]``-sized and every model stays whole on every rank.

Every collective here is exact, so that every rank holds bitwise the same
numbers and the replicated solver loops take the same decisions: each rank
writes its part into its own row of a ``[world, width]`` float64 slot
buffer and one all-gather fills the other rows with a copy of each rank's
(``gather_slots``, ``gather_rows``). A sum across ranks then adds the rows
in rank order in float64 (``ops/fused_glm.py`` ``rank_order_sum``),
whatever order the backend's ring would take. Gloo stages the buffer
through a host tensor; NCCL keeps it on the card and runs in stream order,
so B4's slot gathers make the host wait for nothing.

``DataParallelGroup.sum`` is the exact sum over a group: the rank's float64
slot row, one slot gather, the rank-order sum, so that every rank of the
group holds the same bits.

On the grid (a ``MeshGroup``):

- ``shard_batch(batch, mesh)``: rows over the data axis, replicated over
  the model axis (each rank of a model column runs B4 over its ``data``
  subgroup: the JAX package's ``shard_batch(batch, mesh)``);
- ``shard_batch(batch, mesh, shard_features_dim=True)``: the dense
  feature-axis shard, the JAX package's ``P(DATA, MODEL)`` placement. The
  rank (i, j) keeps the dense tile ``X[rows_i, cols_j]`` of a
  ``TiledDenseMatrix``: its rows padded as ``pad_rows_for_group`` pads
  them, its columns to a multiple of M with zero columns (``tile_sizes``,
  the sparse tile's rule);
- ``shard_coefficients``: a whole coefficient vector's model slice.

``TiledMatrix`` is the product interface a tile offers ``ops/glm.py``'s
tiled branch: ``matvec`` summed over the data row, ``rmatvec`` /
``sq_rmatvec`` over the model column (``DataParallelGroup.sum``), and the
FULL Hessian's ``xtcx``. A dense tile's products are plain matrix products
(``torch.mv``; the JAX package computes them outside any Pallas kernel);
the sorted-COO tile of ``parallel/sparse.py`` runs the segment kernel.

A sparse batch does not row-shard, in the JAX package's words: a COO batch
is not row-partitionable, and every rank of a group here is a process of
its own, so an ELL batch's width would differ from rank to rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops.features import FeatureMatrix, LabeledBatch, _as_tensor, pad_batch
from ..ops.fused_glm import rank_order_sum, rank_order_sum_plain
from .multihost import equal_host_share

Tensor = torch.Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the JAX package's refusals of a sparse batch over several processes or a
# mesh (its shard_batch's; the planner raises them at plan time)
MULTI_ELL_REFUSAL = (
    "multi-process ELL sharding is not supported: the ELL width "
    "is the max nnz of the LOCAL rows, so per-host shapes (and "
    "the compiled programs) would disagree; use a dense layout "
    "(d <= 4096) for multi-process runs"
)
SHARD_COO_REFUSAL = (
    "shard_batch does not support the column-sorted COO layout (its "
    "nnz axis is column-major, not row-partitionable); for a "
    "mesh-sharded huge-d batch build layout='tiled' "
    "(parallel.sparse.tiled_sparse_batch)"
)

# the JAX package's _reject_multiprocess_model_axis: a DataParallelGroup
# is a data axis alone, so over several processes it has no model axis to
# shard (a MeshGroup's ranks take the mesh's devices' place and do)
MULTIPROCESS_MODEL_AXIS_REFUSAL = (
    "model-axis sharding across processes is not supported yet: "
    "callers pass full arrays, but each process may only contribute "
    "its own model-axis slice; multi-process runs shard the data "
    "axis only"
)


@dataclasses.dataclass(eq=False)
class DataParallelGroup:
    """One rank's view of the data axis: its process group, rank, world
    size, device and backend (``"nccl"`` or ``"gloo"``).

    ``collectives`` and ``collective_seconds`` count this rank's collective
    calls (slot gathers, row gathers, broadcasts) and their seconds: each
    collective's own, including the wait for the slowest rank, and not the
    kernel before it. A slot gather over NCCL is timed by a pair of CUDA
    events on the current stream, resolved when ``collective_seconds`` is
    read (the host then waits for the last one); every other call
    synchronizes a CUDA device before and after and takes the host clock
    (staging through the host included)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    process_group: Optional[object] = None  # None: torch.distributed's default group
    collectives: int = 0
    _seconds: float = dataclasses.field(default=0.0, init=False, repr=False)
    _pending: list = dataclasses.field(default_factory=list, init=False, repr=False)
    _slots: Dict[Tuple[int, torch.device], Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False
    )

    def __post_init__(self):
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {self.backend!r}")
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of {self.world_size}")
        self.device = torch.device(self.device)

    def _buffer_device(self) -> torch.device:
        # gloo reduces host tensors: stage explicitly rather than trust its
        # CUDA support
        return torch.device("cpu") if self.backend == "gloo" else self.device

    @property
    def collective_seconds(self) -> float:
        self._resolve(wait=True)
        return self._seconds

    def _resolve(self, wait: bool) -> None:
        """Add the pending NCCL event pairs' times, in order: all of them
        (``wait``: the host waits for each end event), or those already
        done (no wait)."""
        while self._pending:
            start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._seconds += start.elapsed_time(end) * 1e-3
            self._pending.pop(0)

    @contextlib.contextmanager
    def _collective(self, device: torch.device):
        sync = device.type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(device)
        self.collectives += 1
        self._seconds += time.perf_counter() - t0

    def _all_gather(self, buf: Tensor) -> None:
        """Row ``rank`` of ``buf`` (``[world, width]``, contiguous) into the
        same row on every rank: one in-place all-gather."""
        import torch.distributed as dist

        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(buf.view(-1), buf[self.rank], group=self.process_group)

    def slot_buffer(self, width: int, device) -> Tensor:
        """The group's ``[world, width]`` float64 slot buffer on ``device``,
        made on first use and kept (B4 writes this rank's row of it on every
        call); at most a few widths are in use at a time."""
        key = (width, torch.device(device))
        buf = self._slots.get(key)
        if buf is None:
            if len(self._slots) >= 16:
                self._slots.clear()
            buf = torch.empty((self.world_size, width), dtype=torch.float64, device=key[1])
            self._slots[key] = buf
        return buf

    def gather_slots(self, slots: Tensor) -> Tensor:
        """Fill every row of ``slots`` (a ``slot_buffer`` whose row ``rank``
        this rank has written) with the rank that owns it; returns
        ``slots``. Over NCCL the all-gather runs on the card in stream order:
        the current stream waits for it and the host does not. Gloo stages
        a CUDA buffer through the host buffer of the same width."""
        if self.backend == "nccl":
            stream = torch.cuda.current_stream(slots.device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self._all_gather(slots)
            end.record(stream)
            self.collectives += 1
            self._resolve(wait=False)
            self._pending.append((start, end))
            return slots
        with self._collective(slots.device):
            if slots.device.type == "cpu":
                self._all_gather(slots)
            else:
                host = self.slot_buffer(slots.shape[1], "cpu")
                host[self.rank] = slots[self.rank]
                self._all_gather(host)
                slots.copy_(host)
        return slots

    def gather_rows(self, tensors: Sequence[Tensor]) -> List[Tensor]:
        """Each tensor's rows from every rank, concatenated in rank order
        along dim 0 (every rank passes the same shapes): one collective for
        all of them. Exact for float32/float64 values and for integers
        below 2**53."""
        if not tensors:
            return []
        dev = tensors[0].device
        with self._collective(dev):
            flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
            # a fresh buffer: the rows returned below may be views of it
            s = torch.empty(
                (self.world_size, flat.numel()), dtype=torch.float64, device=self._buffer_device()
            )
            s[self.rank] = flat.to(s.device)
            self._all_gather(s)
            out, at = [], 0
            for t in tensors:
                k = t.numel()
                rows = s[:, at : at + k].reshape((self.world_size * t.shape[0],) + tuple(t.shape[1:]))
                out.append(rows.to(device=t.device, dtype=t.dtype))
                at += k
            return out

    def sum(self, t: Tensor, plain: bool = False) -> Tensor:
        """``t`` summed over the group's ranks, every rank the same bits: the
        rank's float64 slot row (``slot_buffer``), one ``gather_slots``, then
        the rows added in rank order (``rank_order_sum``: the CUDA kernel for
        a float32 ``t`` on the card, its plain version on the CPU, for
        float64 and with ``plain``), in ``t``'s dtype and shape. One rank:
        ``t`` itself, with no collective."""
        if self.world_size == 1:
            return t
        flat = t.reshape(-1)
        slots = self.slot_buffer(flat.numel(), t.device)
        slots[self.rank] = flat
        self.gather_slots(slots)
        if plain or t.device.type == "cpu" or t.dtype == torch.float64:
            total = rank_order_sum_plain(slots, t.dtype)
        else:
            total = rank_order_sum(slots, t.dtype)
        return total.view(t.shape)

    def broadcast(self, t: Tensor) -> Tensor:
        """Rank 0's value of ``t`` on every rank (same shape and dtype)."""
        import torch.distributed as dist

        with self._collective(t.device):
            buf = t.detach().to(self._buffer_device(), copy=True).contiguous()
            # a subgroup's rank 0 by its rank in the default group
            src = 0 if self.process_group is None else dist.get_global_rank(self.process_group, 0)
            dist.broadcast(buf, src=src, group=self.process_group)
            return buf.to(t.device)

    def barrier(self) -> None:
        """Every rank reaches this point (a one-element all-reduce, which
        works alike on both backends)."""
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1, device=self._buffer_device()), group=self.process_group)


@dataclasses.dataclass(eq=False)
class MeshGroup:
    """One rank's place on a (data x model) grid of ``n_data * n_model``
    ranks, each with one device: its indices ``(data_index, model_index)``
    and its two subgroups, ``data`` (the ranks of its model column, summed
    over by the JAX package's ``psum(..., "data")``) and ``model`` (the
    ranks of its data row: ``psum(..., "model")``). ``world`` is the whole
    grid's group, None in a single process (a 1 x 1 grid, where neither
    subgroup ever collects)."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data: DataParallelGroup
    model: DataParallelGroup
    world: Optional[DataParallelGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        """The JAX ``Mesh.shape``: ``{"data": D, "model": M}``."""
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def device(self) -> torch.device:
        return self.data.device

    def gather_model(self, tensors: Sequence[Tensor]) -> List[Tensor]:
        """Model-sharded ``[d_loc, ...]`` slices made whole, ``[M * d_loc,
        ...]``, in model order on every rank of the data row: one exact
        row gather for all of them (the JAX package's replication of a
        model-sharded array)."""
        if self.n_model == 1:
            return list(tensors)
        return self.model.gather_rows(tensors)

    def model_slice(self, v: Tensor) -> Tensor:
        """This rank's model-axis slice of a whole ``[dim, ...]`` tensor
        (``dim`` a multiple of ``n_model``): the JAX package's reshard to
        ``P("model")``."""
        d_loc = v.shape[0] // self.n_model
        return v[self.model_index * d_loc : (self.model_index + 1) * d_loc]


def make_mesh(
    n_data: Optional[int] = None, n_model: int = 1, group: Optional[DataParallelGroup] = None, device=None
) -> MeshGroup:
    """This rank's ``MeshGroup`` on a (``n_data`` x ``n_model``) grid of the
    ranks of ``group`` (default: the group this process joined through
    ``parallel.multihost.initialize``), laid out row-major as the JAX
    package's ``make_mesh`` reshapes its devices. ``n_data`` defaults to
    ``world // n_model``; ``n_data * n_model`` must equal the world size.
    Every rank must call it, with the same shape: every rank makes every
    subgroup, in the same order, as ``torch.distributed.new_group``
    requires. With no group (one process) the grid is 1 x 1 on ``device``
    (the card unless asked otherwise)."""
    from . import multihost

    world = group if group is not None else multihost.current_group()
    if world is None:
        if (n_data or 1) != 1 or n_model != 1:
            raise ValueError(
                f"a ({n_data} x {n_model}) grid needs {(n_data or 1) * n_model} ranks: join a process group "
                "first (parallel.multihost.initialize, or parallel.spawn)"
            )
        dev = resolve_device(device)
        solo = lambda: DataParallelGroup(0, 1, dev, "gloo")  # noqa: E731
        return MeshGroup(1, 1, 0, 0, solo(), solo())
    if n_data is None:
        n_data = world.world_size // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world.world_size:
        raise ValueError(
            f"a ({n_data} x {n_model}) grid needs data * model = {world.world_size} ranks (the world size)"
        )
    import torch.distributed as dist

    i, j = divmod(world.rank, n_model)

    def subgroups(members_of, count, mine):
        # every rank makes every subgroup, in the same order; the whole
        # world reuses the default group
        out = None
        for k in range(count):
            members = members_of(k)
            if len(members) == world.world_size:
                pg = world.process_group
            else:
                pg = dist.new_group(ranks=members)
            if k == mine:
                out = DataParallelGroup(
                    rank=members.index(world.rank), world_size=len(members), device=world.device,
                    backend=world.backend, process_group=pg,
                )
        return out

    data = subgroups(lambda jj: [ii * n_model + jj for ii in range(n_data)], n_model, j)
    model = subgroups(lambda ii: [ii * n_model + jj for jj in range(n_model)], n_data, i)
    return MeshGroup(n_data, n_model, i, j, data, model, world)


def _data_axis(group):
    """A ``MeshGroup``'s data axis, or the ``DataParallelGroup`` itself."""
    return group.data if isinstance(group, MeshGroup) else group


def tile_sizes(n_rows: int, dim: int, mesh: MeshGroup, local: bool = False):
    """(n_loc, n_pad, d_loc, d_pad) of a grid's tiles: a data row's rows and
    the padded global row count, a model slice's columns and the padded dim
    (at least one row and column a tile). ``local``: ``n_rows`` are this
    data row's own rows (a per-host read), the same count on every data row."""
    D, M = mesh.n_data, mesh.n_model
    if local:
        n_loc = max(int(n_rows), 1)
        n_pad = n_loc * D
    else:
        n_pad = max(-(-int(n_rows) // D) * D, D)
        n_loc = n_pad // D
    d_pad = max(-(-int(dim) // M) * M, M)
    return n_loc, n_pad, d_pad // M, d_pad


# the FULL Hessian's default row chunk (the JAX package's rule): at least
# 4,096 rows, at most 64 chunks while a chunk's gathered rows stay under
# 256 MiB
_XTCX_MIN_CHUNK = 4096
_XTCX_MAX_CHUNKS = 64
_XTCX_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True, eq=False)
class TiledMatrix:
    """A ``FeatureMatrix``-shaped matrix tiled over a (data, model) grid:
    this rank's tile ``tile`` (a ``[n_loc, d_loc]`` ``FeatureMatrix`` in
    local rows and columns) at grid position ``(mesh.data_index,
    mesh.model_index)``. ``dim`` / ``n_rows`` are the padded global sizes
    (multiples of the axes, ``tile_sizes``); ``dim_true`` the unpadded
    feature count. The coefficient slices a rank passes are its ``[d_loc]``
    model slice, the row vectors its data row's ``[n_loc]`` block."""

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
        """The tile's stored values."""
        return self.tile.values

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

    def _float64_row_chunks(self, chunk: int):
        """``(lo, hi, xt)`` for each window of ``chunk`` local rows: the
        tile's rows ``[lo, hi)`` as a float64 ``[hi - lo, d_loc]`` matrix."""
        raise NotImplementedError

    def xtcx_partial(self, c: Tensor, row_chunk: Optional[int] = None) -> Tensor:
        """This rank's float64 ``[d_loc, dim]`` share of ``X^T diag(c) X``
        over its data row's rows, not yet summed over the model column. The
        rank scans its rows in ``row_chunk`` windows (default
        ``default_row_chunk``): the chunk of its tile as float64 ``[chunk,
        d_loc]``, the chunk's full rows gathered over its data row into
        ``[chunk, dim]``, and ``xt^T (c * xg)`` added into its block, so the
        peak is one chunk's rows and the block, never ``n x dim``."""
        chunk = min(row_chunk or self.default_row_chunk(), self.n_local_rows)
        h = torch.zeros((self.d_local, self.dim), dtype=torch.float64, device=c.device)
        c64 = c.to(torch.float64)
        for lo, hi, xt in self._float64_row_chunks(chunk):
            # the chunk's full rows: every model slice's columns, in model order
            (xg_t,) = self.mesh.gather_model([xt.T.contiguous()])
            h.addmm_(xt.T, c64[lo:hi, None] * xg_t.T)
        return h


@dataclasses.dataclass(frozen=True, eq=False)
class TiledDenseMatrix(TiledMatrix):
    """The dense feature-axis shard (``shard_batch(shard_features_dim=True)``):
    ``tile`` is this rank's dense ``X[rows_i, cols_j]``, zero-padded. Its
    products are ``torch.mv`` on the tile (the same bits for the same input
    on one device) and the grid's exact sums."""

    def to_dense(self) -> Tensor:
        """The whole padded ``[n_rows, dim]`` matrix on every rank: the
        tile's columns gathered over the data row, then the rows over the
        model column (every rank of the grid must call it)."""
        (xt,) = self.mesh.gather_model([self.tile.dense.T.contiguous()])
        if self.mesh.n_data == 1:
            return xt.T.contiguous()
        (x,) = self.mesh.data.gather_rows([xt.T.contiguous()])
        return x

    def _float64_row_chunks(self, chunk: int):
        x = self.tile.dense
        for lo in range(0, self.n_local_rows, chunk):
            hi = min(lo + chunk, self.n_local_rows)
            yield lo, hi, x[lo:hi].to(torch.float64)


def row_range(n_rows: int, group: DataParallelGroup):
    """This rank's ``[start, stop)`` of the real rows; the rank holds
    ``equal_host_share`` rows, the last ``share - (stop - start)`` of them
    zero-weight padding."""
    share = equal_host_share(n_rows, group.world_size)
    start = min(group.rank * share, n_rows)
    return start, min(start + share, n_rows)


def pad_rows_for_group(batch: LabeledBatch, group: DataParallelGroup) -> LabeledBatch:
    """Zero-weight-pad the batch so its row count divides the world size."""
    return pad_batch(batch, equal_host_share(batch.n_rows, group.world_size) * group.world_size)


def _grid_of(group, what: str) -> "MeshGroup":
    """``group``, the grid whose model axis shards the features: a
    ``MeshGroup`` (``make_mesh``; one rank's is ``make_mesh(1, 1)``), as
    the JAX package's counterparts take a mesh. A ``DataParallelGroup``
    over several processes has no model axis and is refused in the JAX
    package's words (``_reject_multiprocess_model_axis``)."""
    if isinstance(group, MeshGroup):
        return group
    if isinstance(group, DataParallelGroup) and group.world_size > 1:
        raise NotImplementedError(f"{what}: {MULTIPROCESS_MODEL_AXIS_REFUSAL}")
    raise TypeError(f"{what} takes a MeshGroup (make_mesh), got {type(group).__name__}")


def shard_batch(
    batch: LabeledBatch, group, shard_features_dim: bool = False
) -> LabeledBatch:
    """This rank's share of a whole dense batch (every rank passes the
    same), copied (so the whole batch can be freed).

    ``shard_features_dim=False``: its contiguous row range over ``group``
    (a ``DataParallelGroup``, or a ``MeshGroup``'s data axis: the ranks of
    a data row keep the same rows), padded as ``pad_rows_for_group`` pads,
    and marked with that group: its sweeps sum across the ranks.

    ``shard_features_dim=True``: the rank's dense tile on the grid
    ``group`` (a ``MeshGroup``; ``TiledDenseMatrix``), on its device, with its data row's
    labels, offsets and weights (padded rows carry weight 0); ``group`` on
    the batch is the grid's ``data`` subgroup when the grid spans ranks, as
    a tiled sparse batch's is.

    Sparse batches are refused in the JAX package's words."""
    if batch.group is not None:
        raise ValueError("the batch is already sharded")
    f = batch.features
    if not f.is_dense:
        raise NotImplementedError(SHARD_COO_REFUSAL if f.layout == "coo" else MULTI_ELL_REFUSAL)
    if shard_features_dim:
        return _tile_dense_batch(batch, _grid_of(group, "shard_batch(shard_features_dim=True)"))
    group = _data_axis(group)
    padded = pad_rows_for_group(batch, group)
    share = padded.n_rows // group.world_size
    lo, hi = group.rank * share, (group.rank + 1) * share
    take = lambda a: a[lo:hi].clone()  # noqa: E731
    return LabeledBatch(
        features=FeatureMatrix(dim=f.dim, dense=take(padded.features.dense).contiguous()),
        labels=take(padded.labels),
        offsets=take(padded.offsets),
        weights=take(padded.weights),
        group=group,
    )


def _tile_dense_batch(batch: LabeledBatch, mesh: "MeshGroup") -> LabeledBatch:
    """The rank's ``[n_loc, d_loc]`` tile of a whole dense batch and its data
    row's ``[n_loc]`` labels, offsets and weights."""
    x = batch.features.dense
    n, d = x.shape
    n_loc, n_pad, d_loc, d_pad = tile_sizes(n, d, mesh)
    r0, c0 = mesh.data_index * n_loc, mesh.model_index * d_loc
    dev = mesh.device
    rows = x[r0 : min(r0 + n_loc, n), c0 : min(c0 + d_loc, d)]
    tile = torch.zeros((n_loc, d_loc), dtype=x.dtype, device=dev)
    tile[: rows.shape[0], : rows.shape[1]] = rows.to(dev)

    def block(a):
        out = torch.zeros(n_loc, dtype=a.dtype, device=dev)
        part = a[r0 : r0 + n_loc]
        out[: part.shape[0]] = part.to(dev)
        return out

    return LabeledBatch(
        features=TiledDenseMatrix(
            dim=d_pad, n_rows=n_pad, mesh=mesh, tile=FeatureMatrix(dim=d_loc, dense=tile), dim_true=d,
        ),
        labels=block(batch.labels),
        offsets=block(batch.offsets),
        weights=block(batch.weights),
        group=None if mesh.world is None else mesh.data,
    )


def shard_coefficients(w, mesh, dtype=None) -> Tensor:
    """This rank's model slice of a whole coefficient vector ``w`` (every
    rank passes the same), zero-padded to the tiles' padded dim, on the
    grid's device: the JAX package's ``P("model")`` placement. ``dtype``
    defaults to ``w``'s (float32 for an array that is not a tensor)."""
    mesh = _grid_of(mesh, "shard_coefficients")
    if dtype is None:
        dtype = w.dtype if isinstance(w, Tensor) else torch.float32
    w = _as_tensor(w, dtype, mesh.device)
    d_pad = tile_sizes(0, w.shape[0], mesh)[3]
    if d_pad > w.shape[0]:
        w = torch.cat([w, w.new_zeros(d_pad - w.shape[0])])
    return mesh.model_slice(w).clone()


def local_batch(
    batch: LabeledBatch, n_rows: int, group: DataParallelGroup
) -> LabeledBatch:
    """Mark a batch that holds only this rank's rows (read by the rank
    itself, as from a memory-mapped file or a per-host row range) as the
    rank's shard: pad it to ``equal_host_share`` rows and set ``group``.
    Its ``row_range(n_rows)`` rows make the same shard ``shard_batch`` cuts
    from the whole batch; a batch of ``equal_host_share(n_rows)`` rows is
    already padded (``cli.train``'s per-host read pads its own range, so the
    padded global row space is the ranks' shares in rank order)."""
    share = equal_host_share(n_rows, group.world_size)
    start, stop = row_range(n_rows, group)
    if batch.n_rows not in (share, stop - start):
        raise ValueError(f"rank {group.rank} holds rows [{start}, {stop}), got {batch.n_rows} rows")
    padded = pad_batch(batch, share)
    return dataclasses.replace(padded, group=group)


def replicate(t: Tensor, group: DataParallelGroup) -> Tensor:
    """Rank 0's tensor on every rank (the coefficient broadcast)."""
    return group.broadcast(t)


def entity_range(num_entities: int, group: DataParallelGroup):
    """This rank's ``[lo, hi)`` of the entity blocks (over a grid's data
    axis for a ``MeshGroup``: the ranks of a data row hold the same range)."""
    group = _data_axis(group)
    if num_entities % group.world_size != 0:
        raise ValueError(
            f"entity count {num_entities} must divide the world size ({group.world_size}); "
            f"build the dataset with pad_entities_to_multiple={group.world_size}"
        )
    chunk = num_entities // group.world_size
    return group.rank * chunk, (group.rank + 1) * chunk


def shard_entity_blocks(blocks, group: DataParallelGroup):
    """This rank's contiguous entity range of ``EntityBlocks``, copied (a
    ``MeshGroup`` shards over its data axis, as the JAX package shards
    entity blocks over "data")."""
    lo, hi = entity_range(blocks.features.shape[0], group)
    return type(blocks)(**{
        f.name: getattr(blocks, f.name)[lo:hi].clone() for f in dataclasses.fields(blocks)
    })


def shard_fixed_effect_dataset(dataset, group: DataParallelGroup):
    """A resident dense ``FixedEffectDataset`` cut to this rank's rows;
    ``true_n_rows`` keeps the global row count."""
    return dataclasses.replace(
        dataset, batch=shard_batch(dataset.batch, group), true_n_rows=dataset.n_rows
    )


def shard_random_effect_dataset(dataset, group: DataParallelGroup):
    """A ``RandomEffectDataset`` whose blocks hold this rank's entity range;
    the entity tables, the scoring arrays and ``host_proj_cols`` (the whole
    support layout, which the replicated model carries) stay whole."""
    if dataset.group is not None:
        raise ValueError("the dataset is already sharded")
    return dataclasses.replace(
        dataset,
        blocks=shard_entity_blocks(dataset.blocks, group),
        host_proj_cols=dataset.blocks.proj_cols.cpu().numpy(),
        group=group,
    )
