"""Data-parallel groups and the sharding helpers of the data axis.

Counterpart of the JAX package's ``parallel/mesh.py`` for its data axis.
There one controller places arrays on a device mesh and XLA inserts the
collectives; here every rank is a process of its own (SPMD over
``torch.distributed``) and a ``DataParallelGroup`` takes the place of the
mesh's data axis:

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

Model-axis (feature) sharding and row-sharded sparse batches are ROADMAP
A10 and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.features import FeatureMatrix, LabeledBatch, pad_batch
from .multihost import equal_host_share

Tensor = torch.Tensor

_FEATURE_AXIS_TODO = (
    "feature-axis (model-axis) sharding is not ported yet (ROADMAP A10); "
    "photon_ml_tpu_torch shards rows over the data axis only"
)
_SPARSE_TODO = (
    "shard_batch takes dense batches only: the reference refuses the column-sorted COO layout "
    "(its entries are column-major, not row-partitionable) and ELL across processes (the ELL "
    "width is the local rows' max nnz, so the ranks' shapes would disagree), and every rank of a "
    "group here is a process of its own; row-sharded sparse batches are ROADMAP A10"
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

    def broadcast(self, t: Tensor) -> Tensor:
        """Rank 0's value of ``t`` on every rank (same shape and dtype)."""
        import torch.distributed as dist

        with self._collective(t.device):
            buf = t.detach().to(self._buffer_device(), copy=True).contiguous()
            dist.broadcast(buf, src=0, group=self.process_group)
            return buf.to(t.device)

    def barrier(self) -> None:
        """Every rank reaches this point (a one-element all-reduce, which
        works alike on both backends)."""
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1, device=self._buffer_device()), group=self.process_group)


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


def shard_batch(
    batch: LabeledBatch, group: DataParallelGroup, shard_features_dim: bool = False
) -> LabeledBatch:
    """This rank's contiguous row range of a whole dense batch, padded as
    ``pad_rows_for_group`` pads, copied (so the whole batch can be freed)
    and marked with ``group``: its sweeps sum across the ranks."""
    if shard_features_dim:
        raise NotImplementedError(_FEATURE_AXIS_TODO)
    if batch.group is not None:
        raise ValueError("the batch is already sharded")
    f = batch.features
    if not f.is_dense:
        raise NotImplementedError(_SPARSE_TODO)
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
    """This rank's ``[lo, hi)`` of the entity blocks."""
    if num_entities % group.world_size != 0:
        raise ValueError(
            f"entity count {num_entities} must divide the world size ({group.world_size}); "
            f"build the dataset with pad_entities_to_multiple={group.world_size}"
        )
    chunk = num_entities // group.world_size
    return group.rank * chunk, (group.rank + 1) * chunk


def shard_entity_blocks(blocks, group: DataParallelGroup):
    """This rank's contiguous entity range of ``EntityBlocks``, copied."""
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
