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
writes its part into its own slot of a zero ``[world, ...]`` float64 buffer
and one ``all_reduce(SUM)`` fills every slot (each column has one nonzero,
and ``x + 0 = x``). A sum across ranks then adds the slots in rank order in
float64 (``slot_sum``), whatever order the backend's ring would take. Gloo
stages the buffer through a host tensor; NCCL keeps it on the card.

Model-axis (feature) sharding and the ELL / sorted-COO layouts are ROADMAP
A10 and A1 and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from ..ops.features import FeatureMatrix, LabeledBatch, pad_batch
from .multihost import equal_host_share

Tensor = torch.Tensor

_FEATURE_AXIS_TODO = (
    "feature-axis (model-axis) sharding is not ported yet (ROADMAP A10); "
    "photon_ml_tpu_torch shards rows over the data axis only"
)
_SPARSE_TODO = "sharding the ELL / sorted-COO layouts is not ported yet (ROADMAP A1)"


@dataclasses.dataclass(eq=False)
class DataParallelGroup:
    """One rank's view of the data axis: its process group, rank, world
    size, device and backend (``"nccl"`` or ``"gloo"``).

    ``collectives`` and ``collective_seconds`` count this rank's collective
    calls (slot sums, row gathers, broadcasts) and their host seconds. A call on a CUDA buffer synchronizes the
    device first, so the seconds are the collective's own (staging, the
    backend, the wait for the slowest rank and the rank-order sum) and not
    the kernel before it."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    process_group: Optional[object] = None  # None: torch.distributed's default group
    collectives: int = 0
    collective_seconds: float = 0.0

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
        self.collective_seconds += time.perf_counter() - t0

    def _all_reduce_sum(self, buf: Tensor) -> None:
        import torch.distributed as dist

        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.process_group)

    def _slots(self, flat: Tensor) -> Tensor:
        """``[world, width]`` float64: row r is rank r's ``flat``."""
        buf = torch.zeros(
            (self.world_size, flat.numel()), dtype=torch.float64, device=self._buffer_device()
        )
        buf[self.rank] = flat.reshape(-1).to(buf.device, torch.float64)
        self._all_reduce_sum(buf)
        return buf

    def slot_sum(self, flat: Tensor) -> Tensor:
        """The sum over ranks of a flat tensor, added in rank order in
        float64; returned in float64 on ``flat``'s device. Bitwise the same
        on every rank and on either backend; the identity for one rank."""
        with self._collective(flat.device):
            s = self._slots(flat)
            acc = s[0]
            for r in range(1, self.world_size):
                acc = acc + s[r]
            return acc.to(flat.device)

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
            s = self._slots(flat)
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
        self._all_reduce_sum(torch.zeros(1, device=self._buffer_device()))


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
    if f.dense is None or f.idx is not None or f.coo_cols is not None:
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
    """Mark a batch that holds only this rank's ``row_range(n_rows)`` rows
    (read by the rank itself, as from a memory-mapped file) as the rank's
    shard: pad it to ``equal_host_share`` rows and set ``group``. The same shard
    ``shard_batch`` cuts from the whole batch."""
    start, stop = row_range(n_rows, group)
    if batch.n_rows != stop - start:
        raise ValueError(f"rank {group.rank} holds rows [{start}, {stop}), got {batch.n_rows} rows")
    padded = pad_batch(batch, equal_host_share(n_rows, group.world_size))
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
