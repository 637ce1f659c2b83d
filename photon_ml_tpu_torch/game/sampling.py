"""Down-sampling of a fixed effect's training batch.

Counterpart of the JAX package's ``game/sampling.py``: a binary task keeps
every positive row and keeps each negative with probability ``rate``,
reweighting the kept ones by ``1 / rate``; any other task keeps each row
with probability ``rate`` at its weight. A dropped row keeps its place with
weight 0, so the batch's shapes do not change, and scoring still sees
every row.

The draw and its application are two functions: ``draw_keep_mask`` draws
the keep mask on the batch's device from a ``torch.Generator`` seeded with
the coordinate's seed (the JAX package draws it from
``jax.random.PRNGKey(seed)``; the two draws differ), and
``apply_keep_mask`` turns a given mask into weights. Over a data-parallel
group every rank draws the whole ``n``-row mask and keeps its own rows, so
the mask does not depend on the world size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.features import LabeledBatch
from ..ops.losses import POSITIVE_RESPONSE_THRESHOLD

Tensor = torch.Tensor

_BINARY_TASKS = {"logistic_regression", "smoothed_hinge_loss_linear_svm"}


def is_binary_task(task: str) -> bool:
    return task.lower() in _BINARY_TASKS


def check_rate(rate: float) -> None:
    if not (0.0 < rate < 1.0):
        raise ValueError(f"down-sampling rate must be in (0, 1): {rate}")


def draw_keep_mask(n_rows: int, rate: float, seed: int, device) -> Tensor:
    """``[n_rows]`` bool: row i is kept where a uniform draw from a
    generator seeded with ``seed`` on ``device`` falls below ``rate``."""
    check_rate(rate)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(n_rows, generator=gen, device=device) < rate


def apply_keep_mask(batch: LabeledBatch, task: str, rate: float, keep: Tensor) -> LabeledBatch:
    """The batch with its weights down-sampled by the mask ``keep`` (one
    entry per row of the batch)."""
    check_rate(rate)
    w = batch.weights
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    keep = keep.to(w.device)
    if is_binary_task(task):
        pos = batch.labels > POSITIVE_RESPONSE_THRESHOLD
        # a divisor on the device: a host scalar would turn the division
        # into a product by its reciprocal on the card
        kept = w / torch.as_tensor(rate, dtype=w.dtype, device=w.device)
        new_w = torch.where(pos, w, torch.where(keep, kept, zero))
    else:
        new_w = torch.where(keep, w, zero)
    return dataclasses.replace(batch, weights=new_w)


def local_rows(v: Tensor, share: int, group) -> Tensor:
    """This rank's rows of a whole ``[n]`` vector, zero-padded to the
    shard's ``share`` rows (``parallel.mesh.shard_batch``'s row layout)."""
    lo = group.rank * share
    part = v[lo : lo + share]
    if part.shape[0] < share:
        part = torch.cat([part, part.new_zeros(share - part.shape[0])])
    return part


def down_sample(
    batch: LabeledBatch, task: str, rate: float, seed: int = 0, n_rows: Optional[int] = None
) -> LabeledBatch:
    """The batch with down-sampled weights (the batch itself when rate >= 1).
    A rank's shard of a batch (``batch.group`` set) needs ``n_rows``, the
    whole batch's real rows: the rank draws that many and keeps its own."""
    if rate >= 1.0:
        return batch
    group = batch.group
    if group is None:
        return apply_keep_mask(batch, task, rate, draw_keep_mask(batch.n_rows, rate, seed, batch.device))
    if n_rows is None:
        raise ValueError("down-sampling a rank's shard needs n_rows, the whole batch's real rows")
    keep = local_rows(draw_keep_mask(n_rows, rate, seed, batch.device), batch.n_rows, group)
    return apply_keep_mask(batch, task, rate, keep)
