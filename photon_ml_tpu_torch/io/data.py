"""The host-side columnar dataset that GAME datasets are built from.

Counterpart of the JAX package's ``io/data.py``, of which only
``RawDataset`` (its fields and ``subset``) is copied here: numpy COO per
feature shard plus labels, offsets, weights, uids and id tags, in a sample
order fixed at read time. The Avro and LIBSVM readers are ROADMAP A5.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RawDataset:
    """Columnar host dataset: everything needed to build device batches."""

    n_rows: int
    labels: np.ndarray  # f8[n]
    offsets: np.ndarray  # f8[n]
    weights: np.ndarray  # f8[n]
    shard_coo: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]  # shard -> (rows, cols, vals)
    shard_dims: Dict[str, int]
    id_tags: Dict[str, np.ndarray]  # tag -> object array of per-row ids
    uids: Optional[np.ndarray] = None

    def subset(self, rows: np.ndarray) -> "RawDataset":
        """Row-subset view (train/validation splits; host-side)."""
        rows = np.asarray(rows)
        old_to_new = np.full(self.n_rows, -1, dtype=np.int64)
        old_to_new[rows] = np.arange(len(rows))
        new_coo = {}
        for s, (r, c, v) in self.shard_coo.items():
            keep = old_to_new[r] >= 0
            new_coo[s] = (old_to_new[r[keep]], c[keep], v[keep])
        return RawDataset(
            n_rows=len(rows),
            labels=self.labels[rows],
            offsets=self.offsets[rows],
            weights=self.weights[rows],
            shard_coo=new_coo,
            shard_dims=dict(self.shard_dims),
            id_tags={t: v[rows] for t, v in self.id_tags.items()},
            uids=None if self.uids is None else self.uids[rows],
        )
