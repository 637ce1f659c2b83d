"""The host-side columnar dataset that GAME datasets are built from.

Counterpart of the JAX package's ``io/data.py``, of which only
``RawDataset`` (its fields, ``subset`` and ``to_batch``) is copied here:
numpy COO per feature shard plus labels, offsets, weights, uids and id
tags, in a sample order fixed at read time. The Avro and LIBSVM readers are
ROADMAP A5; the mesh-tiled sparse layout (``layout="tiled"``) is A10.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike


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

    def to_batch(
        self,
        shard: str,
        dtype=torch.float32,
        layout: str = "auto",
        feature_dtype=None,
        device: DeviceLike = None,
    ):
        """Build a ``LabeledBatch`` of one feature shard on ``device`` (the
        card unless asked otherwise).

        layout: 'auto' (dense when d <= 4096, else ELL) | 'dense' | 'ell'
        (alias 'sparse': row-major padded sparse, moderate d) | 'coo'
        (column-sorted COO, huge d). ``feature_dtype`` (e.g. bfloat16) stores
        only the feature values narrower; labels, offsets and weights stay
        ``dtype``."""
        from ..ops.features import batch_from_coo, batch_from_dense

        rows, cols, vals = self.shard_coo[shard]
        d = self.shard_dims[shard]
        if layout == "auto":
            layout = "dense" if d <= 4096 else "ell"
        if layout == "dense":
            x = np.zeros((self.n_rows, d), dtype=np.float64)
            x[rows, cols] = vals
            return batch_from_dense(
                x, self.labels, self.offsets, self.weights, dtype=dtype,
                feature_dtype=feature_dtype, device=device,
            )
        if layout in ("ell", "sparse", "coo"):
            return batch_from_coo(
                rows, cols, vals, self.labels, d, self.offsets, self.weights, dtype=dtype,
                layout="coo" if layout == "coo" else "ell", feature_dtype=feature_dtype, device=device,
            )
        if layout == "tiled":
            raise NotImplementedError(
                "layout='tiled' (the (data x model)-mesh-tiled sparse batch) is not ported yet (ROADMAP A10)"
            )
        raise ValueError(f"unknown batch layout {layout!r}: expected auto|dense|ell|sparse|coo|tiled")
