"""GAME model classes: fixed-effect, random-effect, and composite GAME models.

Counterpart of the JAX package's ``models/game.py``. A random-effect model
is a padded per-entity sparse matrix: ``coef_indices i32[E, S]`` (global
feature columns, sorted ascending per row, -1 padded) and ``coef_values
f[E, S]``, with the entity id -> row dict on the host. Scoring gathers the
entity's row, then dots in the entity's subspace; unseen entities score 0.

The scoring functions are torch ops. The one scatter
(``ell_row_subspace``) adds each ELL slot in turn, slot 0 first: within a
slot every row writes one position, so no two writes collide and the sum
order is fixed, with no float atomics on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.features import LabeledBatch
from .coefficients import Coefficients
from .glm import GeneralizedLinearModel

Tensor = torch.Tensor

_INT32_MAX = torch.iinfo(torch.int32).max


def ell_support_positions(
    coef_indices: Tensor,  # i32[E, S] sorted ascending per row, -1 padded
    entity_rows: Tensor,  # i32[n], -1 = unseen entity
    feat_idx: Tensor,  # i32[n, F]
) -> Tuple[Tensor, Tensor]:
    """(pos, hit): each row's ELL features mapped into its entity's sorted
    coefficient support (a batched searchsorted, the -1 padding replaced by
    a +inf sentinel so each support row stays sorted)."""
    safe_rows = torch.clamp(entity_rows, min=0).long()
    ent_idx = coef_indices[safe_rows]  # [n, S]
    ent_idx = torch.where(ent_idx < 0, _INT32_MAX, ent_idx).to(torch.int32).contiguous()
    fi = feat_idx.to(torch.int32).contiguous()
    pos = torch.clamp(torch.searchsorted(ent_idx, fi), 0, ent_idx.shape[1] - 1)
    hit = torch.gather(ent_idx, 1, pos) == fi
    return pos.to(torch.int32), hit


def ell_row_subspace(
    coef_indices: Tensor,  # i32[E, S]
    entity_rows: Tensor,  # i32[n]
    feat_idx: Tensor,  # i32[n, F]
    feat_val: Tensor,  # f[n, F]
) -> Tensor:
    """Densify each row's ELL features into its entity's subspace layout:
    x_sub[i, s] = sum of the row's feature values that land at support
    position s. Depends only on the support layout and the feature values,
    so a dataset computes it once and caches it."""
    pos, hit = ell_support_positions(coef_indices, entity_rows, feat_idx)
    n, F = feat_idx.shape
    x_sub = torch.zeros((n, coef_indices.shape[1]), dtype=feat_val.dtype, device=feat_val.device)
    rows = torch.arange(n, device=feat_val.device)
    zero = torch.zeros((), dtype=feat_val.dtype, device=feat_val.device)
    for f in range(F):
        p = pos[:, f].long()
        x_sub[rows, p] = x_sub[rows, p] + torch.where(hit[:, f], feat_val[:, f], zero)
    return x_sub


def score_entity_rows_dense(
    coef_values: Tensor,  # f[E, S]
    entity_rows: Tensor,  # i32[n], -1 = unseen entity
    x_sub: Tensor,  # f[n, S] from ell_row_subspace
) -> Tensor:
    """Score with per-row subspace features already densified: one row
    gather and an elementwise dot."""
    safe_rows = torch.clamp(entity_rows, min=0).long()
    scores = torch.sum(coef_values[safe_rows] * x_sub, dim=1)
    return torch.where(entity_rows >= 0, scores, torch.zeros_like(scores))


def score_entity_rows_dense_lanes(
    coef_values: Tensor,  # f[E, S, L] lane-stacked per-entity coefficients
    entity_rows: Tensor,  # i32[n], -1 = unseen entity
    x_sub: Tensor,  # f[n, S] from ell_row_subspace
) -> Tensor:
    """Lane-stacked :func:`score_entity_rows_dense`: ``[n, L]`` scores of L
    lambda lanes from one densified-subspace cache."""
    safe_rows = torch.clamp(entity_rows, min=0).long()
    scores = torch.sum(coef_values[safe_rows] * x_sub[:, :, None], dim=1)  # [n, L]
    return torch.where((entity_rows >= 0)[:, None], scores, torch.zeros_like(scores))


def score_entity_ell_at(
    coef_values: Tensor,  # f[E, S]
    entity_rows: Tensor,  # i32[n]
    pos: Tensor,  # i32[n, F] from ell_support_positions
    hit: Tensor,  # bool[n, F]
    feat_val: Tensor,  # f[n, F]
) -> Tensor:
    """Scoring with the searchsorted already resolved: a 2-D gather of
    coef_values at (entity row, position) pairs and a masked dot."""
    safe_rows = torch.clamp(entity_rows, min=0).long()
    w = coef_values[safe_rows[:, None], pos.long()]  # [n, F]
    prod = torch.where(hit, w * feat_val, torch.zeros((), dtype=w.dtype, device=w.device))
    scores = torch.sum(prod, dim=1)
    return torch.where(entity_rows >= 0, scores, torch.zeros_like(scores))


def score_entity_ell(
    coef_indices: Tensor,
    coef_values: Tensor,
    entity_rows: Tensor,
    feat_idx: Tensor,
    feat_val: Tensor,
) -> Tensor:
    """Per-row dot product against per-entity sparse coefficient vectors."""
    pos, hit = ell_support_positions(coef_indices, entity_rows, feat_idx)
    return score_entity_ell_at(coef_values, entity_rows, pos, hit, feat_val)


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """One GLM applied to every sample's features from one feature shard."""

    model: GeneralizedLinearModel
    feature_shard: str

    @property
    def coefficients(self) -> Coefficients:
        return self.model.coefficients

    def score(self, batch: LabeledBatch) -> Tensor:
        """Margins without the batch offset: coordinate scores compose by
        summation, offsets are added once by the consumer."""
        return batch.features.matvec(self.model.coefficients.means)


@dataclasses.dataclass
class RandomEffectModel:
    """Per-entity GLMs for one random-effect type over one feature shard."""

    random_effect_type: str  # id-tag column, e.g. "userId"
    feature_shard: str
    task: str
    entity_ids: np.ndarray  # object[E] host-side ids (row order of the arrays)
    coef_indices: Tensor  # i32[E, S] global feature indices, -1 padded
    coef_values: Tensor  # f[E, S]
    variances: Optional[Tensor] = None  # f[E, S] if computed
    _id_to_row: Optional[Dict[str, int]] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self._id_to_row is None:
            self._id_to_row = {str(e): i for i, e in enumerate(self.entity_ids)}

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    def entity_row(self, entity_id: str) -> int:
        """Row index for an entity, -1 if unseen."""
        return self._id_to_row.get(str(entity_id), -1)

    def rows_for(self, entity_ids: Sequence) -> np.ndarray:
        return np.asarray([self.entity_row(e) for e in entity_ids], dtype=np.int64)

    def dense_coefficients(self, dim: int) -> np.ndarray:
        """Materialize [E, dim] dense coefficients (small models / tests)."""
        out = np.zeros((self.num_entities, dim))
        idx = self.coef_indices.cpu().numpy()
        val = self.coef_values.double().cpu().numpy()
        for e in range(self.num_entities):
            m = idx[e] >= 0
            out[e, idx[e][m]] = val[e][m]
        return out

    def score_ell_rows(self, entity_rows: Tensor, feat_idx: Tensor, feat_val: Tensor) -> Tensor:
        """Score rows in ELL layout: row i has features (feat_idx[i],
        feat_val[i]) and entity row entity_rows[i] (-1 => unseen => 0)."""
        return score_entity_ell(self.coef_indices, self.coef_values, entity_rows, feat_idx, feat_val)


@dataclasses.dataclass
class GameModel:
    """coordinateId -> model; total score = sum of coordinate scores."""

    models: Dict[str, object]  # FixedEffectModel | RandomEffectModel
    task: str = "logistic_regression"

    def __getitem__(self, name: str):
        return self.models[name]

    def __contains__(self, name: str) -> bool:
        return name in self.models

    def coordinates(self) -> List[str]:
        return list(self.models)

    def updated(self, name: str, model) -> "GameModel":
        new = dict(self.models)
        new[name] = model
        return GameModel(models=new, task=self.task)
