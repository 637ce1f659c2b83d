"""The GLMix score assembly of batch scoring (``cli.score`` and
``GameTransformer.transform``): the JAX package's ``serving/engine.py``,
its batch part.

Scoring semantics are the reference's (GameTransformer.scala:39-318): total
score = offsets + sum of per-coordinate margins, fixed effects as a dot
against one coefficient vector, random effects as a per-entity sparse dot
with unseen entities contributing 0.

Rows are in ELL layout (``idx=0, val=0`` padding). A fixed effect's margins
are one gather-dot over those rows: on the card one launch of S1's ELL
matvec (``ops/sparse.py``, counted in ``SPARSE_LAUNCHES["ell_matvec"]``),
the JAX package's ``_fe_score_ell``; on the CPU, with ``plain=True`` or
with float64 coefficients, its plain version. A random effect's margins are
``models.game.score_entity_ell``. Each coordinate's margins cross to the
host in one counted fetch and add into a float64 host sum in coordinate
order, as the reference does.

The resident request path (``from_store``, ``score_requests``, ``warm``
and the padding ladders) is ROADMAP A9.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from ..models.game import FixedEffectModel, RandomEffectModel, score_entity_ell
from ..ops.sparse import Segments, row_segments, segment_dot, segment_dot_plain

Tensor = torch.Tensor

_RESIDENT_TODO = "the resident request path of the serving engine is not ported yet (ROADMAP A9)"


class EllRows:
    """Rows in ELL layout on a device (``idx`` int32 ``[n, F]``, ``val``
    ``[n, F]``) with S1's row segments built once, so that every fixed
    effect's margins over them are one ``ell_matvec``."""

    def __init__(self, idx: np.ndarray, val: np.ndarray, dtype: torch.dtype, device: torch.device):
        n, width = idx.shape
        self.n_rows = n
        self.idx = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(device)
        # narrowed on the host, so the upload moves the narrow bytes
        self.val = torch.from_numpy(np.ascontiguousarray(val)).to(dtype).to(device)
        self.segments: Segments = row_segments(
            np.full(n, width), self.idx.reshape(-1), self.val.reshape(-1), uniform=True,
        )

    def margins(self, weights: Tensor, plain: bool = False) -> Tensor:
        """``sum_f val[i, f] * weights[idx[i, f]]`` per row, in the wider of
        the two dtypes: S1 on the card for float32 weights, else the plain
        version (a float64 dot, as float64 batches solve on the card)."""
        w = weights.to(device=self.val.device).contiguous()
        if plain or w.dtype != torch.float32:
            out = segment_dot_plain(self.segments, self.n_rows, w)
        else:
            out = segment_dot("ell_matvec", self.segments, self.n_rows, w)
        return out.to(torch.promote_types(w.dtype, self.val.dtype))


@dataclasses.dataclass(frozen=True)
class _FixedCoord:
    name: str
    feature_shard: str
    weights: Tensor  # f[d]


@dataclasses.dataclass(frozen=True)
class _RandomCoord:
    name: str
    feature_shard: str
    random_effect_type: str
    coef_indices: Tensor  # i32[E, S]
    coef_values: Tensor  # f[E, S]
    rows_for: object  # callable ids -> np.int64[n], -1 unseen


class ScoreEngine:
    """Score assembly over one model's coordinate tables on one device."""

    def __init__(self, coords: List[object], task: str, dtype=torch.float32,
                 device: DeviceLike = None, plain: bool = False):
        """``plain=True`` scores the fixed effects through S1's plain
        version on the card: the reference route to hold the kernel's
        scores against."""
        self._coords = coords
        self.task = task
        self.dtype = dtype
        self.device = resolve_device(device)
        self.plain = plain

    # -- construction --------------------------------------------------------

    @classmethod
    def from_model(cls, game_model, dtype=torch.float32, device: DeviceLike = None,
                   plain: bool = False) -> "ScoreEngine":
        """Engine over an in-memory GameModel (the batch-scoring entry), on
        ``device`` (the device of the model's first coefficients if None)."""
        coords: List[object] = []
        for name, sub in game_model.models.items():
            if isinstance(sub, FixedEffectModel):
                coords.append(_FixedCoord(name, sub.feature_shard, sub.model.coefficients.means))
            elif isinstance(sub, RandomEffectModel):
                coords.append(_RandomCoord(
                    name, sub.feature_shard, sub.random_effect_type, sub.coef_indices,
                    sub.coef_values, sub.rows_for,
                ))
            else:
                raise TypeError(f"unknown model type for {name}: {type(sub)}")
        if device is None and coords:
            first = coords[0]
            device = (first.weights if isinstance(first, _FixedCoord) else first.coef_values).device
        return cls(coords, game_model.task, dtype=dtype, device=device, plain=plain)

    @classmethod
    def from_store(cls, *args, **kwargs):
        raise NotImplementedError(_RESIDENT_TODO)

    def score_requests(self, *args, **kwargs):
        raise NotImplementedError(_RESIDENT_TODO)

    def warm(self, *args, **kwargs):
        raise NotImplementedError(_RESIDENT_TODO)

    # -- introspection -------------------------------------------------------

    @property
    def feature_shards(self) -> List[str]:
        seen: Dict[str, None] = {}
        for c in self._coords:
            seen.setdefault(c.feature_shard, None)
        return list(seen)

    # -- the shared assembly -------------------------------------------------

    def score_ell(
        self,
        offsets: np.ndarray,
        shard_ell: Mapping[str, Tuple[np.ndarray, np.ndarray]],
        entity_rows: Mapping[str, np.ndarray],
    ) -> np.ndarray:
        """Sum per-coordinate margins over rows already in ELL layout.

        ``shard_ell`` maps feature shard -> (idx i32[n, F], val f[n, F]) with
        idx=0/val=0 padding; ``entity_rows`` maps random-effect coordinate
        name -> i32[n] entity rows (-1 = unseen -> contributes 0). Scores
        accumulate in float64 on the host, one counted fetch per coordinate.
        """
        total = np.array(offsets, dtype=np.float64)
        rows: Dict[str, EllRows] = {}
        for c in self._coords:
            ell = rows.get(c.feature_shard)
            if ell is None:
                ell = rows[c.feature_shard] = EllRows(*shard_ell[c.feature_shard], self.dtype, self.device)
            if isinstance(c, _FixedCoord):
                margin = ell.margins(c.weights.to(self.dtype), plain=self.plain)
            else:
                margin = score_entity_ell(
                    c.coef_indices.to(self.device),
                    c.coef_values.to(device=self.device, dtype=self.dtype),
                    torch.as_tensor(np.asarray(entity_rows[c.name], dtype=np.int32), device=self.device),
                    ell.idx,
                    ell.val,
                )
            host = margin.detach().cpu()
            obs.add_device_fetch_bytes(f"serving.score.{c.name}", host.numel() * host.element_size())
            total += host.double().numpy()
        return total

    # -- batch path (cli.score / GameTransformer) ----------------------------

    def score_dataset(self, raw) -> np.ndarray:
        """Score a RawDataset: the batch-mode entry (GameScoringDriver role)."""
        from ..game.data import _rows_to_ell

        shard_ell: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for shard in self.feature_shards:
            r, c, v = raw.shard_coo[shard]
            shard_ell[shard] = _rows_to_ell(r, c, v, raw.n_rows)
        entity_rows: Dict[str, np.ndarray] = {}
        for c in self._coords:
            if isinstance(c, _RandomCoord):
                entity_rows[c.name] = c.rows_for(raw.id_tags[c.random_effect_type]).astype(np.int32)
        return self.score_ell(raw.offsets, shard_ell, entity_rows)
