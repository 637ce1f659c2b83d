"""The one GLMix score assembly, shared by batch scoring (``cli.score`` and
``GameTransformer.transform``) and the resident request path
(``serving.server``): the JAX package's ``serving/engine.py`` on the port.

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

The resident request path (``from_store``, ``score_requests``, ``warm``)
stages a published store's coefficient tables on the device once and pads
every request batch to a small ladder of (rows, feature-width) shapes, the
JAX package's ladder, so that a request batch is a handful of launches of
known shapes. Unseen entities fall back to the fixed effect and count in
``photon_serving_cold_start_total{coordinate=}``. ``warm`` loads S1's
library (``ops/cuda_lib.py`` builds it with nvcc at first use) and scores
the smallest rung before traffic, so no request pays for a build.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..analysis.runtime import logged_fetch
from ..device import DeviceLike, pin_device
from ..models.game import FixedEffectModel, RandomEffectModel, score_entity_ell
from ..ops.sparse import Segments, row_segments, segment_dot, segment_dot_plain

Tensor = torch.Tensor

# Padding ladders for the resident request path. Rows round up to the next
# rung (bigger batches chunk at the top rung); the per-shard ELL feature
# width rounds up likewise: at most len(LADDER_ROWS) * len(LADDER_WIDTH)
# batch shapes per shard.
LADDER_ROWS: Tuple[int, ...] = (1, 8, 64, 256, 1024, 4096, 16384)
LADDER_WIDTH: Tuple[int, ...] = (4, 16, 64, 256, 512)


def _ladder_rows(n: int) -> int:
    for rung in LADDER_ROWS:
        if n <= rung:
            return rung
    return LADDER_ROWS[-1]


def _ladder_width(f: int) -> int:
    for rung in LADDER_WIDTH:
        if f <= rung:
            return rung
    raise ValueError(
        f"request feature width {f} exceeds the serving engine's padded "
        f"feature-width ladder (max {LADDER_WIDTH[-1]} features per row per "
        "shard); score such rows through the batch path (cli.score)"
    )


@dataclasses.dataclass(frozen=True)
class ScoreRequest:
    """One scoring request: per-shard sparse features (already through the
    feature index map) plus the entity id per random-effect type.

    ``model`` routes the request in a multi-model fleet (``serving.fleet``):
    the name of the resident model to score against, or None for the
    server's default model. The engine itself ignores it."""

    features: Mapping[str, Tuple[Sequence[int], Sequence[float]]]
    ids: Mapping[str, object] = dataclasses.field(default_factory=dict)
    offset: float = 0.0
    model: Optional[str] = None


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
        # pinned, so that a batcher's worker thread can select it
        self.device = pin_device(device)
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
    def from_store(cls, store, dtype=torch.float32, device: DeviceLike = None,
                   plain: bool = False) -> "ScoreEngine":
        """Engine over an opened mmap ModelStore (the resident entry), on
        ``device`` (the card if None). The coefficient tables are staged to
        the device once here, in ``dtype``; entity-row lookups stay on the
        store's mmap index. The store's arrays are read-only maps, so each
        is copied before it becomes a tensor."""
        from .store import FixedStoreCoord, RandomStoreCoord

        dev = pin_device(device)

        def stage(arr: np.ndarray, dt: Optional[torch.dtype] = None) -> Tensor:
            t = torch.from_numpy(np.array(arr))
            return t.to(device=dev, dtype=dt or t.dtype)

        coords: List[object] = []
        for c in store.coords:
            if isinstance(c, FixedStoreCoord):
                coords.append(_FixedCoord(c.name, c.feature_shard, stage(c.weights, dtype)))
            elif isinstance(c, RandomStoreCoord):
                coords.append(_RandomCoord(
                    c.name, c.feature_shard, c.random_effect_type, stage(c.coef_indices),
                    stage(c.coef_values, dtype), c.rows_for,
                ))
            else:
                raise TypeError(f"unknown store coordinate type: {type(c)}")
        return cls(coords, store.task, dtype=dtype, device=dev, plain=plain)

    # -- introspection -------------------------------------------------------

    @property
    def random_effect_types(self) -> List[str]:
        return [c.random_effect_type for c in self._coords if isinstance(c, _RandomCoord)]

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
        return self.fetch_scores(offsets, self.device_margins(shard_ell, entity_rows))

    def device_margins(
        self,
        shard_ell: Mapping[str, Tuple[np.ndarray, np.ndarray]],
        entity_rows: Mapping[str, np.ndarray],
    ) -> List[Tuple[str, Tensor]]:
        """The device half of ``score_ell``: upload the rows and launch each
        coordinate's margins, left on the device as ``(name, margins)``."""
        rows: Dict[str, EllRows] = {}
        margins: List[Tuple[str, Tensor]] = []
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
            margins.append((c.name, margin))
        return margins

    @staticmethod
    def fetch_scores(offsets: np.ndarray, margins: Sequence[Tuple[str, Tensor]]) -> np.ndarray:
        """The host half of ``score_ell``: fetch each coordinate's margins
        (one counted fetch each) and sum them onto the offsets in float64."""
        total = np.array(offsets, dtype=np.float64)
        for name, margin in margins:
            total += logged_fetch(f"serving.score.{name}", margin).astype(np.float64)
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

    # -- resident request path ----------------------------------------------

    def score_requests(self, requests: Sequence[ScoreRequest], count_cold: bool = True) -> np.ndarray:
        """Score a microbatch of requests at the ladder's shapes; unseen
        entities fall back to the fixed effect and count in
        ``photon_serving_cold_start_total{coordinate=}`` (``count_cold=False``
        for synthetic warm-up traffic that must not pollute the metric)."""
        n = len(requests)
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        top = LADDER_ROWS[-1]
        if n > top:
            return np.concatenate(
                [self.score_requests(requests[i : i + top], count_cold) for i in range(0, n, top)]
            )
        return self.score_ell(*self.assemble(requests, count_cold))[:n]

    def assemble(self, requests: Sequence[ScoreRequest], count_cold: bool = True):
        """The host half of ``score_requests`` for at most one top rung of
        requests: ``(offsets, shard_ell, entity_rows)`` padded to the
        ladder, for ``score_ell``; counts the cold starts."""
        n = len(requests)
        pad_n = _ladder_rows(n)
        shard_ell: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for shard in self.feature_shards:
            feats = [r.features.get(shard, ((), ())) for r in requests]
            width = _ladder_width(max((len(f[0]) for f in feats), default=1))
            idx = np.zeros((pad_n, width), dtype=np.int32)
            val = np.zeros((pad_n, width), dtype=np.float64)
            for i, (fi, fv) in enumerate(feats):
                k = len(fi)
                idx[i, :k] = fi
                val[i, :k] = fv
            shard_ell[shard] = (idx, val)

        entity_rows: Dict[str, np.ndarray] = {}
        cold = obs.current_run().registry.counter(
            "photon_serving_cold_start_total",
            "requests scored fixed-effect-only because the entity was unseen",
        )
        for c in self._coords:
            if not isinstance(c, _RandomCoord):
                continue
            rows = c.rows_for([r.ids.get(c.random_effect_type) for r in requests])
            n_cold = int(np.count_nonzero(rows < 0))
            if n_cold and count_cold:
                cold.labels(coordinate=c.name).inc(n_cold)
            erow = np.full(pad_n, -1, dtype=np.int32)
            erow[:n] = rows.astype(np.int32)
            entity_rows[c.name] = erow

        offsets = np.zeros(pad_n, dtype=np.float64)
        offsets[:n] = [r.offset for r in requests]
        return offsets, shard_ell, entity_rows

    def warm(self) -> None:
        """Score the ladder's smallest shapes ahead of traffic: on the card
        this loads (and, on a fresh checkout, builds) S1's library."""
        req = ScoreRequest(features={s: ((0,), (0.0,)) for s in self.feature_shards})
        self.score_requests([req], count_cold=False)
