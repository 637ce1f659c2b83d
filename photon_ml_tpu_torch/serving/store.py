"""Mmap-backed GAME model store: the deployment format of a published model.

The JAX package's ``serving/store.py`` on the port. The training-side
persistence format (``io/model_io.py``) is the reference's Avro layout:
portable, but opening it parses every ``BayesianLinearModelAvro`` record.
The serving store is the same model flattened once, at publish time, into
raw binary coefficient tables plus a key-sorted ``MmapIndexMap`` per random
effect, so opening a store is a handful of ``mmap`` calls whose host memory
does not grow with the entity count.

Layout of one store (= one published snapshot)::

    store_dir/
      store-meta.json            # written LAST: its presence certifies the store
      fe-<coord>.bin             # f[d] raw fixed-effect coefficient vector
      re-<coord>-indices.bin     # i32[E, S] per-entity sorted support (-1 pad)
      re-<coord>-values.bin      # f[E, S]  per-entity coefficients
      re-<coord>-entities.bin    # MmapIndexMap: entity id -> row in [E, S]

All files land atomically (``robust.atomic``) and the meta goes last, so a
crashed publish never leaves a store that opens half-written. The files are
byte-compatible with the JAX package's stores.

Each coordinate's coefficients leave the card in one counted fetch
(``serving.store_build`` in ``photon_device_fetch_bytes_total``), in the
model's own dtype, so the tables hold the model's bits.
``ScoreEngine.from_store`` stages an opened store's tables on the device
for the resident request path.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import fetch
from ..io.index_map import MmapIndexMap
from ..robust.atomic import atomic_write, atomic_write_json
from ..robust.retry import io_call

STORE_META = "store-meta.json"
STORE_VERSION = 1


def _fe_path(store_dir: str, name: str) -> str:
    return os.path.join(store_dir, f"fe-{name}.bin")


def _re_path(store_dir: str, name: str, part: str) -> str:
    return os.path.join(store_dir, f"re-{name}-{part}.bin")


def build_store(
    model_dir: str,
    index_maps: Mapping[str, object],
    store_dir: str,
    task: Optional[str] = None,
) -> str:
    """Publish-side flatten of an Avro GAME model directory: load it (on
    the host) and write the mmap store."""
    from ..io.model_io import load_game_model

    model = load_game_model(model_dir, index_maps, task=task, device="cpu")
    return build_store_from_model(model, store_dir)


def build_store_from_model(game_model, store_dir: str) -> str:
    """Write ``game_model`` as an mmap store under ``store_dir``."""
    from ..models.game import FixedEffectModel, RandomEffectModel

    os.makedirs(store_dir, exist_ok=True)
    coords: List[dict] = []
    for name, sub in game_model.models.items():
        if isinstance(sub, FixedEffectModel):
            (w,) = fetch("serving.store_build", [sub.model.coefficients.means])
            io_call(_write_raw, _fe_path(store_dir, name), w, site="io.serving_store")
            coords.append({
                "name": name,
                "kind": "fixed",
                "shard": sub.feature_shard,
                "dim": int(w.shape[0]),
                "dtype": str(w.dtype),
            })
        elif isinstance(sub, RandomEffectModel):
            idx, val = fetch("serving.store_build", [sub.coef_indices.to(torch.int32), sub.coef_values])
            io_call(_write_raw, _re_path(store_dir, name, "indices"), idx, site="io.serving_store")
            io_call(_write_raw, _re_path(store_dir, name, "values"), val, site="io.serving_store")
            MmapIndexMap.write(
                ((str(e), row) for row, e in enumerate(sub.entity_ids)),
                _re_path(store_dir, name, "entities"),
            )
            coords.append({
                "name": name,
                "kind": "random",
                "shard": sub.feature_shard,
                "re_type": sub.random_effect_type,
                "entities": int(idx.shape[0]),
                "support": int(idx.shape[1]),
                "dtype": str(val.dtype),
            })
        else:
            raise TypeError(f"unknown sub-model type for {name}: {type(sub)}")
    # meta last: a store without it is an aborted publish, not a torn model
    io_call(
        atomic_write_json,
        os.path.join(store_dir, STORE_META),
        {"version": STORE_VERSION, "task": game_model.task, "coordinates": coords},
        indent=2,
        site="io.serving_store",
    )
    return store_dir


def _write_raw(path: str, arr: np.ndarray) -> None:
    with atomic_write(path, "wb") as f:
        f.write(np.ascontiguousarray(arr).tobytes())


@dataclasses.dataclass(frozen=True)
class FixedStoreCoord:
    """One fixed-effect coordinate: a dense mmap'd coefficient vector."""

    name: str
    feature_shard: str
    weights: np.ndarray  # memmap f[d]


@dataclasses.dataclass(frozen=True)
class RandomStoreCoord:
    """One random-effect coordinate: mmap'd [E, S] coefficient tables plus an
    entity id -> row index (a binary search over the mapped blob)."""

    name: str
    feature_shard: str
    random_effect_type: str
    coef_indices: np.ndarray  # memmap i32[E, S]
    coef_values: np.ndarray  # memmap f[E, S]
    entities: MmapIndexMap

    def rows_for(self, entity_ids: Sequence) -> np.ndarray:
        """Row per entity id, -1 for unseen (the cold-start signal)."""
        out = np.empty(len(entity_ids), dtype=np.int64)
        for i, e in enumerate(entity_ids):
            out[i] = -1 if e is None else self.entities.get_index(str(e))
        return out


class ModelStore:
    """An opened snapshot: coordinate tables as mmap views, in the model's
    coordinate order. Opening is one ``mmap`` a table, no parsing."""

    def __init__(self, store_dir: str, task: str, coords: List[object]):
        self.store_dir = store_dir
        self.task = task
        self.coords = coords

    @staticmethod
    def open(store_dir: str) -> "ModelStore":
        def _read_meta():
            with open(os.path.join(store_dir, STORE_META)) as f:
                return json.load(f)

        meta = io_call(_read_meta, site="io.serving_store")
        version = meta.get("version")
        if version != STORE_VERSION:
            raise ValueError(
                f"{store_dir}: unsupported serving store version {version!r} "
                f"(this build reads version {STORE_VERSION}; re-publish the "
                "snapshot with serving.store.build_store)"
            )

        def _open_tables() -> List[object]:
            # mmap is idempotent, so the loop retries as one io_call unit
            coords: List[object] = []
            for c in meta["coordinates"]:
                dt = np.dtype(c["dtype"])
                if c["kind"] == "fixed":
                    coords.append(FixedStoreCoord(
                        name=c["name"],
                        feature_shard=c["shard"],
                        weights=np.memmap(_fe_path(store_dir, c["name"]), dtype=dt, mode="r", shape=(c["dim"],)),
                    ))
                else:
                    shape: Tuple[int, int] = (c["entities"], c["support"])
                    coords.append(RandomStoreCoord(
                        name=c["name"],
                        feature_shard=c["shard"],
                        random_effect_type=c["re_type"],
                        coef_indices=np.memmap(
                            _re_path(store_dir, c["name"], "indices"), dtype=np.int32, mode="r", shape=shape
                        ),
                        coef_values=np.memmap(
                            _re_path(store_dir, c["name"], "values"), dtype=dt, mode="r", shape=shape
                        ),
                        entities=MmapIndexMap.open(_re_path(store_dir, c["name"], "entities")),
                    ))
            return coords

        return ModelStore(store_dir, meta["task"], io_call(_open_tables, site="io.serving_store"))


def discover_shards(model_dir: str) -> List[str]:
    """Feature shards a GAME model directory references (from the id-info
    files): what a server needs to load index maps without a training
    configuration in hand."""
    shards = set()
    for sub, line_of_shard in (("fixed-effect", 0), ("random-effect", 1)):
        base = os.path.join(model_dir, sub)
        if not os.path.isdir(base):
            continue
        for name in sorted(os.listdir(base)):
            info = os.path.join(base, name, "id-info")
            if not os.path.isfile(info):
                continue
            with open(info) as f:
                lines = [ln.strip() for ln in f.readlines()]
            if len(lines) > line_of_shard:
                shards.add(lines[line_of_shard])
    return sorted(shards)
