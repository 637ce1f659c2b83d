"""Deterministic synthetic data generators for tests and benchmarks.

The role of the reference's photon-test-utils
(SparkTestUtils.scala:84-180 "numerically benign" generators + GameTestUtils):
seeded, well-conditioned GLM / GLMix datasets with controllable entity skew.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


def generate_glm_data(
    task: str = "logistic_regression",
    n: int = 1000,
    d: int = 20,
    seed: int = 0,
    noise: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (x[n,d] with intercept column last, y[n], w_true[d])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    w = rng.normal(size=d) / np.sqrt(d)
    z = x @ w
    if task == "logistic_regression" or task == "smoothed_hinge_loss_linear_svm":
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z / max(noise, 1e-6)))).astype(float)
    elif task == "linear_regression":
        y = z + noise * rng.normal(size=n)
    elif task == "poisson_regression":
        y = rng.poisson(np.exp(np.clip(z, -4, 4))).astype(float)
    else:
        raise ValueError(task)
    return x, y, w


@dataclasses.dataclass
class MixedEffectData:
    """Synthetic GLMix data: global fixed effect + per-entity random effects."""

    n: int
    labels: np.ndarray
    global_x: np.ndarray  # [n, d_fixed]
    entity_x: Dict[str, np.ndarray]  # re_type -> [n, d_re]
    entity_ids: Dict[str, np.ndarray]  # re_type -> object[n]
    w_fixed: np.ndarray
    w_entities: Dict[str, Dict[str, np.ndarray]]  # re_type -> entity -> w


def generate_mixed_effect_data(
    task: str = "logistic_regression",
    n: int = 2000,
    d_fixed: int = 10,
    re_specs: Optional[Dict[str, Tuple[int, int]]] = None,  # type -> (n_entities, d_re)
    seed: int = 0,
    entity_skew: float = 1.0,  # zipf-ish skew of rows per entity
    noise: float = 0.5,
) -> MixedEffectData:
    rng = np.random.default_rng(seed)
    re_specs = re_specs or {"userId": (50, 5)}

    gx = rng.normal(size=(n, d_fixed))
    gx[:, -1] = 1.0
    w_fixed = rng.normal(size=d_fixed) / np.sqrt(d_fixed)
    z = gx @ w_fixed

    entity_x: Dict[str, np.ndarray] = {}
    entity_ids: Dict[str, np.ndarray] = {}
    w_entities: Dict[str, Dict[str, np.ndarray]] = {}
    for re_type, (n_ent, d_re) in re_specs.items():
        # skewed entity assignment (entity sizes follow a power law for
        # realistic bin-packing / active-set behavior)
        probs = (1.0 / np.arange(1, n_ent + 1) ** entity_skew)
        probs /= probs.sum()
        assign = rng.choice(n_ent, size=n, p=probs)
        ex = rng.normal(size=(n, d_re))
        ex[:, -1] = 1.0
        ws = {f"e{k}": rng.normal(size=d_re) / np.sqrt(d_re) for k in range(n_ent)}
        w_mat = np.stack([ws[f"e{k}"] for k in range(n_ent)])
        z = z + np.einsum("nd,nd->n", ex, w_mat[assign])
        entity_x[re_type] = ex
        entity_ids[re_type] = np.asarray([f"e{k}" for k in assign], dtype=object)
        w_entities[re_type] = ws

    if task == "logistic_regression":
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    elif task == "linear_regression":
        y = z + noise * rng.normal(size=n)
    elif task == "poisson_regression":
        y = rng.poisson(np.exp(np.clip(z, -4, 4))).astype(float)
    else:
        raise ValueError(task)

    return MixedEffectData(
        n=n,
        labels=y,
        global_x=gx,
        entity_x=entity_x,
        entity_ids=entity_ids,
        w_fixed=w_fixed,
        w_entities=w_entities,
    )


def generate_game_records(data: MixedEffectData) -> List[dict]:
    """MixedEffectData -> Avro-style records (TrainingExampleAvro shape with
    per-random-effect feature bags and id columns in metadataMap)."""
    recs = []
    for i in range(data.n):
        rec = {
            "uid": str(i),
            "label": float(data.labels[i]),
            "features": [
                {"name": f"g{j}", "term": "", "value": float(v)}
                for j, v in enumerate(data.global_x[i])
                if v != 0.0
            ],
            "metadataMap": {},
            "weight": 1.0,
            "offset": 0.0,
        }
        for re_type, ex in data.entity_x.items():
            bag = re_type.replace("Id", "") + "Features"
            rec[bag] = [
                {"name": f"{re_type[0]}{j}", "term": "", "value": float(v)}
                for j, v in enumerate(ex[i])
                if v != 0.0
            ]
            rec["metadataMap"][re_type] = str(data.entity_ids[re_type][i])
        recs.append(rec)
    return recs


def mixed_data_to_raw_dataset(data: MixedEffectData):
    """Build a RawDataset directly (no Avro round trip) with one shard per
    effect: 'global' + one per random-effect type."""
    from ..io.data import RawDataset

    n = data.n
    shard_coo = {}
    shard_dims = {}
    gx = data.global_x
    rows, cols = np.nonzero(gx)
    shard_coo["global"] = (rows, cols, gx[rows, cols])
    shard_dims["global"] = gx.shape[1]
    for re_type, ex in data.entity_x.items():
        shard = re_type.replace("Id", "") + "Shard"
        rows, cols = np.nonzero(ex)
        shard_coo[shard] = (rows, cols, ex[rows, cols])
        shard_dims[shard] = ex.shape[1]
    return RawDataset(
        n_rows=n,
        labels=data.labels.astype(np.float64),
        offsets=np.zeros(n),
        weights=np.ones(n),
        shard_coo=shard_coo,
        shard_dims=shard_dims,
        id_tags={t: v for t, v in data.entity_ids.items()},
        uids=np.asarray([str(i) for i in range(n)], dtype=object),
    )
