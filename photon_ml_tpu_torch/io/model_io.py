"""GAME / GLM model persistence in the reference's on-disk layout.

Reference: photon-client .../data/avro/ModelProcessingUtils.scala:77-625.
Layout (verified against the reference's checked-in fixture models):

    modelDir/
      model-metadata.json
      fixed-effect/<coordinateId>/
        id-info                      # line 1: feature shard id
        coefficients/part-00000.avro # one BayesianLinearModelAvro record
      random-effect/<coordinateId>/
        id-info                      # line 1: random-effect type (id tag)
                                     # line 2: feature shard id
        coefficients/part-*.avro     # one record per entity (modelId = entity)

Coefficients serialize as (name, term, value) triples through the shard's
IndexMap, so models interoperate with Photon ML deployments and with the JAX
package, whose ``io/model_io.py`` this copies. Loaded models land on
``device`` (the card unless the caller asks for the CPU) in ``dtype``
(float32 unless asked otherwise); a float32 model saved and loaded keeps
its bits, since the records hold doubles.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

from ..models.coefficients import Coefficients
from ..models.game import FixedEffectModel, GameModel, RandomEffectModel
from ..models.glm import GeneralizedLinearModel, model_for_task
from ..robust.atomic import atomic_write, atomic_write_json
from ..robust.retry import io_call
from .avro import iter_avro_directory, write_avro_file
from .index_map import IndexMap, feature_key, split_feature_key
from .schemas import BAYESIAN_LINEAR_MODEL_AVRO

# Interop class names (reference: photon-api .../supervised/**)
_MODEL_CLASS_NAMES = {
    "logistic_regression": "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    "linear_regression": "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    "poisson_regression": "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    "smoothed_hinge_loss_linear_svm": "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}
_CLASS_NAME_TO_TASK = {v: k for k, v in _MODEL_CLASS_NAMES.items()}


def _coefficients_to_record(
    model_id: str,
    means: np.ndarray,
    variances: Optional[np.ndarray],
    index_map: IndexMap,
    task: str,
    sparsity_threshold: float = 0.0,
) -> dict:
    def triples(vec):
        out = []
        for i in np.nonzero(np.abs(vec) > sparsity_threshold)[0]:
            key = index_map.get_feature_name(int(i))
            if key is None:
                continue
            name, term = split_feature_key(key)
            out.append({"name": name, "term": term, "value": float(vec[i])})
        return out

    rec = {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS_NAMES.get(task),
        "means": triples(means),
        "variances": None if variances is None else triples(variances),
        "lossFunction": None,
    }
    return rec


def _record_to_vector(rec_items, index_map: IndexMap, dim: int) -> np.ndarray:
    vec = np.zeros(dim)
    for t in rec_items:
        key = feature_key(t["name"], t["term"])
        idx = index_map.get_index(key)
        if idx >= 0:
            vec[idx] = t["value"]
    return vec


def save_glm(
    path: str,
    model: GeneralizedLinearModel,
    index_map: IndexMap,
    model_id: str = "",
    sparsity_threshold: float = 0.0,
):
    """Write a single GLM as one BayesianLinearModelAvro record file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    coef = model.coefficients
    rec = _coefficients_to_record(
        model_id,
        _host(coef.means),
        None if coef.variances is None else _host(coef.variances),
        index_map,
        type(model).task,
        sparsity_threshold,
    )
    write_avro_file(path, BAYESIAN_LINEAR_MODEL_AVRO, [rec])


def _host(t) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_glm(
    path: str,
    index_map: IndexMap,
    task: Optional[str] = None,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
):
    """The one GLM of a BayesianLinearModelAvro file (or directory), its
    coefficients ``dtype`` on ``device``."""
    recs = list(iter_avro_directory(path))
    if len(recs) != 1:
        raise ValueError(f"{path}: expected 1 model record, found {len(recs)}")
    rec = recs[0]
    task = task or _CLASS_NAME_TO_TASK.get(rec.get("modelClass") or "", "linear_regression")
    dim = len(index_map)
    means = _record_to_vector(rec["means"], index_map, dim)
    variances = (
        _record_to_vector(rec["variances"], index_map, dim)
        if rec.get("variances")
        else None
    )
    dev = resolve_device(device)
    coef = Coefficients(
        means=torch.as_tensor(means, dtype=dtype, device=dev),
        variances=None if variances is None else torch.as_tensor(variances, dtype=dtype, device=dev),
    )
    return model_for_task(task, coef)


def index_fingerprint(index_maps: Mapping[str, IndexMap]) -> dict:
    """Per-shard digests of the (feature key -> index) bijection, stamped
    into ``model-metadata.json`` at save time. ``keys`` digests the key SET
    (order-independent) — two indices with equal ``keys`` but different
    ``layout`` hold the same features at permuted positions, which the
    (name, term)-keyed load remaps losslessly. A ``layout`` match means the
    index is bitwise-identical, so warm-start priors align with no scan."""
    shards = {}
    for shard in sorted(index_maps):
        imap = index_maps[shard]
        h_keys = hashlib.sha256()
        h_layout = hashlib.sha256()
        for key, idx in sorted(imap.items()):
            kb = key.encode("utf-8")
            h_keys.update(kb)
            h_keys.update(b"\x00")
            h_layout.update(kb)
            h_layout.update(f":{idx}\x00".encode("utf-8"))
        shards[shard] = {
            "size": len(imap),
            "keys": h_keys.hexdigest(),
            "layout": h_layout.hexdigest(),
        }
    return {"version": 1, "shards": shards}


def _iter_model_coefficient_dirs(model_dir: str):
    """Yield (coordinate, feature_shard, coefficients_dir) for every
    sub-model in the reference layout."""
    for kind in ("fixed-effect", "random-effect"):
        root = os.path.join(model_dir, kind)
        if not os.path.isdir(root):
            continue
        for name in sorted(os.listdir(root)):
            base = os.path.join(root, name)
            if not os.path.isdir(base):
                continue
            with open(os.path.join(base, "id-info")) as f:
                first = f.readline().strip()
                shard = f.readline().strip() if kind == "random-effect" else first
            yield name, shard, os.path.join(base, "coefficients")


def check_prior_compatibility(
    model_dir: str, index_maps: Mapping[str, IndexMap]
) -> Dict[str, str]:
    """Verify a warm-start prior's feature space against the current index
    before ``--incremental-training`` loads it.

    Returns ``{shard: "exact" | "remap"}``. ``exact``: the stored
    fingerprint matches the current index bitwise. ``remap``: the indices
    differ but every prior feature exists under the current index, so the
    (name, term)-keyed load relocates each coefficient correctly. Any prior
    feature MISSING from the current index is refused with a typed error —
    ``load_game_model`` would silently drop those coefficients, mis-centering
    the prior instead of failing."""
    meta_path = os.path.join(model_dir, "model-metadata.json")
    stored = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            stored = (json.load(f).get("featureIndexFingerprint") or {}).get(
                "shards", {}
            )
    current = index_fingerprint(index_maps)["shards"]

    verdict: Dict[str, str] = {}
    scan_shards = set()
    for name, shard, coef_dir in _iter_model_coefficient_dirs(model_dir):
        if shard in verdict or shard in scan_shards:
            continue
        if shard not in index_maps:
            raise ValueError(
                "--incremental-training refused: prior model features absent "
                f"from the current feature index (shard {shard!r} of "
                f"{model_dir} has no current index at all); rebuild the "
                "feature index to cover the prior model"
            )
        got, want = stored.get(shard), current.get(shard)
        if got and want and got.get("layout") == want.get("layout"):
            verdict[shard] = "exact"
        elif got and want and got.get("keys") == want.get("keys"):
            verdict[shard] = "remap"
        else:
            scan_shards.add(shard)

    # no (or mismatched) fingerprint: scan the coefficient triples themselves
    for name, shard, coef_dir in _iter_model_coefficient_dirs(model_dir):
        if shard not in scan_shards:
            continue
        imap = index_maps[shard]
        missing = 0
        example = None
        for rec in iter_avro_directory(coef_dir):
            for part in ("means", "variances"):
                for t in rec.get(part) or ():
                    key = feature_key(t["name"], t["term"])
                    if key not in imap:
                        missing += 1
                        example = example or key
        if missing:
            raise ValueError(
                "--incremental-training refused: prior model features absent "
                f"from the current feature index ({missing} coefficient(s) of "
                f"shard {shard!r}, e.g. {example!r}); a silent load would "
                "mis-align the warm-start priors — rebuild the feature index "
                "to cover the prior model"
            )
        verdict[shard] = "remap"
        scan_shards.discard(shard)
    return verdict


def save_game_model(
    model_dir: str,
    game_model: GameModel,
    index_maps: Mapping[str, IndexMap],
    metadata: Optional[dict] = None,
    sparsity_threshold: float = 0.0,
    records_per_file: int = 100_000,
):
    os.makedirs(model_dir, exist_ok=True)
    meta = {
        "modelType": game_model.task.upper(),
        "featureIndexFingerprint": index_fingerprint(index_maps),
        **(metadata or {}),
    }
    # every file in the layout lands atomically (temp+fsync+rename,
    # robust.atomic) and retries transient failures at site io.model_save: a
    # crashed/flaky save never leaves a torn file a later load half-reads
    io_call(
        atomic_write_json,
        os.path.join(model_dir, "model-metadata.json"),
        meta, indent=2,
        site="io.model_save",
    )

    def _write_id_info(path, text):
        with atomic_write(path, "w") as f:
            f.write(text)

    for name, sub in game_model.models.items():
        if isinstance(sub, FixedEffectModel):
            base = os.path.join(model_dir, "fixed-effect", name)
            os.makedirs(os.path.join(base, "coefficients"), exist_ok=True)
            io_call(
                _write_id_info, os.path.join(base, "id-info"),
                sub.feature_shard + "\n", site="io.model_save",
            )
            save_glm(
                os.path.join(base, "coefficients", "part-00000.avro"),
                sub.model,
                index_maps[sub.feature_shard],
                model_id=name,
                sparsity_threshold=sparsity_threshold,
            )
        elif isinstance(sub, RandomEffectModel):
            base = os.path.join(model_dir, "random-effect", name)
            os.makedirs(os.path.join(base, "coefficients"), exist_ok=True)
            io_call(
                _write_id_info, os.path.join(base, "id-info"),
                sub.random_effect_type + "\n" + sub.feature_shard + "\n",
                site="io.model_save",
            )
            imap = index_maps[sub.feature_shard]
            idx = _host(sub.coef_indices)
            val = _host(sub.coef_values)
            var = None if sub.variances is None else _host(sub.variances)

            def entity_records():
                for e, ent in enumerate(sub.entity_ids):
                    m = idx[e] >= 0
                    means = [
                        {
                            "name": (kv := split_feature_key(imap.get_feature_name(int(j))))[0],
                            "term": kv[1],
                            "value": float(v),
                        }
                        for j, v in zip(idx[e][m], val[e][m])
                        if abs(v) > sparsity_threshold
                    ]
                    variances = None
                    if var is not None:
                        variances = [
                            {
                                "name": (kv := split_feature_key(imap.get_feature_name(int(j))))[0],
                                "term": kv[1],
                                "value": float(v),
                            }
                            for j, v in zip(idx[e][m], var[e][m])
                        ]
                    yield {
                        "modelId": str(ent),
                        "modelClass": _MODEL_CLASS_NAMES.get(sub.task),
                        "means": means,
                        "variances": variances,
                        "lossFunction": None,
                    }

            # chunk into part files
            part = 0
            chunk = []
            for rec in entity_records():
                chunk.append(rec)
                if len(chunk) >= records_per_file:
                    write_avro_file(
                        os.path.join(base, "coefficients", f"part-{part:05d}.avro"),
                        BAYESIAN_LINEAR_MODEL_AVRO,
                        chunk,
                    )
                    part += 1
                    chunk = []
            write_avro_file(
                os.path.join(base, "coefficients", f"part-{part:05d}.avro"),
                BAYESIAN_LINEAR_MODEL_AVRO,
                chunk,
            )
        else:
            raise TypeError(f"Unknown sub-model type for {name}: {type(sub)}")


def load_game_model(
    model_dir: str,
    index_maps: Mapping[str, IndexMap],
    task: Optional[str] = None,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> GameModel:
    """A GAME model from the reference layout, its coefficients ``dtype``
    on ``device``."""
    dev = resolve_device(device)
    meta_path = os.path.join(model_dir, "model-metadata.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    task = task or meta.get("modelType", "LINEAR_REGRESSION").lower()

    models: Dict[str, object] = {}
    fe_dir = os.path.join(model_dir, "fixed-effect")
    if os.path.isdir(fe_dir):
        for name in sorted(os.listdir(fe_dir)):
            base = os.path.join(fe_dir, name)
            if not os.path.isdir(base):
                continue
            with open(os.path.join(base, "id-info")) as f:
                shard = f.readline().strip()
            glm = load_glm(os.path.join(base, "coefficients"), index_maps[shard], task, dev, dtype)
            models[name] = FixedEffectModel(model=glm, feature_shard=shard)

    re_dir = os.path.join(model_dir, "random-effect")
    if os.path.isdir(re_dir):
        for name in sorted(os.listdir(re_dir)):
            base = os.path.join(re_dir, name)
            if not os.path.isdir(base):
                continue
            with open(os.path.join(base, "id-info")) as f:
                re_type = f.readline().strip()
                shard = f.readline().strip()
            imap = index_maps[shard]
            ids, vecs, variances = [], [], []
            has_var = False
            for rec in iter_avro_directory(os.path.join(base, "coefficients")):
                ids.append(rec["modelId"])
                items = [
                    (imap.get_index(feature_key(t["name"], t["term"])), t["value"])
                    for t in rec["means"]
                ]
                vecs.append([(i, v) for i, v in items if i >= 0])
                if rec.get("variances"):
                    has_var = True
                    vitems = [
                        (imap.get_index(feature_key(t["name"], t["term"])), t["value"])
                        for t in rec["variances"]
                    ]
                    variances.append({i: v for i, v in vitems if i >= 0})
                else:
                    variances.append({})
            S = max((len(v) for v in vecs), default=1) or 1
            E = len(ids)
            idx = np.full((E, S), -1, dtype=np.int32)
            val = np.zeros((E, S))
            var = np.zeros((E, S)) if has_var else None
            for e, items in enumerate(vecs):
                items.sort()
                for k, (i, v) in enumerate(items):
                    idx[e, k] = i
                    val[e, k] = v
                    if var is not None:
                        var[e, k] = variances[e].get(i, 0.0)
            models[name] = RandomEffectModel(
                random_effect_type=re_type,
                feature_shard=shard,
                task=task,
                entity_ids=np.asarray(ids, dtype=object),
                coef_indices=torch.as_tensor(idx, device=dev),
                coef_values=torch.as_tensor(val, dtype=dtype, device=dev),
                variances=None if var is None else torch.as_tensor(var, dtype=dtype, device=dev),
            )
    return GameModel(models=models, task=task)
