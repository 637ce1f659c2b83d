"""GAME datasets: fixed-effect batches and entity-blocked random-effect data.

Counterpart of the JAX package's ``game/data.py``. A random-effect dataset
is a set of dense entity blocks on the device:

    features  f[E, K, S]   per-entity rows projected into the entity's
    labels    f[E, K]      feature subspace (S = max subspace dim,
    weights   f[E, K]      K = max (capped) rows per entity; zero-padded)
    offsets   f[E, K]
    proj_cols i32[E, S]    local dim -> global feature column (-1 pad)
    active_rows i32[E, K]  global sample row of each block cell (-1 pad)

The host build (``build_random_effect_dataset``) is the JAX package's numpy
code, copied: the entity plan, the splitmix64 hash-priority reservoir of at
most ``active_cap`` rows per entity with the count/cap weight rescale, the
vectorized subspace projection and the optional Pearson feature selection.
Its numpy arrays are the JAX build's, bit for bit; only the last step
differs, which places them on the dataset's device as torch tensors.

A dataset sharded over a data-parallel group (``parallel.mesh``'s
``shard_fixed_effect_dataset`` / ``shard_random_effect_dataset``) holds one
rank's rows of the fixed effect's batch, or one rank's entity range of the
random effect's blocks; its entity tables and scoring arrays stay whole.
``build_fixed_effect_dataset`` is the JAX package's resident path: the
shard's batch in any layout of ``RawDataset.to_batch``. Streamed
(out-of-core) datasets are ROADMAP A7 and the multi-process build
(``game/data_mp.py``) is A10: their fields and arguments raise when set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..io.data import RawDataset
from ..ops.features import LabeledBatch

Tensor = torch.Tensor

_STREAMED_TODO = "streamed (out-of-core) datasets are not ported yet (ROADMAP A7)"
_MULTI_TODO = (
    "multi-process-built and streamed mesh-sharded datasets are not ported yet "
    "(ROADMAP A10); shard a whole dataset with parallel.mesh instead"
)


@dataclasses.dataclass(frozen=True)
class FixedEffectDataset:
    """All samples' features from one shard, resident on the device.

    ``true_dim`` / ``true_n_rows`` are the unpadded shard dimension and
    sample count; they default to the batch's. A row-sharded batch
    (``batch.group`` set) holds one rank's padded rows, so ``true_n_rows``
    is then required: the global row count."""

    coordinate_id: str
    feature_shard: str
    batch: Optional[LabeledBatch]
    true_dim: Optional[int] = None
    true_n_rows: Optional[int] = None
    host_batch: Optional[object] = None
    streamed: bool = False
    hbm_budget_bytes: Optional[int] = None
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.streamed or self.host_batch is not None or self.hbm_budget_bytes is not None:
            raise NotImplementedError(_STREAMED_TODO)
        if self.mesh is not None:
            raise NotImplementedError(_MULTI_TODO)
        if self.batch is None:
            raise ValueError("a resident FixedEffectDataset needs its batch")
        if self.batch.group is not None and self.true_n_rows is None:
            raise ValueError("a row-sharded batch needs true_n_rows, the global row count")

    @property
    def n_rows(self) -> int:
        return self.true_n_rows if self.true_n_rows is not None else self.batch.n_rows

    @property
    def dim(self) -> int:
        return self.true_dim if self.true_dim is not None else self.batch.dim


@dataclasses.dataclass(frozen=True)
class EntityBlocks:
    """Device-side entity-blocked training data (see module docstring)."""

    features: Tensor  # f[E, K, S]
    labels: Tensor  # f[E, K]
    offsets: Tensor  # f[E, K] (base offsets only; residuals added at train time)
    weights: Tensor  # f[E, K]; 0 = padding
    proj_cols: Tensor  # i32[E, S]; -1 = padding
    active_rows: Tensor  # i32[E, K]; -1 = padding

    @property
    def num_entities(self) -> int:
        return self.features.shape[0]

    @property
    def rows_per_entity(self) -> int:
        return self.features.shape[1]

    @property
    def subspace_dim(self) -> int:
        return self.features.shape[2]


@dataclasses.dataclass(frozen=True)
class RandomEffectDataset:
    """Entity-blocked random-effect dataset + full-row scoring arrays."""

    coordinate_id: str
    feature_shard: str
    random_effect_type: str
    entity_ids: np.ndarray  # object[E], order = block row
    blocks: EntityBlocks
    # scoring representation for ALL rows of the full dataset (ELL, global space)
    row_entity: Tensor  # i32[n] block row per sample, -1 = entity dropped/unseen
    ell_idx: Tensor  # i32[n, F]
    ell_val: Tensor  # f[n, F]
    passive_rows: np.ndarray  # i64[*] rows not in any active block (info only)
    # host-side per-entity stats (entities are size-sorted descending), used
    # to bucket the solver by block size
    entity_counts: Optional[np.ndarray] = None  # i64[E] active rows per entity
    entity_subspace_dims: Optional[np.ndarray] = None  # i64[E] real S per entity
    host_proj_cols: Optional[np.ndarray] = None
    streamed: bool = False
    hbm_budget_bytes: Optional[int] = None
    entity_shard_range: Optional[Tuple[int, int]] = None
    mesh: Optional[object] = None
    # entity-sharded over a data-parallel group: ``blocks`` hold this rank's
    # contiguous entity range, ``host_proj_cols`` the whole support layout
    group: Optional[object] = None  # parallel.mesh.DataParallelGroup

    def __post_init__(self):
        if self.streamed or self.hbm_budget_bytes is not None:
            raise NotImplementedError(_STREAMED_TODO)
        if self.entity_shard_range is not None or self.mesh is not None:
            raise NotImplementedError(_MULTI_TODO)
        if (self.host_proj_cols is None) != (self.group is None):
            raise ValueError(
                "an entity-sharded dataset carries both its group and host_proj_cols "
                "(parallel.mesh.shard_random_effect_dataset)"
            )

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    @property
    def device(self) -> torch.device:
        return self.blocks.features.device


@dataclasses.dataclass(frozen=True)
class _EntityPlan:
    """The deterministic entity layout: which entities train, their block
    order (size-sorted descending, stable), the padded block count, the
    per-entity active cap, and weight rescales."""

    kept_entities: np.ndarray  # i64[E_real] indices into uniq, size-sorted
    old_to_block: np.ndarray  # i64[len(uniq)] -> block row or -1
    E_real: int
    E: int  # padded block count
    cap: int
    K: int  # block row capacity
    weight_scale: np.ndarray  # f8[E] count/cap rescale for capped entities


def _entity_plan(
    counts: np.ndarray,
    active_lower_bound: int,
    active_cap: Optional[int],
    pad_entities_to_multiple: int,
) -> _EntityPlan:
    kept_mask = counts >= active_lower_bound
    kept_entities = np.nonzero(kept_mask)[0]
    # order entities by descending size
    kept_entities = kept_entities[np.argsort(-counts[kept_entities], kind="stable")]
    E_real = len(kept_entities)
    E = max(
        ((E_real + pad_entities_to_multiple - 1) // pad_entities_to_multiple)
        * pad_entities_to_multiple,
        pad_entities_to_multiple,
    )
    old_to_block = np.full(len(counts), -1, dtype=np.int64)
    old_to_block[kept_entities] = np.arange(E_real)
    cap = active_cap if active_cap is not None else int(counts.max() if len(counts) else 1)
    K = int(min(int(counts[kept_entities].max()) if E_real else 1, cap)) or 1
    weight_scale = np.ones(E)
    if E_real:
        counts_kept = counts[kept_entities].astype(np.float64)
        weight_scale[:E_real] = np.where(counts_kept > cap, counts_kept / cap, 1.0)
    return _EntityPlan(
        kept_entities=kept_entities,
        old_to_block=old_to_block,
        E_real=E_real,
        E=E,
        cap=cap,
        K=K,
        weight_scale=weight_scale,
    )


def _hash64(a: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic splitmix64-style mix of row ids (the reservoir priority)."""
    x = a.astype(np.uint64) + np.uint64((seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _rows_to_ell(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int,
    width: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """COO -> per-row padded (idx, val) with idx=0/val=0 padding. Vectorized."""
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    counts = np.bincount(r, minlength=n)
    F = width if width is not None else max(int(counts.max()) if n else 1, 1)
    idx = np.zeros((n, F), dtype=np.int32)
    val = np.zeros((n, F), dtype=np.float64)
    if len(r):
        starts = np.cumsum(np.concatenate([[0], counts[:-1]]))
        within = np.arange(len(r)) - starts[r]
        idx[r, within] = c
        val[r, within] = v
    return idx, val


def _pearson_keep_mask(
    feats: np.ndarray,  # f8[E, K, S] zero-padded per-entity features
    labels: np.ndarray,  # f8[E, K]
    row_mask: np.ndarray,  # bool[E, K] filled (active) slots
    proj_cols: np.ndarray,  # i32[E, S], -1 = padding
    ratio: float,
) -> np.ndarray:
    """Per-entity Pearson-correlation feature selection, vectorized over all
    entities: keep the ceil(ratio * n_rows) columns with the largest
    |Pearson(feature, label)|, where the first constant 1.0 column (the
    intercept) scores 1.0 and other constant columns 0, and only where it
    shrinks the entity's active set. Returns bool[E, S]: True = keep."""
    E, K, S = feats.shape
    EPS = np.finfo(np.float64).eps
    n_e = row_mask.sum(axis=1)  # rows per entity
    n_safe = np.maximum(n_e, 1).astype(np.float64)

    mean_y = (labels * row_mask).sum(axis=1) / n_safe
    dy = (labels - mean_y[:, None]) * row_mask
    std_y = np.sqrt((dy * dy).sum(axis=1))

    mean_x = (feats * row_mask[:, :, None]).sum(axis=1) / n_safe[:, None]
    dx = (feats - mean_x[:, None, :]) * row_mask[:, :, None]
    cov = np.einsum("eks,ek->es", dx, dy)
    std_x = np.sqrt((dx * dx).sum(axis=1))  # sum over K -> [E, S]
    score = cov / (std_y[:, None] * std_x + EPS)

    # constant columns: intercept (value 1.0, first occurrence) scores 1.0,
    # any other constant scores 0
    const = std_x < np.sqrt(n_safe)[:, None] * EPS
    cand = const & (np.abs(mean_x - 1.0) < 1e-12) & (proj_cols >= 0)
    first_one = np.zeros_like(cand)
    has = cand.any(axis=1)
    first_one[np.nonzero(has)[0], np.argmax(cand, axis=1)[has]] = True
    score = np.where(const, np.where(first_one, 1.0, 0.0), score)

    n_active = (proj_cols >= 0).sum(axis=1)
    k_keep = np.ceil(ratio * n_e).astype(np.int64)
    k_keep = np.where(k_keep < n_active, k_keep, n_active)

    # rank columns by descending |score| (stable: earlier column wins ties),
    # |score| quantized to a 1e-12 grid so that last-ulp differences cannot
    # flip a tie
    absc = np.where(proj_cols >= 0, np.round(np.abs(score), 12), -1.0)
    order = np.argsort(-absc, axis=1, kind="stable")
    rank = np.empty((E, S), dtype=np.int64)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(S), (E, S)), axis=1)
    return (rank < k_keep[:, None]) & (proj_cols >= 0)


def build_fixed_effect_dataset(
    raw: RawDataset,
    coordinate_id: str,
    feature_shard: str,
    dtype=torch.float32,
    layout: str = "auto",
    mesh=None,
    feature_dtype=None,
    hbm_budget_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> FixedEffectDataset:
    """All rows of ``feature_shard`` as one resident batch on ``device`` (the
    card unless asked otherwise), in ``layout`` (``RawDataset.to_batch``:
    auto picks dense up to d = 4,096 and ELL above). ``hbm_budget_bytes``
    (the streamed fixed effect) is ROADMAP A7 and ``mesh`` A10."""
    if hbm_budget_bytes is not None:
        raise NotImplementedError(_STREAMED_TODO)
    if mesh is not None:
        raise NotImplementedError(_MULTI_TODO)
    return FixedEffectDataset(
        coordinate_id=coordinate_id,
        feature_shard=feature_shard,
        batch=raw.to_batch(
            feature_shard, dtype=dtype, layout=layout, feature_dtype=feature_dtype, device=device
        ),
        true_dim=raw.shard_dims[feature_shard],
        true_n_rows=raw.n_rows,
    )


def _to_device(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> Tensor:
    """Host numpy -> device tensor of ``dtype``; floating arrays narrow on
    the host first (f64 -> f32), so the upload moves the narrow bytes."""
    if dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
        return t.to(dtype)
    np_dtype = {torch.float64: np.float64, torch.int32: np.int32, torch.int64: np.int64}[dtype]
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype)).to(device)


def build_random_effect_dataset(
    raw: RawDataset,
    coordinate_id: str,
    feature_shard: str,
    random_effect_type: str,
    active_cap: Optional[int] = None,
    active_lower_bound: int = 1,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    pad_entities_to_multiple: int = 1,
    features_to_samples_ratio: Optional[float] = None,
    feature_dtype: Optional[torch.dtype] = None,
    hbm_budget_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> RandomEffectDataset:
    """Host-side dataset build, then the blocks and scoring arrays on
    ``device`` (the card unless asked otherwise).

    active_cap: reservoir-cap per entity with count/cap weight rescale.
    active_lower_bound: entities with fewer samples are not trained.
    features_to_samples_ratio: per entity, keep only the ceil(ratio * n_rows)
    features with the largest |Pearson(feature, label)|.
    feature_dtype: narrower storage (e.g. bfloat16) for the block features
    and the ELL scoring values only; labels, offsets, weights and solver
    state stay ``dtype``.
    hbm_budget_bytes: the streamed build, ROADMAP A7 (raises).
    """
    if hbm_budget_bytes is not None:
        raise NotImplementedError(_STREAMED_TODO)
    dev = resolve_device(device)
    n = raw.n_rows
    ids = raw.id_tags[random_effect_type]
    rows, cols, vals = raw.shard_coo[feature_shard]

    # --- group rows by entity ------------------------------------------------
    ids_arr = np.asarray(ids)
    if ids_arr.dtype == object:
        ids_arr = ids_arr.astype(str)
    uniq, inv = np.unique(ids_arr, return_inverse=True)
    counts = np.bincount(inv, minlength=len(uniq))

    plan = _entity_plan(counts, active_lower_bound, active_cap, pad_entities_to_multiple)
    kept_entities, old_to_block = plan.kept_entities, plan.old_to_block
    E_real, E, K = plan.E_real, plan.E, plan.K

    # --- per-entity active selection (deterministic reservoir) ---------------
    row_ids = np.arange(n, dtype=np.int64)
    priority = _hash64(row_ids, seed)
    # sort rows by (entity, priority): active set = first K rows of each group
    entity_of_row = old_to_block[inv]
    order = np.lexsort((priority, entity_of_row))
    sorted_rows = row_ids[order]
    sorted_entity = entity_of_row[order]
    if E_real:
        starts = np.searchsorted(sorted_entity, np.arange(E_real))
        rank = np.arange(n) - starts[np.clip(sorted_entity, 0, E_real - 1)]
        is_active = (sorted_entity >= 0) & (rank < K)
    else:
        # every entity fell below active_lower_bound: empty (padded) blocks
        rank = np.zeros(n, dtype=np.int64)
        is_active = np.zeros(n, dtype=bool)

    active_rows_np = np.full((E, K), -1, dtype=np.int64)
    weight_scale = plan.weight_scale
    sel = np.nonzero(is_active)[0]
    active_rows_np[sorted_entity[sel], rank[sel]] = sorted_rows[sel]

    passive = sorted_rows[~is_active & (sorted_entity >= 0)]

    # --- ELL features for all rows (scoring path) ----------------------------
    ell_idx_np, ell_val_np = _rows_to_ell(rows, cols, vals, n)

    # --- per-entity subspace projection + dense blocks, vectorized -----------
    ae = sorted_entity[sel]  # block row per active sample        [A]
    ak = rank[sel]  # slot within block                           [A]
    ar = sorted_rows[sel]  # global sample row                    [A]

    labels_b = np.zeros((E, K))
    offsets_b = np.zeros((E, K))
    weights_b = np.zeros((E, K))
    labels_b[ae, ak] = raw.labels[ar]
    offsets_b[ae, ak] = raw.offsets[ar]
    weights_b[ae, ak] = raw.weights[ar] * weight_scale[ae]

    d_shard = raw.shard_dims[feature_shard]
    fi = ell_idx_np[ar]  # [A, F] global cols of active rows
    fv = ell_val_np[ar]  # [A, F]
    nz = fv != 0.0
    # unique (entity, col) pairs, entity-major and col-ascending: the
    # per-entity sorted active-index union of the subspace projector
    keys = ae[:, None].astype(np.int64) * d_shard + fi  # [A, F]
    uniq_keys = np.unique(keys[nz])
    ent_of_key = (uniq_keys // d_shard).astype(np.int64)
    col_of_key = (uniq_keys % d_shard).astype(np.int32)
    per_entity_s = np.bincount(ent_of_key, minlength=E)
    S = max(int(per_entity_s.max()) if len(uniq_keys) else 1, 1)
    key_starts = np.concatenate([[0], np.cumsum(per_entity_s)[:-1]])
    pos_within = np.arange(len(uniq_keys)) - key_starts[ent_of_key]
    proj_cols_np = np.full((E, S), -1, dtype=np.int32)
    proj_cols_np[ent_of_key, pos_within] = col_of_key

    feats = np.zeros((E, K, S), dtype=np.float64)
    aa, ff = np.nonzero(nz)  # active nnz coordinates, row-major
    loc = np.searchsorted(uniq_keys, keys[aa, ff]) - key_starts[ae[aa]]
    feats[ae[aa], ak[aa], loc] = fv[aa, ff]

    if features_to_samples_ratio is not None:
        keep = _pearson_keep_mask(
            feats, labels_b, active_rows_np >= 0, proj_cols_np, features_to_samples_ratio,
        )
        # compact kept columns to the front (stable: column order preserved)
        # and shrink the block S dim to the new max subspace size
        order = np.argsort(~keep, axis=1, kind="stable")
        proj_cols_np = np.take_along_axis(np.where(keep, proj_cols_np, -1), order, axis=1)
        feats = np.take_along_axis(
            np.where(keep[:, None, :], feats, 0.0), order[:, None, :], axis=2
        )
        per_entity_s = keep.sum(axis=1).astype(np.int64)
        S = max(int(per_entity_s.max()) if E_real else 1, 1)
        proj_cols_np = proj_cols_np[:, :S]
        feats = feats[:, :, :S]

    fdt = feature_dtype or dtype
    blocks = EntityBlocks(
        features=_to_device(feats, fdt, dev),
        labels=_to_device(labels_b, dtype, dev),
        offsets=_to_device(offsets_b, dtype, dev),
        weights=_to_device(weights_b, dtype, dev),
        proj_cols=_to_device(proj_cols_np, torch.int32, dev),
        active_rows=_to_device(active_rows_np, torch.int32, dev),
    )
    del feats

    row_entity = np.where(entity_of_row >= 0, entity_of_row, -1).astype(np.int32)
    kept_ids = uniq[kept_entities].astype(str)
    entity_ids = np.concatenate(
        [kept_ids, np.asarray([f"__pad{i}" for i in range(E - E_real)], dtype=object)]
    ) if E > E_real else kept_ids

    return RandomEffectDataset(
        coordinate_id=coordinate_id,
        feature_shard=feature_shard,
        random_effect_type=random_effect_type,
        entity_ids=entity_ids.astype(object),
        blocks=blocks,
        row_entity=_to_device(row_entity, torch.int32, dev),
        ell_idx=_to_device(ell_idx_np, torch.int32, dev),
        ell_val=_to_device(ell_val_np, fdt, dev),
        passive_rows=passive,
        entity_counts=np.sum(active_rows_np >= 0, axis=1).astype(np.int64),
        entity_subspace_dims=per_entity_s.astype(np.int64),
    )
