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
shard's batch in any layout of ``RawDataset.to_batch``; given a ``group``,
the rows a process read itself become its dense row shard.

Built across processes (each rank read only its own rows): the fixed
effect's batch is the rank's padded rows, and ``game/data_mp.py`` builds the
random effect's blocks for the rank's entity range with its scoring arrays
over the rank's padded rows (``local_rows``); the padded global row space
is the ranks' padded shares in rank order.

Streamed (out-of-core) datasets, the JAX package's: given
``hbm_budget_bytes`` and a batch whose device estimate exceeds it, the
fixed effect keeps its rows in a :class:`HostRowBatch` (dense or ELL planes
in host memory, page-locked when built for a card, so that the row slices
of ``game/fe_streaming.py`` copy to the card asynchronously), and the random
effect keeps its entity blocks in host memory (``game/streaming.py``
stages entity slices). ``build_fixed_effect_dataset_from_disk`` decodes
part files straight into preallocated host planes through the pooled
readers of ``io/data.py``, never materializing a ``RawDataset``.

Streamed across processes (the JAX package's "streamed under a mesh"): each
rank keeps only its own rows and its own entity range in host memory and
stages them through its card. A streamed fixed effect over a ``group``
holds the rank's true rows (dense, or ELL at the width of the rank's own
rows: per-rank ELL widths stay private) and counts the padded global rows
in ``true_n_rows``; a streamed random effect built across processes
(``game/data_mp.py``) holds the blocks of its ``entity_shard_range`` and
the scoring arrays of the rank's padded rows. The port's datasets carry
their ``group`` where the JAX package's carry a mesh.
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

_MESH_FIELD = (
    "the port's datasets are sharded by their data-parallel group (group=...), not by a mesh"
)


@dataclasses.dataclass(frozen=True)
class HostRowBatch:
    """Host-resident row-major fixed-effect training data for the streamed
    (out-of-core) path: dense ``[n, d]`` or ELL ``idx/val [n, F]`` CPU
    tensors, whose row axis slices into budget-sized windows
    (``game/fe_streaming.py``). The planes are torch tensors (a bfloat16
    feature plane has no numpy dtype); a batch built for a card holds them
    in page-locked memory (``pinned``). COO (column-sorted) and tiled
    layouts are not row-sliceable and are refused upstream."""

    dim: int
    labels: Tensor  # f[n] solve dtype
    offsets: Tensor  # f[n]
    weights: Tensor  # f[n]
    dense: Optional[Tensor] = None  # f[n, d] feature dtype
    ell_idx: Optional[Tensor] = None  # i32[n, F]
    ell_val: Optional[Tensor] = None  # f[n, F] feature dtype

    def __post_init__(self):
        if (self.dense is None) == (self.ell_idx is None):
            raise ValueError("a HostRowBatch holds exactly one of dense / (ell_idx, ell_val)")
        for name in ("labels", "offsets", "weights", "dense", "ell_idx", "ell_val"):
            t = getattr(self, name)
            if t is not None and t.device.type != "cpu":
                raise ValueError(f"HostRowBatch.{name} must lie in host memory, got {t.device}")

    @property
    def n_rows(self) -> int:
        return int(self.labels.shape[0])

    @property
    def layout(self) -> str:
        return "dense" if self.dense is not None else "ell"

    def feature_row_nbytes(self) -> int:
        if self.dense is not None:
            return self.dim * self.dense.element_size()
        return self.ell_idx.shape[1] * (self.ell_val.element_size() + self.ell_idx.element_size())

    def is_pinned(self) -> bool:
        planes = (self.dense,) if self.dense is not None else (self.ell_idx, self.ell_val)
        return all(t.is_pinned() for t in planes)

    def cache(self) -> dict:
        """A dict kept with this batch object (a pinned copy has its own):
        what the streamed path builds once per batch, as each ELL slice's
        column segments (``game/fe_streaming.py``)."""
        cached = getattr(self, "_cache", None)
        if cached is None:
            cached = {}
            object.__setattr__(self, "_cache", cached)
        return cached

    def pinned(self) -> "HostRowBatch":
        """This batch with its feature planes in page-locked memory (one
        copy, made once and cached; a pinned batch is returned as it is),
        so that a row slice copies to the card with ``non_blocking=True``
        on a copy stream."""
        if self.is_pinned():
            return self
        cached = getattr(self, "_pinned", None)
        if cached is None:
            pin = lambda t: None if t is None else t.pin_memory()  # noqa: E731
            cached = dataclasses.replace(
                self, dense=pin(self.dense), ell_idx=pin(self.ell_idx), ell_val=pin(self.ell_val)
            )
            object.__setattr__(self, "_pinned", cached)
        return cached


def _host_plane(a: np.ndarray, dtype: torch.dtype, pinned: bool) -> Tensor:
    """Host numpy -> a CPU tensor of ``dtype`` (f64 narrows through f32 to
    bfloat16, as ``_to_device`` does), page-locked when ``pinned``."""
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)
    else:
        np_dtype = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32}[dtype]
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype))
    return t.pin_memory() if pinned else t


def _dense_rows(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, d: int) -> np.ndarray:
    """COO -> dense ``[n, d]`` float64, duplicates summed in input order:
    ``np.add.at``'s result bit for bit (the JAX package's streamed build),
    by ``np.bincount``, which adds in the same order and runs far faster."""
    flat = np.bincount(
        rows.astype(np.int64) * d + cols.astype(np.int64), weights=vals.astype(np.float64), minlength=n * d
    )
    return flat.reshape(n, d)


@dataclasses.dataclass(frozen=True)
class FixedEffectDataset:
    """All samples' features from one shard: resident on the device, or
    streamed (``streamed=True``: ``batch`` None, ``host_batch`` the host
    rows, slices staged under ``hbm_budget_bytes``).

    ``true_dim`` / ``true_n_rows`` are the unpadded shard dimension and
    sample count; they default to the batch's. A row-sharded batch
    (``batch.group`` set) holds one rank's padded rows, so ``true_n_rows``
    is then required: the global row count. A streamed dataset over a
    ``group`` holds the rank's true rows in ``host_batch`` and the padded
    global row count in ``true_n_rows``."""

    coordinate_id: str
    feature_shard: str
    batch: Optional[LabeledBatch]
    true_dim: Optional[int] = None
    true_n_rows: Optional[int] = None
    host_batch: Optional[HostRowBatch] = None
    streamed: bool = False
    hbm_budget_bytes: Optional[int] = None
    mesh: Optional[object] = None
    # the device of a streamed dataset's resident planes and slices
    device: Optional[torch.device] = None
    # streamed across processes: the rank's DataParallelGroup
    group: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise ValueError(_MESH_FIELD)
        if self.streamed:
            if self.batch is not None or self.host_batch is None or self.hbm_budget_bytes is None:
                raise ValueError("a streamed FixedEffectDataset holds host_batch and hbm_budget_bytes, no batch")
            if self.device is None:
                raise ValueError("a streamed FixedEffectDataset needs the device its slices stream to")
            if self.group is not None and self.true_n_rows is None:
                raise ValueError("a streamed dataset over a group needs true_n_rows, the padded global row count")
            return
        if self.group is not None:
            raise ValueError("a resident FixedEffectDataset's group is its batch's")
        if self.host_batch is not None:
            raise ValueError("a resident FixedEffectDataset holds no host_batch")
        if self.batch is None:
            raise ValueError("a resident FixedEffectDataset needs its batch")
        if self.batch.group is not None and self.true_n_rows is None:
            raise ValueError("a row-sharded batch needs true_n_rows, the global row count")

    @property
    def n_rows(self) -> int:
        if self.true_n_rows is not None:
            return self.true_n_rows
        return self.batch.n_rows if self.batch is not None else self.host_batch.n_rows

    @property
    def dim(self) -> int:
        if self.true_dim is not None:
            return self.true_dim
        return self.batch.dim if self.batch is not None else self.host_batch.dim


@dataclasses.dataclass(frozen=True)
class EntityBlocks:
    """Entity-blocked training data (see module docstring): on the device,
    or in host memory for a streamed dataset."""

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
    # streamed across processes: the [lo, hi) block rows ``blocks`` hold
    entity_shard_range: Optional[Tuple[int, int]] = None
    mesh: Optional[object] = None
    # entity-sharded over a data-parallel group: ``blocks`` hold this rank's
    # contiguous entity range, ``host_proj_cols`` the whole support layout
    group: Optional[object] = None  # parallel.mesh.DataParallelGroup
    # built across processes (game/data_mp.py): the scoring arrays hold this
    # rank's padded rows of the padded global row space, and scores gather
    # every rank's rows in rank order
    local_rows: bool = False

    def __post_init__(self):
        if self.streamed:
            if self.hbm_budget_bytes is None:
                raise ValueError("a streamed RandomEffectDataset needs hbm_budget_bytes")
            if self.blocks.features.device.type != "cpu":
                raise ValueError("a streamed RandomEffectDataset keeps its blocks in host memory")
            if (self.group is None) != (self.entity_shard_range is None):
                raise ValueError(
                    "a streamed RandomEffectDataset over a group holds the blocks of its entity_shard_range"
                )
        elif self.hbm_budget_bytes is not None:
            raise ValueError("hbm_budget_bytes is set on streamed datasets only")
        elif self.entity_shard_range is not None:
            raise ValueError("entity_shard_range is set on streamed datasets over a group only")
        if self.mesh is not None:
            raise ValueError(_MESH_FIELD)
        if (self.host_proj_cols is None) != (self.group is None):
            raise ValueError(
                "an entity-sharded dataset carries both its group and host_proj_cols "
                "(parallel.mesh.shard_random_effect_dataset)"
            )
        if self.local_rows and self.group is None:
            raise ValueError("a dataset whose scoring arrays hold one rank's rows needs its group")

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    @property
    def n_rows(self) -> int:
        """Rows of the (padded global) row space the dataset scores."""
        n = int(self.row_entity.shape[0])
        return n * self.group.world_size if self.local_rows else n

    @property
    def device(self) -> torch.device:
        return self.row_entity.device


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
    group=None,
) -> FixedEffectDataset:
    """All rows of ``feature_shard`` as one resident batch on ``device`` (the
    card unless asked otherwise), in ``layout`` (``RawDataset.to_batch``:
    auto picks dense up to d = 4,096 and ELL above).

    ``group`` (a ``parallel.mesh.DataParallelGroup``): ``raw`` holds only
    this rank's rows, padded to the share every rank holds
    (``RawDataset.pad_rows(equal_host_share(N))``), and the dataset is the
    rank's dense row shard of the padded global row space
    (``parallel.mesh.local_batch``); its sweeps sum across the ranks. A
    resident ELL or COO layout over processes is refused in the JAX
    package's words; with a budget the rank streams its own true rows
    (below).

    ``mesh`` (a ``parallel.mesh.MeshGroup``) with ``layout="tiled"``: the
    rank's tile of the (data x model)-tiled batch (``RawDataset.to_batch``;
    ``raw`` holds the whole batch, or its data row's rows when read per
    host), its rows the data row's block of the padded global row space.
    Any other layout under a mesh takes its data axis as ``group``: the
    JAX package's ``shard_batch(batch, mesh)``, rows over the data axis and
    replicated over the model axis, so the M ranks of a data row hold the
    same rows and each model column runs B1-B3 through B4 over its ``data``
    subgroup.

    ``hbm_budget_bytes``: when set and the resident batch's device bytes
    (``fe_streaming.estimate_fe_batch_bytes``) exceed it, the dataset is
    built streamed: the rows stay in a :class:`HostRowBatch` (dense, or ELL
    with the global row-nnz width; page-locked for a card) and training and
    scoring stream row slices through ``device``. Only the row-sliceable
    layouts (auto, dense, ell) take a budget. Over a ``group`` the estimate
    is the rank's share (every rank streams when the largest share does
    not fit) and the host batch holds the rank's true rows, ELL at the
    width of its own rows; ``true_n_rows`` is the padded global count."""
    dev = resolve_device(device)
    d = raw.shard_dims[feature_shard]
    if layout == "tiled":
        from ..plan.planner import PlanError

        if mesh is None:
            raise PlanError(
                f"coordinate {coordinate_id}: layout='tiled' requires the "
                "estimator to be built with a device mesh"
            )
        if hbm_budget_bytes is not None:
            raise PlanError(
                f"coordinate {coordinate_id}: hbm_budget_mb on a fixed "
                "effect requires a row-sliceable layout "
                f"(auto|dense|ell), got layout={layout!r}"
            )
        batch = raw.to_batch(feature_shard, dtype=dtype, layout="tiled", feature_dtype=feature_dtype, mesh=mesh)
        local = raw.global_row_start is not None
        return FixedEffectDataset(
            coordinate_id=coordinate_id, feature_shard=feature_shard, batch=batch, true_dim=d,
            true_n_rows=raw.n_rows * mesh.n_data if local else raw.n_rows,
        )
    if mesh is not None and mesh.world is not None:
        # rows over the data axis, replicated over the model axis
        group = mesh.data
    if group is not None:
        from ..parallel import multihost
        from ..parallel.mesh import MULTI_ELL_REFUSAL, SHARD_COO_REFUSAL, local_batch
        from ..plan.planner import PlanError

        eff_layout = ("dense" if d <= 4096 else "ell") if layout == "auto" else layout
        n_global = raw.n_rows * group.world_size
        if hbm_budget_bytes is not None:
            eff_layout = _row_sliceable_layout(coordinate_id, layout, d, "hbm_budget_mb on a fixed effect")
            est, width = _resident_estimate(raw, feature_shard, eff_layout, feature_dtype or dtype, dtype)
            # every rank decides alike: the largest share's estimate (ELL
            # widths differ from rank to rank)
            if max(multihost.allgather_object(est)) > hbm_budget_bytes:
                n_true = raw.true_rows if raw.true_rows is not None else raw.n_rows
                host = _host_row_batch(raw, feature_shard, n_true, eff_layout, width, dtype, feature_dtype or dtype,
                                       pinned=dev.type == "cuda")
                return FixedEffectDataset(
                    coordinate_id=coordinate_id, feature_shard=feature_shard, batch=None, true_dim=d,
                    true_n_rows=n_global, host_batch=host, streamed=True, hbm_budget_bytes=int(hbm_budget_bytes),
                    device=dev, group=group,
                )
        if eff_layout in ("coo", "sparse"):
            raise PlanError(SHARD_COO_REFUSAL)
        if eff_layout != "dense":
            raise PlanError(MULTI_ELL_REFUSAL)
        batch = raw.to_batch(feature_shard, dtype=dtype, layout="dense", feature_dtype=feature_dtype, device=dev)
        return FixedEffectDataset(
            coordinate_id=coordinate_id, feature_shard=feature_shard, true_dim=d, true_n_rows=n_global,
            batch=local_batch(batch, n_global, group),
        )
    if hbm_budget_bytes is not None:
        eff_layout = _row_sliceable_layout(coordinate_id, layout, d, "hbm_budget_mb on a fixed effect")
        est, width = _resident_estimate(raw, feature_shard, eff_layout, feature_dtype or dtype, dtype)
        if est > hbm_budget_bytes:
            host = _host_row_batch(raw, feature_shard, raw.n_rows, eff_layout, width, dtype, feature_dtype or dtype,
                                   pinned=dev.type == "cuda")
            return FixedEffectDataset(
                coordinate_id=coordinate_id, feature_shard=feature_shard, batch=None, true_dim=d,
                true_n_rows=raw.n_rows, host_batch=host, streamed=True, hbm_budget_bytes=int(hbm_budget_bytes),
                device=dev,
            )
    return FixedEffectDataset(
        coordinate_id=coordinate_id,
        feature_shard=feature_shard,
        batch=raw.to_batch(
            feature_shard, dtype=dtype, layout=layout, feature_dtype=feature_dtype, device=dev
        ),
        true_dim=d,
        true_n_rows=raw.n_rows,
    )


def _resident_estimate(raw: RawDataset, feature_shard: str, eff_layout: str, fdt, dtype) -> Tuple[int, int]:
    """(device bytes of ``raw``'s rows as a resident batch of
    ``eff_layout``, the ELL width: the rows' max nnz, 0 for dense)."""
    from .fe_streaming import estimate_fe_batch_bytes

    n = raw.n_rows
    width = 0
    if eff_layout == "ell":
        rows = raw.shard_coo[feature_shard][0]
        counts = np.bincount(rows, minlength=n) if n else np.zeros(0, np.int64)
        width = max(int(counts.max()) if n else 1, 1)
    est = estimate_fe_batch_bytes(
        n, raw.shard_dims[feature_shard], eff_layout, ell_width=width, feature_itemsize=_itemsize(fdt),
        scalar_itemsize=_itemsize(dtype),
    )
    return est, width


def _host_row_batch(raw: RawDataset, feature_shard: str, n: int, eff_layout: str, width: int, dtype, fdt,
                    pinned: bool) -> "HostRowBatch":
    """The first ``n`` rows of ``raw`` as host planes: dense, or ELL of
    ``width`` entries a row; the feature planes page-locked when
    ``pinned``."""
    rows, cols, vals = raw.shard_coo[feature_shard]
    d = raw.shard_dims[feature_shard]
    if n < raw.n_rows:
        keep = rows < n
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    planes = dict(
        labels=_host_plane(raw.labels[:n], dtype, False),
        offsets=_host_plane(raw.offsets[:n], dtype, False),
        weights=_host_plane(raw.weights[:n], dtype, False),
    )
    if eff_layout == "dense":
        return HostRowBatch(dim=d, dense=_host_plane(_dense_rows(rows, cols, vals, n, d), fdt, pinned), **planes)
    ell_idx, ell_val = _rows_to_ell(rows, cols, vals, n, width=width)
    return HostRowBatch(dim=d, ell_idx=_host_plane(ell_idx, torch.int32, pinned),
                        ell_val=_host_plane(ell_val, fdt, pinned), **planes)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _row_sliceable_layout(coordinate_id: str, layout: str, d: int, what: str) -> str:
    """``layout`` resolved as ``RawDataset.to_batch`` resolves auto (dense up
    to d = 4,096, ELL above); anything but dense / ELL raises."""
    eff_layout = ("dense" if d <= 4096 else "ell") if layout == "auto" else layout
    if eff_layout not in ("dense", "ell"):
        raise ValueError(
            f"coordinate {coordinate_id}: {what} requires a row-sliceable layout "
            f"(auto|dense|ell), got layout={layout!r}"
        )
    return eff_layout


def build_fixed_effect_dataset_from_disk(
    path,
    shard_configs,
    coordinate_id: str,
    feature_shard: str,
    hbm_budget_bytes: int,
    *,
    index_maps=None,
    id_tag_columns=(),
    response_column: str = "label",
    columns=None,
    reader_schema=None,
    dtype=torch.float32,
    layout: str = "auto",
    feature_dtype=None,
    workers=None,
    pool=None,
    ingest_budget_bytes: Optional[int] = None,
    prefetch_depth: int = 2,
    device: DeviceLike = None,
):
    """Disk -> :class:`HostRowBatch` without materializing the whole
    ``RawDataset``: part files decode across the ingest worker pool
    (``io.data.read_avro_part_pieces``) and each part's rows are written
    straight into the preallocated host planes. Returns ``(dataset,
    index_maps)``, the dataset always streamed under ``hbm_budget_bytes``
    (use ``read_avro_dataset_chunked`` + :func:`build_fixed_effect_dataset`
    for a resident batch).

    Bitwise the in-memory builder's planes: parts arrive in file order with
    contiguous ascending row blocks, so the per-part dense fills and
    ``_rows_to_ell(width=global)`` give the global constructions' arrays.
    The dense layout keeps one part's COO alive at a time; the ELL layout
    buffers the parts' compact COO until the global row-nnz width is known
    (O(nnz) host memory, never the records)."""
    from .. import obs
    from ..io.avro import count_avro_rows, list_avro_parts
    from ..io.data import read_avro_part_pieces, scan_index_maps_pipelined

    dev = resolve_device(device)
    paths = [path] if isinstance(path, str) else list(path)
    parts = [part for p in paths for part in list_avro_parts(p)]
    if not parts:
        raise ValueError(f"no .avro part files under {paths!r}")
    read_kw = dict(
        id_tag_columns=id_tag_columns, response_column=response_column, columns=columns,
        reader_schema=reader_schema, prefetch_depth=prefetch_depth, workers=workers, pool=pool,
        ingest_budget_bytes=ingest_budget_bytes,
    )
    with obs.span("ingest.disk_slice", n_parts=len(parts)):
        if index_maps is None:
            index_maps = scan_index_maps_pipelined(
                parts, shard_configs, reader_schema, prefetch_depth=prefetch_depth, workers=workers,
                pool=pool, ingest_budget_bytes=ingest_budget_bytes,
            )
        d = len(index_maps[feature_shard])
        eff_layout = _row_sliceable_layout(coordinate_id, layout, d, "the disk-to-slice ingest path")
        # header-only row counts: block counts, no decompression
        n = sum(count_avro_rows(part) for part in parts)
        fdt = feature_dtype or dtype
        pinned = dev.type == "cuda"
        scalars = {name: np.empty(n, np.float64) for name in ("labels", "offsets", "weights")}
        coo_parts = []
        dense = np.zeros((n, d), np.float64) if eff_layout == "dense" else None
        row0 = 0

        def _drain(_i, piece) -> None:
            nonlocal row0
            m = piece.n_rows
            for name, plane in scalars.items():
                plane[row0:row0 + m] = getattr(piece, name)
            rows, cols, vals = piece.shard_coo[feature_shard]
            if dense is not None:
                dense[row0:row0 + m] = _dense_rows(rows, cols, vals, m, d)
            else:
                coo_parts.append((m, (rows, cols, vals)))
            row0 += m

        read_avro_part_pieces(paths, shard_configs, _drain, index_maps, **read_kw)
        planes = {name: _host_plane(plane, dtype, False) for name, plane in scalars.items()}
        if dense is not None:
            host = HostRowBatch(dim=d, dense=_host_plane(dense, fdt, pinned), **planes)
        else:
            width = 1
            for m, (rows, _c, _v) in coo_parts:
                if m:
                    width = max(width, int(np.bincount(rows, minlength=m).max()))
            ell_idx = np.zeros((n, width), np.int32)
            ell_val = np.zeros((n, width), np.float64)
            r0 = 0
            for m, (rows, cols, vals) in coo_parts:
                ell_idx[r0:r0 + m], ell_val[r0:r0 + m] = _rows_to_ell(rows, cols, vals, m, width=width)
                r0 += m
            del coo_parts[:]
            host = HostRowBatch(dim=d, ell_idx=_host_plane(ell_idx, torch.int32, pinned),
                                ell_val=_host_plane(ell_val, fdt, pinned), **planes)
        reg = obs.current_run().registry
        reg.counter("photon_ingest_parts_total", "part files decoded by the chunked reader").labels(
            mode="disk_slice").inc(len(parts))
        reg.counter("photon_ingest_rows_total", "rows produced by the chunked reader").labels(
            mode="disk_slice").inc(n)
    dataset = FixedEffectDataset(
        coordinate_id=coordinate_id, feature_shard=feature_shard, batch=None, true_dim=d, true_n_rows=n,
        host_batch=host, streamed=True, hbm_budget_bytes=int(hbm_budget_bytes), device=dev,
    )
    return dataset, dict(index_maps)


def _entity_blocks(feats, labels, offsets, weights, proj_cols, active_rows, dtype, fdt, device: torch.device,
                  host: bool) -> EntityBlocks:
    """Host numpy block arrays as :class:`EntityBlocks` on ``device`` (the
    features in ``fdt``, the row planes in ``dtype``), or with ``host`` in
    host memory, page-locked for a card (a streamed dataset's)."""
    if host:
        put = lambda a, t: _host_plane(a, t, device.type == "cuda")  # noqa: E731
    else:
        put = lambda a, t: _to_device(a, t, device)  # noqa: E731
    return EntityBlocks(
        features=put(feats, fdt), labels=put(labels, dtype), offsets=put(offsets, dtype), weights=put(weights, dtype),
        proj_cols=put(proj_cols, torch.int32), active_rows=put(active_rows, torch.int32),
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
    hbm_budget_bytes: when set and the blocks' device bytes
    (``streaming.estimate_block_bytes``) exceed it, the dataset is built
    streamed: the blocks stay in host memory (page-locked for a card) and
    training and scoring stream entity slices through ``device``
    (``game/streaming.py``); the scoring arrays go to ``device`` as ever.
    """
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
    streamed = False
    if hbm_budget_bytes is not None:
        from .streaming import estimate_block_bytes

        streamed = estimate_block_bytes(*feats.shape, feature_itemsize=_itemsize(fdt)) > hbm_budget_bytes
    blocks = _entity_blocks(feats, labels_b, offsets_b, weights_b, proj_cols_np, active_rows_np, dtype, fdt, dev,
                           host=streamed)
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
        streamed=streamed,
        hbm_budget_bytes=int(hbm_budget_bytes) if streamed else None,
    )
