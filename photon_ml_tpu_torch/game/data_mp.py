"""The random-effect dataset built across processes: entity planning over
every rank's rows.

The JAX package's ``game/data_mp.py`` on the port. Reference: the
reference's cluster-side random-effect pipeline, a size-aware partitioner
that collects (entityId -> count) to the Spark driver
(photon-api .../data/RandomEffectDatasetPartitioner.scala:117-180) and a
``partitionBy`` shuffle of every entity's rows to the executor that owns it,
followed by per-partition local dataset builds (RandomEffectDataset.scala:
255-360).

Each rank holds only the rows it read itself (its per-host row range,
padded to the share every rank holds), so the build runs in four steps:

1. **Planning exchange** (host, small): every rank's local ``(entity id,
   count)`` table, its rows' widest feature count and its padded share are
   gathered (``parallel.multihost.allgather_object``); every rank merges
   them alike into the same ``_EntityPlan`` (size-sorted entity order, block
   capacity K, weight rescales) as the single-process build's.
2. **The shuffle**: each row of a kept entity goes to the rank that owns the
   entity's block (``parallel.mesh.entity_range``), packed into one int64
   row (its padded global row id, its reservoir priority, its block, its ELL
   columns and the bits of its label, offset, rescaled weight and ELL
   values) and moved by one ``torch.distributed.all_to_all_single`` (gloo
   on host tensors, NCCL on the card).
3. **Active selection and projection on the owner** (host numpy, the
   single-process build's code on the rank's entity range): the rows sorted
   as ``np.lexsort((priority, entity))`` sorts them (the padded global row
   id breaks ties, as the true row id does in one process: the map between
   them keeps order), the first K of each entity active, each entity's
   rows projected onto its feature subspace; Pearson selection in float64
   on the 1e-12 grid. The subspace width S is the maximum over every
   rank's entities (gathered), so that every rank's blocks have one shape.
4. **Assembly**: the rank's blocks on its device, the whole support layout
   (``host_proj_cols``), entity counts and subspace dims on every rank; the
   scoring arrays (``row_entity``, ``ell_idx``, ``ell_val``) over the rank's
   own padded rows (``local_rows``: scores gather every rank's).

The reservoir priorities hash the TRUE global row id (``raw.global_row_start``
is required over several processes), so the active sets are the single-
process build's; block rows (``active_rows``) and passive rows carry PADDED
global row ids: rank r's row i is ``r * share + i``. The plan, reservoir
order and block contents, keyed by entity id, are the single-process
build's bit for bit (tests/test_torch_re_build.py).

Counters in the obs registry: ``photon_re_build_rows{coordinate,process}``
(true local rows), ``photon_re_build_local_entities{coordinate,process}``,
``photon_re_build_global_entities{coordinate}``,
``photon_re_build_shuffled_rows{coordinate,process}`` (rows this rank
received) and ``photon_re_build_seconds{coordinate,process}``.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from ..io.data import RawDataset
from ..parallel import multihost
from ..parallel.mesh import entity_range
from .data import (
    EntityBlocks,
    RandomEffectDataset,
    _entity_plan,
    _hash64,
    _pearson_keep_mask,
    _rows_to_ell,
    _to_device,
)

# the int64 columns of a shuffled row before its F ELL columns: padded
# global row id, reservoir priority (uint64 bits), block; after them the
# float64 bits of label, offset and rescaled weight, then F ELL values
_HEAD = 3
_TAIL = 3


def build_random_effect_dataset_global(
    raw: RawDataset,
    coordinate_id: str,
    feature_shard: str,
    random_effect_type: str,
    group,
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
    """A ``RandomEffectDataset`` over every rank's rows, built from this
    rank's ``raw`` (its row range, padded to the share every rank holds).

    ``group`` is this rank's ``parallel.mesh.DataParallelGroup``; the
    entity count pads to a multiple of both ``pad_entities_to_multiple`` and
    the world size, and the rank keeps its ``entity_range`` of the blocks on
    ``device``. The other arguments are ``build_random_effect_dataset``'s.
    A budget (``hbm_budget_bytes``) over processes is ROADMAP A10."""
    from ..plan.planner import A10, not_ported

    if hbm_budget_bytes is not None:
        raise not_ported(f"coordinate {coordinate_id}: hbm_budget_mb over several processes", A10)
    world, rank = group.world_size, group.rank
    if world > 1 and raw.global_row_start is None:
        raise ValueError(
            "the multi-process random-effect build requires raw.global_row_start (this process's first "
            "global row): without it every process would hash reservoir priorities from row 0 and the "
            "active sets would silently diverge; set it from multihost.host_row_range"
        )
    t0 = time.perf_counter()
    dev = resolve_device(device)
    n_local = raw.n_rows
    true_local = raw.true_rows if raw.true_rows is not None else raw.n_rows
    g_start = raw.global_row_start or 0
    d_shard = raw.shard_dims[feature_shard]
    rows, cols, vals = raw.shard_coo[feature_shard]

    # --- 1. the planning exchange (host, small) ------------------------------
    ids_arr = np.asarray(raw.id_tags[random_effect_type][:true_local]).astype(str)
    uniq_l, inv_l = np.unique(ids_arr, return_inverse=True)
    counts_l = np.bincount(inv_l, minlength=len(uniq_l)).astype(np.int64)
    nnz_rows = np.bincount(rows, minlength=n_local) if len(rows) else np.zeros(1, np.int64)
    f_local = max(int(nnz_rows.max()) if n_local else 1, 1)
    tables = multihost.allgather_object((uniq_l, counts_l, f_local, n_local))
    shares = {t[3] for t in tables}
    if len(shares) != 1:
        raise ValueError(
            f"every rank must hold the same padded share of rows (RawDataset.pad_rows(equal_host_share(N))); "
            f"got {[t[3] for t in tables]}"
        )
    F = max(t[2] for t in tables)
    uniq, inv_m = np.unique(np.concatenate([t[0] for t in tables]), return_inverse=True)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(counts, inv_m, np.concatenate([t[1] for t in tables]))

    pad = pad_entities_to_multiple * world // math.gcd(pad_entities_to_multiple, world)
    plan = _entity_plan(counts, active_lower_bound, active_cap, pad)
    E_real, E, K = plan.E_real, plan.E, plan.K
    lo, hi = entity_range(E, group)
    E_loc = hi - lo

    # --- 2. this rank's rows, packed and sent to their entities' owners ------
    local_block = plan.old_to_block[np.searchsorted(uniq, ids_arr)] if true_local else np.zeros(0, np.int64)
    row_ids = np.arange(true_local, dtype=np.int64)
    priority = _hash64(g_start + row_ids, seed)
    ell_idx_l, ell_val_l = _rows_to_ell(rows, cols, vals, n_local, width=F)
    kept = np.nonzero(local_block >= 0)[0]
    block = local_block[kept]
    weights = raw.weights[kept] * plan.weight_scale[block]
    packed = np.concatenate(
        [
            np.stack([rank * n_local + kept, priority[kept].view(np.int64), block], axis=1),
            ell_idx_l[kept].astype(np.int64),
            np.stack([raw.labels[kept], raw.offsets[kept], weights], axis=1).astype(np.float64).view(np.int64),
            ell_val_l[kept].view(np.int64),
        ],
        axis=1,
    )
    owner = block // max(E // world, 1)
    order = np.argsort(owner, kind="stable")
    packed = packed[order]
    send = np.bincount(owner, minlength=world).astype(np.int64)
    received = _shuffle(packed, send, group)

    # --- 3. active selection and projection on the owner (host numpy) --------
    pid, rblock = received[:, 0], received[:, 2] - lo
    prio = np.ascontiguousarray(received[:, 1]).view(np.uint64)
    r_idx = received[:, _HEAD : _HEAD + F].astype(np.int64)
    fl = np.ascontiguousarray(received[:, _HEAD + F :]).view(np.float64)
    r_label, r_offset, r_weight, r_val = fl[:, 0], fl[:, 1], fl[:, 2], fl[:, _TAIL:]
    # np.lexsort((priority, entity)) of the one-process build; the padded
    # global row id keeps the true rows' order, so it breaks ties as the
    # one-process build's position does
    order = np.lexsort((pid, prio, rblock))
    s_block = rblock[order]
    starts = np.searchsorted(s_block, np.arange(E_loc))
    rank_in = np.arange(len(order)) - starts[np.clip(s_block, 0, max(E_loc - 1, 0))]
    is_active = rank_in < K
    sel = order[is_active]
    ae, ak = s_block[is_active], rank_in[is_active]
    active_rows_np = np.full((E_loc, K), -1, dtype=np.int64)
    active_rows_np[ae, ak] = pid[sel]
    local_passive = pid[order[~is_active]]

    labels_b = np.zeros((E_loc, K))
    offsets_b = np.zeros((E_loc, K))
    weights_b = np.zeros((E_loc, K))
    labels_b[ae, ak] = r_label[sel]
    offsets_b[ae, ak] = r_offset[sel]
    weights_b[ae, ak] = r_weight[sel]

    fi, fv = r_idx[sel], r_val[sel]  # [A, F] global columns and values of the active rows
    nz = fv != 0.0
    keys = ae[:, None].astype(np.int64) * d_shard + fi
    uniq_keys = np.unique(keys[nz])
    ent_of_key = (uniq_keys // d_shard).astype(np.int64)
    col_of_key = (uniq_keys % d_shard).astype(np.int32)
    per_entity_s = np.bincount(ent_of_key, minlength=E_loc).astype(np.int64)
    # one block width on every rank: the widest subspace of any entity
    S = max(max(multihost.allgather_object(int(per_entity_s.max()) if len(uniq_keys) else 1)), 1)
    key_starts = np.concatenate([[0], np.cumsum(per_entity_s)[:-1]]).astype(np.int64)
    pos_within = np.arange(len(uniq_keys)) - key_starts[ent_of_key]
    proj_cols_np = np.full((E_loc, S), -1, dtype=np.int32)
    proj_cols_np[ent_of_key, pos_within] = col_of_key
    feats = np.zeros((E_loc, K, S), dtype=np.float64)
    aa, ff = np.nonzero(nz)
    loc = np.searchsorted(uniq_keys, keys[aa, ff]) - key_starts[ae[aa]]
    feats[ae[aa], ak[aa], loc] = fv[aa, ff]

    if features_to_samples_ratio is not None:
        _require_wide_dtype(feats)
        keep = _pearson_keep_mask(feats, labels_b, active_rows_np >= 0, proj_cols_np, features_to_samples_ratio)
        order_c = np.argsort(~keep, axis=1, kind="stable")
        proj_cols_np = np.take_along_axis(np.where(keep, proj_cols_np, -1), order_c, axis=1)
        feats = np.take_along_axis(np.where(keep[:, None, :], feats, 0.0), order_c[:, None, :], axis=2)
        per_entity_s = keep.sum(axis=1).astype(np.int64)
        S = max(max(multihost.allgather_object(int(per_entity_s.max()) if E_loc else 0)), 1)
        proj_cols_np = proj_cols_np[:, :S]
        feats = feats[:, :, :S]

    # --- 4. the whole tables on every rank, this rank's blocks on its device -
    whole = multihost.allgather_object(
        (proj_cols_np, per_entity_s, np.sum(active_rows_np >= 0, axis=1).astype(np.int64), local_passive)
    )
    host_proj_cols = np.concatenate([w[0] for w in whole])
    entity_subspace_dims = np.concatenate([w[1] for w in whole])
    entity_counts = np.concatenate([w[2] for w in whole])
    passive_rows = np.sort(np.concatenate([w[3] for w in whole]))

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
    row_entity = np.full(n_local, -1, dtype=np.int32)
    row_entity[:true_local] = local_block
    kept_ids = uniq[plan.kept_entities].astype(str)
    entity_ids = np.concatenate(
        [kept_ids, np.asarray([f"__pad{i}" for i in range(E - E_real)], dtype=object)]
    ) if E > E_real else kept_ids

    reg = obs.current_run().registry
    proc = str(rank)
    reg.gauge("photon_re_build_rows", "true (unpadded) local rows per process").labels(
        coordinate=coordinate_id, process=proc).set(true_local)
    reg.gauge("photon_re_build_local_entities", "distinct local entities per process").labels(
        coordinate=coordinate_id, process=proc).set(len(uniq_l))
    reg.gauge("photon_re_build_global_entities", "kept entities in the merged plan").labels(
        coordinate=coordinate_id).set(E_real)
    reg.gauge("photon_re_build_shuffled_rows", "rows of kept entities this process received in the shuffle").labels(
        coordinate=coordinate_id, process=proc).set(len(received))
    reg.gauge("photon_re_build_seconds", "wall seconds of this process's random-effect build").labels(
        coordinate=coordinate_id, process=proc).set(time.perf_counter() - t0)

    return RandomEffectDataset(
        coordinate_id=coordinate_id,
        feature_shard=feature_shard,
        random_effect_type=random_effect_type,
        entity_ids=entity_ids.astype(object),
        blocks=blocks,
        row_entity=_to_device(row_entity, torch.int32, dev),
        ell_idx=_to_device(ell_idx_l, torch.int32, dev),
        ell_val=_to_device(ell_val_l, fdt, dev),
        passive_rows=passive_rows,
        entity_counts=entity_counts,
        entity_subspace_dims=entity_subspace_dims,
        host_proj_cols=host_proj_cols,
        group=group,
        local_rows=True,
    )


def _shuffle(packed: np.ndarray, send: np.ndarray, group) -> np.ndarray:
    """Every rank's packed rows for this rank's entities, in rank order: one
    ``all_to_all_single`` over the default group (its split sizes first, by
    an object gather). ``packed`` is ordered by destination rank, ``send``
    the row count for each. One rank: ``packed`` itself."""
    if group.world_size == 1:
        return packed
    import torch.distributed as dist

    width = packed.shape[1]
    all_send = multihost.allgather_object(send)
    recv = np.asarray([s[group.rank] for s in all_send], dtype=np.int64)
    buf_dev = group.device if group.backend == "nccl" else torch.device("cpu")
    src = torch.from_numpy(np.ascontiguousarray(packed).reshape(-1)).to(buf_dev)
    out = torch.empty(int(recv.sum()) * width, dtype=torch.int64, device=buf_dev)
    dist.all_to_all_single(
        out, src, output_split_sizes=(recv * width).tolist(), input_split_sizes=(send * width).tolist(),
        group=group.process_group,
    )
    return out.cpu().numpy().reshape(-1, width)


def _require_wide_dtype(feats: np.ndarray) -> None:
    """Pearson selection ranks |score| quantized to a 1e-12 grid, below
    float32's resolution: it runs on float64 host arrays only (the JAX
    package refuses without x64 for the same reason)."""
    if feats.dtype != np.float64:
        raise ValueError(
            "features_to_samples_ratio on the multi-process build needs float64 scores: the 1e-12 tie-break "
            f"grid is below the resolution of {feats.dtype}"
        )
