"""Data readers: Avro training examples and LIBSVM text into the columnar
host dataset that device batches are built from.

The JAX package's ``io/data.py``, copied: the reference's AvroDataReader
(photon-client .../data/avro/AvroDataReader.scala:54-490) decodes Avro rows
into one sparse-vector column per *feature shard*, where a shard is the
union of several *feature bags* (record fields holding FeatureAvro arrays),
each feature identified by (name, term) and mapped through an IndexMap, with
an intercept injected per shard (AvroDataReader.scala:336-338).

The product is a host-side columnar ``RawDataset`` (numpy COO per shard plus
labels, offsets, weights, uids and id tags) that ``to_batch`` turns into a
``LabeledBatch`` on the card. Sample order is fixed at read time. Both the
modern ``TrainingExampleAvro`` and the legacy metronome ``TrainingExample``
shapes read (unions of numeric types for label, weight and offset; optional
term).

Two decode engines: the native C++ columnar decoder (``native``) and the
pure-Python codec (``io/avro.py``); ``DECODED_PARTS`` counts the part files
each engine decoded, so a run can show which one ran. The chunked reader
records the JAX package's ingest metrics (``photon_ingest_*``) and spans
(``ingest.chunked``, ``ingest.decode``) in the ``obs`` registry.
``to_batch(layout="tiled", mesh=...)`` builds a rank's tile of the
(data x model)-tiled sparse layout (``parallel/sparse.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike

from .avro import iter_avro_directory, read_avro_file
from .columns import (
    META_DATA_MAP,
    OFFSET,
    RESPONSE,
    UID,
    WEIGHT,
    InputColumnsNames,
)
from .index_map import INTERCEPT_KEY, IndexMap, feature_key

logger = logging.getLogger("photon_ml_tpu_torch")

ENGINES = ("native", "python")
# part files decoded, by engine (chunks of one part count once)
DECODED_PARTS = {e: 0 for e in ENGINES}


def reset_decoded_parts() -> None:
    for k in DECODED_PARTS:
        DECODED_PARTS[k] = 0



@dataclasses.dataclass(frozen=True)
class FeatureShardConfig:
    """Which feature-bag columns feed a shard, and whether to add an intercept
    (reference: FeatureShardConfiguration, GameDriver feature-shard params)."""

    feature_bags: Tuple[str, ...]
    has_intercept: bool = True


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
    # multi-process provenance: this process's rows are global rows
    # [global_row_start, global_row_start + true_rows); rows beyond true_rows
    # are zero-weight equal-share padding (pad_rows)
    global_row_start: Optional[int] = None
    true_rows: Optional[int] = None

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

    def pad_rows(self, target: int) -> "RawDataset":
        """Zero-weight-pad to `target` rows (empty features, label/offset 0):
        equalizes per-host shares in multi-process mode so every process
        contributes the same local shape to the global arrays."""
        if target <= self.n_rows:
            return self
        extra = target - self.n_rows
        return RawDataset(
            n_rows=target,
            labels=np.concatenate([self.labels, np.zeros(extra)]),
            offsets=np.concatenate([self.offsets, np.zeros(extra)]),
            weights=np.concatenate([self.weights, np.zeros(extra)]),
            shard_coo=dict(self.shard_coo),
            shard_dims=dict(self.shard_dims),
            id_tags={
                t: np.concatenate([v, np.full(extra, "", dtype=object)])
                for t, v in self.id_tags.items()
            },
            uids=None
            if self.uids is None
            else np.concatenate([self.uids, np.full(extra, None, dtype=object)]),
            global_row_start=self.global_row_start,
            true_rows=self.n_rows if self.true_rows is None else self.true_rows,
        )

    def to_batch(
        self,
        shard: str,
        dtype=torch.float32,
        layout: str = "auto",
        feature_dtype=None,
        device: DeviceLike = None,
        mesh=None,
    ):
        """Build a ``LabeledBatch`` of one feature shard on ``device`` (the
        card unless asked otherwise).

        layout: 'auto' (dense when d <= 4096, else ELL) | 'dense' | 'ell'
        (alias 'sparse': row-major padded sparse, moderate d) | 'coo'
        (column-sorted COO, huge d) | 'tiled' ((data x model)-tiled sparse,
        huge d sharded over the ranks of ``mesh``, a
        ``parallel.mesh.MeshGroup``: this rank's tile on the mesh's device;
        see parallel/sparse.py). A dataset read per host
        (``global_row_start`` set) holds its data row's rows, else every
        rank holds the whole batch and keeps its block. ``feature_dtype``
        (e.g. bfloat16) stores only the feature values narrower (not on the
        tiled layout); labels, offsets and weights stay ``dtype``."""
        from ..ops.features import batch_from_coo, batch_from_dense

        rows, cols, vals = self.shard_coo[shard]
        d = self.shard_dims[shard]
        if layout == "auto":
            layout = "dense" if d <= 4096 else "ell"
        if feature_dtype is not None and layout == "tiled":
            raise ValueError(
                "feature_dtype is not supported on the tiled layout "
                "(shard_map value arrays stay in the solve dtype)"
            )
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
            if mesh is None:
                raise ValueError("layout='tiled' requires a device mesh")
            from ..parallel.sparse import tiled_sparse_batch

            return tiled_sparse_batch(
                rows, cols, vals, self.labels, d, mesh, offsets=self.offsets, weights=self.weights, dtype=dtype,
                local=self.global_row_start is not None,
            )
        raise ValueError(f"unknown batch layout {layout!r}: expected auto|dense|ell|sparse|coo|tiled")


def _num(v, default: float) -> float:
    return default if v is None else float(v)


def _collect_bag(
    rec: dict, bag: str
) -> Iterable[Tuple[str, float]]:
    for f in rec.get(bag) or ():
        term = f.get("term")
        yield feature_key(f["name"], "" if term is None else str(term)), float(f["value"])


def build_index_maps(
    records: Sequence[dict],
    shard_configs: Mapping[str, FeatureShardConfig],
) -> Dict[str, IndexMap]:
    """One pass over the data: distinct feature keys per shard -> IndexMap
    (the in-memory path of FeatureIndexingDriver / DefaultIndexMapLoader)."""
    keys: Dict[str, set] = {s: set() for s in shard_configs}
    for rec in records:
        for shard, cfg in shard_configs.items():
            bucket = keys[shard]
            for bag in cfg.feature_bags:
                for key, _ in _collect_bag(rec, bag):
                    bucket.add(key)
    return {
        s: IndexMap.from_keys(keys[s], add_intercept=shard_configs[s].has_intercept)
        for s in shard_configs
    }


def records_to_dataset(
    records: Sequence[dict],
    shard_configs: Mapping[str, FeatureShardConfig],
    index_maps: Mapping[str, IndexMap],
    id_tag_columns: Sequence[str] = (),
    response_column: str = "label",
    columns: Optional[InputColumnsNames] = None,
) -> RawDataset:
    """Decode Avro records into a RawDataset (AvroDataReader.readMerged
    semantics: bags merged per shard, name+term -> index, intercept injected,
    unknown features dropped). ``columns`` remaps the reserved uid/response/
    offset/weight/metadataMap field names (InputColumnsNames.scala:29-106);
    an explicit response remap takes precedence over response_column,
    otherwise lookup order is response_column, 'response'."""
    col_names = columns or InputColumnsNames()
    n = len(records)
    labels = np.zeros(n, dtype=np.float64)
    offsets = np.zeros(n, dtype=np.float64)
    weights = np.ones(n, dtype=np.float64)
    uids: List[Optional[str]] = []
    tags: Dict[str, List] = {t: [] for t in id_tag_columns}
    coo: Dict[str, Tuple[List[int], List[int], List[float]]] = {
        s: ([], [], []) for s in shard_configs
    }

    # an explicit response remap outranks the response_column default, so a
    # stray field named 'label' can't shadow the remapped response
    response_remapped = columns is not None and col_names[RESPONSE] != RESPONSE
    for i, rec in enumerate(records):
        if response_remapped:
            label = rec.get(col_names[RESPONSE])
            if label is None:
                label = rec.get(response_column)
        else:
            label = rec.get(response_column)
            if label is None:
                label = rec.get(col_names[RESPONSE])
        if label is None:
            label = rec.get("response")
        labels[i] = _num(label, 0.0)
        offsets[i] = _num(rec.get(col_names[OFFSET]), 0.0)
        weights[i] = _num(rec.get(col_names[WEIGHT]), 1.0)
        uid = rec.get(col_names[UID])
        uids.append(None if uid is None else str(uid))
        meta = rec.get(col_names[META_DATA_MAP]) or {}
        for t in id_tag_columns:
            v = rec.get(t)
            if v is None:
                v = meta.get(t)
            tags[t].append("" if v is None else str(v))

        for shard, cfg in shard_configs.items():
            imap = index_maps[shard]
            rows, cols, vals = coo[shard]
            for key, value in _merge_bags(rec, cfg.feature_bags):
                j = imap.get_index(key)
                if j >= 0:
                    rows.append(i)
                    cols.append(j)
                    vals.append(value)
            if cfg.has_intercept:
                j = imap.get_index(INTERCEPT_KEY)
                if j >= 0:
                    rows.append(i)
                    cols.append(j)
                    vals.append(1.0)

    return RawDataset(
        n_rows=n,
        labels=labels,
        offsets=offsets,
        weights=weights,
        shard_coo={
            s: (
                np.asarray(r, dtype=np.int64),
                np.asarray(c, dtype=np.int64),
                np.asarray(v, dtype=np.float64),
            )
            for s, (r, c, v) in coo.items()
        },
        shard_dims={s: len(index_maps[s]) for s in shard_configs},
        id_tags={t: np.asarray(v, dtype=object) for t, v in tags.items()},
        uids=np.asarray(uids, dtype=object),
    )


def _merge_bags(rec: dict, bags: Tuple[str, ...]) -> Iterable[Tuple[str, float]]:
    """Merge bag columns; duplicate (name, term) keys within a row keep the
    last value (the reference declares duplicates undefined behavior). Dedup
    applies in the single-bag case too so dense and ELL layouts agree."""
    merged: Dict[str, float] = {}
    for bag in bags:
        for k, v in _collect_bag(rec, bag):
            merged[k] = v
    yield from merged.items()


def read_avro_dataset(
    path: Union[str, Sequence[str]],
    shard_configs: Mapping[str, FeatureShardConfig],
    index_maps: Optional[Mapping[str, IndexMap]] = None,
    id_tag_columns: Sequence[str] = (),
    response_column: str = "label",
    columns: Optional[InputColumnsNames] = None,
    reader_schema=None,
    row_range: Optional[Tuple[int, int]] = None,
    part_counts: Optional[Mapping[str, int]] = None,
    engine: str = "auto",
    workers: Optional[int] = None,
) -> Tuple[RawDataset, Dict[str, IndexMap]]:
    """Read Avro file(s)/directories into a RawDataset, building index maps
    from the data when not supplied (DefaultIndexMapLoader path). ``path``
    may be a list (e.g. date-ranged day directories); ``reader_schema``
    resolves evolved writer data into the expected shape.

    ``row_range=(start, stop)`` reads only that global row window across the
    concatenated part files (per-host input split for the multi-process
    runtime; blocks outside the window are skipped without decode). Index
    maps must be prebuilt in that mode — a host-local map would disagree
    across hosts. ``part_counts`` (part path -> row count) skips the
    per-part header scan when the caller already counted.

    ``engine``: 'auto' uses the native C++ columnar decoder
    (``native``) when it is available and the request fits it
    (no reader_schema), falling back to the pure-Python codec; 'native'
    requires it; 'python' forces the fallback. ``workers``: the native
    engine's decode threads per part (default ``PHOTON_DECODE_THREADS`` or
    the core count); the output does not depend on it."""
    paths = [path] if isinstance(path, str) else list(path)
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "native" and reader_schema is not None:
        raise ValueError(
            "engine='native' does not support reader_schema resolution"
        )
    if row_range is not None and index_maps is None:
        raise ValueError(
            "row_range reading requires prebuilt index_maps (a host-local "
            "index map would be inconsistent across hosts); run the "
            "feature-indexing driver first"
        )
    if engine != "python" and reader_schema is None:
        out = None
        try:
            out = _native_read(
                paths, shard_configs, index_maps, id_tag_columns,
                response_column, columns, row_range, part_counts, workers,
            )
        except Exception:
            if engine == "native":
                raise
            logger.warning(
                "native Avro decode failed; falling back to Python codec",
                exc_info=True,
            )
        if out is not None:
            return out
        if engine == "native":
            raise RuntimeError("native decoder unavailable (no g++/zlib?)")
    if row_range is None:
        from .avro import list_avro_parts

        DECODED_PARTS["python"] += sum(len(list_avro_parts(p)) for p in paths)
        records = [r for p in paths for r in iter_avro_directory(p, reader_schema)]
    else:
        from .avro import parse_schema

        if reader_schema is not None and not isinstance(reader_schema, tuple):
            reader_schema = parse_schema(reader_schema)
        records = []
        for part, window in _iter_part_windows(paths, row_range, part_counts):
            DECODED_PARTS["python"] += 1
            records.extend(
                read_avro_file(part, reader_schema, row_range=window)[1]
            )
    if index_maps is None:
        index_maps = build_index_maps(records, shard_configs)
    ds = records_to_dataset(
        records, shard_configs, index_maps, id_tag_columns, response_column,
        columns=columns,
    )
    return ds, dict(index_maps)


def _concat_raw(pieces: Sequence[RawDataset]) -> RawDataset:
    """Stitch per-part RawDatasets in part order (row indices re-offset)."""
    if len(pieces) == 1:
        return pieces[0]
    row0 = np.cumsum([0] + [p.n_rows for p in pieces])
    shard_coo = {
        s: (
            np.concatenate(
                [p.shard_coo[s][0] + row0[i] for i, p in enumerate(pieces)]
            ),
            np.concatenate([p.shard_coo[s][1] for p in pieces]),
            np.concatenate([p.shard_coo[s][2] for p in pieces]),
        )
        for s in pieces[0].shard_coo
    }
    return RawDataset(
        n_rows=int(row0[-1]),
        labels=np.concatenate([p.labels for p in pieces]),
        offsets=np.concatenate([p.offsets for p in pieces]),
        weights=np.concatenate([p.weights for p in pieces]),
        shard_coo=shard_coo,
        shard_dims=dict(pieces[0].shard_dims),
        id_tags={
            t: np.concatenate([p.id_tags[t] for p in pieces])
            for t in pieces[0].id_tags
        },
        uids=None
        if pieces[0].uids is None
        else np.concatenate([p.uids for p in pieces]),
    )


def resolve_ingest_workers(workers: Optional[Union[int, str]] = None) -> int:
    """Effective decode-pool size: ``None``/``0``/``"auto"`` sizes to the
    host (``cpu_count - 2``, min 1 — leave the consumer thread and the
    thread that launches the card's work a core each); explicit counts pass through, min 1."""
    if workers in (None, 0, "auto"):
        return max(1, (os.cpu_count() or 1) - 2)
    w = int(workers)
    if w < 1:
        raise ValueError(f"ingest workers must be >= 1: {workers!r}")
    return w


def _pipeline_parts(
    parts: Sequence[str],
    reader_schema,
    consume,
    *,
    prefetch_depth: int = 2,
    workers: Optional[Union[int, str]] = None,
    pool=None,
    ingest_budget_bytes: Optional[int] = None,
) -> None:
    """Decode ``parts`` across the ingest worker pool and hand each part's
    record list to ``consume(part_index, records)`` in file order.

    The shared engine under :func:`read_avro_dataset_chunked` and
    :func:`read_avro_part_pieces`: an N-worker
    :class:`~photon_ml_tpu_torch.utils.futures.PrefetchQueue` decodes parts
    concurrently, the sequencer re-emits them in file order (bit-stable row
    order at any worker count), and ``ingest_budget_bytes`` bounds the parts
    in flight (queued + held + being-decoded) by compressed on-disk size.
    Emits ``photon_ingest_decode_seconds{worker=}``,
    ``photon_ingest_queue_depth`` and
    ``photon_ingest_budget_stalls_total``, and an ``ingest.decode`` span a
    part."""
    from .. import obs
    from ..utils.futures import PrefetchQueue

    n_workers = resolve_ingest_workers(workers)
    reg = obs.current_run().registry
    depth_gauge = reg.gauge(
        "photon_ingest_queue_depth",
        "decoded parts waiting in the chunked reader's prefetch queue",
    )
    decode_hist = reg.histogram(
        "photon_ingest_decode_seconds",
        "per-part decode wall inside the ingest worker pool",
    )
    stall_counter = reg.counter(
        "photon_ingest_budget_stalls_total",
        "part decodes deferred because in-flight bytes hit the ingest budget",
    )
    # workers run off the consumer thread: anchor their spans explicitly
    # (contextvar span ancestry does not cross threads)
    anchor = obs.current_span()

    def _decode(i: int):
        part = parts[i]
        with obs.span("ingest.decode", parent=anchor, part=os.path.basename(part)) as sp:
            records = read_avro_file(part, reader_schema)[1]
        decode_hist.labels(worker=threading.current_thread().name).observe(sp.duration_s)
        return records

    # depth >= workers so every worker can hold one part in flight;
    # at workers=1 this is exactly the pre-pool depth (max(2, 1) == 2)
    depth = max(prefetch_depth, n_workers)
    part_cost = (
        (lambda i: os.path.getsize(parts[i]))
        if ingest_budget_bytes is not None
        else None
    )
    q = PrefetchQueue(
        _decode, len(parts), depth=depth,
        cost=part_cost, budget=ingest_budget_bytes,
        name="photon-bg-decode", workers=n_workers, pool=pool,
    )
    try:
        for i in range(len(parts)):
            idx, records = q.get()
            if idx != i:
                raise RuntimeError("chunked reader prefetch out of order")
            DECODED_PARTS["python"] += 1
            depth_gauge.labels(mode="chunked").set(q.qsize())
            consume(i, records)
            del records
    finally:
        # close first: a metrics-label error must not leave the queue's
        # worker threads running (budget_stalls stays readable after close)
        q.close()
        stall_counter.labels(mode="chunked").inc(q.budget_stalls)


def scan_index_maps_pipelined(
    parts: Sequence[str],
    shard_configs: Mapping[str, FeatureShardConfig],
    reader_schema=None,
    *,
    prefetch_depth: int = 2,
    workers: Optional[Union[int, str]] = None,
    pool=None,
    ingest_budget_bytes: Optional[int] = None,
) -> Dict[str, IndexMap]:
    """Keys-only pooled pass over ``parts``: build the identical index maps
    the monolithic reader would, at bounded record residency."""
    keys: Dict[str, set] = {s: set() for s in shard_configs}

    def _scan(_i, records) -> None:
        for rec in records:
            for shard, cfg in shard_configs.items():
                bucket = keys[shard]
                for bag in cfg.feature_bags:
                    for key, _ in _collect_bag(rec, bag):
                        bucket.add(key)

    _pipeline_parts(
        parts, reader_schema, _scan, prefetch_depth=prefetch_depth,
        workers=workers, pool=pool, ingest_budget_bytes=ingest_budget_bytes,
    )
    return {
        s: IndexMap.from_keys(
            keys[s], add_intercept=shard_configs[s].has_intercept
        )
        for s in shard_configs
    }


def read_avro_part_pieces(
    path: Union[str, Sequence[str]],
    shard_configs: Mapping[str, FeatureShardConfig],
    consume,
    index_maps: Mapping[str, IndexMap],
    id_tag_columns: Sequence[str] = (),
    response_column: str = "label",
    columns: Optional[InputColumnsNames] = None,
    reader_schema=None,
    prefetch_depth: int = 2,
    workers: Optional[Union[int, str]] = None,
    pool=None,
    ingest_budget_bytes: Optional[int] = None,
) -> int:
    """Pooled decode of every part file, converted per part to a
    :class:`RawDataset` piece and handed to ``consume(part_index, piece)``
    in file order; pieces are NEVER concatenated, so peak residency is one
    piece plus the decode pipeline. The building block of the disk→slice
    streamed fixed-effect path (``game/data.build_fixed_effect_dataset_from_disk``).
    Requires prebuilt ``index_maps`` (build them with
    :func:`scan_index_maps_pipelined` or ``cli.index``). Returns the part
    count."""
    from .avro import list_avro_parts, parse_schema

    paths = [path] if isinstance(path, str) else list(path)
    if reader_schema is not None and not isinstance(reader_schema, tuple):
        reader_schema = parse_schema(reader_schema)
    parts = [part for p in paths for part in list_avro_parts(p)]
    if not parts:
        raise ValueError(f"no .avro part files under {paths!r}")

    def _convert(i: int, records) -> None:
        consume(
            i,
            records_to_dataset(
                records, shard_configs, index_maps, id_tag_columns,
                response_column, columns=columns,
            ),
        )

    _pipeline_parts(
        parts, reader_schema, _convert, prefetch_depth=prefetch_depth,
        workers=workers, pool=pool, ingest_budget_bytes=ingest_budget_bytes,
    )
    return len(parts)


def read_avro_dataset_chunked(
    path: Union[str, Sequence[str]],
    shard_configs: Mapping[str, FeatureShardConfig],
    index_maps: Optional[Mapping[str, IndexMap]] = None,
    id_tag_columns: Sequence[str] = (),
    response_column: str = "label",
    columns: Optional[InputColumnsNames] = None,
    reader_schema=None,
    engine: str = "auto",
    prefetch_depth: int = 2,
    workers: Optional[Union[int, str]] = None,
    pool=None,
    ingest_budget_bytes: Optional[int] = None,
) -> Tuple[RawDataset, Dict[str, IndexMap]]:
    """``read_avro_dataset`` with bounded host RSS and pooled pipelined decode.

    The monolithic Python path decodes EVERY part file into one record list
    before any columnar conversion — peak host memory is the whole input as
    Python dicts. This reader is the training-data twin of cli/train's
    background validation decode: it walks part files through a bounded
    prefetch queue (``prefetch_depth`` parts decoding ahead, default 2)
    while the consumer converts the current part to columnar arrays, then
    frees the records. Peak record residency is ~``prefetch_depth + 1``
    parts instead of all of them, and decode wall overlaps conversion
    instead of blocking up front.

    ``workers`` fans the per-part decode across a
    :class:`~photon_ml_tpu_torch.utils.futures.WorkerPool` (``"auto"``/``None``/0
    sizes to ``cpu_count - 2``, min 1); a sequencer re-emits parts in file
    order, so output is identical at ANY worker count, and ``workers=1`` is
    bit-identical to the original single-daemon-thread reader (same decode
    order, same queue depth). Pass ``pool`` to share one pool across
    readers (cli/train shares it with the validation decode). The queue
    depth grows to ``max(prefetch_depth, workers)`` so every worker can hold
    a part in flight. ``ingest_budget_bytes`` bounds the decoded parts in
    flight (queued + held + being-decoded) by each part's compressed
    on-disk size — a deliberately conservative RSS proxy (decoded records
    are larger).

    When index maps are not supplied, a keys-only first pass (same bounded
    residency) builds the identical maps the monolithic reader would, at the
    cost of decoding twice — prebuild maps to avoid the second sweep.

    The native C++ engine already decodes per-part/per-block into columnar
    chunks without a record list, so eligible requests delegate to
    ``read_avro_dataset``, with ``workers`` threads decoding each part's
    blocks (sized as above). Identical output to ``read_avro_dataset`` in
    all cases (part order is preserved, so row order matches bit-for-bit).
    """
    from .. import obs
    from .avro import list_avro_parts

    paths = [path] if isinstance(path, str) else list(path)
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    n_parts = sum(len(list_avro_parts(p)) for p in paths)
    with obs.span("ingest.chunked", n_parts=n_parts):
        ds, maps = _read_chunked(
            paths, shard_configs, index_maps, id_tag_columns, response_column, columns,
            reader_schema, prefetch_depth, workers, pool, ingest_budget_bytes, engine,
        )
    reg = obs.current_run().registry
    reg.counter(
        "photon_ingest_parts_total", "part files decoded by the chunked reader"
    ).labels(mode="chunked").inc(n_parts)
    reg.counter(
        "photon_ingest_rows_total", "rows produced by the chunked reader"
    ).labels(mode="chunked").inc(ds.n_rows)
    return ds, maps


def _read_chunked(
    paths, shard_configs, index_maps, id_tag_columns, response_column, columns,
    reader_schema, prefetch_depth, workers, pool, ingest_budget_bytes, engine,
):
    if engine != "python" and reader_schema is None:
        from .. import native

        if engine == "native" or native.available():
            return read_avro_dataset(
                paths, shard_configs, index_maps=index_maps,
                id_tag_columns=id_tag_columns,
                response_column=response_column, columns=columns,
                engine=engine, workers=resolve_ingest_workers(workers),
            )

    from .avro import list_avro_parts, parse_schema

    if prefetch_depth < 1:
        raise ValueError(f"prefetch_depth must be >= 1: {prefetch_depth}")
    resolve_ingest_workers(workers)  # validate before any decode starts
    if reader_schema is not None and not isinstance(reader_schema, tuple):
        reader_schema = parse_schema(reader_schema)
    parts = [part for p in paths for part in list_avro_parts(p)]
    if len(parts) <= 1:
        # nothing to pipeline over — one shot through the monolithic reader
        return read_avro_dataset(
            paths, shard_configs, index_maps=index_maps,
            id_tag_columns=id_tag_columns, response_column=response_column,
            columns=columns, reader_schema=reader_schema, engine="python",
        )

    if index_maps is None:
        index_maps = scan_index_maps_pipelined(
            parts, shard_configs, reader_schema,
            prefetch_depth=prefetch_depth, workers=workers, pool=pool,
            ingest_budget_bytes=ingest_budget_bytes,
        )

    pieces: List[RawDataset] = []

    def _convert(_i: int, records) -> None:
        pieces.append(
            records_to_dataset(
                records, shard_configs, index_maps, id_tag_columns,
                response_column, columns=columns,
            )
        )

    _pipeline_parts(
        parts, reader_schema, _convert, prefetch_depth=prefetch_depth,
        workers=workers, pool=pool, ingest_budget_bytes=ingest_budget_bytes,
    )

    return _concat_raw(pieces), dict(index_maps)


# ---------------------------------------------------------------------------
# LIBSVM (dev-scripts/libsvm_text_to_trainingexample_avro.py equivalent input)
# ---------------------------------------------------------------------------


def read_libsvm(
    path: str, dim: Optional[int] = None, add_intercept: bool = True
) -> RawDataset:
    """Read LIBSVM text: ``<label> <idx>:<val> ...`` with {-1,+1} or {0,1}
    labels; 1-based or 0-based indices both handled (max index defines d)."""
    rows: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    labels: List[float] = []
    max_col = -1
    with open(path) as f:
        i = 0
        for line in f:
            parts = line.split()
            if not parts:
                continue
            y = float(parts[0])
            labels.append(1.0 if y > 0 else 0.0)
            for tok in parts[1:]:
                c, _, v = tok.partition(":")
                ci = int(c)
                rows.append(i)
                cols.append(ci)
                vals.append(float(v))
                max_col = max(max_col, ci)
            i += 1
    n = len(labels)
    d = dim if dim is not None else max_col + 1
    if add_intercept:
        for r in range(n):
            rows.append(r)
            cols.append(d)
            vals.append(1.0)
        d += 1
    imap_dim = d
    return RawDataset(
        n_rows=n,
        labels=np.asarray(labels),
        offsets=np.zeros(n),
        weights=np.ones(n),
        shard_coo={"global": (np.asarray(rows), np.asarray(cols), np.asarray(vals))},
        shard_dims={"global": imap_dim},
        id_tags={},
        uids=None,
    )


def _iter_part_windows(
    paths: Sequence[str],
    row_range: Optional[Tuple[int, int]],
    part_counts: Optional[Mapping[str, int]],
):
    """Yield (part_path, per-part window or None) covering `row_range` across
    the concatenated part files (both reader engines share this)."""
    from .avro import count_avro_rows, list_avro_parts

    if row_range is None:
        for p in paths:
            for part in list_avro_parts(p):
                yield part, None
        return
    start, stop = row_range
    offset = 0
    for p in paths:
        for part in list_avro_parts(p):
            if offset >= stop:
                return
            if part_counts is not None and part in part_counts:
                n = part_counts[part]
            else:
                n = count_avro_rows(part)
            lo, hi = max(start - offset, 0), min(stop - offset, n)
            if lo < hi:
                yield part, (lo, hi)
            offset += n


def _native_read(
    paths: Sequence[str],
    shard_configs: Mapping[str, FeatureShardConfig],
    index_maps: Optional[Mapping[str, IndexMap]],
    id_tag_columns: Sequence[str],
    response_column: str,
    columns: Optional[InputColumnsNames],
    row_range: Optional[Tuple[int, int]],
    part_counts: Optional[Mapping[str, int]],
    workers: Optional[int] = None,
) -> Optional[Tuple[RawDataset, Dict[str, IndexMap]]]:
    """C++ columnar fast path of read_avro_dataset (``native``):
    same semantics as records_to_dataset, vectorized end-to-end. Returns
    None when the native library is unavailable."""
    from .. import native, obs

    if not native.available():
        return None

    col_names = columns or InputColumnsNames()

    # sink layout (same for every part file; absent fields just stay NaN).
    # Response priority matches records_to_dataset: an explicit remap
    # outranks response_column.
    if columns is not None and col_names[RESPONSE] != RESPONSE:
        resp_order = [col_names[RESPONSE], response_column, "response"]
    else:
        resp_order = [response_column, col_names[RESPONSE], "response"]
    resp_candidates = list(dict.fromkeys(resp_order))
    num_fields = {name: i for i, name in enumerate(resp_candidates)}
    off_sink = len(num_fields)
    num_fields[col_names[OFFSET]] = off_sink
    wt_sink = off_sink + 1
    num_fields[col_names[WEIGHT]] = wt_sink

    str_fields = {col_names[UID]: 0}
    tag_sink = {}       # tag -> top-level sink
    tag_map_sink = {}   # tag -> metadataMap sink (separate: top-level wins)
    s = 1
    for t in id_tag_columns:
        if t in num_fields:
            # a tag sharing a numeric column's field name needs dynamic
            # typing; the Python codec handles it
            from ..native import ProgramError

            raise ProgramError(
                f"id tag {t!r} collides with a numeric input column"
            )
        if t in str_fields:
            tag_sink[t] = str_fields[t]  # e.g. tag == uid column: share
        else:
            str_fields[t] = s
            tag_sink[t] = s
            s += 1
    map_keys = {}
    for t in id_tag_columns:
        tag_map_sink[t] = s
        map_keys[t] = s
        s += 1

    all_bags = list(
        dict.fromkeys(b for cfg in shard_configs.values() for b in cfg.feature_bags)
    )
    bag_fields = {b: i for i, b in enumerate(all_bags)}

    # decode every part (respecting the global row window); each part decodes
    # its OCF blocks on a thread pool (native.decode_file_chunks) — the
    # chunk Columnars stitch exactly like per-file parts
    cols: List[native.Columnar] = []
    for part, window in _iter_part_windows(paths, row_range, part_counts):
        with obs.span("ingest.decode", part=os.path.basename(part), engine="native"):
            cols.extend(
                native.decode_file_chunks(
                    part, num_fields, str_fields, bag_fields, map_keys,
                    map_field=col_names[META_DATA_MAP], row_range=window,
                    n_threads=workers,
                )
            )
        DECODED_PARTS["native"] += 1

    n = sum(c.n_rows for c in cols)
    row_offsets = np.cumsum([0] + [c.n_rows for c in cols])

    def stack_num(sink: int) -> np.ndarray:
        if not cols:
            return np.empty(0)
        return np.concatenate([c.num_cols[sink] for c in cols])

    def stack_present(sink: int) -> np.ndarray:
        if not cols:
            return np.empty(0, bool)
        return np.concatenate([c.num_present[sink] for c in cols])

    # response: first PRESENT candidate, else 0.0 — presence (not NaN) is the
    # absence test, so a genuine NaN label propagates exactly like the Python
    # codec's
    labels = np.zeros(n, dtype=np.float64)
    filled = np.zeros(n, dtype=bool)
    for name in resp_candidates:
        sink = num_fields[name]
        cand = stack_num(sink)
        take = ~filled & stack_present(sink)
        labels[take] = cand[take]
        filled |= take
    offs = stack_num(off_sink)
    offs[~stack_present(off_sink)] = 0.0
    wts = stack_num(wt_sink)
    wts[~stack_present(wt_sink)] = 1.0

    def scatter_str(sink: int, default) -> np.ndarray:
        out = np.full(n, default, dtype=object)
        for ci, c in enumerate(cols):
            rows, vals = c.str_cols[sink]
            if len(rows):
                out[rows + row_offsets[ci]] = vals
        return out

    uids = scatter_str(0, None)
    id_tags = {}
    for t in id_tag_columns:
        # metadataMap first, then top-level (rec.get(t) wins over meta.get(t))
        out = scatter_str(tag_map_sink[t], "")
        for ci, c in enumerate(cols):
            rows, vals = c.str_cols[tag_sink[t]]
            if len(rows):
                out[rows + row_offsets[ci]] = vals
        id_tags[t] = out

    # per-bag global triples with keys resolved per part
    bag_triples: Dict[str, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {
        b: [] for b in all_bags
    }
    for ci, c in enumerate(cols):
        for b, bi in bag_fields.items():
            rows, kid, vals, keys = c.bags[bi]
            if len(rows):
                bag_triples[b].append((rows + row_offsets[ci], kid, vals, keys))

    building_maps = index_maps is None
    if building_maps:
        shard_keys = {}
        for shard, cfg in shard_configs.items():
            ks: set = set()
            for b in cfg.feature_bags:
                for _, _, _, keys in bag_triples[b]:
                    ks.update(keys.tolist())
            shard_keys[shard] = ks
        index_maps = {
            shard: IndexMap.from_keys(
                shard_keys[shard], add_intercept=shard_configs[shard].has_intercept
            )
            for shard in shard_configs
        }

    shard_coo = {}
    for shard, cfg in shard_configs.items():
        imap = index_maps[shard]
        rs, cs, vs = [], [], []
        for b in cfg.feature_bags:
            for rows, kid, vals, keys in bag_triples[b]:
                # vectorized key -> column: lookup only the unique keys
                key_cols = np.fromiter(
                    (imap.get_index(k) for k in keys), dtype=np.int64,
                    count=len(keys),
                )
                col_of = key_cols[kid]
                keep = col_of >= 0
                rs.append(rows[keep])
                cs.append(col_of[keep])
                vs.append(vals[keep])
        if rs:
            rows = np.concatenate(rs)
            colsv = np.concatenate(cs)
            vals = np.concatenate(vs)
            # last-wins dedupe on (row, col): bag order then input order,
            # matching _merge_bags' dict semantics
            d = len(imap)
            keys64 = rows * np.int64(d + 1) + colsv
            order = np.arange(len(keys64), dtype=np.int64)
            idx = np.lexsort((order, keys64))
            ks = keys64[idx]
            last = idx[np.r_[ks[1:] != ks[:-1], True]] if len(ks) else idx
            rows, colsv, vals = rows[last], colsv[last], vals[last]
        else:
            rows = np.empty(0, np.int64)
            colsv = np.empty(0, np.int64)
            vals = np.empty(0, np.float64)
        if cfg.has_intercept:
            j = imap.get_index(INTERCEPT_KEY)
            if j >= 0:
                rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
                colsv = np.concatenate([colsv, np.full(n, j, dtype=np.int64)])
                vals = np.concatenate([vals, np.ones(n)])
        shard_coo[shard] = (rows, colsv, vals)

    ds = RawDataset(
        n_rows=n,
        labels=labels,
        offsets=offs,
        weights=wts,
        shard_coo=shard_coo,
        shard_dims={s_: len(index_maps[s_]) for s_ in shard_configs},
        id_tags=id_tags,
        uids=uids,
    )
    return ds, dict(index_maps)
