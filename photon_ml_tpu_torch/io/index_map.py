"""Feature index maps: (name, term) feature identity -> dense column index.

Reference: photon-api .../index/IndexMap.scala + DefaultIndexMap /
PalDBIndexMap, and the NameAndTerm feature identity
(photon-client .../data/avro/NameAndTerm.scala). Feature keys concatenate
name + "\\u0001" + term; the intercept is the reserved key
"(INTERCEPT)" + "\\u0001" + "" (Constants.scala:31-42).

The in-memory map is a plain dict (DefaultIndexMap). The reference's PalDB
off-heap store exists so thousands of JVM executors can mmap one immutable
index; the analogue here is a flat binary file (sorted key blob +
offsets, written once at indexing time) that loads zero-copy via numpy — see
``save``/``load``. Index building at scale is a one-time host-side step
(SURVEY.md §2.1 P11).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..robust.atomic import atomic_write, atomic_write_json
from ..robust.retry import io_call

DELIMITER = ""
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""
INTERCEPT_KEY = INTERCEPT_NAME + DELIMITER + INTERCEPT_TERM

_MAGIC = b"PHIDX001"
_MAGIC2 = b"PHIDX002"  # key-sorted, mmap-searchable (MmapIndexMap)

# offsets and indices are stored little-endian int64 ("<q"); size every
# header read from the dtype rather than a bare 8
_I64 = np.dtype(np.int64).itemsize


def feature_key(name: str, term: str = "") -> str:
    return name + DELIMITER + term


def split_feature_key(key: str) -> Tuple[str, str]:
    name, _, term = key.partition(DELIMITER)
    return name, term


class IndexMap:
    """Immutable feature-key -> index bijection for one feature shard."""

    def __init__(self, key_to_index: Dict[str, int]):
        self._k2i = key_to_index
        self._i2k: Optional[List[str]] = None

    @property
    def size(self) -> int:
        return len(self._k2i)

    def __len__(self) -> int:
        return len(self._k2i)

    def __contains__(self, key: str) -> bool:
        return key in self._k2i

    def get_index(self, key: str) -> int:
        """-1 for unseen features (IndexMap.NULL_KEY semantics)."""
        return self._k2i.get(key, -1)

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._i2k is None:
            i2k = [""] * len(self._k2i)
            for k, i in self._k2i.items():
                i2k[i] = k
            self._i2k = i2k
        return self._i2k[index] if 0 <= index < len(self._i2k) else None

    @property
    def intercept_index(self) -> Optional[int]:
        idx = self.get_index(INTERCEPT_KEY)
        return None if idx < 0 else idx

    def keys(self) -> Iterator[str]:
        return iter(self._k2i)

    def items(self) -> Iterator[Tuple[str, int]]:
        return iter(self._k2i.items())

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_keys(keys: Iterable[str], add_intercept: bool = True) -> "IndexMap":
        uniq = sorted(set(keys) - {INTERCEPT_KEY})
        if add_intercept:
            uniq.append(INTERCEPT_KEY)
        return IndexMap({k: i for i, k in enumerate(uniq)})

    @staticmethod
    def from_name_terms(
        name_terms: Iterable[Tuple[str, str]], add_intercept: bool = True
    ) -> "IndexMap":
        return IndexMap.from_keys(
            (feature_key(n, t) for n, t in name_terms), add_intercept
        )

    # -- binary store (PalDB-equivalent immutable index file) ---------------

    def save(self, path: str):
        """Write a flat binary store: header, i64 key-blob offsets, i64 global
        indices, utf-8 key blob. Entry k's key is blob[offsets[k]:offsets[k+1]]
        and maps to indices[k] — indices are stored explicitly, so a store may
        hold any subset of a global map (hash partitions included). Loading is
        one read + two numpy views (the "off-heap store" role of PalDBIndexMap)."""
        entries = [
            (k.encode("utf-8"), i)
            for k, i in sorted(self._k2i.items(), key=lambda kv: kv[1])
        ]
        _write_store(_MAGIC, entries, path)

    @staticmethod
    def load(path: str) -> "IndexMap":
        def _read(path):
            with open(path, "rb") as f:
                magic = f.read(8)
                if magic != _MAGIC:
                    raise ValueError(f"{path}: bad index store magic {magic!r}")
                (n,) = struct.unpack("<q", f.read(8))
                offsets = np.frombuffer(f.read(_I64 * (n + 1)), dtype=np.int64)
                indices = np.frombuffer(f.read(_I64 * n), dtype=np.int64)
                return n, offsets, indices, f.read()

        # transient read failures retry (site io.index_map_load); a bad magic
        # is a ValueError and fails immediately
        n, offsets, indices, blob = io_call(_read, path, site="io.index_map_load")
        k2i = {
            blob[offsets[k] : offsets[k + 1]].decode("utf-8"): int(indices[k])
            for k in range(n)
        }
        return IndexMap(k2i)


def save_partitioned(index_map: IndexMap, out_dir: str, num_partitions: int, shard: str):
    """Write the index as hash-partitioned mmap stores + metadata, matching
    the layout produced by FeatureIndexingDriver (one store per partition;
    partition = hash(key) % n, PalDBIndexMap.scala:69-105 semantics)."""
    os.makedirs(out_dir, exist_ok=True)
    parts: List[Dict[str, int]] = [dict() for _ in range(num_partitions)]
    for k, i in index_map.items():
        parts[_partition(k, num_partitions)][k] = i
    for p, mapping in enumerate(parts):
        MmapIndexMap.write(
            mapping.items(), os.path.join(out_dir, f"index-{shard}-{p:05d}.bin")
        )
    atomic_write_json(
        os.path.join(out_dir, f"_index-{shard}-meta.json"),
        {"shard": shard, "numPartitions": num_partitions, "size": len(index_map)},
    )


def load_partitioned(out_dir: str, shard: str):
    """Open the partitioned stores as zero-heap mmap views (v2 'PHIDX002'
    layout); v1 'PHIDX001' stores from older runs load into an in-memory
    IndexMap for compatibility."""
    def _read_meta():
        with open(os.path.join(out_dir, f"_index-{shard}-meta.json")) as f:
            return json.load(f)

    meta = io_call(_read_meta, site="io.index_map_load")
    part_paths = [
        os.path.join(out_dir, f"index-{shard}-{p:05d}.bin")
        for p in range(meta["numPartitions"])
    ]
    with open(part_paths[0], "rb") as f:
        magic = f.read(8)
    if magic == _MAGIC2:
        return PartitionedIndexMap(
            [MmapIndexMap.open(p) for p in part_paths], meta["size"]
        )
    merged: Dict[str, int] = {}
    for p in part_paths:
        merged.update(IndexMap.load(p).items())
    return IndexMap(merged)


def _write_store(magic: bytes, entries: List[Tuple[bytes, int]], path: str):
    """Shared v1/v2 store layout: magic, i64 n, i64 offsets[n+1], i64
    indices[n], key blob. v1 orders entries by index, v2 by key."""
    n = len(entries)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(k) for k, _ in entries], out=offsets[1:])
    indices = np.asarray([i for _, i in entries], dtype=np.int64)
    # atomic: a crashed indexing run must not leave a torn store that a later
    # training run mmaps (robust.atomic — the output-committer property)
    with atomic_write(path, "wb") as f:
        f.write(magic)
        f.write(struct.pack("<q", n))
        f.write(offsets.tobytes())
        f.write(indices.tobytes())
        f.write(b"".join(k for k, _ in entries))


def _partition(key: str, n: int) -> int:
    # deterministic across runs (unlike Python's salted hash)
    h = 2166136261
    for b in key.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % n


class MmapIndexMap:
    """Zero-heap, memory-mapped index store: the PalDBIndexMap role
    (photon-api .../index/PalDBIndexMap.scala:43-278 — thousands of executors
    mmap one immutable off-heap store instead of materializing per-process
    hashmaps). The v2 store keeps entries sorted BY KEY, so lookups are
    binary searches over the mapped key blob — nothing is copied onto the
    Python heap; the OS page cache is shared across processes on a host.

    Interface-compatible with IndexMap (get_index / get_feature_name /
    items / intercept_index), so every consumer takes either."""

    def __init__(self, mm, offsets: np.ndarray, indices: np.ndarray,
                 blob_start: int, path: str):
        self._mm = mm
        self._offsets = offsets      # i64[n+1] into the key blob (key-sorted)
        self._indices = indices      # i64[n]  global index per sorted key
        self._blob_start = blob_start
        self._path = path
        self._rev: Optional[np.ndarray] = None  # index -> sorted-entry pos

    def __len__(self) -> int:
        return len(self._indices)

    @property
    def size(self) -> int:
        return len(self._indices)

    def _key_at(self, k: int) -> bytes:
        s = self._blob_start
        return bytes(self._mm[s + self._offsets[k]: s + self._offsets[k + 1]])

    def get_index(self, key: str) -> int:
        target = key.encode("utf-8")
        lo, hi = 0, len(self._indices)
        while lo < hi:
            mid = (lo + hi) // 2
            k = self._key_at(mid)
            if k < target:
                lo = mid + 1
            elif k > target:
                hi = mid
            else:
                return int(self._indices[mid])
        return -1

    def __contains__(self, key: str) -> bool:
        return self.get_index(key) >= 0

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._rev is None:
            self._rev = np.argsort(self._indices)
        pos = np.searchsorted(self._indices, index, sorter=self._rev)
        if pos >= len(self._indices):
            return None
        entry = int(self._rev[pos])
        if int(self._indices[entry]) != index:
            return None
        return self._key_at(entry).decode("utf-8")

    @property
    def intercept_index(self) -> Optional[int]:
        idx = self.get_index(INTERCEPT_KEY)
        return None if idx < 0 else idx

    def keys(self) -> Iterator[str]:
        for k in range(len(self._indices)):
            yield self._key_at(k).decode("utf-8")

    def items(self) -> Iterator[Tuple[str, int]]:
        for k in range(len(self._indices)):
            yield self._key_at(k).decode("utf-8"), int(self._indices[k])

    # -- store --------------------------------------------------------------

    @staticmethod
    def write(items: Iterable[Tuple[str, int]], path: str):
        """Write a key-sorted v2 store ('PHIDX002')."""
        _write_store(
            _MAGIC2, sorted((k.encode("utf-8"), i) for k, i in items), path
        )

    @staticmethod
    def open(path: str) -> "MmapIndexMap":
        import mmap as _mmap

        def _map():
            with open(path, "rb") as f:
                return _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)

        mm = io_call(_map, site="io.index_map_load")
        if mm[:8] != _MAGIC2:
            raise ValueError(f"{path}: bad v2 index store magic {bytes(mm[:8])!r}")
        (n,) = struct.unpack("<q", mm[8:16])
        off0 = 16
        offsets = np.frombuffer(mm, dtype=np.int64, count=n + 1, offset=off0)
        indices = np.frombuffer(
            mm, dtype=np.int64, count=n, offset=off0 + _I64 * (n + 1)
        )
        blob_start = off0 + _I64 * (n + 1) + _I64 * n
        return MmapIndexMap(mm, offsets, indices, blob_start, path)


class PartitionedIndexMap:
    """Hash-partitioned set of mmap stores looked up per key — the
    PalDBIndexMap partition routing (getIndex hashes the key to pick the
    store, PalDBIndexMap.scala:69-105). Same interface as IndexMap."""

    def __init__(self, parts: List[MmapIndexMap], size: int):
        self._parts = parts
        self._size = size
        # per-occurrence ingest calls get_index once per feature instance;
        # memoize resolved keys so repeats are dict hits, not binary searches
        self._memo: Dict[str, int] = {}
        self._rev_part: Optional[np.ndarray] = None
        self._rev_entry: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self._size

    @property
    def size(self) -> int:
        return self._size

    def get_index(self, key: str) -> int:
        idx = self._memo.get(key)
        if idx is None:
            idx = self._parts[_partition(key, len(self._parts))].get_index(key)
            self._memo[key] = idx
        return idx

    def __contains__(self, key: str) -> bool:
        return self.get_index(key) >= 0

    def _build_reverse(self):
        # one-time merged reverse map: global index -> (partition, entry)
        self._rev_part = np.full(self._size, -1, dtype=np.int32)
        self._rev_entry = np.zeros(self._size, dtype=np.int64)
        for pi, p in enumerate(self._parts):
            idx = p._indices
            ok = (idx >= 0) & (idx < self._size)
            self._rev_part[idx[ok]] = pi
            self._rev_entry[idx[ok]] = np.flatnonzero(ok)

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._rev_part is None:
            self._build_reverse()
        if not (0 <= index < self._size) or self._rev_part[index] < 0:
            return None
        part = self._parts[int(self._rev_part[index])]
        return part._key_at(int(self._rev_entry[index])).decode("utf-8")

    @property
    def intercept_index(self) -> Optional[int]:
        idx = self.get_index(INTERCEPT_KEY)
        return None if idx < 0 else idx

    def keys(self) -> Iterator[str]:
        for p in self._parts:
            yield from p.keys()

    def items(self) -> Iterator[Tuple[str, int]]:
        for p in self._parts:
            yield from p.items()
