"""The native (C++) Avro decoder.

``decoder.cpp`` is a generic Avro-binary interpreter driven by a compact
schema program, with block-level deflate and row-window skipping; it
returns columnar arrays and interned feature keys ready for a vectorized
index-map lookup. It is the JAX package's decoder, copied.

It builds itself with ``g++ -O3 -shared -fPIC ... -lz`` on first use into
``build/photon_ml_tpu_torch/native/`` under the repository root (the hash
of the source names the library, so an edited source builds anew; a per-pid
temporary name and an atomic rename keep concurrent first builds apart).
``available()`` is False when the toolchain or zlib is missing; the readers'
``engine="auto"`` then falls back to the pure-Python codec (``io/avro.py``),
and ``engine="native"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("photon_ml_tpu_torch")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "photon_ml_tpu_torch", "native")


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"_photon_native-{digest}.so")

# opcodes — must match decoder.cpp
OP_NULL, OP_BOOL, OP_INT, OP_LONG, OP_FLOAT, OP_DOUBLE = 0, 1, 2, 3, 4, 5
OP_BYTES, OP_STRING, OP_RECORD, OP_ENUM, OP_FIXED = 6, 7, 8, 9, 10
OP_ARRAY, OP_MAP, OP_UNION = 11, 12, 13

SINK_NONE = -1
STR_SINK_BASE = 500  # per-row string sinks live at 500+idx (decoder.cpp)
BAG_SINK_BASE = 1000

_build_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None


def _build() -> Optional[ctypes.CDLL]:
    """Compile decoder.cpp into ``library_path()`` (cached by the source's
    hash) and load it."""
    global _lib, _lib_error
    with _build_lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        _LIB_PATH = library_path()
        try:
            if not os.path.exists(_LIB_PATH):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # per-pid temp name: concurrent first-use builds (multi-process
                # CLI) must not interleave g++ output into one file before the
                # atomic rename
                tmp = f"{_LIB_PATH}.tmp.{os.getpid()}"
                cmd = [
                    "g++", "-O3", "-Wall", "-shared", "-fPIC",
                    _SRC, "-o", tmp, "-lz",
                ]
                subprocess.run(cmd, check=True, capture_output=True, text=True)
                os.replace(tmp, _LIB_PATH)
                logger.info("built native decoder: %s", _LIB_PATH)
            lib = ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            _lib_error = f"native decoder unavailable: {detail[:500]}"
            logger.info(_lib_error)
            return None
        _bind(lib)
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL):
    c = ctypes
    lib.pr_decode.restype = c.c_void_p
    lib.pr_decode.argtypes = [
        c.c_char_p, c.c_int64, c.c_int64,          # data, file_len, data_off
        c.c_char_p, c.c_int32,                     # sync, codec
        c.POINTER(c.c_int32),                      # program
        c.c_int32, c.c_int32, c.c_int32,           # n_num, n_str, n_bags
        c.POINTER(c.c_char_p), c.POINTER(c.c_int32), c.c_int32,  # map keys
        c.c_int64, c.c_int64,                      # row_start, row_stop
    ]
    lib.pr_error.restype = c.c_char_p
    lib.pr_error.argtypes = [c.c_void_p]
    lib.pr_n_rows.restype = c.c_int64
    lib.pr_n_rows.argtypes = [c.c_void_p]
    lib.pr_num_col.restype = c.POINTER(c.c_double)
    lib.pr_num_col.argtypes = [c.c_void_p, c.c_int32]
    lib.pr_num_present.restype = c.POINTER(c.c_uint8)
    lib.pr_num_present.argtypes = [c.c_void_p, c.c_int32]
    for name in ("pr_str_count", "pr_bag_count", "pr_bag_n_keys"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p, c.c_int32]
    for name in ("pr_str_rows", "pr_str_offsets", "pr_bag_rows",
                 "pr_bag_key_offsets"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_int64)
        fn.argtypes = [c.c_void_p, c.c_int32]
    for name in ("pr_str_bytes", "pr_bag_key_bytes"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_char)
        fn.argtypes = [c.c_void_p, c.c_int32]
    lib.pr_bag_key_ids.restype = c.POINTER(c.c_int32)
    lib.pr_bag_key_ids.argtypes = [c.c_void_p, c.c_int32]
    lib.pr_bag_values.restype = c.POINTER(c.c_double)
    lib.pr_bag_values.argtypes = [c.c_void_p, c.c_int32]
    lib.pr_free.restype = None
    lib.pr_free.argtypes = [c.c_void_p]


def available() -> bool:
    return _build() is not None


# ---------------------------------------------------------------------------
# schema-program compiler
# ---------------------------------------------------------------------------


class ProgramError(ValueError):
    """Schema shape the native interpreter does not cover (fall back)."""


def _check_sink_type(op: int, sink: int):
    """Reject sink/type combinations the decoder cannot capture faithfully
    (the Python codec handles them via dynamic typing; callers fall back)."""
    if sink == SINK_NONE or op == OP_NULL:
        return
    if sink >= BAG_SINK_BASE:
        slot = (sink - BAG_SINK_BASE) % 3
        if slot == 2:  # value: numeric
            if op not in (OP_INT, OP_LONG, OP_FLOAT, OP_DOUBLE, OP_BOOL):
                raise ProgramError("bag value field is not numeric")
        else:  # name/term: string
            if op not in (OP_STRING, OP_BYTES):
                raise ProgramError("bag name/term field is not a string")
    elif sink >= STR_SINK_BASE:
        # per-row string column: strings, or int/long (decimal-formatted,
        # str(int) parity); float/double/bool would not match Python's str()
        if op not in (OP_STRING, OP_BYTES, OP_INT, OP_LONG):
            raise ProgramError(
                "string column backed by a non-string, non-integer field"
            )
    else:
        # numeric per-row column; strings parse via strtod (float(str) parity)
        if op not in (OP_INT, OP_LONG, OP_FLOAT, OP_DOUBLE, OP_BOOL,
                      OP_STRING, OP_BYTES):
            raise ProgramError("numeric column backed by a non-numeric field")


def compile_program(
    schema,
    env,
    num_fields: Dict[str, int],
    str_fields: Dict[str, int],
    bag_fields: Dict[str, int],
    map_field: Optional[str],
) -> List[int]:
    """Writer schema -> int32 program. Top-level record fields are routed to
    sinks by name; a bag field's item record routes name/term/value to the
    bag's slots; `map_field` marks the metadataMap (sink 0 on its MAP node).
    """
    top = env.resolve(schema)
    if not isinstance(top, dict) or top.get("type") not in ("record", "error"):
        raise ProgramError("top-level schema must be a record")

    def node(s, sink=SINK_NONE, bag: Optional[int] = None, depth=0) -> List[int]:
        if depth > 32:
            raise ProgramError("schema nesting too deep (recursive schema?)")
        s = env.resolve(s)
        if isinstance(s, dict) and s.get("type") == "union":
            s = s["types"]
        if isinstance(s, list):
            # branches inherit the union's sink so bag arrays / captured
            # primitives under ["null", X] unions still route
            branches = [node(b, sink, bag, depth + 1) for b in s]
            out = [OP_UNION, sink, 0, len(branches)]
            for b in branches:
                out.extend(b)
            out[2] = len(out)
            return out
        t = s if isinstance(s, str) else s.get("type")
        if isinstance(t, (dict, list)):
            return node(t, sink, bag, depth + 1)
        prim = {
            "null": OP_NULL, "boolean": OP_BOOL, "int": OP_INT,
            "long": OP_LONG, "float": OP_FLOAT, "double": OP_DOUBLE,
            "bytes": OP_BYTES, "string": OP_STRING,
        }
        if t in prim:
            op = prim[t]
            _check_sink_type(op, sink)
            return [op, sink, 3]
        if t == "enum":
            return [OP_ENUM, SINK_NONE, 3]
        if t == "fixed":
            return [OP_FIXED, SINK_NONE, 4, int(s["size"])]
        if t in ("record", "error"):
            fields = []
            for f in s["fields"]:
                fsink = SINK_NONE
                if bag is not None:
                    slot = {"name": 0, "term": 1, "value": 2}.get(f["name"])
                    if slot is not None:
                        fsink = BAG_SINK_BASE + 3 * bag + slot
                fields.append(node(f["type"], fsink, None, depth + 1))
            out = [OP_RECORD, sink, 0, len(s["fields"])]
            for f in fields:
                out.extend(f)
            out[2] = len(out)
            return out
        if t == "array":
            item_bag = bag
            item = node(s["items"], SINK_NONE, item_bag, depth + 1)
            out = [OP_ARRAY, sink, 0] + item
            out[2] = len(out)
            return out
        if t == "map":
            value = node(s["values"], SINK_NONE, None, depth + 1)
            out = [OP_MAP, sink, 0] + value
            out[2] = len(out)
            return out
        raise ProgramError(f"unsupported Avro type {t!r}")

    fields = []
    for f in top["fields"]:
        name = f["name"]
        if name in bag_fields:
            b = bag_fields[name]
            arr = env.resolve(f["type"])
            if isinstance(arr, dict) and isinstance(arr.get("type"), dict):
                arr = arr["type"]
            fields.append(node(f["type"], bag_fields[name], bag=b))
        elif name in num_fields:
            fields.append(node(f["type"], num_fields[name]))
        elif name in str_fields:
            fields.append(node(f["type"], str_fields[name]))
        elif map_field is not None and name == map_field:
            fields.append(node(f["type"], 0))
        else:
            fields.append(node(f["type"]))
    out = [OP_RECORD, SINK_NONE, 0, len(top["fields"])]
    for f in fields:
        out.extend(f)
    out[2] = len(out)
    return out


# ---------------------------------------------------------------------------
# columnar file decode
# ---------------------------------------------------------------------------


class Columnar:
    """Decoded columnar content of one file (numpy copies, C buffers freed)."""

    __slots__ = ("n_rows", "num_cols", "num_present", "str_cols", "bags")

    def __init__(self, n_rows, num_cols, num_present, str_cols, bags):
        self.n_rows = n_rows
        self.num_cols = num_cols      # [np.ndarray f8[n_rows]]
        self.num_present = num_present  # [np.ndarray bool[n_rows]] field seen
        self.str_cols = str_cols      # [(rows i8[k], values object[k])]
        self.bags = bags              # [(rows i8[m], key_ids i4[m], vals f8[m], keys object[u])]


def _split_strings(offsets: np.ndarray, raw: bytes) -> np.ndarray:
    out = np.empty(len(offsets) - 1, dtype=object)
    for i in range(len(offsets) - 1):
        out[i] = raw[offsets[i]:offsets[i + 1]].decode("utf-8")
    return out


def decode_file(
    path: str,
    num_fields: Dict[str, int],
    str_fields: Dict[str, int],
    bag_fields: Dict[str, int],
    map_keys: Dict[str, int],
    map_field: str = "metadataMap",
    row_range: Optional[Tuple[int, int]] = None,
    _program_cache: dict = {},
) -> Columnar:
    """Decode one container file into columnar arrays via the native lib."""
    lib = _build()
    if lib is None:
        raise RuntimeError(_lib_error or "native decoder unavailable")

    import mmap as _mmap

    from ..io.avro import MAGIC, SYNC_SIZE, SchemaEnv, _read_datum, _Reader, parse_schema

    f = open(path, "rb")
    try:
        data = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    except ValueError:
        f.close()
        raise ValueError(f"{path}: not an Avro object container file")
    except BaseException:
        f.close()  # OSError etc. would otherwise escape with f open
        raise
    with f:
        try:
            return _decode_mapped(
                lib, path, data, num_fields, str_fields, bag_fields, map_keys,
                map_field, row_range, _program_cache,
            )
        finally:
            try:
                data.close()
            except BufferError:
                # a propagating exception's traceback still holds the
                # np.frombuffer view; let GC close the map rather than
                # masking the real error with BufferError
                pass


def _prepare_mapped(lib, path, data, num_fields, str_fields, bag_fields,
                    map_keys, map_field, _program_cache):
    """Parse the container header and compile/cache the schema program;
    returns everything a (chunk) decode call needs."""
    from ..io.avro import MAGIC, SYNC_SIZE, SchemaEnv, _read_datum, _Reader, parse_schema

    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro object container file")
    meta = _read_datum(r, {"type": "map", "values": "bytes"}, SchemaEnv())
    schema_json = meta["avro.schema"].decode("utf-8")
    codec_name = meta.get("avro.codec", b"null").decode("utf-8")
    if codec_name not in ("null", "deflate"):
        raise ProgramError(f"unsupported codec {codec_name}")
    sync = r.read(SYNC_SIZE)
    data_off = r.pos

    cache_key = (schema_json, tuple(sorted(num_fields.items())),
                 tuple(sorted(str_fields.items())),
                 tuple(sorted(bag_fields.items())), map_field)
    program = _program_cache.get(cache_key)
    if program is None:
        schema, env = parse_schema(schema_json)
        # per-row string sinks live in their own id space (decoder.cpp)
        str_prog = {k: STR_SINK_BASE + v for k, v in str_fields.items()}
        program = np.asarray(
            compile_program(schema, env, num_fields, str_prog, bag_fields,
                            map_field),
            dtype=np.int32,
        )
        _program_cache[cache_key] = program

    n_num = max(num_fields.values(), default=-1) + 1
    n_str = max(
        list(str_fields.values()) + list(map_keys.values()), default=-1
    ) + 1
    n_bags = max(bag_fields.values(), default=-1) + 1

    mk_names = list(map_keys)
    mk_arr = (ctypes.c_char_p * max(len(mk_names), 1))()
    mk_sinks = (ctypes.c_int32 * max(len(mk_names), 1))()
    for i, k in enumerate(mk_names):
        mk_arr[i] = k.encode()
        mk_sinks[i] = STR_SINK_BASE + map_keys[k]
    return dict(
        data_off=data_off, sync=sync, codec=1 if codec_name == "deflate" else 0,
        program=program, n_num=n_num, n_str=n_str, n_bags=n_bags,
        mk_arr=mk_arr, mk_sinks=mk_sinks, n_mk=len(mk_names),
    )


def _run_decode(lib, path, view, data_len, prep, data_off, start, stop) -> Columnar:
    """One pr_decode call over [data_off, ...) with record window [start, stop)
    relative to data_off; builds the numpy Columnar. Releases the GIL for the
    duration of the native decode (ctypes foreign call)."""
    n_num, n_str, n_bags = prep["n_num"], prep["n_str"], prep["n_bags"]
    res = lib.pr_decode(
        view.ctypes.data_as(ctypes.c_char_p), data_len, data_off, prep["sync"],
        prep["codec"],
        prep["program"].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_num, n_str, n_bags,
        prep["mk_arr"], prep["mk_sinks"], prep["n_mk"],
        start, stop,
    )
    try:
        err = lib.pr_error(res)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n = lib.pr_n_rows(res)
        num_cols = [
            np.ctypeslib.as_array(lib.pr_num_col(res, s), shape=(n,)).copy()
            if n else np.empty(0)
            for s in range(n_num)
        ]
        num_present = [
            np.ctypeslib.as_array(lib.pr_num_present(res, s), shape=(n,))
            .copy()
            .astype(bool)
            if n else np.empty(0, bool)
            for s in range(n_num)
        ]
        str_cols = []
        for s in range(n_str):
            k = lib.pr_str_count(res, s)
            if k == 0:
                str_cols.append((np.empty(0, np.int64), np.empty(0, object)))
                continue
            rows = np.ctypeslib.as_array(lib.pr_str_rows(res, s), shape=(k,)).copy()
            offs = np.ctypeslib.as_array(
                lib.pr_str_offsets(res, s), shape=(k + 1,)
            ).copy()
            raw = ctypes.string_at(lib.pr_str_bytes(res, s), int(offs[-1]))
            str_cols.append((rows, _split_strings(offs, raw)))
        bags = []
        for b in range(n_bags):
            m = lib.pr_bag_count(res, b)
            u = lib.pr_bag_n_keys(res, b)
            if m == 0:
                bags.append(
                    (np.empty(0, np.int64), np.empty(0, np.int32),
                     np.empty(0), np.empty(0, object))
                )
                continue
            rows = np.ctypeslib.as_array(lib.pr_bag_rows(res, b), shape=(m,)).copy()
            kid = np.ctypeslib.as_array(lib.pr_bag_key_ids(res, b), shape=(m,)).copy()
            vals = np.ctypeslib.as_array(lib.pr_bag_values(res, b), shape=(m,)).copy()
            offs = np.ctypeslib.as_array(
                lib.pr_bag_key_offsets(res, b), shape=(u + 1,)
            ).copy()
            raw = ctypes.string_at(lib.pr_bag_key_bytes(res, b), int(offs[-1]))
            bags.append((rows, kid, vals, _split_strings(offs, raw)))
        return Columnar(int(n), num_cols, num_present, str_cols, bags)
    finally:
        lib.pr_free(res)


def _decode_mapped(lib, path, data, num_fields, str_fields, bag_fields,
                   map_keys, map_field, row_range, _program_cache) -> Columnar:
    prep = _prepare_mapped(
        lib, path, data, num_fields, str_fields, bag_fields, map_keys,
        map_field, _program_cache,
    )
    start, stop = row_range if row_range is not None else (0, 2**62)
    view = np.frombuffer(data, dtype=np.uint8)  # zero-copy over the mmap
    return _run_decode(
        lib, path, view, len(data), prep, prep["data_off"], start, stop
    )


def _scan_blocks(data, data_off, path):
    """Block boundaries from the container headers alone (no decompression):
    [(block_offset, first_record_index, record_count, byte_size)]."""
    from ..io.avro import SYNC_SIZE, _Reader

    r = _Reader(data)
    r.pos = data_off
    out = []
    row = 0
    while not r.at_end():
        off = r.pos
        count = r.read_long()
        size = r.read_long()
        if count < 0 or size < 0 or r.pos + size + SYNC_SIZE > len(data):
            raise ValueError(
                f"{path}: corrupt Avro block header "
                f"(count={count}, size={size} at offset {off})"
            )
        out.append((off, row, count, size))
        row += count
        r.pos += size + SYNC_SIZE
    return out


def decode_file_chunks(
    path: str,
    num_fields: Dict[str, int],
    str_fields: Dict[str, int],
    bag_fields: Dict[str, int],
    map_keys: Dict[str, int],
    map_field: str = "metadataMap",
    row_range: Optional[Tuple[int, int]] = None,
    n_threads: Optional[int] = None,
    _program_cache: dict = {},
) -> List[Columnar]:
    """Decode one container file on a thread pool, one contiguous run of
    OCF blocks per thread (blocks are independently-deflated units; the
    reference decodes splits on every executor in parallel,
    AvroDataReader.scala:54-490 — this is the shared-memory analogue).

    The native call releases the GIL, so chunks genuinely decode in parallel.
    Returns the chunk Columnars in row order; callers stitch them exactly
    like per-file parts. n_threads defaults to PHOTON_DECODE_THREADS or the
    core count."""
    lib = _build()
    if lib is None:
        raise RuntimeError(_lib_error or "native decoder unavailable")
    if n_threads is None:
        n_threads = int(os.environ.get("PHOTON_DECODE_THREADS", 0)) or (os.cpu_count() or 1)

    import mmap as _mmap

    f = open(path, "rb")
    try:
        data = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    except ValueError:
        f.close()
        raise ValueError(f"{path}: not an Avro object container file")
    except BaseException:
        f.close()  # OSError etc. would otherwise escape with f open
        raise
    with f:
        try:
            prep = _prepare_mapped(
                lib, path, data, num_fields, str_fields, bag_fields, map_keys,
                map_field, _program_cache,
            )
            start, stop = row_range if row_range is not None else (0, 2**62)
            blocks = _scan_blocks(data, prep["data_off"], path)
            # keep only blocks intersecting the window
            blocks = [
                b for b in blocks if b[1] + b[2] > start and b[1] < stop
            ]
            if not blocks or n_threads <= 1 or len(blocks) == 1:
                view = np.frombuffer(data, dtype=np.uint8)
                return [
                    _run_decode(
                        lib, path, view, len(data), prep, prep["data_off"],
                        start, stop,
                    )
                ]
            # split into <= n_threads contiguous chunks balanced by bytes
            total_bytes = sum(b[3] for b in blocks)
            target = max(total_bytes / min(n_threads, len(blocks)), 1)
            chunks = []
            cur, acc = [], 0
            for b in blocks:
                cur.append(b)
                acc += b[3]
                if acc >= target and len(chunks) < n_threads - 1:
                    chunks.append(cur)
                    cur, acc = [], 0
            if cur:
                chunks.append(cur)

            view = np.frombuffer(data, dtype=np.uint8)

            def run(chunk):
                off, first_row = chunk[0][0], chunk[0][1]
                last_row = chunk[-1][1] + chunk[-1][2]
                lo = max(start - first_row, 0)
                hi = min(stop, last_row) - first_row
                return _run_decode(
                    lib, path, view, len(data), prep, off, lo, hi
                )

            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(chunks)) as pool:
                return list(pool.map(run, chunks))
        finally:
            try:
                data.close()
            except BufferError:
                pass
