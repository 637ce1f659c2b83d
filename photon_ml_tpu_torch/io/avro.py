"""Pure-Python Avro binary codec: Object Container Files, read + write.

The reference's wire format is Avro-on-HDFS (photon-avro-schemas/*.avsc,
AvroDataReader/AvroUtils in photon-client). This environment has no avro/
fastavro package, so the codec is implemented from the Avro 1.x specification:

- zigzag-varint ints/longs, little-endian float/double, length-prefixed
  bytes/string, records as concatenated fields, arrays/maps as count-prefixed
  blocks (negative count => byte size follows), unions as branch-index +
  value, enums as int index, fixed as raw bytes;
- Object Container Files: magic ``Obj\\x01``, file-metadata map with
  ``avro.schema`` / ``avro.codec``, 16-byte sync marker, then
  (count, size, payload, sync) blocks; codecs ``null`` and ``deflate``
  (raw zlib, wbits=-15).

Reader-vs-writer schema resolution follows the Avro spec's resolution rules
(pass ``reader_schema=`` to ``read_avro_file``/``iter_avro_directory``):
record fields match by name, writer-only fields are skipped, reader-only
fields take their defaults, numeric promotions (int->long/float/double,
long->float/double, float->double) and string<->bytes conversions apply, and
unions resolve branch-by-branch — so evolved production data decodes against
the current schema.

Decoding is the host-side IO hot path that feeds the card. The record
layer is isolated (``_read_datum``/``_write_datum``) so the C++ decoder
(``native``) replaces it without touching callers.
"""

from __future__ import annotations

import io as _io
import json
import mmap
import os
import struct
import zlib
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

from ..robust.atomic import atomic_write
from ..robust.retry import io_call

MAGIC = b"Obj\x01"
SYNC_SIZE = 16
_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}

Schema = Union[str, dict, list]


# ---------------------------------------------------------------------------
# schema handling
# ---------------------------------------------------------------------------


class SchemaEnv:
    """Named-type registry for record/enum/fixed references."""

    def __init__(self):
        self.named: Dict[str, dict] = {}

    def register(self, schema: dict):
        name = schema.get("name")
        if name:
            ns = schema.get("namespace")
            full = f"{ns}.{name}" if ns and "." not in name else name
            self.named[full] = schema
            self.named[name.split(".")[-1]] = schema

    def resolve(self, schema: Schema) -> Schema:
        if isinstance(schema, str) and schema not in _PRIMITIVES:
            if schema in self.named:
                return self.named[schema]
            short = schema.split(".")[-1]
            if short in self.named:
                return self.named[short]
            raise ValueError(f"Unknown named type: {schema}")
        return schema


def _walk_register(schema: Schema, env: SchemaEnv):
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "error"):
            env.register(schema)
            for f in schema["fields"]:
                _walk_register(f["type"], env)
        elif t in ("enum", "fixed"):
            env.register(schema)
        elif t == "array":
            _walk_register(schema["items"], env)
        elif t == "map":
            _walk_register(schema["values"], env)
    elif isinstance(schema, list):
        for s in schema:
            _walk_register(s, env)


def parse_schema(schema: Union[str, Schema]) -> Tuple[Schema, SchemaEnv]:
    if isinstance(schema, str) and (schema.lstrip()[:1] in "{["):
        schema = json.loads(schema)
    env = SchemaEnv()
    _walk_register(schema, env)
    return schema, env


# ---------------------------------------------------------------------------
# binary decoder
# ---------------------------------------------------------------------------


def _iter_block_counts(r: "_Reader") -> Iterator[int]:
    """Yield per-block item counts of an Avro array/map encoding (negative
    count means a byte size follows; 0 terminates)."""
    while True:
        count = r.read_long()
        if count == 0:
            return
        if count < 0:
            r.read_long()  # byte size, unused
            count = -count
        yield count


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        p = self.pos
        self.pos = p + n
        return self.buf[p : p + n]

    def read_long(self) -> int:
        b = self.buf
        p = self.pos
        shift = 0
        acc = 0
        while True:
            byte = b[p]
            p += 1
            acc |= (byte & 0x7F) << shift
            if byte < 0x80:
                break
            shift += 7
        self.pos = p
        return (acc >> 1) ^ -(acc & 1)

    def read_float(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)


def _read_datum(r: _Reader, schema: Schema, env: SchemaEnv) -> Any:
    schema = env.resolve(schema)
    if isinstance(schema, str):
        t = schema
    elif isinstance(schema, list):
        idx = r.read_long()
        return _read_datum(r, schema[idx], env)
    else:
        t = schema["type"]
        if isinstance(t, (dict, list)):
            return _read_datum(r, t, env)

    if t == "null":
        return None
    if t == "boolean":
        return r.read(1) == b"\x01"
    if t in ("int", "long"):
        return r.read_long()
    if t == "float":
        return r.read_float()
    if t == "double":
        return r.read_double()
    if t == "bytes":
        return r.read_bytes()
    if t == "string":
        return r.read_string()
    if t == "record" or t == "error":
        return {
            f["name"]: _read_datum(r, f["type"], env) for f in schema["fields"]
        }
    if t == "enum":
        return schema["symbols"][r.read_long()]
    if t == "fixed":
        return r.read(schema["size"])
    if t == "array":
        out: List[Any] = []
        items = schema["items"]
        for count in _iter_block_counts(r):
            for _ in range(count):
                out.append(_read_datum(r, items, env))
        return out
    if t == "map":
        m: Dict[str, Any] = {}
        values = schema["values"]
        for count in _iter_block_counts(r):
            for _ in range(count):
                key = r.read_string()  # key must decode before the value
                m[key] = _read_datum(r, values, env)
        return m
    if t == "union":
        idx = r.read_long()
        return _read_datum(r, schema["types"][idx], env)
    raise ValueError(f"Unsupported Avro type: {t!r}")


_UNPACK_FLOAT = struct.Struct("<f").unpack_from
_UNPACK_DOUBLE = struct.Struct("<d").unpack_from


def _decoder(schema: Schema, env: SchemaEnv, r: _Reader, compiled: Optional[dict] = None):
    """Compile ``schema`` into ``decode()``, which reads one datum at
    ``r``'s position (what ``_read_datum(r, schema, env)`` returns): the
    schema is walked once, not once a datum, and ``r``'s buffer may be
    swapped between calls. A named record refers to its own decoder by a
    cell, so recursive schemas compile."""
    compiled = {} if compiled is None else compiled
    schema = env.resolve(schema)
    read_long = r.read_long
    if isinstance(schema, list):
        branches = [_decoder(s, env, r, compiled) for s in schema]
        return lambda: branches[read_long()]()
    t = schema if isinstance(schema, str) else schema["type"]
    if isinstance(t, (dict, list)):
        return _decoder(t, env, r, compiled)
    if t == "union":  # nonstandard {"type": "union", "types": [...]} spelling
        return _decoder(schema["types"], env, r, compiled)
    if t == "null":
        return lambda: None
    if t == "boolean":
        return lambda: r.read(1) == b"\x01"
    if t in ("int", "long"):
        return read_long
    if t == "float":
        def float_():
            p = r.pos
            r.pos = p + 4
            return _UNPACK_FLOAT(r.buf, p)[0]

        return float_
    if t == "double":
        def double():
            p = r.pos
            r.pos = p + 8
            return _UNPACK_DOUBLE(r.buf, p)[0]

        return double
    if t == "bytes":
        return r.read_bytes
    if t == "string":
        def string():
            n = read_long()
            p = r.pos
            r.pos = p + n
            return r.buf[p:p + n].decode("utf-8")

        return string
    if t in ("record", "error"):
        key = id(schema)
        if key in compiled:
            cell = compiled[key]
            return lambda: cell[0]()
        cell = compiled[key] = [None]
        fields = [(f["name"], _decoder(f["type"], env, r, compiled)) for f in schema["fields"]]

        def record():
            return {name: dec() for name, dec in fields}

        cell[0] = record
        return record
    if t == "enum":
        symbols = schema["symbols"]
        return lambda: symbols[read_long()]
    if t == "fixed":
        size = schema["size"]
        return lambda: r.read(size)
    if t == "array":
        items = _decoder(schema["items"], env, r, compiled)

        def array():
            out: List[Any] = []
            for count in _iter_block_counts(r):
                for _ in range(count):
                    out.append(items())
            return out

        return array
    if t == "map":
        values = _decoder(schema["values"], env, r, compiled)
        key_ = _decoder("string", env, r, compiled)

        def map_():
            m: Dict[str, Any] = {}
            for count in _iter_block_counts(r):
                for _ in range(count):
                    k = key_()  # the key decodes before the value
                    m[k] = values()
            return m

        return map_
    raise ValueError(f"Unsupported Avro type: {t!r}")


# ---------------------------------------------------------------------------
# reader-vs-writer schema resolution (Avro spec "Schema Resolution")
# ---------------------------------------------------------------------------

_PROMOTIONS = {
    "int": {"int", "long", "float", "double"},
    "long": {"long", "float", "double"},
    "float": {"float", "double"},
    "double": {"double"},
    "string": {"string", "bytes"},
    "bytes": {"bytes", "string"},
}


def _type_name(schema: Schema, env: SchemaEnv) -> str:
    schema = env.resolve(schema)
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    t = schema["type"]
    if isinstance(t, (dict, list)):
        return _type_name(t, env)
    return t


def _short_name(schema: dict) -> str:
    return schema.get("name", "").split(".")[-1]


def _match(writer: Schema, reader: Schema, wenv: SchemaEnv, renv: SchemaEnv) -> bool:
    """Can data written with `writer` resolve into `reader`? (shallow check —
    deep mismatches surface as errors during decode)."""
    wt, rt = _type_name(writer, wenv), _type_name(reader, renv)
    if wt in _PROMOTIONS:
        return rt in _PROMOTIONS[wt]
    if wt in ("null", "boolean"):
        return rt == wt
    if wt == "union" or rt == "union":
        return True  # branch-level matching happens at decode time
    if wt != rt:
        return False
    if wt in ("record", "error", "enum", "fixed"):
        w, r = wenv.resolve(writer), renv.resolve(reader)
        return _short_name(w) == _short_name(r)
    return True  # array/map: item/value checked during decode


def _read_resolved(
    r: _Reader, writer: Schema, reader: Schema, wenv: SchemaEnv, renv: SchemaEnv
) -> Any:
    """Decode a datum written as `writer` into the shape of `reader`."""
    writer = wenv.resolve(writer)
    reader = renv.resolve(reader)

    # unwrap {"type": <complex>} wrappers and the nonstandard
    # {"type": "union", "types": [...]} union spelling
    if isinstance(writer, dict):
        if writer.get("type") == "union":
            writer = writer["types"]
        elif isinstance(writer.get("type"), (dict, list)):
            return _read_resolved(r, writer["type"], reader, wenv, renv)
    if isinstance(reader, dict):
        if reader.get("type") == "union":
            reader = reader["types"]
        elif isinstance(reader.get("type"), (dict, list)):
            return _read_resolved(r, writer, reader["type"], wenv, renv)

    # writer union: read the branch index, resolve that branch against reader
    if isinstance(writer, list):
        idx = r.read_long()
        return _read_resolved(r, writer[idx], reader, wenv, renv)
    # reader union (writer is not): first matching reader branch
    if isinstance(reader, list):
        for branch in reader:
            if _match(writer, branch, wenv, renv):
                return _read_resolved(r, writer, branch, wenv, renv)
        raise ValueError(
            f"cannot resolve writer type {_type_name(writer, wenv)!r} "
            f"into reader union {reader}"
        )

    wt = writer if isinstance(writer, str) else writer["type"]
    rt = reader if isinstance(reader, str) else reader["type"]

    if wt in _PRIMITIVES:
        if rt not in _PROMOTIONS.get(wt, {wt}):
            raise ValueError(f"cannot promote writer {wt!r} to reader {rt!r}")
        value = _read_datum(r, wt, wenv)
        if wt in ("int", "long") and rt in ("float", "double"):
            return float(value)
        if wt == "string" and rt == "bytes":
            return value.encode("utf-8")
        if wt == "bytes" and rt == "string":
            return value.decode("utf-8")
        return value

    if wt != rt:
        raise ValueError(f"writer type {wt!r} does not resolve to reader {rt!r}")

    if wt in ("record", "error"):
        if _short_name(writer) != _short_name(reader):
            raise ValueError(
                f"record name mismatch: writer {_short_name(writer)!r} "
                f"vs reader {_short_name(reader)!r}"
            )
        reader_fields = {f["name"]: f for f in reader["fields"]}
        out: Dict[str, Any] = {}
        seen = set()
        for wf in writer["fields"]:
            name = wf["name"]
            rf = reader_fields.get(name)
            if rf is None:
                _read_datum(r, wf["type"], wenv)  # skip writer-only field
            else:
                out[name] = _read_resolved(r, wf["type"], rf["type"], wenv, renv)
                seen.add(name)
        for name, rf in reader_fields.items():
            if name not in seen:
                if "default" not in rf:
                    raise ValueError(
                        f"reader field {name!r} missing from writer data and "
                        "has no default"
                    )
                out[name] = _default_value(rf["type"], rf["default"], renv)
        return out

    if wt == "enum":
        symbol = writer["symbols"][r.read_long()]
        if symbol not in reader["symbols"]:
            if "default" in reader:
                return reader["default"]
            raise ValueError(f"enum symbol {symbol!r} not in reader schema")
        return symbol

    if wt == "fixed":
        if writer["size"] != reader["size"]:
            raise ValueError("fixed size mismatch between writer and reader")
        return r.read(writer["size"])

    if wt == "array":
        out_list: List[Any] = []
        for count in _iter_block_counts(r):
            for _ in range(count):
                out_list.append(
                    _read_resolved(r, writer["items"], reader["items"], wenv, renv)
                )
        return out_list

    if wt == "map":
        m: Dict[str, Any] = {}
        for count in _iter_block_counts(r):
            for _ in range(count):
                key = r.read_string()
                m[key] = _read_resolved(
                    r, writer["values"], reader["values"], wenv, renv
                )
        return m

    raise ValueError(f"Unsupported Avro type in resolution: {wt!r}")


def _default_value(schema: Schema, default: Any, env: SchemaEnv) -> Any:
    """Materialize a reader-schema field default (JSON shape -> datum). Per
    the spec, a union field's default conforms to the union's FIRST branch."""
    schema = env.resolve(schema)
    if isinstance(schema, list):
        return _default_value(schema[0], default, env)
    t = schema if isinstance(schema, str) else schema["type"]
    if t == "bytes" and isinstance(default, str):
        return default.encode("iso-8859-1")
    if t in ("int", "long") and default is not None:
        return int(default)
    if t in ("float", "double") and default is not None:
        return float(default)
    return default


# ---------------------------------------------------------------------------
# binary encoder
# ---------------------------------------------------------------------------


def _zigzag_varint(n: int) -> bytes:
    n = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


# the encodings of the longs most often written (counts, lengths, branch
# indexes), looked up instead of computed
_SMALL_LONGS = 4096
_LONG_BYTES = [_zigzag_varint(n) for n in range(_SMALL_LONGS)]
_STRING_CACHE = 1 << 16
_PACK_FLOAT = struct.Struct("<f").pack
_PACK_DOUBLE = struct.Struct("<d").pack


def _long_bytes(n: int) -> bytes:
    return _LONG_BYTES[n] if 0 <= n < _SMALL_LONGS else _zigzag_varint(n)


def avro_long(n: int) -> bytes:
    """An int or long in Avro's binary encoding (zigzag varint)."""
    return _long_bytes(n)


def avro_string(s: str) -> bytes:
    """A string in Avro's binary encoding (its UTF-8 length, then the bytes)."""
    b = s.encode("utf-8")
    return _long_bytes(len(b)) + b


class _Writer:
    __slots__ = ("out",)

    def __init__(self):
        self.out = _io.BytesIO()

    def write(self, b: bytes):
        self.out.write(b)

    def write_long(self, n: int):
        self.out.write(_long_bytes(n))

    def getvalue(self) -> bytes:
        return self.out.getvalue()


def _branch_matcher(schema: Schema, env: SchemaEnv):
    """The test that picks a union branch for a datum: null vs the first
    branch whose type fits the datum's Python type."""
    rs = env.resolve(schema)
    t = rs if isinstance(rs, str) else rs.get("type") if isinstance(rs, dict) else None
    if t == "null":
        return lambda d: d is None
    kinds = {
        "string": str, "enum": str, "bytes": bytes, "fixed": bytes,
        "record": dict, "error": dict, "map": dict, "array": (list, tuple),
    }
    if t in ("int", "long"):
        return lambda d: isinstance(d, int) and not isinstance(d, bool)
    if t in ("float", "double"):
        return lambda d: isinstance(d, (int, float)) and not isinstance(d, bool)
    if t == "boolean":
        return lambda d: isinstance(d, bool)
    if t in kinds:
        kind = kinds[t]
        return lambda d: isinstance(d, kind)
    return lambda d: False


def _encoder(schema: Schema, env: SchemaEnv, compiled: Optional[dict] = None):
    """Compile ``schema`` into ``encode(append, datum)``, which appends the
    datum's Avro binary encoding to a list of byte strings by ``append``:
    the schema is walked once, not once a datum. A named record refers to
    its own encoder by a cell, so recursive schemas compile."""
    compiled = {} if compiled is None else compiled
    schema = env.resolve(schema)
    if isinstance(schema, list):
        branches = [
            (_branch_matcher(s, env), _long_bytes(i), _encoder(s, env, compiled)) for i, s in enumerate(schema)
        ]

        def union(append, d):
            for match, index, enc in branches:
                if match(d):
                    append(index)
                    enc(append, d)
                    return
            raise ValueError(f"No union branch for datum {d!r} in {schema}")

        return union
    t = schema if isinstance(schema, str) else schema["type"]
    if isinstance(t, (dict, list)):
        return _encoder(t, env, compiled)
    if t == "union":  # nonstandard {"type": "union", "types": [...]} spelling
        return _encoder(schema["types"], env, compiled)
    if t == "null":
        return lambda append, d: None
    if t == "boolean":
        return lambda append, d: append(b"\x01" if d else b"\x00")
    if t in ("int", "long"):
        return lambda append, d: append(_long_bytes(int(d)))
    if t == "float":
        return lambda append, d: append(_PACK_FLOAT(float(d)))
    if t == "double":
        return lambda append, d: append(_PACK_DOUBLE(float(d)))
    if t == "bytes":
        def bytes_(append, d):
            append(_long_bytes(len(d)))
            append(d)

        return bytes_
    if t == "string":
        # names and terms repeat from record to record: each string's
        # encoding is kept, up to _STRING_CACHE of them an encoder
        cache: Dict[str, bytes] = compiled.setdefault("strings", {})

        def string(append, d):
            b = cache.get(d)
            if b is None:
                b = d.encode("utf-8")
                b = _long_bytes(len(b)) + b
                if len(cache) < _STRING_CACHE:
                    cache[d] = b
            append(b)

        return string
    if t in ("record", "error"):
        key = id(schema)
        if key in compiled:
            cell = compiled[key]
            return lambda append, d: cell[0](append, d)
        cell = compiled[key] = [None]
        fields = [
            (f["name"], "default" in f, f.get("default"), _encoder(f["type"], env, compiled))
            for f in schema["fields"]
        ]

        def record(append, d):
            for name, has_default, default, enc in fields:
                if name in d:
                    enc(append, d[name])
                elif has_default:
                    enc(append, default)
                else:
                    raise KeyError(f"Record missing field {name!r}")

        cell[0] = record
        return record
    if t == "enum":
        symbols = schema["symbols"]
        return lambda append, d: append(_long_bytes(symbols.index(d)))
    if t == "fixed":
        return lambda append, d: append(d)
    if t == "array":
        items = _encoder(schema["items"], env, compiled)

        def array(append, d):
            if d:
                append(_long_bytes(len(d)))
                for item in d:
                    items(append, item)
            append(b"\x00")

        return array
    if t == "map":
        values = _encoder(schema["values"], env, compiled)
        string = _encoder("string", env, compiled)

        def map_(append, d):
            if d:
                append(_long_bytes(len(d)))
                for k, v in d.items():
                    string(append, k)
                    values(append, v)
            append(b"\x00")

        return map_
    raise ValueError(f"Unsupported Avro type: {t!r}")


def _write_datum(w: _Writer, schema: Schema, datum: Any, env: SchemaEnv):
    chunks: List[bytes] = []
    _encoder(schema, env)(chunks.append, datum)
    w.write(b"".join(chunks))


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------


def read_avro_file(
    path: str,
    reader_schema: Optional[Union[str, Schema]] = None,
    row_range: Optional[Tuple[int, int]] = None,
) -> Tuple[Schema, List[dict]]:
    """Read one .avro Object Container File -> (writer schema, records).

    With ``reader_schema``, records are resolved into the reader's shape
    (field defaults, numeric promotion, skipped writer-only fields); it may
    be a schema or a pre-parsed ``(schema, SchemaEnv)`` pair.

    With ``row_range=(start, stop)``, only records in that index window come
    back; blocks wholly outside the window are skipped WITHOUT decompressing
    or decoding (the per-host input split of the multi-process runtime —
    each host pays IO+decode for ~1/P of the data). The file is memory-mapped,
    so skipped payload pages are never read from disk.

    Transient IO failures (OSError) retry under the default backoff policy
    at site ``io.avro_read`` (the reference's Spark task retry)."""
    return io_call(
        _read_avro_file, path, reader_schema, row_range, site="io.avro_read"
    )


def _read_avro_file(
    path: str,
    reader_schema: Optional[Union[str, Schema]] = None,
    row_range: Optional[Tuple[int, int]] = None,
) -> Tuple[Schema, List[dict]]:
    with open(path, "rb") as f:
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # zero-length file
            raise ValueError(f"{path}: not an Avro object container file")
        with data:
            r = _Reader(data)
            if r.read(4) != MAGIC:
                raise ValueError(f"{path}: not an Avro object container file")
            meta_schema = {"type": "map", "values": "bytes"}
            env0 = SchemaEnv()
            meta = _read_datum(r, meta_schema, env0)
            schema_json = meta["avro.schema"].decode("utf-8")
            codec = meta.get("avro.codec", b"null").decode("utf-8")
            schema, env = parse_schema(schema_json)
            sync = r.read(SYNC_SIZE)

            if reader_schema is not None:
                if isinstance(reader_schema, tuple):
                    rschema, renv = reader_schema
                else:
                    rschema, renv = parse_schema(reader_schema)

            records: List[dict] = []
            row_idx = 0
            # one reader over each block's payload in turn, and the schema's
            # decoder over it, compiled at the first block decoded
            block_reader, decode = _Reader(b""), None
            while not r.at_end():
                count = r.read_long()
                size = r.read_long()
                if row_range is not None and row_idx >= row_range[1]:
                    break  # past the window: nothing left to decode
                if row_range is not None and row_idx + count <= row_range[0]:
                    r.pos += size  # skip payload pages entirely
                    if r.pos + SYNC_SIZE > len(r.buf):
                        raise ValueError(f"{path}: truncated block (corrupt file)")
                    if r.read(SYNC_SIZE) != sync:
                        raise ValueError(
                            f"{path}: sync marker mismatch (corrupt file)"
                        )
                    row_idx += count
                    continue
                payload = r.read(size)
                if codec == "deflate":
                    payload = zlib.decompress(payload, -15)
                elif codec != "null":
                    raise ValueError(f"Unsupported Avro codec: {codec}")
                block: List[dict] = []
                if reader_schema is None:
                    if decode is None:
                        decode = _decoder(schema, env, block_reader)
                    block_reader.buf, block_reader.pos = payload, 0
                    for _ in range(count):
                        block.append(decode())
                else:
                    br = _Reader(payload)
                    for _ in range(count):
                        block.append(_read_resolved(br, schema, rschema, env, renv))
                if row_range is not None:
                    lo = max(row_range[0] - row_idx, 0)
                    hi = min(row_range[1] - row_idx, count)
                    block = block[lo:hi]
                records.extend(block)
                row_idx += count
                block_sync = r.read(SYNC_SIZE)
                if block_sync != sync:
                    raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
            return schema, records


def count_avro_rows(path: str) -> int:
    """Record count of an Object Container File from block headers alone —
    no decompression, no record decode. Retries transient IO failures at
    site ``io.avro_read``."""
    return io_call(_count_avro_rows, path, site="io.avro_read")


def _count_avro_rows(path: str) -> int:
    with open(path, "rb") as f:
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            raise ValueError(f"{path}: not an Avro object container file")
        with data:
            r = _Reader(data)
            if r.read(4) != MAGIC:
                raise ValueError(f"{path}: not an Avro object container file")
            _read_datum(r, {"type": "map", "values": "bytes"}, SchemaEnv())
            r.pos += SYNC_SIZE
            total = 0
            while not r.at_end():
                count = r.read_long()
                size = r.read_long()
                # a corrupt/hostile header could rewind the cursor (negative
                # size => infinite loop) or overflow the total; validate like
                # the read path's block-skip does
                if count < 0 or size < 0 or r.pos + size + SYNC_SIZE > len(data):
                    raise ValueError(
                        f"{path}: corrupt Avro block header "
                        f"(count={count}, size={size} at offset {r.pos})"
                    )
                r.pos += size + SYNC_SIZE
                total += count
            return total


def list_avro_parts(path: str) -> List[str]:
    """Part files of an Avro dataset directory (or the single file itself)."""
    if os.path.isfile(path):
        return [path]
    return [
        os.path.join(path, name)
        for name in sorted(os.listdir(path))
        if not name.startswith((".", "_")) and name.endswith(".avro")
    ]


def iter_avro_directory(
    path: str, reader_schema: Optional[Union[str, Schema]] = None
) -> Iterator[dict]:
    """Read all part files of an Avro dataset directory (or a single file),
    mirroring how the reference consumes HDFS output dirs."""
    if reader_schema is not None and not isinstance(reader_schema, tuple):
        reader_schema = parse_schema(reader_schema)  # parse once for all parts
    for part in list_avro_parts(path):
        yield from read_avro_file(part, reader_schema)[1]


def write_avro_file(
    path: str,
    schema: Union[str, Schema],
    records: Iterable[dict],
    codec: str = "deflate",
    sync_interval_records: int = 4000,
    encoded: bool = False,
):
    """Write ``records`` as an Object Container File of ``schema``;
    ``encoded``: each record is already its datum's binary encoding
    (bytes), written as it is."""
    schema_obj, env = parse_schema(schema)
    schema_json = json.dumps(schema_obj)
    sync = os.urandom(SYNC_SIZE)

    header = _Writer()
    header.write(MAGIC)
    _write_datum(
        header,
        {"type": "map", "values": "bytes"},
        {"avro.schema": schema_json.encode("utf-8"), "avro.codec": codec.encode("utf-8")},
        env,
    )
    header.write(sync)

    def flush_block(out, chunks: List[bytes], count: int):
        if count == 0:
            return
        payload = b"".join(chunks)
        if codec == "deflate":
            co = zlib.compressobj(level=6, wbits=-15)
            payload = co.compress(payload) + co.flush()
        elif codec != "null":
            raise ValueError(f"Unsupported Avro codec: {codec}")
        head = _Writer()
        head.write_long(count)
        head.write_long(len(payload))
        out.write(head.getvalue())
        out.write(payload)
        out.write(sync)

    # atomic (robust.atomic): a crash mid-write leaves no torn .avro behind —
    # readers see the old file or the complete new one, never a truncated
    # container (the reference gets this from the HDFS output committer)
    with atomic_write(path, "wb") as out:
        out.write(header.getvalue())
        encode = (lambda append, rec: append(rec)) if encoded else _encoder(schema_obj, env)
        chunks: List[bytes] = []
        count = 0
        for rec in records:
            encode(chunks.append, rec)
            count += 1
            if count >= sync_interval_records:
                flush_block(out, chunks, count)
                chunks = []
                count = 0
        flush_block(out, chunks, count)
