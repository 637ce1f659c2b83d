// Native Avro -> columnar decoder: the host-side IO hot path.
//
// The reference's executors spend their ingest time in AvroDataReader
// (photon-client .../data/avro/AvroDataReader.scala:54-490) decoding Avro
// rows into per-shard sparse vectors. Here the equivalent hot loop — Object
// Container File blocks -> columnar arrays — is C++: a generic Avro binary
// interpreter driven by a compact "schema program" compiled on the Python
// side from the file's writer schema (photon_ml_tpu/native/__init__.py).
//
// Outputs (all grow-only buffers returned via the C ABI, freed by
// pr_free):
//   - numeric per-row columns (response/offset/weight candidates), NaN for
//     absent/null
//   - (row, string) pairs for uid / top-level id-tag columns and for
//     requested metadataMap keys
//   - per feature bag: row indices + name/term string arenas + double values
//
// Supports codecs null and deflate (raw zlib, wbits=-15) and a [start, stop)
// row window whose out-of-window blocks are skipped without inflating.
//
// Build: g++ -O3 -shared -fPIC decoder.cpp -o _photon_native.so -lz

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

// schema-program opcodes (must match native/__init__.py)
enum Op {
  OP_NULL = 0,
  OP_BOOL = 1,
  OP_INT = 2,
  OP_LONG = 3,
  OP_FLOAT = 4,
  OP_DOUBLE = 5,
  OP_BYTES = 6,
  OP_STRING = 7,
  OP_RECORD = 8,
  OP_ENUM = 9,
  OP_FIXED = 10,
  OP_ARRAY = 11,
  OP_MAP = 12,
  OP_UNION = 13,
};

constexpr int32_t SINK_NONE = -1;
// sink id spaces: [0, STR_SINK_BASE) numeric per-row columns,
// [STR_SINK_BASE, BAG_SINK_BASE) per-row string columns,
// [BAG_SINK_BASE, ...) bag slots (name=base+3b, term=+1, value=+2)
constexpr int32_t STR_SINK_BASE = 500;
constexpr int32_t BAG_SINK_BASE = 1000;

struct StrPairs {           // (row, string) capture for a per-row column
  std::vector<int64_t> rows;
  std::vector<int64_t> offsets{0};
  std::string bytes;
  void push(int64_t row, const char* p, int64_t n) {
    rows.push_back(row);
    bytes.append(p, (size_t)n);
    offsets.push_back((int64_t)bytes.size());
  }
};

struct Bag {
  // one entry per feature triple; key_id indexes the interned unique keys
  std::vector<int64_t> rows;
  std::vector<int32_t> key_ids;
  std::vector<double> values;
  // interned feature keys: name + '\x01' + term (io/index_map.feature_key)
  std::unordered_map<std::string, int32_t> intern;
  std::vector<int64_t> key_offsets{0};
  std::string key_bytes;

  int32_t intern_key(const std::string& key) {
    auto it = intern.find(key);
    if (it != intern.end()) return it->second;
    int32_t id = (int32_t)intern.size();
    intern.emplace(key, id);
    key_bytes.append(key);
    key_offsets.push_back((int64_t)key_bytes.size());
    return id;
  }
};

struct Result {
  int64_t n_rows = 0;
  std::vector<std::vector<double>> num_cols;  // [sink][row]
  // presence bitmap per numeric sink: distinguishes an absent field from a
  // present-but-NaN value (the Python codec propagates NaN; without this the
  // two engines would disagree on rows carrying genuine NaNs)
  std::vector<std::vector<uint8_t>> num_present;
  std::vector<StrPairs> str_cols;
  std::vector<Bag> bags;
  std::string error;
};

struct MapKey {
  std::string key;
  int32_t str_sink;
};

struct Ctx {
  const uint8_t* p;
  const uint8_t* end;
  Result* res;
  const std::vector<MapKey>* map_keys;
  int64_t row = 0;        // current absolute output row
  int32_t cur_bag = -1;   // bag scope while decoding bag array items
  // scratch for the feature item being decoded (field order independent)
  std::string pending_key;
  bool has_name = false;
  bool has_term = false;
  double pending_value = 0.0;
  bool ok = true;

  bool fail(const char* msg) {
    if (res->error.empty()) res->error = msg;
    ok = false;
    return false;
  }
  bool need(int64_t n) {
    if (end - p < n) return fail("unexpected end of block payload");
    return true;
  }
  bool read_long(int64_t* out) {
    uint64_t acc = 0;
    int shift = 0;
    while (true) {
      if (p >= end) return fail("truncated varint");
      uint8_t b = *p++;
      acc |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 63) return fail("varint too long");
    }
    *out = (int64_t)(acc >> 1) ^ -(int64_t)(acc & 1);
    return true;
  }
};

// c.row < 0 marks an out-of-window record being skipped: the bytes must be
// decoded (Avro has no per-record framing) but nothing may be captured.
void store_num(Ctx& c, int32_t sink, double v) {
  if (sink == SINK_NONE || c.row < 0) return;
  if (sink >= BAG_SINK_BASE) {
    c.pending_value = v;  // slot %3==2: the feature value
    return;
  }
  if (sink >= STR_SINK_BASE) return;  // numeric datum, string column: compiler
                                      // only allows int/long (handled inline)
  auto& col = c.res->num_cols[sink];
  if ((int64_t)col.size() <= c.row) col.resize(c.row + 1, NAN);
  col[c.row] = v;
  auto& pres = c.res->num_present[sink];
  if ((int64_t)pres.size() <= c.row) pres.resize(c.row + 1, 0);
  pres[c.row] = 1;
}

void store_str(Ctx& c, int32_t sink, const char* s, int64_t n) {
  if (sink == SINK_NONE || c.row < 0) return;
  if (sink < STR_SINK_BASE) return;  // string datum, numeric column: compiler
                                     // rejects; defensive no-op
  if (sink >= BAG_SINK_BASE) {
    int32_t slot = (sink - BAG_SINK_BASE) % 3;
    if (slot == 0) {
      // name arrives first in the scratch key; term appended after '\x01'
      c.pending_key.assign(s, (size_t)n);
      c.has_name = true;
    } else if (slot == 1) {
      c.pending_key.push_back('\x01');
      c.pending_key.append(s, (size_t)n);
      c.has_term = true;
    }
    return;
  }
  c.res->str_cols[sink - STR_SINK_BASE].push(c.row, s, n);
}

// On a null union branch: numeric sinks keep their NaN default; BAG string
// slots must still emit exactly one (empty) entry so the scratch key stays
// aligned, while per-row string columns keep their caller-side default
// (None/"" applied in Python).
void store_null(Ctx& c, int32_t sink, const int32_t* node) {
  if (sink == SINK_NONE) return;
  int32_t op = node[0];
  if ((op == OP_STRING || op == OP_BYTES) && sink >= BAG_SINK_BASE)
    store_str(c, sink, "", 0);
}

bool decode(Ctx& c, const int32_t* prog);

// Capture a metadataMap value into a per-row string column with Python
// str(v) parity: strings pass through, int/long format as decimal, null
// keeps the caller-side default; other value types make the whole decode
// fail so callers fall back to the Python codec.
bool capture_map_value(Ctx& c, const int32_t* val, int32_t route) {
  int32_t vop = val[0];
  if (vop == OP_STRING || vop == OP_BYTES) {
    int64_t n;
    if (!c.read_long(&n)) return false;
    if (n < 0 || !c.need(n)) return c.fail("bad map value");
    store_str(c, route, (const char*)c.p, n);
    c.p += n;
    return true;
  }
  if (vop == OP_INT || vop == OP_LONG) {
    int64_t v;
    if (!c.read_long(&v)) return false;
    char buf[24];
    int n = snprintf(buf, sizeof(buf), "%lld", (long long)v);
    store_str(c, route, buf, n);
    return true;
  }
  if (vop == OP_BOOL) {
    if (!c.need(1)) return false;
    bool v = *c.p++ != 0;
    store_str(c, route, v ? "True" : "False", v ? 4 : 5);
    return true;
  }
  if (vop == OP_NULL) return true;
  if (vop == OP_UNION) {
    int64_t idx;
    if (!c.read_long(&idx)) return false;
    const int32_t* b = val + 4;
    int32_t nb = val[3];
    if (idx < 0 || idx >= nb) return c.fail("bad union branch");
    for (int64_t k = 0; k < idx; k++) b += b[2];
    return capture_map_value(c, b, route);
  }
  return c.fail("unsupported metadataMap value type for id-tag capture");
}

// decode one datum described by the program node at `prog`
bool decode(Ctx& c, const int32_t* prog) {
  int32_t op = prog[0];
  int32_t sink = prog[1];
  switch (op) {
    case OP_NULL:
      store_null(c, sink, prog);
      return true;
    case OP_BOOL: {
      if (!c.need(1)) return false;
      store_num(c, sink, (double)(*c.p++ != 0));
      return true;
    }
    case OP_INT:
    case OP_LONG:
    case OP_ENUM: {
      int64_t v;
      if (!c.read_long(&v)) return false;
      if (op == OP_ENUM) return true;
      if (sink >= STR_SINK_BASE && sink < BAG_SINK_BASE) {
        char buf[24];
        int n = snprintf(buf, sizeof(buf), "%lld", (long long)v);
        store_str(c, sink, buf, n);
      } else {
        store_num(c, sink, (double)v);
      }
      return true;
    }
    case OP_FLOAT: {
      if (!c.need(4)) return false;
      float f;
      std::memcpy(&f, c.p, 4);
      c.p += 4;
      store_num(c, sink, (double)f);
      return true;
    }
    case OP_DOUBLE: {
      if (!c.need(8)) return false;
      double d;
      std::memcpy(&d, c.p, 8);
      c.p += 8;
      store_num(c, sink, d);
      return true;
    }
    case OP_BYTES:
    case OP_STRING: {
      int64_t n;
      if (!c.read_long(&n)) return false;
      if (n < 0 || !c.need(n)) return c.fail("bad string length");
      if (sink != SINK_NONE && sink < STR_SINK_BASE && c.row >= 0) {
        // string datum routed into a numeric column: float(str) parity
        char buf[64];
        if (n >= (int64_t)sizeof(buf))
          return c.fail("numeric string too long");
        std::memcpy(buf, c.p, (size_t)n);
        buf[n] = 0;
        char* endp = nullptr;
        double v = strtod(buf, &endp);
        while (endp && *endp == ' ') endp++;
        if (endp == buf || (endp && *endp != 0))
          return c.fail("non-numeric string in numeric column");
        store_num(c, sink, v);
      } else {
        store_str(c, sink, (const char*)c.p, n);
      }
      c.p += n;
      return true;
    }
    case OP_FIXED: {
      int64_t n = prog[3];
      if (!c.need(n)) return false;
      c.p += n;
      return true;
    }
    case OP_RECORD: {
      int32_t nfields = prog[3];
      const int32_t* f = prog + 4;
      for (int32_t i = 0; i < nfields; i++) {
        if (!decode(c, f)) return false;
        f += f[2];
      }
      return true;
    }
    case OP_ARRAY: {
      const int32_t* item = prog + 3;
      while (true) {
        int64_t count;
        if (!c.read_long(&count)) return false;
        if (count == 0) break;
        if (count < 0) {
          int64_t nbytes;
          if (!c.read_long(&nbytes)) return false;
          count = -count;
        }
        for (int64_t i = 0; i < count; i++) {
          int32_t saved_bag = c.cur_bag;
          bool is_bag = sink != SINK_NONE && sink < BAG_SINK_BASE && c.row >= 0;
          if (is_bag) {
            c.cur_bag = sink;
            c.pending_key.clear();
            c.has_name = c.has_term = false;
            c.pending_value = 0.0;
          }
          bool okay = decode(c, item);
          c.cur_bag = saved_bag;
          if (!okay) return false;
          if (is_bag) {
            // finalize the feature triple (field order independent)
            if (!c.has_name) return c.fail("feature item missing name");
            if (!c.has_term) c.pending_key.push_back('\x01');
            Bag& b = c.res->bags[sink];
            b.rows.push_back(c.row);
            b.key_ids.push_back(b.intern_key(c.pending_key));
            b.values.push_back(c.pending_value);
          }
        }
      }
      return true;
    }
    case OP_MAP: {
      const int32_t* val = prog + 3;
      while (true) {
        int64_t count;
        if (!c.read_long(&count)) return false;
        if (count == 0) break;
        if (count < 0) {
          int64_t nbytes;
          if (!c.read_long(&nbytes)) return false;
          count = -count;
        }
        for (int64_t i = 0; i < count; i++) {
          int64_t klen;
          if (!c.read_long(&klen)) return false;
          if (klen < 0 || !c.need(klen)) return c.fail("bad map key");
          const char* key = (const char*)c.p;
          c.p += klen;
          int32_t route = SINK_NONE;
          if (sink == 0 && c.map_keys) {  // the tracked metadataMap
            for (const auto& mk : *c.map_keys) {
              if ((int64_t)mk.key.size() == klen &&
                  std::memcmp(mk.key.data(), key, (size_t)klen) == 0) {
                route = mk.str_sink;
                break;
              }
            }
          }
          // value node with the routed sink: decode through a patched header
          if (route == SINK_NONE) {
            // decode and discard (sink of the value program applies; values
            // under maps are compiled with SINK_NONE)
            if (!decode(c, val)) return false;
          } else {
            if (!capture_map_value(c, val, route)) return false;
          }
        }
      }
      return true;
    }
    case OP_UNION: {
      int64_t idx;
      if (!c.read_long(&idx)) return false;
      int32_t nb = prog[3];
      if (idx < 0 || idx >= nb) return c.fail("bad union branch index");
      const int32_t* b = prog + 4;
      for (int64_t i = 0; i < idx; i++) b += b[2];
      if (b[0] == OP_NULL && sink != SINK_NONE) {
        // null branch of a sinked union: emit the union's default capture
        // typed by the union's non-null branch
        const int32_t* t = prog + 4;
        const int32_t* nonnull = nullptr;
        for (int32_t i = 0; i < nb; i++) {
          if (t[0] != OP_NULL) {
            nonnull = t;
            break;
          }
          t += t[2];
        }
        if (nonnull) store_null(c, sink, nonnull);
        return true;
      }
      // propagate the union's sink onto the branch via a patched header
      int32_t patched[3] = {b[0], sink != SINK_NONE ? sink : b[1], b[2]};
      if (b[0] == OP_RECORD || b[0] == OP_ARRAY || b[0] == OP_MAP ||
          b[0] == OP_UNION || b[0] == OP_FIXED) {
        // complex branches keep their own sinks (compiled in)
        return decode(c, b);
      }
      // primitive branch: temporary node with propagated sink
      int32_t tmp[4] = {patched[0], patched[1], 3, 0};
      const uint8_t* before = c.p;
      (void)before;
      return decode(c, tmp);
    }
  }
  return c.fail("unknown opcode");
}

bool inflate_raw(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  out.resize(n * 4 + 4096);
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = (uInt)n;
  size_t written = 0;
  int rc = Z_OK;
  while (rc != Z_STREAM_END) {
    if (written == out.size()) out.resize(out.size() * 2);
    zs.next_out = out.data() + written;
    zs.avail_out = (uInt)(out.size() - written);
    rc = inflate(&zs, Z_NO_FLUSH);
    written = out.size() - zs.avail_out;
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
  }
  inflateEnd(&zs);
  out.resize(written);
  return true;
}

}  // namespace

extern "C" {

// Decode the data blocks of one Object Container File.
//  data/file_len:   full file bytes (caller mmaps)
//  data_off:        offset of the first block (right after the header sync)
//  sync:            16-byte sync marker
//  codec:           0 = null, 1 = deflate
//  program:         int32 schema program for one record
//  n_num/n_str/n_bags: sink counts
//  map_keys/map_key_sinks/n_map_keys: metadataMap keys to capture -> str sink
//  row_start/row_stop: [start, stop) window over this file's records
//                      (pass 0, INT64_MAX for all)
// Returns an opaque Result*; check pr_error()[0] != 0 for failure.
void* pr_decode(const uint8_t* data, int64_t file_len, int64_t data_off,
                const uint8_t* sync, int32_t codec, const int32_t* program,
                int32_t n_num, int32_t n_str, int32_t n_bags,
                const char* const* map_keys, const int32_t* map_key_sinks,
                int32_t n_map_keys, int64_t row_start, int64_t row_stop) {
  auto* res = new Result();
  res->num_cols.resize(n_num);
  res->num_present.resize(n_num);
  res->str_cols.resize(n_str);
  res->bags.resize(n_bags);

  std::vector<MapKey> mks;
  for (int32_t i = 0; i < n_map_keys; i++)
    mks.push_back(MapKey{map_keys[i], map_key_sinks[i]});

  Ctx header_ctx{data + data_off, data + file_len, res, &mks};
  Ctx& hc = header_ctx;
  int64_t file_row = 0;  // record index within the file
  int64_t out_row = 0;   // output row index
  std::vector<uint8_t> scratch;

  while (hc.p < hc.end) {
    int64_t count, size;
    if (!hc.read_long(&count) || !hc.read_long(&size)) break;
    if (size < 0 || hc.end - hc.p < 16 || hc.end - hc.p - 16 < size) {
      res->error = "truncated block";
      break;
    }
    const uint8_t* payload = hc.p;
    hc.p += size;
    if (std::memcmp(hc.p, sync, 16) != 0) {
      res->error = "sync marker mismatch (corrupt file)";
      break;
    }
    hc.p += 16;
    if (file_row + count <= row_start || file_row >= row_stop) {
      file_row += count;  // whole block outside the window: never inflate
      continue;
    }

    const uint8_t* body = payload;
    int64_t body_len = size;
    if (codec == 1) {
      if (!inflate_raw(payload, (size_t)size, scratch)) {
        res->error = "deflate error";
        break;
      }
      body = scratch.data();
      body_len = (int64_t)scratch.size();
    }

    Ctx bc{body, body + body_len, res, &mks};
    for (int64_t i = 0; i < count; i++) {
      bool in_window = file_row >= row_start && file_row < row_stop;
      bc.row = in_window ? out_row : -1;  // -1 = decode bytes, capture nothing
      if (!decode(bc, program)) break;
      if (in_window) out_row++;
      file_row++;
    }
    if (!bc.ok) {
      if (res->error.empty()) res->error = "decode error";
      break;
    }
    if (file_row >= row_stop) break;
  }
  res->n_rows = out_row;
  for (auto& col : res->num_cols) col.resize((size_t)out_row, NAN);
  for (auto& pres : res->num_present) pres.resize((size_t)out_row, 0);
  return res;
}

const char* pr_error(void* r) { return ((Result*)r)->error.c_str(); }
int64_t pr_n_rows(void* r) { return ((Result*)r)->n_rows; }

const double* pr_num_col(void* r, int32_t s) {
  return ((Result*)r)->num_cols[s].data();
}

const uint8_t* pr_num_present(void* r, int32_t s) {
  return ((Result*)r)->num_present[s].data();
}

int64_t pr_str_count(void* r, int32_t s) {
  return (int64_t)((Result*)r)->str_cols[s].rows.size();
}
const int64_t* pr_str_rows(void* r, int32_t s) {
  return ((Result*)r)->str_cols[s].rows.data();
}
const int64_t* pr_str_offsets(void* r, int32_t s) {
  return ((Result*)r)->str_cols[s].offsets.data();
}
const char* pr_str_bytes(void* r, int32_t s) {
  return ((Result*)r)->str_cols[s].bytes.data();
}

int64_t pr_bag_count(void* r, int32_t b) {
  return (int64_t)((Result*)r)->bags[b].rows.size();
}
const int64_t* pr_bag_rows(void* r, int32_t b) {
  return ((Result*)r)->bags[b].rows.data();
}
const int32_t* pr_bag_key_ids(void* r, int32_t b) {
  return ((Result*)r)->bags[b].key_ids.data();
}
const double* pr_bag_values(void* r, int32_t b) {
  return ((Result*)r)->bags[b].values.data();
}
int64_t pr_bag_n_keys(void* r, int32_t b) {
  return (int64_t)((Result*)r)->bags[b].intern.size();
}
const int64_t* pr_bag_key_offsets(void* r, int32_t b) {
  return ((Result*)r)->bags[b].key_offsets.data();
}
const char* pr_bag_key_bytes(void* r, int32_t b) {
  return ((Result*)r)->bags[b].key_bytes.data();
}

void pr_free(void* r) { delete (Result*)r; }

}  // extern "C"
