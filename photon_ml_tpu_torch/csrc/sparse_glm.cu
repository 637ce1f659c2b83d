// Segmented gather-dot for the sparse feature layouts on Hopper (sm_90a).
//
// Replaces the XLA gathers and scatter-adds of the sparse products in
// photon_ml_tpu/ops/features.py (FeatureMatrix.matvec, rmatvec and
// sq_rmatvec over the ELL and the column-sorted COO layouts, :103-172; the
// JAX package has no Pallas kernel for them). It computes all six:
//
//   out[s] = sum_{j in segment s} src[gather[j]] * val[j]     (or val[j]^2)
//
// each output summed in double and rounded to float once, written exactly
// once, with no float atomics. The same kernels compute S2, the lane-wide
// products of the lambda-lane sweeps (FeatureMatrix.matmat and rmatmat,
// :112 and :144 there):
//
//   out[s, l] = sum_{j in segment s} src[gather[j], l] * val[j]
//
// over a row-major src [n_src, L] and out [n_seg, L]. ops/features.py
// builds each product's companions once per matrix on the host
// (ops/sparse.py), in one of two forms, and each form has its kernel:
//
// Row groups (matvec, segments of about 8 or more entries each): segment
// pointers (int32, or int64 past 2^31 entries) or the uniform rows of the
// ELL layout, and a group width G of 4, 8, 16 or 32 lanes, picked on the
// host from the mean segment length. A group of G lanes takes one segment,
// so a warp holds 32 / G segments at once. Lane q of the group takes the
// kLaneEntries consecutive entries from start + q * kLaneEntries, then those
// G * kLaneEntries further on, and so on; each pass loads its indices and
// values with one 16-byte load each where the alignment allows and issues
// all its gathers before its first add. The group then adds its partials in
// a log2(G)-step xor butterfly, after which every lane holds the sums.
//
// Key walk (rmatvec and sq_rmatvec; and matvec where a row is longer than
// ops/sparse.py's LONG_SEGMENT): the entries in segment order carry their
// segment as an int32 key, and no per-segment pointer exists. A warp takes
// a tile of kTile entries, lane l the kRunEntries consecutive entries from
// l * kRunEntries, and adds each run of equal keys in entry order. A run
// that closes in the lane is the lane's to write. A key that crosses lanes
// is joined by a segmented scan over the warp's lanes, in a fixed lane
// order. A key that crosses a tile boundary leaves float64 carries (the
// tile's head and tail partials), and a second small kernel adds each such
// key's carries in tile order: the host lists those keys with their first
// and last tiles (the joins). A long column (an intercept) is just many
// lanes' runs. Each tile owns the outputs from one past the key before its
// first entry to its last key (to the end for the last tile), less the
// keys the joins write, and writes them all, gaps between keys (empty
// columns) as zeros, once.
//
// Columns (S2). A launch takes a panel of up to kPanel columns; a wider L
// runs in panels, the L / kPanel full ones on the grid's y axis and one of
// the L % kPanel columns left (one pass over the entries each). A thread
// loads its entries (indices, values, keys) once into registers and walks
// the panel's columns in sub-chunks of kSub (4; the last sub-chunk has the
// width mod 4), each column by exactly the operations S1 runs for its one
// (the same partition of entries over lanes, the same fused multiply-adds
// in the same order, the same butterfly, scan and float64 carries), so that
// column l of S2 is, bit for bit, S1 on column l of src. S1 is the panel
// of one column. A panel's capacity W (1, 4, 8, 12 or 16 columns, a
// template argument) is the narrowest that holds its width; columns past
// the width are skipped. Each gather reads a sub-chunk's columns of the
// source row contiguously (one float4 where L is a multiple of 4). The row
// groups issue every sub-chunk's gathers of a pass at once, so a row's
// sub-chunks share the sectors they fetch; the key walk gathers one
// sub-chunk at a time (its registers hold 8 entries). Output rows leave
// whole: in a row group the G lanes, which all hold the segment's sums
// after the butterfly, store one sub-chunk each (a float4 where L is a
// multiple of 4), so a panel's part of a row is one contiguous store across
// the group; the key walk puts each closed run's sums for the whole panel
// in shared memory (a slot per entry at which a run closes), maps the
// tile's output rows to their slots, and stores the rows [lo, hi) of the
// panel contiguously, zeros where a row has no slot. One column keeps S1's
// own form: its sums in registers, staged by row in a window of 1,024 rows.
//
// Why kPanel = 16: the row-group kernel holds a panel's sums in double (2 x
// 16 registers) and the gathered rows of a pass's 4 entries (4 x 16) at
// once, 128 registers a thread at W = 16; the key walk stages 256 entries x
// 16 floats (16.5 KB) a warp in shared memory, 72 KB a block of 4 warps,
// three blocks an SM. A wider panel would spill the row groups and leave
// the key walk two blocks an SM.
//
// Order: the layout alone fixes the summation order (G comes from the
// layout, kTile and kRunEntries are constants), not the grid, the panel or
// the timing of blocks: two launches give the same bits.
//
// What bounds it: the gathers, and for a wide key walk the output. Each
// entry is an index (4 bytes) and a value (4 or 2), plus its key in the key
// walk, streamed with evict-first loads (__ldcs), and one gather of the
// source row's panel from an unpredictable address (a 32-byte sector
// through L1 and L2 for 4 useful bytes at L = 1). Two double operations an
// entry and column are far below the card's rate. The rmatvec output is
// n_seg x L floats (640 MB at d = 10,000,000, L = 16), written as whole
// rows. Measured on an H100 at bench.py's sparse shape (chip_smoke.py phase
// 8, PERF.md): with the gathers replaced by contiguous reads, matvec takes
// a quarter of its time and the key walk five eighths; w (40 MB at d =
// 10,000,000) does not stay in L2, with or without an L2 evict-last policy
// on the gathers, so none is used. The key walk at W = 16 is bound by its
// latency (12 warps an SM, a sub-chunk's gathers, adds and scan in turn)
// more than by its bytes: 35% of the byte bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                  // row groups, joins, zeros
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kLaneEntries = 4;                // row groups: entries a lane takes a pass
constexpr int kRunEntries = 8;                 // key walk: entries a lane walks
constexpr int kTile = kWarp * kRunEntries;     // key walk: entries a warp tile
constexpr int kSub = 4;                        // columns a sub-chunk
constexpr int kPanel = 16;                     // columns a pass over the entries
constexpr int kMaxPanels = 65535;              // full panels on the grid's y axis
constexpr int kMapRows = 256;                  // key walk: output rows a warp maps at a time
constexpr int kSerialTiles = 32;               // joins: a chain of more tiles is added by a warp
constexpr int kStaticSmem = 48 * 1024;         // above it, only with the attribute set
constexpr long long kMaxBlocks = 1LL << 20;
constexpr unsigned kFull = 0xffffffffu;

// a panel of capacity W: sub-chunks of SW columns (W itself below kSub), NS of them
template <int W>
struct Cols {
  static constexpr int SW = W < kSub ? W : kSub;
  static constexpr int NS = W / SW;
};

// the capacity of a panel of `width` columns
int capacity_for(int width) { return width <= 1 ? 1 : ((width + kSub - 1) / kSub) * kSub; }

// n (<= S) columns from p through the read-only path, zeros past n; one
// float4 for a whole sub-chunk where `vec` (p 16-byte aligned)
template <int S>
__device__ __forceinline__ void gather_cols(const float* __restrict__ p, int n, bool vec, float (&x)[S]) {
  if constexpr (S == kSub) {
    if (vec && n == kSub) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < S; ++c) x[c] = c < n ? __ldg(p + c) : 0.0f;
}

// a key-walk lane's gathers of one sub-chunk: n columns from c0 of the
// source rows of its cnt entries
template <int S>
__device__ __forceinline__ void gather_sub(const float* __restrict__ src, const int (&idx)[kRunEntries], int cnt, int L,
                                           int c0, int n, bool vec, float (&x)[kRunEntries][S]) {
#pragma unroll
  for (int e = 0; e < kRunEntries; ++e) {
    if (e < cnt) {
      gather_cols<S>(src + (long long)idx[e] * L + c0, n, vec, x[e]);
    } else {
#pragma unroll
      for (int c = 0; c < S; ++c) x[e][c] = 0.0f;
    }
  }
}

// the first n (<= S) sums rounded to float at p; one float4 where `vec`
template <int S>
__device__ __forceinline__ void store_cols(float* p, int n, bool vec, const double (&a)[S]) {
  if constexpr (S == kSub) {
    if (vec && n == kSub) {
      *reinterpret_cast<float4*>(p) = make_float4((float)a[0], (float)a[1], (float)a[2], (float)a[3]);
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < S; ++c)
    if (c < n) p[c] = (float)a[c];
}

__device__ __forceinline__ double bf16_bits(unsigned bits) { return (double)__uint_as_float(bits << 16); }

__device__ __forceinline__ double load_value(const float* v, long long j) { return (double)__ldcs(v + j); }
__device__ __forceinline__ double load_value(const uint16_t* v, long long j) {
  return bf16_bits(__ldcs(reinterpret_cast<const unsigned short*>(v) + j));
}

// kLaneEntries values from j, one vector load (16 bytes f32, 8 bf16)
__device__ __forceinline__ void load_values4(const float* v, long long j, double (&out)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(v + j));
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}
__device__ __forceinline__ void load_values4(const uint16_t* v, long long j, double (&out)[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(v + j));
  out[0] = bf16_bits(q.x & 0xffffu);
  out[1] = bf16_bits(q.x >> 16);
  out[2] = bf16_bits(q.y & 0xffffu);
  out[3] = bf16_bits(q.y >> 16);
}

template <typename V>
__device__ __forceinline__ bool values_aligned(const V* v, long long j) {
  return (reinterpret_cast<uintptr_t>(v + j) & (sizeof(V) * kLaneEntries - 1)) == 0;
}

// an entry's factor: its value, or its square
template <bool SQ>
__device__ __forceinline__ double factor(double v) {
  return SQ ? v * v : v;
}

// acc + x * f, one rounding: the same operation for every column and width
__device__ __forceinline__ double add_term(double acc, float x, double f) { return __fma_rn((double)x, f, acc); }

// ------------------------------------------------------------ row groups

template <typename V, bool SQ, int G, int W>
__global__ void __launch_bounds__(kThreads)
    row_group_kernel(const int* __restrict__ ptr32, const long long* __restrict__ ptr64, long long seg_len,
                     long long n_seg, const int* __restrict__ gather, const V* __restrict__ val,
                     const float* __restrict__ src, float* __restrict__ out, int L, int col0, int width, int vec) {
  constexpr int SW = Cols<W>::SW, NS = Cols<W>::NS;
  constexpr int kPerWarp = kWarp / G;
  const int c0 = col0 + blockIdx.y * W;
  const int lane = threadIdx.x & (kWarp - 1);
  const int q = lane & (G - 1);
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock * kPerWarp;
  // the loop bound is the same for the whole warp: every lane reaches the
  // shuffles below
  for (long long first = warp * kPerWarp; first < n_seg; first += stride) {
    const long long s = first + lane / G;
    long long start = 0, end = 0;
    if (s < n_seg) {
      if (ptr32 != nullptr) {
        start = __ldcs(ptr32 + s);
        end = __ldcs(ptr32 + s + 1);
      } else if (ptr64 != nullptr) {
        start = __ldcs(ptr64 + s);
        end = __ldcs(ptr64 + s + 1);
      } else {
        start = s * seg_len;
        end = start + seg_len;
      }
    }
    double acc[NS][SW];
#pragma unroll
    for (int k = 0; k < NS; ++k)
#pragma unroll
      for (int c = 0; c < SW; ++c) acc[k][c] = 0.0;
#pragma unroll (W <= kSub ? 2 : 1)
    for (long long j = start + q * kLaneEntries; j < end; j += G * kLaneEntries) {
      int idx[kLaneEntries];
      double v[kLaneEntries];
      if (j + kLaneEntries <= end && (reinterpret_cast<uintptr_t>(gather + j) & 15) == 0 && values_aligned(val, j)) {
        const int4 g = __ldcs(reinterpret_cast<const int4*>(gather + j));
        idx[0] = g.x;
        idx[1] = g.y;
        idx[2] = g.z;
        idx[3] = g.w;
        load_values4(val, j, v);
      } else {
#pragma unroll
        for (int e = 0; e < kLaneEntries; ++e) {
          const bool live = j + e < end;
          idx[e] = live ? __ldcs(gather + j + e) : -1;
          v[e] = live ? load_value(val, j + e) : 0.0;
        }
      }
      // every gather of the pass, for the whole panel, before the first add
      float x[kLaneEntries][NS][SW];
#pragma unroll
      for (int e = 0; e < kLaneEntries; ++e) {
        const float* row = src + (long long)(idx[e] >= 0 ? idx[e] : 0) * L + c0;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          if (idx[e] >= 0 && k * SW < width) {
            gather_cols<SW>(row + k * SW, width - k * SW, vec, x[e][k]);
          } else {
#pragma unroll
            for (int c = 0; c < SW; ++c) x[e][k][c] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kLaneEntries; ++e)
        if (idx[e] >= 0) {
          const double f = factor<SQ>(v[e]);
#pragma unroll
          for (int k = 0; k < NS; ++k)
#pragma unroll
            for (int c = 0; c < SW; ++c) acc[k][c] = add_term(acc[k][c], x[e][k][c], f);
        }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < NS; ++k)
#pragma unroll
        for (int c = 0; c < SW; ++c) acc[k][c] += __shfl_xor_sync(kFull, acc[k][c], off);
    }
    // every lane of the group holds the same sums: lane q stores the
    // sub-chunks k with k mod G = q, so the row's panel leaves in one
    // contiguous store across the group
    if (s < n_seg) {
      float* row = out + s * L + c0;
#pragma unroll
      for (int k = 0; k < NS; ++k)
        if (k % G == q && k * SW < width) store_cols<SW>(row + k * SW, width - k * SW, vec, acc[k]);
    }
  }
}

// -------------------------------------------------------------- key walk

// the key walk's shared memory at capacity W: a warp's slots (kRunEntries
// per lane, W floats each, each lane's block padded so that the lanes'
// stores fall in distinct banks) and its map of kRows output rows to slots.
// One column (S1) needs no slots: its sums stay in registers and the map
// holds the rows' sums themselves, 1,024 rows at a time.
template <int W>
struct Walk {
  static constexpr int kPad = W % kSub == 0 ? kSub : 1;
  static constexpr int kLaneFloats = W == 1 ? 0 : kRunEntries * W + kPad;
  static constexpr int kSlotFloats = kWarp * kLaneFloats;
  static constexpr int kRows = W == 1 ? 1024 : kMapRows;
  static constexpr int kWarps = W >= 8 ? 4 : kWarpsPerBlock;
  static constexpr int kBytes = kWarps * (kSlotFloats + kRows) * 4;
};

template <typename V, bool SQ, int W>
__global__ void __launch_bounds__(Walk<W>::kWarps * kWarp)
    key_walk_kernel(const int* __restrict__ keys, const int* __restrict__ gather, const V* __restrict__ val,
                    long long nnz, int n_seg, int vector_loads, const float* __restrict__ src,
                    float* __restrict__ out, double* __restrict__ head, double* __restrict__ tail, int L, int col0,
                    int width, int vec) {
  using S = Walk<W>;
  constexpr int SW = Cols<W>::SW, NS = Cols<W>::NS;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int wib = threadIdx.x / kWarp;
  float* slots = smem + wib * S::kSlotFloats;
  float* mine = slots + lane * S::kLaneFloats;
  int* map = reinterpret_cast<int*>(smem + S::kWarps * S::kSlotFloats) + wib * S::kRows;
  const int c0 = col0 + blockIdx.y * W;
  // the output stores: `per_row` items a row (float4s where the panel's
  // rows are 16-byte aligned), rows_step rows a warp store
  const bool vec_out = W >= kSub && vec && width % kSub == 0;
  const int per_row = vec_out ? width / kSub : width;
  const int rows_step = kWarp / per_row;
  const int my_row = lane / per_row, my_item = lane % per_row;
  const long long n_tiles = (nnz + kTile - 1) / kTile;
  const long long warps = (long long)gridDim.x * S::kWarps;
  for (long long tile = (long long)blockIdx.x * S::kWarps + wib; tile < n_tiles; tile += warps) {
    const long long base = tile * kTile + (long long)lane * kRunEntries;
    const long long left = nnz - base;
    const int cnt = left <= 0 ? 0 : (left < kRunEntries ? (int)left : kRunEntries);
    int key[kRunEntries], idx[kRunEntries];
    double v[kRunEntries];
    if (cnt == kRunEntries && vector_loads) {
#pragma unroll
      for (int h = 0; h < kRunEntries; h += 4) {
        const int4 k4 = __ldcs(reinterpret_cast<const int4*>(keys + base + h));
        const int4 g4 = __ldcs(reinterpret_cast<const int4*>(gather + base + h));
        key[h] = k4.x;
        key[h + 1] = k4.y;
        key[h + 2] = k4.z;
        key[h + 3] = k4.w;
        idx[h] = g4.x;
        idx[h + 1] = g4.y;
        idx[h + 2] = g4.z;
        idx[h + 3] = g4.w;
        double v4[4];
        load_values4(val, base + h, v4);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[h + e] = v4[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < kRunEntries; ++e) {
        const bool live = e < cnt;
        key[e] = live ? __ldcs(keys + base + e) : n_seg;
        idx[e] = live ? __ldcs(gather + base + e) : 0;
        v[e] = live ? load_value(val, base + e) : 0.0;
      }
    }

    // the gathered columns of one sub-chunk; one column's go out with the
    // entries (a wider panel's would hold their registers through the key
    // analysis below)
    float x[kRunEntries][SW];
    if constexpr (W == 1) gather_sub<SW>(src, idx, cnt, L, c0, 1, vec, x);

    // the keys around the lane's entries: n_seg past the last entry, -1
    // before the first
    const int first = key[0];
    int last = n_seg;
#pragma unroll
    for (int e = 0; e < kRunEntries; ++e)
      if (e < cnt) last = key[e];
    int prev = __shfl_up_sync(kFull, last, 1);
    int next = __shfl_down_sync(kFull, first, 1);
    if (lane == 0) prev = base > 0 ? __ldcs(keys + base - 1) : -1;
    if (lane == kWarp - 1) next = base + kRunEntries < nnz ? __ldcs(keys + base + kRunEntries) : n_seg;
    const bool open_left = cnt > 0 && prev == first;
    const bool open_right = cnt > 0 && next == last;

    // each sub-chunk of the panel's columns: S1's operations column by
    // column. The runs depend on the keys alone, so every sub-chunk finds
    // the same ones.
    float res[kRunEntries], first_res = 0.0f;  // one column: the sums to write
    bool through = false, write_first = false;
    unsigned closed = 0u;  // bit e: the run ending at entry e is this lane's to write
    int e_first = 0;       // the entry at which an open-left first run closes
    int last_lane = 0;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (k * SW >= width) break;  // the same for the whole warp
      const int cs = k * SW;
      const int n_cols = width - cs < SW ? width - cs : SW;
      if constexpr (W > 1) gather_sub<SW>(src, idx, cnt, L, c0 + cs, n_cols, vec, x);

      // runs of equal keys, in entry order
      double acc[SW], first_sum[SW];
#pragma unroll
      for (int c = 0; c < SW; ++c) acc[c] = first_sum[c] = 0.0;
      bool in_first = true;
      bool first_closes = false;  // an open-left first run closes in this lane
      closed = 0u;
#pragma unroll
      for (int e = 0; e < kRunEntries; ++e) {
        if constexpr (W == 1) res[e] = 0.0f;
        if (e < cnt) {
          const double f = factor<SQ>(v[e]);
#pragma unroll
          for (int c = 0; c < SW; ++c) acc[c] = add_term(acc[c], x[e][c], f);
          const int after = e + 1 < cnt ? key[e + 1] : next;
          if (after != key[e]) {
            if (in_first && open_left) {
#pragma unroll
              for (int c = 0; c < SW; ++c) first_sum[c] = acc[c];
              first_closes = true;
              e_first = e;
            } else {
              if constexpr (W == 1) {
                res[e] = (float)acc[0];
              } else {
                store_cols<SW>(mine + e * W + cs, n_cols, n_cols == kSub, acc);
              }
              closed |= 1u << e;
            }
#pragma unroll
            for (int c = 0; c < SW; ++c) acc[c] = 0.0;
            in_first = false;
          }
        }
      }
      through = open_left && in_first;  // one run, open at both ends

      // segmented inclusive scan of the open-right partials over the lanes:
      // a lane that runs through adds the chain on its left, earlier first
      double s[SW];
#pragma unroll
      for (int c = 0; c < SW; ++c) s[c] = open_right ? acc[c] : 0.0;
      bool chained = through;
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        double up[SW];
#pragma unroll
        for (int c = 0; c < SW; ++c) up[c] = __shfl_up_sync(kFull, s[c], d);
        const int up_chained = __shfl_up_sync(kFull, (int)chained, d);
        if (chained && lane >= d) {
#pragma unroll
          for (int c = 0; c < SW; ++c) s[c] = up[c] + s[c];
          chained = up_chained != 0;
        }
      }
      double carry[SW];
#pragma unroll
      for (int c = 0; c < SW; ++c) carry[c] = __shfl_up_sync(kFull, s[c], 1);
      const unsigned through_mask = __ballot_sync(kFull, through);
      const unsigned below = (1u << lane) - 1u;
      // the open-left first run's key began in an earlier tile: its join adds the rest
      const bool joined = (through_mask & below) == below;
      write_first = first_closes && !joined;
      if (first_closes) {
        double total[SW];
#pragma unroll
        for (int c = 0; c < SW; ++c) total[c] = (lane > 0 ? carry[c] : 0.0) + first_sum[c];
        if (!joined) {
          if constexpr (W == 1) {
            first_res = (float)total[0];
          } else {
            store_cols<SW>(mine + e_first * W + cs, n_cols, n_cols == kSub, total);
          }
        } else if (head != nullptr) {
#pragma unroll
          for (int c = 0; c < SW; ++c)
            if (c < n_cols) head[tile * L + c0 + cs + c] = total[c];
        }
      }
      const unsigned holders = __ballot_sync(kFull, cnt > 0);
      last_lane = kWarp - 1 - __clz(holders);
      if (lane == last_lane && open_right && tail != nullptr) {
        // the key goes on into the next tile
#pragma unroll
        for (int c = 0; c < SW; ++c)
          if (c < n_cols) tail[tile * L + c0 + cs + c] = s[c];
      }
    }

    // the tile's outputs: from one past the key before it to its last key
    // (less that key if it goes on; to the end for the last tile), each row
    // its slot's sums or zeros
    const int tile_prev = __shfl_sync(kFull, prev, 0);
    const int tile_last = __shfl_sync(kFull, last, last_lane);
    const int tile_next = __shfl_sync(kFull, next, last_lane);
    const long long lo = (long long)tile_prev + 1;
    const long long hi = tile_next == n_seg ? n_seg : (tile_next == tile_last ? tile_last : (long long)tile_last + 1);
    for (long long w0 = lo; w0 < hi; w0 += S::kRows) {
      const int n = hi - w0 < S::kRows ? (int)(hi - w0) : S::kRows;
      if constexpr (W == 1) {
        // one column: the window holds the rows' sums themselves
        float* win = reinterpret_cast<float*>(map);
        for (int r = lane; r < n; r += kWarp) win[r] = 0.0f;
        __syncwarp();
#pragma unroll
        for (int e = 0; e < kRunEntries; ++e) {
          const long long r = (long long)key[e] - w0;
          if (((closed >> e) & 1u) && r >= 0 && r < n) win[r] = res[e];
        }
        if (write_first && first - w0 >= 0 && first - w0 < n) win[first - w0] = first_res;
        __syncwarp();
        for (int r = lane; r < n; r += kWarp) out[(w0 + r) * L + c0] = win[r];
      } else {
        const unsigned written = closed | (write_first ? 1u << e_first : 0u);
        for (int r = lane; r < n; r += kWarp) map[r] = -1;
        __syncwarp();
#pragma unroll
        for (int e = 0; e < kRunEntries; ++e) {
          const long long r = (long long)key[e] - w0;
          if (((written >> e) & 1u) && r >= 0 && r < n) map[r] = lane * kRunEntries + e;
        }
        __syncwarp();
        if (my_row < rows_step) {
          for (int r = my_row; r < n; r += rows_step) {
            const int slot = map[r];
            const float* from = slots + (slot / kRunEntries) * S::kLaneFloats + (slot % kRunEntries) * W;
            float* to = out + (w0 + r) * L + c0;
            if (vec_out) {
              const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              *reinterpret_cast<float4*>(to + my_item * kSub) =
                  slot < 0 ? z : *reinterpret_cast<const float4*>(from + my_item * kSub);
            } else {
              to[my_item] = slot < 0 ? 0.0f : from[my_item];
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// out[key] for each key that crosses a tile boundary: its first tile's
// tail, the tails of the tiles it runs through and its last tile's head,
// added in tile order, every column of the panel in one pass over the
// tiles. A lane per join; a chain of more than kSerialTiles tiles is added
// by the whole warp (lane-strided runs, then a butterfly).
template <int W>
__global__ void __launch_bounds__(kThreads)
    join_kernel(const int* __restrict__ joins, long long n_joins, const double* __restrict__ head,
                const double* __restrict__ tail, float* __restrict__ out, int L, int col0, int width) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c0 = col0 + blockIdx.y * W;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) & ~(long long)(kWarp - 1);
       first < n_joins; first += stride) {
    const long long i = first + lane;
    const bool live = i < n_joins;
    int key = 0;
    long long u = 0, w = 0;
    if (live) {
      key = joins[3 * i];
      u = joins[3 * i + 1];
      w = joins[3 * i + 2];
    }
    const bool wide = live && w - u > kSerialTiles;
    double acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = 0.0;
    if (live && !wide) {
      for (long long t = u; t < w; ++t) {
#pragma unroll
        for (int c = 0; c < W; ++c)
          if (c < width) acc[c] += tail[t * L + c0 + c];
      }
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < width) acc[c] += head[w * L + c0 + c];
    }
    unsigned pending = __ballot_sync(kFull, wide);
    while (pending != 0u) {
      const int owner = __ffs(pending) - 1;
      pending &= pending - 1u;
      const long long a = __shfl_sync(kFull, u, owner);
      const long long b = __shfl_sync(kFull, w, owner);
      double part[W];
#pragma unroll
      for (int c = 0; c < W; ++c) part[c] = 0.0;
      for (long long t = a + lane; t < b; t += kWarp) {
#pragma unroll
        for (int c = 0; c < W; ++c)
          if (c < width) part[c] += tail[t * L + c0 + c];
      }
#pragma unroll
      for (int c = 0; c < W; ++c) {
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) part[c] += __shfl_xor_sync(kFull, part[c], off);
        if (lane == owner && c < width) acc[c] = part[c] + head[b * L + c0 + c];
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < width) out[(long long)key * L + c0 + c] = (float)acc[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads) zero_kernel(long long n, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += (long long)gridDim.x * kThreads)
    out[i] = 0.0f;
}

long long blocks_for(long long work_items, long long per_block) {
  long long blocks = (work_items + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

// one panel launch (or `panels` of them on the grid's y axis, W columns
// apart): columns [col0 + y * W, + width)
struct Panel {
  int col0, width, panels;
};

template <typename V, bool SQ, int W>
cudaError_t launch_rows(int group, const int* ptr32, const long long* ptr64, long long seg_len, long long n_seg,
                        const int* gather, const void* val, const float* src, float* out, int L, Panel p, int vec,
                        cudaStream_t st) {
  const V* v = static_cast<const V*>(val);
  const dim3 grid((unsigned)blocks_for(n_seg * group, kThreads), (unsigned)p.panels);
  switch (group) {
    case 4:
      row_group_kernel<V, SQ, 4, W><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out, L,
                                                               p.col0, p.width, vec);
      break;
    case 8:
      row_group_kernel<V, SQ, 8, W><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out, L,
                                                               p.col0, p.width, vec);
      break;
    case 16:
      row_group_kernel<V, SQ, 16, W><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out,
                                                                L, p.col0, p.width, vec);
      break;
    default:
      row_group_kernel<V, SQ, 32, W><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out,
                                                                L, p.col0, p.width, vec);
  }
  return cudaGetLastError();
}

template <typename V, bool SQ, int W>
cudaError_t launch_keys(const int* keys, const int* gather, const void* val, long long nnz, long long n_seg,
                        const int* joins, long long n_joins, const float* src, float* out, double* head,
                        double* tail, int L, Panel p, int vec, cudaStream_t st) {
  using S = Walk<W>;
  const V* v = static_cast<const V*>(val);
  if (S::kBytes > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(key_walk_kernel<V, SQ, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (err != cudaSuccess) return err;
  }
  const int vector_loads = ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(gather) |
                             reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  const long long n_tiles = (nnz + kTile - 1) / kTile;
  key_walk_kernel<V, SQ, W><<<dim3((unsigned)blocks_for(n_tiles, S::kWarps), (unsigned)p.panels), S::kWarps * kWarp,
                              S::kBytes, st>>>(keys, gather, v, nnz, (int)n_seg, vector_loads, src, out, head, tail,
                                               L, p.col0, p.width, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_joins == 0) return err;
  join_kernel<W><<<dim3((unsigned)blocks_for(n_joins, kThreads), (unsigned)p.panels), kThreads, 0, st>>>(
      joins, n_joins, head, tail, out, L, p.col0, p.width);
  return cudaGetLastError();
}

// Each launch form as a functor over the capacity W, so that one plan
// drives both.
template <typename V>
struct RowsLaunch {
  int group;
  const int* ptr32;
  const long long* ptr64;
  long long seg_len, n_seg;
  const int* gather;
  const void* val;
  const float* src;
  float* out;
  int L, vec;
  cudaStream_t st;
  template <int W>
  cudaError_t run(Panel p) const {
    return launch_rows<V, false, W>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, L, p, vec, st);
  }
};

template <typename V>
struct KeysLaunch {
  const int* keys;
  const int* gather;
  const void* val;
  long long nnz, n_seg;
  const int* joins;
  long long n_joins;
  const float* src;
  float* out;
  double *head, *tail;
  int L, vec;
  cudaStream_t st;
  template <int W>
  cudaError_t run(Panel p) const {
    return launch_keys<V, false, W>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail, L, p, vec,
                                    st);
  }
};

// the panels of L columns: L / kPanel full panels in one launch, then one
// panel of the L % kPanel columns left at the narrowest capacity that
// holds them (ops/sparse.py lane_plan mirrors this)
template <typename F>
cudaError_t run_panels(const F& f, int L) {
  const int full = L / kPanel, rest = L % kPanel;
  if (full > 0) {
    const cudaError_t err = f.template run<kPanel>(Panel{0, kPanel, full});
    if (err != cudaSuccess || rest == 0) return err;
  }
  const Panel p{full * kPanel, rest, 1};
  switch (capacity_for(rest)) {
    case 1:
      return f.template run<1>(p);
    case 4:
      return f.template run<4>(p);
    case 8:
      return f.template run<8>(p);
    case 12:
      return f.template run<12>(p);
    default:
      return f.template run<16>(p);
  }
}

// float4 loads and stores along the rows: L a multiple of 4, src and out
// 16-byte aligned
int vector_rows(const float* src, const float* out, int L) {
  return L % kSub == 0 && ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

bool bad_rows(int group, const int* ptr32, const long long* ptr64, long long seg_len, long long n_seg) {
  return n_seg < 0 || seg_len < 0 || (ptr32 != nullptr && ptr64 != nullptr) ||
         (group != 4 && group != 8 && group != 16 && group != 32);
}

// the full panels go on the grid's y axis; the squared values take one lane
bool bad_lanes(int square, int n_lanes) {
  return n_lanes < 1 || n_lanes > kMaxPanels * kPanel || (square && n_lanes != 1);
}

bool bad_keys(long long nnz, long long n_seg, const int* joins, long long n_joins, const double* head,
              const double* tail) {
  return nnz < 0 || n_seg < 0 || n_seg > 0x7fffffffLL || n_joins < 0 ||
         (n_joins > 0 && (joins == nullptr || head == nullptr || tail == nullptr));
}

}  // namespace

extern "C" {

// The key walk's tile (entries a warp), which the host's joins follow.
int segment_tile_entries() { return kTile; }

// The widest panel (columns a pass over the entries), the sub-chunk's
// columns, and the capacity a panel of `width` columns takes (1 to
// kPanel), which ops/sparse.py's plan mirrors.
int segment_panel_columns() { return kPanel; }
int segment_sub_columns() { return kSub; }
int segment_panel_capacity(int width) { return width < 1 || width > kPanel ? 0 : capacity_for(width); }

// Row groups: out[s, l] for s < n_seg, l < n_lanes over the segments
// [ptr[s], ptr[s + 1]) (ptr32: int32, or ptr64: int64, [n_seg + 1]; both
// null for uniform segments of seg_len entries), `group` lanes a segment
// (4, 8, 16 or 32). gather: int32 [nnz] source index of each entry; val:
// [nnz] float32 (bf16 = 0) or bfloat16 (bf16 = 1); src: row-major float32
// [n_src, n_lanes]; out: row-major float32 [n_seg, n_lanes]. square = 1
// sums src * val^2 (one lane only). S1 is n_lanes = 1. Launches on
// `stream` (one launch per panel form: two where n_lanes is over 16 and
// not a multiple of 16); returns a cudaError_t (cudaErrorInvalidValue for a
// bad argument; 0 and no launch for n_seg 0).
int segment_rows_launch(int bf16, int square, int group, const int* ptr32, const long long* ptr64,
                        long long seg_len, long long n_seg, const int* gather, const void* val, const float* src,
                        float* out, int n_lanes, void* stream) {
  if (bad_rows(group, ptr32, ptr64, seg_len, n_seg) || bad_lanes(square, n_lanes)) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Panel one{0, 1, 1};
  if (square)
    return (int)(bf16 ? launch_rows<uint16_t, true, 1>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, 1,
                                                       one, 0, st)
                      : launch_rows<float, true, 1>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, 1,
                                                    one, 0, st));
  const int vec = vector_rows(src, out, n_lanes);
  if (bf16)
    return (int)run_panels(
        RowsLaunch<uint16_t>{group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, n_lanes, vec, st}, n_lanes);
  return (int)run_panels(RowsLaunch<float>{group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, n_lanes, vec, st},
                         n_lanes);
}

// Key walk: out[s, l] for s < n_seg (< 2^31), l < n_lanes over nnz entries
// whose int32 keys (ascending, each < n_seg) name their segment; gather,
// val, src, out, square and n_lanes as above. joins: int32 [n_joins, 3],
// (key, first tile, last tile) of each key whose entries cross a boundary
// of kTile entries, in key order; head and tail: float64
// [ceil(nnz / kTile) * n_lanes] scratch, null when n_joins is 0. A second
// launch per panel form adds the joins when n_joins > 0.
int segment_keys_launch(int bf16, int square, const int* keys, const int* gather, const void* val, long long nnz,
                        long long n_seg, const int* joins, long long n_joins, const float* src, float* out,
                        double* head, double* tail, int n_lanes, void* stream) {
  if (bad_keys(nnz, n_seg, joins, n_joins, head, tail) || bad_lanes(square, n_lanes))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nnz == 0) {
    zero_kernel<<<(unsigned)blocks_for(n_seg * n_lanes, kThreads), kThreads, 0, st>>>(n_seg * n_lanes, out);
    return (int)cudaGetLastError();
  }
  const Panel one{0, 1, 1};
  if (square)
    return (int)(bf16 ? launch_keys<uint16_t, true, 1>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head,
                                                       tail, 1, one, 0, st)
                      : launch_keys<float, true, 1>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head,
                                                    tail, 1, one, 0, st));
  const int vec = vector_rows(src, out, n_lanes);
  if (bf16)
    return (int)run_panels(KeysLaunch<uint16_t>{keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail,
                                                n_lanes, vec, st},
                           n_lanes);
  return (int)run_panels(
      KeysLaunch<float>{keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail, n_lanes, vec, st},
      n_lanes);
}

}  // extern "C"
