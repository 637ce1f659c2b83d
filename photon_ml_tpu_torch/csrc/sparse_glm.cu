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
// over a row-major src [n_src, L] and out [n_seg, L]. A thread takes C
// consecutive columns of one chunk (C = 4, 3, 2 or 1, the largest that
// divides L; blockIdx.y is the chunk) with one gather of C contiguous floats
// an entry, and runs for each column exactly the operations S1 runs for its
// one: the same partition of entries over lanes, the same adds in the same
// order, the same butterfly and scan. S1 is the case L = C = 1, so column l
// of S2 is, bit for bit, S1 on column l of src. ops/features.py builds each product's
// companions once per matrix on the host (ops/sparse.py), in one of two
// forms, and each form has its kernel:
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
// a log2(G)-step butterfly, and lane 0 of the group writes the output.
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
// keys the joins write: it zeroes a window of them in shared memory, puts
// its closed sums in, and writes the window out with coalesced stores, so
// that gaps between keys (empty columns) are written as zeros, once.
//
// Order: the layout alone fixes the summation order (G comes from the
// layout, kTile and kRunEntries are constants), not the grid or the timing
// of blocks: two launches give the same bits. The order differs from the
// earlier warp-per-segment design, so the bits may differ from its by the
// rounding of a double sum.
//
// What bounds it: the gathers. Each entry is an index (4 bytes) and a
// value (4 or 2), plus its key in the key walk, streamed with evict-first
// loads (__ldcs), and one gather of src from an unpredictable address: a
// 32-byte sector through L1 and L2 for 4 useful bytes. Two double
// operations an entry are far below the card's rate. Measured on an H100
// at bench.py's sparse shape (chip_smoke.py phase 8, PERF.md): with the
// gathers replaced by contiguous reads, matvec takes a quarter of its time
// and the key walk five eighths; the 6.4 M random gathers alone take ~0.03
// ms from L2, and w (40 MB at d = 10,000,000) does not stay in L2 (matvec
// takes ~0.058 ms with w at 10 or 20 MB, ~0.09 at 40), with or without an
// L2 evict-last policy on the gathers, so none is used. The design keeps many
// gathers in flight (every lane issues all of its own before it adds), the
// stores coalesced, and the column direction free of per-column pointers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kLaneEntries = 4;                // row groups: entries a lane takes a pass
constexpr int kRunEntries = 8;                 // key walk: entries a lane walks
constexpr int kTile = kWarp * kRunEntries;     // key walk: entries a warp tile
constexpr int kWindow = 1024;                  // key walk: outputs a warp stages at a time
constexpr int kSerialTiles = 32;               // joins: a chain of more tiles is added by a warp
constexpr long long kMaxBlocks = 1LL << 20;
constexpr unsigned kFull = 0xffffffffu;

// the C columns from c0 of src's row i (rows of L floats) through the
// read-only path, one vector load where the address allows
template <int C>
__device__ __forceinline__ void gather_src(const float* __restrict__ src, int i, int L, int c0, float (&x)[C]) {
  const float* p = src + (long long)i * L + c0;
  if constexpr (C == 4) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
      return;
    }
  } else if constexpr (C == 2) {
    if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      x[0] = q.x;
      x[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = __ldg(p + c);
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

template <bool SQ>
__device__ __forceinline__ double term(float x, double v) {
  return (double)x * (SQ ? v * v : v);
}

// ------------------------------------------------------------ row groups

template <typename V, bool SQ, int G, int C>
__global__ void __launch_bounds__(kThreads)
    row_group_kernel(const int* __restrict__ ptr32, const long long* __restrict__ ptr64, long long seg_len,
                     long long n_seg, const int* __restrict__ gather, const V* __restrict__ val,
                     const float* __restrict__ src, float* __restrict__ out, int L) {
  constexpr int kPerWarp = kWarp / G;
  const int c0 = blockIdx.y * C;
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
    double acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0;
#pragma unroll 2
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
      float x[kLaneEntries][C];
#pragma unroll
      for (int e = 0; e < kLaneEntries; ++e) {
        if (idx[e] >= 0) {
          gather_src<C>(src, idx[e], L, c0, x[e]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) x[e][c] = 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < kLaneEntries; ++e)
        if (idx[e] >= 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += term<SQ>(x[e][c], v[e]);
        }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += __shfl_xor_sync(kFull, acc[c], off);
    }
    if (q == 0 && s < n_seg) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[s * L + c0 + c] = (float)acc[c];
    }
  }
}

// -------------------------------------------------------------- key walk

template <typename V, bool SQ, int C>
__global__ void __launch_bounds__(kThreads)
    key_walk_kernel(const int* __restrict__ keys, const int* __restrict__ gather, const V* __restrict__ val,
                    long long nnz, int n_seg, int vector_loads, const float* __restrict__ src,
                    float* __restrict__ out, double* __restrict__ head, double* __restrict__ tail, int L) {
  // a warp stages kWindow / C output rows of its C columns at a time
  constexpr int kRows = kWindow / C;
  __shared__ float window[kWarpsPerBlock][kWindow];
  const int lane = threadIdx.x & (kWarp - 1);
  const int c0 = blockIdx.y * C;
  float* win = window[threadIdx.x / kWarp];
  const long long n_tiles = (nnz + kTile - 1) / kTile;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long tile = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp; tile < n_tiles;
       tile += warps) {
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
    float x[kRunEntries][C];
#pragma unroll
    for (int e = 0; e < kRunEntries; ++e) {
      if (e < cnt) {
        gather_src<C>(src, idx[e], L, c0, x[e]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) x[e][c] = 0.0f;
      }
    }

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

    // runs of equal keys, in entry order
    const bool open_left = cnt > 0 && prev == first;
    double acc[C], first_sum[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = first_sum[c] = 0.0;
    bool in_first = true;
    bool first_closes = false;  // an open-left first run closes in this lane
    unsigned closed = 0u;       // bit e: the run ending at entry e is this lane's to write
    float res[kRunEntries][C];
#pragma unroll
    for (int e = 0; e < kRunEntries; ++e) {
#pragma unroll
      for (int c = 0; c < C; ++c) res[e][c] = 0.0f;
      if (e < cnt) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += term<SQ>(x[e][c], v[e]);
        const int after = e + 1 < cnt ? key[e + 1] : next;
        if (after != key[e]) {
          if (in_first && open_left) {
#pragma unroll
            for (int c = 0; c < C; ++c) first_sum[c] = acc[c];
            first_closes = true;
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) res[e][c] = (float)acc[c];
            closed |= 1u << e;
          }
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = 0.0;
          in_first = false;
        }
      }
    }
    const bool open_right = cnt > 0 && next == last;
    const bool through = open_left && in_first;  // one run, open at both ends

    // segmented inclusive scan of the open-right partials over the lanes:
    // a lane that runs through adds the chain on its left, earlier first
    double s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = open_right ? acc[c] : 0.0;
    bool chained = through;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      double up[C];
#pragma unroll
      for (int c = 0; c < C; ++c) up[c] = __shfl_up_sync(kFull, s[c], d);
      const int up_chained = __shfl_up_sync(kFull, (int)chained, d);
      if (chained && lane >= d) {
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = up[c] + s[c];
        chained = up_chained != 0;
      }
    }
    double carry[C];
#pragma unroll
    for (int c = 0; c < C; ++c) carry[c] = __shfl_up_sync(kFull, s[c], 1);
    const unsigned through_mask = __ballot_sync(kFull, through);
    const unsigned below = (1u << lane) - 1u;
    bool write_first = false;  // the open-left first run's key (key[0]) is this lane's to write
    float first_res[C];
#pragma unroll
    for (int c = 0; c < C; ++c) first_res[c] = 0.0f;
    if (first_closes) {
      double total[C];
#pragma unroll
      for (int c = 0; c < C; ++c) total[c] = (lane > 0 ? carry[c] : 0.0) + first_sum[c];
      if ((through_mask & below) == below) {
        // the key began in an earlier tile: its join adds the rest
        if (head != nullptr) {
#pragma unroll
          for (int c = 0; c < C; ++c) head[tile * L + c0 + c] = total[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) first_res[c] = (float)total[c];
        write_first = true;
      }
    }
    const unsigned holders = __ballot_sync(kFull, cnt > 0);
    const int last_lane = kWarp - 1 - __clz(holders);
    if (lane == last_lane && open_right && tail != nullptr) {
      // the key goes on into the next tile
#pragma unroll
      for (int c = 0; c < C; ++c) tail[tile * L + c0 + c] = s[c];
    }

    // the tile's outputs: from one past the key before it to its last key
    // (less that key if it goes on; to the end for the last tile)
    const int tile_prev = __shfl_sync(kFull, prev, 0);
    const int tile_last = __shfl_sync(kFull, last, last_lane);
    const int tile_next = __shfl_sync(kFull, next, last_lane);
    const long long lo = (long long)tile_prev + 1;
    const long long hi = tile_next == n_seg ? n_seg : (tile_next == tile_last ? tile_last : (long long)tile_last + 1);
    for (long long w0 = lo; w0 < hi; w0 += kRows) {
      const int n = hi - w0 < kRows ? (int)(hi - w0) : kRows;
      for (int c = lane; c < n * C; c += kWarp) win[c] = 0.0f;
      __syncwarp();
#pragma unroll
      for (int e = 0; e < kRunEntries; ++e) {
        const long long r = (long long)key[e] - w0;
        if (((closed >> e) & 1u) && r >= 0 && r < n) {
#pragma unroll
          for (int c = 0; c < C; ++c) win[r * C + c] = res[e][c];
        }
      }
      if (write_first && first - w0 >= 0 && first - w0 < n) {
#pragma unroll
        for (int c = 0; c < C; ++c) win[(first - w0) * C + c] = first_res[c];
      }
      __syncwarp();
      for (int c = lane; c < n * C; c += kWarp) out[(w0 + c / C) * L + c0 + c % C] = win[c];
      __syncwarp();
    }
  }
}

// out[key] for each key that crosses a tile boundary: its first tile's
// tail, the tails of the tiles it runs through and its last tile's head,
// added in tile order, column by column. A lane per join; a chain of more
// than kSerialTiles tiles is added by the whole warp (lane-strided runs,
// then a butterfly).
template <int C>
__global__ void __launch_bounds__(kThreads)
    join_kernel(const int* __restrict__ joins, long long n_joins, const double* __restrict__ head,
                const double* __restrict__ tail, float* __restrict__ out, int L) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c0 = blockIdx.y * C;
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
    double acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0;
    if (live && !wide) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        for (long long t = u; t < w; ++t) acc[c] += tail[t * L + c0 + c];
        acc[c] += head[w * L + c0 + c];
      }
    }
    unsigned pending = __ballot_sync(kFull, wide);
    while (pending != 0u) {
      const int owner = __ffs(pending) - 1;
      pending &= pending - 1u;
      const long long a = __shfl_sync(kFull, u, owner);
      const long long b = __shfl_sync(kFull, w, owner);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        double part = 0.0;
        for (long long t = a + lane; t < b; t += kWarp) part += tail[t * L + c0 + c];
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
        if (lane == owner) acc[c] = part + head[b * L + c0 + c];
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[(long long)key * L + c0 + c] = (float)acc[c];
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

// the columns a thread takes: the widest chunk that divides L (a column
// chunk of its own re-reads every entry, and its gathers miss the sectors
// the other chunks' fetched)
int chunk_for(int L) { return L % 4 == 0 ? 4 : (L % 3 == 0 ? 3 : (L % 2 == 0 ? 2 : 1)); }

template <typename V, bool SQ, int C>
cudaError_t launch_rows(int group, const int* ptr32, const long long* ptr64, long long seg_len, long long n_seg,
                        const int* gather, const void* val, const float* src, float* out, int L, cudaStream_t st) {
  const V* v = static_cast<const V*>(val);
  const dim3 grid((unsigned)blocks_for(n_seg * group, kThreads), (unsigned)(L / C));
  switch (group) {
    case 4:
      row_group_kernel<V, SQ, 4, C><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out, L);
      break;
    case 8:
      row_group_kernel<V, SQ, 8, C><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out, L);
      break;
    case 16:
      row_group_kernel<V, SQ, 16, C><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out, L);
      break;
    default:
      row_group_kernel<V, SQ, 32, C><<<grid, kThreads, 0, st>>>(ptr32, ptr64, seg_len, n_seg, gather, v, src, out, L);
  }
  return cudaGetLastError();
}

template <typename V, bool SQ, int C>
cudaError_t launch_keys(const int* keys, const int* gather, const void* val, long long nnz, long long n_seg,
                        const int* joins, long long n_joins, const float* src, float* out, double* head,
                        double* tail, int L, cudaStream_t st) {
  const V* v = static_cast<const V*>(val);
  const int vector_loads = ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(gather) |
                             reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  const long long n_tiles = (nnz + kTile - 1) / kTile;
  key_walk_kernel<V, SQ, C><<<dim3((unsigned)blocks_for(n_tiles, kWarpsPerBlock), (unsigned)(L / C)), kThreads, 0,
                              st>>>(keys, gather, v, nnz, (int)n_seg, vector_loads, src, out, head, tail, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_joins == 0) return err;
  join_kernel<C><<<dim3((unsigned)blocks_for(n_joins, kThreads), (unsigned)(L / C)), kThreads, 0, st>>>(
      joins, n_joins, head, tail, out, L);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_rows_lanes(int group, const int* ptr32, const long long* ptr64, long long seg_len,
                              long long n_seg, const int* gather, const void* val, const float* src, float* out,
                              int L, cudaStream_t st) {
  switch (chunk_for(L)) {
    case 4:
      return launch_rows<V, false, 4>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, L, st);
    case 3:
      return launch_rows<V, false, 3>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, L, st);
    case 2:
      return launch_rows<V, false, 2>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, L, st);
    default:
      return launch_rows<V, false, 1>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, L, st);
  }
}

template <typename V>
cudaError_t launch_keys_lanes(const int* keys, const int* gather, const void* val, long long nnz, long long n_seg,
                              const int* joins, long long n_joins, const float* src, float* out, double* head,
                              double* tail, int L, cudaStream_t st) {
  switch (chunk_for(L)) {
    case 4:
      return launch_keys<V, false, 4>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail, L, st);
    case 3:
      return launch_keys<V, false, 3>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail, L, st);
    case 2:
      return launch_keys<V, false, 2>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail, L, st);
    default:
      return launch_keys<V, false, 1>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail, L, st);
  }
}

bool bad_rows(int group, const int* ptr32, const long long* ptr64, long long seg_len, long long n_seg) {
  return n_seg < 0 || seg_len < 0 || (ptr32 != nullptr && ptr64 != nullptr) ||
         (group != 4 && group != 8 && group != 16 && group != 32);
}

// the grid's y axis holds the column chunks; the squared values take one lane
bool bad_lanes(int square, int n_lanes) { return n_lanes < 1 || n_lanes > 65535 || (square && n_lanes != 1); }

bool bad_keys(long long nnz, long long n_seg, const int* joins, long long n_joins, const double* head,
              const double* tail) {
  return nnz < 0 || n_seg < 0 || n_seg > 0x7fffffffLL || n_joins < 0 ||
         (n_joins > 0 && (joins == nullptr || head == nullptr || tail == nullptr));
}

}  // namespace

extern "C" {

// The key walk's tile (entries a warp), which the host's joins follow.
int segment_tile_entries() { return kTile; }

// Row groups: out[s, l] for s < n_seg, l < n_lanes over the segments
// [ptr[s], ptr[s + 1]) (ptr32: int32, or ptr64: int64, [n_seg + 1]; both
// null for uniform segments of seg_len entries), `group` lanes a segment
// (4, 8, 16 or 32). gather: int32 [nnz] source index of each entry; val:
// [nnz] float32 (bf16 = 0) or bfloat16 (bf16 = 1); src: row-major float32
// [n_src, n_lanes]; out: row-major float32 [n_seg, n_lanes]. square = 1
// sums src * val^2 (one lane only). S1 is n_lanes = 1. Launches on
// `stream`; returns a cudaError_t (cudaErrorInvalidValue for a bad
// argument; 0 and no launch for n_seg 0).
int segment_rows_launch(int bf16, int square, int group, const int* ptr32, const long long* ptr64,
                        long long seg_len, long long n_seg, const int* gather, const void* val, const float* src,
                        float* out, int n_lanes, void* stream) {
  if (bad_rows(group, ptr32, ptr64, seg_len, n_seg) || bad_lanes(square, n_lanes)) return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (square)
    return (int)(bf16 ? launch_rows<uint16_t, true, 1>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, 1,
                                                       st)
                      : launch_rows<float, true, 1>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, 1, st));
  return (int)(bf16 ? launch_rows_lanes<uint16_t>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out,
                                                  n_lanes, st)
                    : launch_rows_lanes<float>(group, ptr32, ptr64, seg_len, n_seg, gather, val, src, out, n_lanes,
                                               st));
}

// Key walk: out[s, l] for s < n_seg (< 2^31), l < n_lanes over nnz entries
// whose int32 keys (ascending, each < n_seg) name their segment; gather,
// val, src, out, square and n_lanes as above. joins: int32 [n_joins, 3],
// (key, first tile, last tile) of each key whose entries cross a boundary
// of kTile entries, in key order; head and tail: float64
// [ceil(nnz / kTile) * n_lanes] scratch, null when n_joins is 0. A second
// launch adds the joins when n_joins > 0.
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
  if (square)
    return (int)(bf16 ? launch_keys<uint16_t, true, 1>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head,
                                                       tail, 1, st)
                      : launch_keys<float, true, 1>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head,
                                                    tail, 1, st));
  return (int)(bf16 ? launch_keys_lanes<uint16_t>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head,
                                                  tail, n_lanes, st)
                    : launch_keys_lanes<float>(keys, gather, val, nnz, n_seg, joins, n_joins, src, out, head, tail,
                                               n_lanes, st));
}

}  // extern "C"
