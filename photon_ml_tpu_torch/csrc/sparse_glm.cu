// Segmented gather-dot for the sparse feature layouts on Hopper (sm_90a).
//
// Replaces the XLA gathers and scatter-adds of the sparse products in
// photon_ml_tpu/ops/features.py (FeatureMatrix.matvec, rmatvec and
// sq_rmatvec over the ELL and the column-sorted COO layouts, :103-172; the
// JAX package has no Pallas kernel for them). One kernel computes all six:
//
//   out[s] = sum_{j in [start(s), end(s))} src[gather[j]] * val[j]     (or val[j]^2)
//
// over n_seg segments, with start(s) = ptr[s], end(s) = ptr[s + 1], or,
// without ptr, the uniform segments start(s) = s * seg_len (the ELL rows).
// ops/features.py builds each layout's segments once per matrix on the
// host: ELL matvec runs over the rows of idx/val as they are; ELL rmatvec
// over the entries reordered by column (their rows and values copied in
// that order, with column pointers); COO matvec over the entries reordered
// by row (columns and values, with row pointers); COO rmatvec over the
// column-sorted entries as they are, with column pointers. Every output
// element is one segment, so an empty segment writes its 0 and the launch
// writes every element of out exactly once.
//
// Order: each segment sums in double in a fixed order and the result is
// rounded to float once. No atomics, so two launches give the same bits.
// A warp takes 32 consecutive segments. A segment of at most kShortSegment
// entries is summed by its own lane, entries in order. A longer one (an ELL
// row of 32) is summed by the whole warp, one at a time: lane l adds
// entries l, l + 32, ... in order, then a butterfly of __shfl_xor_sync adds
// the 32 partials (every lane ends with the same bits, as IEEE addition
// commutes), and the owning lane keeps the sum. A segment of more than
// `chunk` entries (an intercept column: one entry a row) is left to a
// plan that ops/sparse.py builds with the segments: its entries are cut
// into chunks of `chunk` entries, the same launch gives each chunk a warp
// of its own (before the tiles, so that they start first), which writes
// the chunk's sum into a float64 partial, and a second small kernel adds
// each long segment's partials in chunk order and writes its output. One
// warp on a column of n entries would take n / 32 dependent steps: 1.05
// ms against 0.115 for the rest of an n = 200,000 rmatvec on the H100.
//
// What bounds it: the bytes. Each entry is an index (4 bytes), a value (4
// or 2) and one gather of src from an unpredictable address, a whole
// 32-byte sector read for 4 useful bytes; plus the pointers and the output.
// Two double operations per entry are far below the card's rate. The
// design keeps the entries and pointers streaming (consecutive lanes read
// consecutive segments, or consecutive entries of one segment) and leaves
// the gathers to the L2 cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr long long kShortSegment = 4;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ double widen(float v) { return (double)v; }
__device__ __forceinline__ double widen(__nv_bfloat16 v) { return (double)__bfloat162float(v); }

template <typename V, bool SQ>
__device__ __forceinline__ double term(const float* __restrict__ src, const int* __restrict__ gather,
                                       const V* __restrict__ val, long long j) {
  const double v = widen(val[j]);
  return (double)src[gather[j]] * (SQ ? v * v : v);
}

// The sum of entries [a, b) by the whole warp: lane-strided runs in order,
// then the butterfly; every lane returns the same bits.
template <typename V, bool SQ>
__device__ __forceinline__ double warp_sum(const float* __restrict__ src, const int* __restrict__ gather,
                                           const V* __restrict__ val, long long a, long long b, int lane) {
  double part = 0.0;
#pragma unroll 4
  for (long long j = a + lane; j < b; j += kWarp) part += term<V, SQ>(src, gather, val, j);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

struct LongPlan {
  long long chunk;               // entries a chunk; a segment of more is long
  long long n_chunks;            // chunks of all long segments
  const int* chunk_owner;        // [n_chunks] index of the chunk's long segment
  const long long* chunk_first;  // [n_long + 1] first chunk of each long segment
  const long long* long_ids;     // [n_long] segment id of each long segment
  double* partial;               // [n_chunks] the chunks' sums
};

template <typename V, bool SQ>
__global__ void __launch_bounds__(kThreads)
    segment_dot_kernel(const long long* __restrict__ ptr, long long seg_len, long long n_seg,
                       const int* __restrict__ gather, const V* __restrict__ val,
                       const float* __restrict__ src, float* __restrict__ out, LongPlan plan,
                       long long chunk_blocks) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  if ((long long)blockIdx.x < chunk_blocks) {
    // one chunk of a long segment a warp
    const long long q = (long long)blockIdx.x * kWarpsPerBlock + warp;
    if (q >= plan.n_chunks) return;
    const int owner = plan.chunk_owner[q];
    const long long s = plan.long_ids[owner];
    const long long seg_start = ptr != nullptr ? ptr[s] : s * seg_len;
    const long long seg_end = ptr != nullptr ? ptr[s + 1] : seg_start + seg_len;
    const long long a = seg_start + (q - plan.chunk_first[owner]) * plan.chunk;
    const long long b = a + plan.chunk < seg_end ? a + plan.chunk : seg_end;
    const double sum = warp_sum<V, SQ>(src, gather, val, a, b, lane);
    if (lane == 0) plan.partial[q] = sum;
    return;
  }
  const long long warps = ((long long)gridDim.x - chunk_blocks) * kWarpsPerBlock;
  // the loop bound is the same for the whole warp: every lane reaches the
  // ballot and the shuffles below
  for (long long tile = ((long long)blockIdx.x - chunk_blocks) * kWarpsPerBlock + warp; tile * kWarp < n_seg;
       tile += warps) {
    const long long s = tile * kWarp + lane;
    const bool live = s < n_seg;
    long long start = 0, end = 0;
    if (live) {
      if (ptr != nullptr) {
        start = ptr[s];
        end = ptr[s + 1];
      } else {
        start = s * seg_len;
        end = start + seg_len;
      }
    }
    const long long len = end - start;
    const bool chunked = plan.chunk > 0 && len > plan.chunk;  // written by the finalize
    const bool is_long = len > kShortSegment && !chunked;
    double acc = 0.0;
    if (len <= kShortSegment) {
      for (long long j = start; j < end; ++j) acc += term<V, SQ>(src, gather, val, j);
    }
    unsigned pending = __ballot_sync(0xffffffffu, is_long);
    while (pending != 0u) {
      const int owner = __ffs(pending) - 1;
      pending &= pending - 1u;
      const long long a = __shfl_sync(0xffffffffu, start, owner);
      const long long b = __shfl_sync(0xffffffffu, end, owner);
      const double sum = warp_sum<V, SQ>(src, gather, val, a, b, lane);
      if (lane == owner) acc = sum;
    }
    if (live && !chunked) out[s] = (float)acc;
  }
}

// out[long_ids[i]] = the sum of long segment i's chunk partials, in chunk
// order, a thread a long segment.
__global__ void __launch_bounds__(kThreads)
    long_segment_finalize_kernel(LongPlan plan, long long n_long, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_long) return;
  double acc = 0.0;
  for (long long q = plan.chunk_first[i]; q < plan.chunk_first[i + 1]; ++q) acc += plan.partial[q];
  out[plan.long_ids[i]] = (float)acc;
}

template <typename V, bool SQ>
cudaError_t launch(const long long* ptr, long long seg_len, long long n_seg, const int* gather, const void* val,
                   const float* src, float* out, const LongPlan& plan, long long n_long, cudaStream_t stream) {
  const long long tiles = (n_seg + kWarp - 1) / kWarp;
  long long blocks = (tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const long long chunk_blocks = (plan.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_dot_kernel<V, SQ><<<(unsigned)(chunk_blocks + blocks), kThreads, 0, stream>>>(
      ptr, seg_len, n_seg, gather, static_cast<const V*>(val), src, out, plan, chunk_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_long == 0) return err;
  long_segment_finalize_kernel<<<(unsigned)((n_long + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      plan, n_long, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[s] for s < n_seg (see above). ptr: int64 [n_seg + 1] segment
// pointers, or null for uniform segments of seg_len entries. gather: int32
// [nnz] source index of each entry; val: [nnz] float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); src: float32; out: float32 [n_seg]. square = 1 sums
// src * val^2. The long-segment plan: with chunk > 0, every segment of more
// than chunk entries is one of the n_long long_ids (int64), cut into
// n_chunks chunks (chunk_owner int32 [n_chunks], chunk_first int64
// [n_long + 1]) whose sums go to partial (float64 [n_chunks], scratch);
// chunk = 0 and n_long = 0 without one. Launches on `stream` (a second
// launch adds the partials when n_long > 0); returns a cudaError_t
// (cudaErrorInvalidValue for a bad argument; 0 and no launch for n_seg 0).
int segment_dot_launch(int bf16, int square, const long long* ptr, long long seg_len, long long n_seg,
                       const int* gather, const void* val, const float* src, float* out, long long chunk,
                       long long n_chunks, long long n_long, const int* chunk_owner, const long long* chunk_first,
                       const long long* long_ids, double* partial, void* stream) {
  if (n_seg < 0 || (ptr == nullptr && seg_len < 0) || chunk < 0 || n_chunks < 0 || n_long < 0)
    return (int)cudaErrorInvalidValue;
  if (n_long > 0 && (chunk == 0 || n_chunks < n_long || chunk_owner == nullptr || chunk_first == nullptr ||
                     long_ids == nullptr || partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  const LongPlan plan{chunk, n_chunks, chunk_owner, chunk_first, long_ids, partial};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return (int)(square ? launch<__nv_bfloat16, true>(ptr, seg_len, n_seg, gather, val, src, out, plan, n_long, st)
                        : launch<__nv_bfloat16, false>(ptr, seg_len, n_seg, gather, val, src, out, plan, n_long, st));
  }
  return (int)(square ? launch<float, true>(ptr, seg_len, n_seg, gather, val, src, out, plan, n_long, st)
                      : launch<float, false>(ptr, seg_len, n_seg, gather, val, src, out, plan, n_long, st));
}

}  // extern "C"
