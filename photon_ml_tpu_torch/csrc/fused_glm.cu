// Fused dense GLM sweeps for Hopper (sm_90a): one pass over X per call.
//
// Replaces the three Pallas TPU kernels of photon_ml_tpu/ops/pallas_glm.py:
//   fused_value_grad      (_vg_kernel)  -> (sum_i wt_i l_i, X^T(wt*dz), sum_i wt_i dz_i)
//                                          with z = X.coef + offsets
//   fused_hessian_vector  (_hv_kernel)  -> (X^T(c*u), sum_i c_i u_i)
//                                          with c = wt*l''(z), u = X.v + vshift
//   fused_hessian_stats   (_hd_kernel)  -> s2 = (X*X)^T c, and with the shifts
//                                          s1 = X^T c, s0 = sum_i c_i; c = wt*l''(z)
//
// What bounds them: the bytes of X. Each call does 4 to 6 flops per element
// of X (a dot and one or two accumulations), against the card's ~20 f32
// flops per byte of device-memory bandwidth, so all three are
// bandwidth-bound; the unfused compositions read X two or three times.
// Inside an SM, the margins in double (below) cost an f32->f64 conversion
// and a double FMA per element, and each row carries a chain of dependent
// double operations (the warp's butterfly sum, exp, log1p, a division)
// before its columns can take it; with one block of eight warps an SM, that
// latency, not the bytes, sets the pace of a bf16 X (PERF.md).
//
// Two bodies read X from device memory exactly once.
//
// The ring body (value+grad and Hv, d <= kRingMaxD = 1,024). One block per
// SM walks a strided set of row tiles (RingShape: 16 KB for an f32 X, 8 KB
// for bf16; at most 32 rows). A producer warp keeps them in flight in a
// ring of shared-memory stages, two for each consumer warp (7 for f32, 11
// for bf16): one bulk copy per tile (cp.async.bulk, completion counted in
// bytes on the stage's mbarrier) where X's rows are 16-byte aligned; the
// consumer warp stages its own tile with plain loads otherwise (d*elem not
// a multiple of 16, or a base pointer off 16 bytes). A consumer waits on
// its stage's full barrier, not on __syncthreads, and hands the stage back
// on its empty barrier. It takes the tile's rows kRowBatch = 4 at a time:
// each lane reads its d/32 values of a row from the staged tile with
// 16-byte loads and adds them into the rows' margins with its columns of
// the coefficients held in double in registers since the block started (v
// too, in registers for f32, in shared memory for bf16, where the warps
// need the registers), so x is the only value converted per element; the
// warp sums each margin by butterfly; lane l applies the loss of row
// l mod 4, so the batch's losses run at once; then each lane reads the row
// again and adds weight*x into its own f32 columns of the warp's [d]
// partial, in registers, rows in order. At the block's end the warp
// partials take the ring's place in shared memory and add in warp order
// (in double) into the block's partial.
//
// The staged body (the Hessian statistics, and value+grad and Hv for wider
// d). Each block walks a strided set of row tiles (a few contiguous rows,
// at most kTileBytes) staged in shared memory with 16-byte loads; one warp
// per row computes the row's margin(s) from the staged copy and applies the
// loss; then one thread per column accumulates weight*x[r, j] over the
// tile's rows, still from shared memory.
//
// Every column of a block's partial is owned by one thread or lane, and the
// tree finalize sums the per-block partials in a fixed order in double (a
// warp per 32 columns on each of 8 warps, each lane a strided set of blocks
// in four interleaved chains, then the 8 warps in order), so the result is
// the same on every run: no float atomics anywhere. (The serial finalize,
// one thread per column over every block in order, is kept to time the
// previous design against this one.)
//
// Over a data-parallel group (B4, replacing _shard_psum_call's psum), each
// rank's finalize writes its totals, as the f32 values widened to double,
// straight into its row of the group's [world, width] float64 slot buffer;
// the caller fills the other rows with one all-gather (NCCL: on the card,
// in stream order), and rank_order_sum_kernel adds the rows in rank order
// into the f32 outputs. No host round trip and no extra copy: the call is
// the rank's sweep, a collective of world x width doubles, and one small
// launch.
//
// Numerics. The margins z (and u), the loss and its derivatives, and the
// scalar sums are computed in double, per row: the row dot's products of f32
// or bf16 values are exact in double, so z is the float64 margin up to
// rounding, and where the function is discontinuous (smoothed hinge's l'' at
// m = 0 and m = 1) or rounds (the bf16 per-row weight) the kernel decides as
// the float64 reference does. That costs a conversion and a double FMA per
// element of X (see above). The column accumulation, the bulk of the flops,
// takes f32 FMAs (no TF32). A bf16 X keeps the reference's rounding points:
// bf16 coefficients (rounded by the caller), and the per-row weight (wt*dz
// for the gradient, c*u for Hv) rounded to f32 and then bf16 before the
// column product. The Hessian statistics take (x*x) in f32, which is exact
// for a bf16 x (the TPU kernel rounds the square to bf16 for its bf16 dot);
// c is rounded like the other per-row weights, while s0 sums the unrounded
// c in double. Labels, offsets, weights and every output are f32. Row
// indices are 64-bit, and no load reaches past row n (the ragged last tile
// is cut short).
//
// Loss codes (keep in step with photon_ml_tpu_torch/ops/losses.py):
//   0 logistic, 1 squared, 2 poisson, 3 smoothed hinge.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Sweep modes; keep in step with photon_ml_tpu_torch/ops/fused_glm.py.
enum Mode : int { kVG = 0, kHV = 1, kHD = 2, kHDShifts = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 32 * 1024;
constexpr int kMaxTileRows = 32;
// the opt-in ceiling of 227 KB, less room for the static reduction buffer
constexpr size_t kMaxSmem = 227 * 1024 - 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The per-row weight enters the column product in X's type: f32, or f32
// then bf16 (the reference rounds its f32 value to bf16).
template <typename T> __device__ __forceinline__ float round_to(double v);
template <> __device__ __forceinline__ float round_to<float>(double v) { return (float)v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(double v) {
  return __bfloat162float(__float2bfloat16((float)v));
}

__device__ __forceinline__ double warp_sum(double v) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double sigmoid_d(double x) { return 1.0 / (1.0 + exp(-x)); }

__device__ __forceinline__ void loss_and_dz(int loss, double z, double y, double& l, double& dz) {
  switch (loss) {
    case 0: {  // logistic: l = log(1 + exp(s)), dz = +-sigmoid(s), one exp(-|s|)
      const bool pos = y > 0.5;
      const double s = pos ? -z : z;
      const double e = exp(-fabs(s));
      l = fmax(s, 0.0) + log1p(e);  // as jnp.logaddexp(s, 0)
      const double sig = (s >= 0.0 ? 1.0 : e) / (1.0 + e);
      dz = pos ? -sig : sig;
      break;
    }
    case 1: {  // squared
      const double diff = z - y;
      l = 0.5 * diff * diff;
      dz = diff;
      break;
    }
    case 2: {  // poisson
      const double ez = exp(z);
      l = ez - y * z;
      dz = ez - y;
      break;
    }
    default: {  // smoothed hinge: the loss takes m <= 0, the derivative m < 0
      const double ym = y > 0.5 ? 1.0 : -1.0;
      const double m = ym * z;
      l = m <= 0.0 ? 0.5 - m : (m < 1.0 ? 0.5 * (1.0 - m) * (1.0 - m) : 0.0);
      const double dm = m < 0.0 ? -1.0 : (m < 1.0 ? m - 1.0 : 0.0);
      dz = dm * ym;
    }
  }
}

__device__ __forceinline__ double d2z(int loss, double z, double y) {
  switch (loss) {
    case 0: {
      const double s = sigmoid_d(z);
      return s * (1.0 - s);
    }
    case 1:
      return 1.0;
    case 2:
      return exp(z);
    default: {
      const double m = (y > 0.5 ? 1.0 : -1.0) * z;
      return (m > 0.0 && m < 1.0) ? 1.0 : 0.0;
    }
  }
}

__host__ __device__ __forceinline__ size_t round_up16(size_t b) { return (b + 15) & ~size_t(15); }

// [d]-sized shared vectors of a mode: the coefficients, v (Hv), and one
// accumulator per column output (two for the Hessian stats with shifts).
__host__ __device__ constexpr int d_vectors(int mode) {
  return mode == kHV ? 3 : (mode == kHDShifts ? 3 : 2);
}

// Per-block output width: the column partial(s), then the scalar partials —
// value grad: [d] + (sum wt*l, sum wt*dz); Hv: [d] + (sum c*u);
// Hessian stats: s2 [d]; with shifts s2 [d] + s1 [d] + (sum c).
__host__ __device__ constexpr int out_width(int mode, int d) {
  return mode == kVG ? d + 2 : (mode == kHV ? d + 1 : (mode == kHD ? d : 2 * d + 1));
}

// Shared-memory layout: X tile | coef [d] | v [d] (Hv only) | acc [d] |
// acc1 [d] (stats with shifts only) | row weight, label, offset, sample
// weight [rows_per_tile] each.
size_t smem_bytes(int rows_per_tile, int d, int elem, int mode) {
  const size_t x_bytes = round_up16((size_t)rows_per_tile * d * elem);
  return x_bytes + sizeof(float) * ((size_t)d * d_vectors(mode) + 4 * (size_t)rows_per_tile);
}

// One kernel body for the three sweeps; MODE selects what a row computes
// and what the columns accumulate. Block b writes row b of part[grid, width].
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_glm_kernel(const T* __restrict__ x, const T* __restrict__ coef, const T* __restrict__ v,
                 const float* __restrict__ y, const float* __restrict__ off,
                 const float* __restrict__ wt, const float* __restrict__ vshift,
                 int64_t n, int d, int rows_per_tile, int loss, int vec16,
                 float* __restrict__ part) {
  constexpr bool HV = MODE == kHV;
  constexpr bool HD = MODE == kHD || MODE == kHDShifts;
  constexpr bool SHIFTS = MODE == kHDShifts;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[kWarps][2];
  T* xs = reinterpret_cast<T*>(smem);
  float* cs = reinterpret_cast<float*>(smem + round_up16((size_t)rows_per_tile * d * sizeof(T)));
  float* vs = cs + d;
  float* acc = HV ? vs + d : cs + d;
  float* acc1 = acc + d;  // s1 columns (stats with shifts)
  float* rw = cs + (size_t)d * d_vectors(MODE);
  float* ys = rw + rows_per_tile;
  float* os = ys + rows_per_tile;
  float* ws = os + rows_per_tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < d; j += kThreads) {
    cs[j] = to_f(coef[j]);
    if (HV) vs[j] = to_f(v[j]);
    acc[j] = 0.0f;
    if (SHIFTS) acc1[j] = 0.0f;
  }
  const double vsh = HV ? (double)*vshift : 0.0;
  double s0 = 0.0, s1 = 0.0;  // lane 0 of each warp

  const int64_t n_tiles = (n + rows_per_tile - 1) / rows_per_tile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t row0 = t * rows_per_tile;
    const int rows = (int)(n - row0 < rows_per_tile ? n - row0 : rows_per_tile);
    const int64_t count = (int64_t)rows * d;
    const T* src = x + row0 * (int64_t)d;
    __syncthreads();  // the previous tile's readers are done
    if (vec16) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(xs);
      const int64_t n4 = count * (int64_t)sizeof(T) / 16;
      for (int64_t i = tid; i < n4; i += kThreads) d4[i] = __ldg(s4 + i);
    } else {
      for (int64_t i = tid; i < count; i += kThreads) xs[i] = src[i];
    }
    if (tid < rows) {
      ys[tid] = y[row0 + tid];
      os[tid] = off[row0 + tid];
      ws[tid] = wt[row0 + tid];
    }
    __syncthreads();

    // margins: one warp per row, in double (see the note at the top)
    for (int r = warp; r < rows; r += kWarps) {
      const T* xr = xs + (int64_t)r * d;
      double z = 0.0, u = 0.0;
      for (int k = lane; k < d; k += 32) {
        const double xv = (double)to_f(xr[k]);
        z = fma((double)cs[k], xv, z);
        if (HV) u = fma((double)vs[k], xv, u);
      }
      z = warp_sum(z);
      if (HV) u = warp_sum(u);
      if (lane == 0) {
        z += (double)os[r];
        const double w = (double)ws[r];
        if (HV) {
          const double cu = w * d2z(loss, z, (double)ys[r]) * (u + vsh);
          s0 += cu;
          rw[r] = round_to<T>(cu);
        } else if (HD) {
          const double c = w * d2z(loss, z, (double)ys[r]);
          if (SHIFTS) s0 += c;
          rw[r] = round_to<T>(c);
        } else {
          double l, dz;
          loss_and_dz(loss, z, (double)ys[r], l, dz);
          const double wdz = w * dz;
          s0 += w * l;
          s1 += wdz;
          rw[r] = round_to<T>(wdz);
        }
      }
    }
    __syncthreads();

    // column accumulation: one thread per column, the tile's rows in order
    for (int j = tid; j < d; j += kThreads) {
      float a = acc[j];
      if (HD) {
        float a1 = SHIFTS ? acc1[j] : 0.0f;
        for (int r = 0; r < rows; ++r) {
          const float xv = to_f(xs[(int64_t)r * d + j]);
          a = fmaf(rw[r], xv * xv, a);
          if (SHIFTS) a1 = fmaf(rw[r], xv, a1);
        }
        if (SHIFTS) acc1[j] = a1;
      } else {
        for (int r = 0; r < rows; ++r) a = fmaf(rw[r], to_f(xs[(int64_t)r * d + j]), a);
      }
      acc[j] = a;
    }
  }

  if (lane == 0) {
    red[warp][0] = s0;
    red[warp][1] = s1;
  }
  __syncthreads();
  float* out = part + (int64_t)blockIdx.x * out_width(MODE, d);
  for (int j = tid; j < d; j += kThreads) {
    out[j] = acc[j];
    if (SHIFTS) out[d + j] = acc1[j];
  }
  if (tid == 0 && MODE != kHD) {
    double a0 = 0.0, a1 = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a0 += red[w][0];
      a1 += red[w][1];
    }
    const int s = SHIFTS ? 2 * d : d;
    out[s] = (float)a0;
    if (MODE == kVG) out[s + 1] = (float)a1;
  }
}

// A finalize's two output forms: the f32 total into out[j], or (B4, slot
// not null) the same f32 value widened to double into slot[j], this rank's
// row of the group's [world, width] float64 slot buffer.
__device__ __forceinline__ void store_total(float* out, double* slot, int j, double t) {
  if (slot != nullptr) {
    slot[j] = (double)(float)t;
  } else {
    out[j] = (float)t;
  }
}

// The serial finalize: one thread per column sums the per-block partials,
// blocks in order, in double. Kept only to time the previous design.
__global__ void finalize_serial_kernel(const float* __restrict__ part, int grid, int width,
                                       float* __restrict__ out, double* __restrict__ slot) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  double a = 0.0;
  for (int b = 0; b < grid; ++b) a += (double)part[(int64_t)b * width + j];
  store_total(out, slot, j, a);
}

constexpr int kFinalizeWarps = 8;

// The tree finalize: block c sums columns [32c, 32c + 32). Lane l of warp w
// adds blocks w, w + 8, w + 16, ... of column 32c + l in four interleaved
// double chains (block index / 8 mod 4), the chains add in a fixed order,
// then warp 0 adds the eight warps in order. Fixed order, so deterministic.
__global__ void __launch_bounds__(kFinalizeWarps * 32)
finalize_tree_kernel(const float* __restrict__ part, int grid, int width,
                     float* __restrict__ out, double* __restrict__ slot) {
  __shared__ double s[kFinalizeWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  if (j < width) {
    int m = 0;
    for (int b = w; b < grid; b += kFinalizeWarps, ++m) {
      a[m & 3] += (double)part[(int64_t)b * width + j];
    }
  }
  s[w][lane] = (a[0] + a[1]) + (a[2] + a[3]);
  __syncthreads();
  if (w == 0 && j < width) {
    double t = 0.0;
    for (int q = 0; q < kFinalizeWarps; ++q) t += s[q][lane];
    store_total(out, slot, j, t);
  }
}

// B4's rank-order sum (replaces the psum of _shard_psum_call in
// photon_ml_tpu/ops/pallas_glm.py). slots is the group's [world, width]
// float64 buffer after the all-gather: row r holds rank r's totals. Column
// j adds the rows in rank order in double (acc = s[0]; acc += s[r]), so every
// rank and either backend get the same bits whatever order the collective
// took, and writes the sum as f32 into out[j]. One thread per column, no
// atomics. It moves a few KB (world x width doubles): its time is the
// launch's.
__global__ void rank_order_sum_kernel(const double* __restrict__ slots, int world, int width,
                                      float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  double acc = slots[j];
  for (int r = 1; r < world; ++r) acc += slots[(int64_t)r * width + j];
  out[j] = (float)acc;
}

// ---------------------------------------------------------------- ring body

constexpr int kLaneCols = 32;  // columns per lane
constexpr int kRingMaxD = 32 * kLaneCols;
constexpr int kRingMaxTileRows = 32;  // a lane per row of the tile
constexpr int kRingStagesPerWarp = 2;
constexpr int kRowBatch = 4;  // rows whose margins and losses run together

// The ring's shape per X type and mode: consumer warps (plus one producer
// warp), tile bytes, and where v lives. A bf16 X, whose tiles take half
// the time to arrive, needs more warps at work: eleven consumer warps (12
// warps: 384 threads, at most 168 registers each) with 8 KB tiles, and
// for Hv its v in shared memory as double (the coefficients and v in
// registers take 128 of them). An f32 X takes seven (8 warps: 255
// registers) with 16 KB tiles and both vectors in registers. Each was the
// fastest of the shapes timed at n=500,000, d=1,024 (PERF.md).
template <typename T, int MODE>
struct RingShape {
  static constexpr bool kWide = sizeof(T) == 2;
  static constexpr bool kSharedV = kWide && MODE == kHV;
  static constexpr int kWarps = kWide ? 11 : 7;
  static constexpr int kThreads = (kWarps + 1) * 32;
  static constexpr int kTileBytes = (kWide ? 8 : 16) * 1024;
};

__host__ __device__ __forceinline__ size_t round_up128(size_t b) { return (b + 127) & ~size_t(127); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Block until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One bulk copy global -> shared (16-byte aligned source, destination and
// size), its bytes counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes of X as f32: 4 floats, or 8 bf16 (the low half of a word first).
__device__ __forceinline__ void unpack16(const float*, uint4 r, float* o) {
  o[0] = __uint_as_float(r.x);
  o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z);
  o[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16*, uint4 r, float* o) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Lane `lane`'s columns of a [d] vector, in double, 0 past d: column
// (i*32 + lane)*VEC + q goes to out[i*VEC + q] (VEC > 1: the 16 bytes a
// lane reads of a row).
template <typename T, int VEC>
__device__ __forceinline__ void lane_vector(const T* vec, int d, int lane, double (&out)[kLaneCols]) {
#pragma unroll
  for (int c = 0; c < kLaneCols; ++c) {
    const int j = ((c / VEC) * 32 + lane) * VEC + c % VEC;
    out[c] = j < d ? (double)to_f(vec[j]) : 0.0;
  }
}

// Chunk i of lane `lane`'s values of row xr as f32 (0 past d).
template <typename T, int VEC>
__device__ __forceinline__ void lane_chunk(const T* xr, int d, int lane, int i, float (&xv)[VEC]) {
  const int j0 = (i * 32 + lane) * VEC;
  if constexpr (VEC == 1) {
    xv[0] = j0 < d ? to_f(xr[j0]) : 0.0f;
  } else if (j0 < d) {
    unpack16(xr, *reinterpret_cast<const uint4*>(xr + j0), xv);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) xv[q] = 0.0f;
  }
}

// Shared-memory layout of the ring body: the ring (stages tiles, each
// rounded up to 128 bytes; once every tile is consumed, the warp partials
// [W][d] f32 take its place: the 2*W stages, each of at least one row of d
// elements of at least 2 bytes, hold them) | full and empty barriers
// [stages] each | with kSharedV, v in double [column of lane][lane], so that
// a warp's 32 lanes read 32 consecutive doubles.
__host__ __device__ __forceinline__ size_t ring_tile_stride(int rows_per_tile, int d, int elem) {
  return round_up128((size_t)rows_per_tile * d * elem);
}
size_t ring_smem_bytes(int rows_per_tile, int stages, int d, int elem, bool shared_v) {
  return (size_t)stages * ring_tile_stride(rows_per_tile, d, elem) +
         2 * sizeof(uint64_t) * (size_t)stages + (shared_v ? sizeof(double) * kRingMaxD : 0);
}

// The ring body of value+grad (MODE kVG) and Hv (kHV). The block's k-th
// tile (tile blockIdx.x + k*gridDim.x, rows_per_tile <= 32 rows) goes to
// consumer warp k mod W through stage k mod stages (stages = W *
// kRingStagesPerWarp, so each stage has one consumer). VEC > 1 (16 / the
// element size): the producer warp fills the stages by bulk copy and a lane
// reads 16 bytes of a row at a time; VEC == 1 (rows or base not 16-byte
// aligned): the consumer warp stages its own tile with plain loads. A warp
// takes its tile's rows B at a time: the rows' margins in double
// (interleaved), their warp sums, then the loss of row q on the lanes l
// with l mod B = q (the batch's losses at once), then weight*x into the
// lane's f32 columns, rows in order. Block b writes row b of
// part[grid, width] as the staged body does.
template <typename T, int MODE, int VEC>
__global__ void __launch_bounds__(RingShape<T, MODE>::kThreads, 1)
fused_glm_ring_kernel(const T* __restrict__ x, const T* __restrict__ coef, const T* __restrict__ v,
                      const float* __restrict__ y, const float* __restrict__ off,
                      const float* __restrict__ wt, const float* __restrict__ vshift, int64_t n,
                      int d, int rows_per_tile, int stages, int loss, float* __restrict__ part) {
  constexpr bool HV = MODE == kHV;
  constexpr bool TMA = VEC > 1;
  constexpr int W = RingShape<T, MODE>::kWarps;
  constexpr bool SV = RingShape<T, MODE>::kSharedV;
  constexpr int B = kRowBatch;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double red[W][2];
  const size_t stride = ring_tile_stride(rows_per_tile, d, sizeof(T));
  float* wpart = reinterpret_cast<float*>(smem);  // after the last tile
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * stride);
  uint64_t* empty = full + stages;
  double* vs = reinterpret_cast<double*>(empty + stages);  // SV: v [column of lane][lane]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if constexpr (SV) {
    for (int idx = tid; idx < kLaneCols * 32; idx += RingShape<T, MODE>::kThreads) {
      const int c = idx / 32, l = idx % 32;
      const int j = ((c / VEC) * 32 + l) * VEC + c % VEC;
      vs[idx] = j < d ? (double)to_f(v[j]) : 0.0;
    }
  }
  if (TMA && tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 32);  // the producer warp's lanes (+ the copy's bytes)
      mbar_init(empty + s, 1);  // the stage's consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int64_t n_tiles = (n + rows_per_tile - 1) / rows_per_tile;
  if (warp == W) {
    // producer: the block's tiles in order, each into stage k mod stages
    if constexpr (TMA) {
      int k = 0;
      for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++k) {
        const int s = k % stages;
        if (k >= stages) mbar_wait(empty + s, (uint32_t)((k / stages - 1) & 1));
        if (lane == 0) {
          const int64_t row0 = t * rows_per_tile;
          const int rows = (int)(n - row0 < rows_per_tile ? n - row0 : rows_per_tile);
          const uint32_t bytes = (uint32_t)rows * (uint32_t)d * (uint32_t)sizeof(T);
          mbar_arrive_expect_tx(full + s, bytes);
          bulk_copy(smem + (size_t)s * stride, x + row0 * (int64_t)d, bytes, full + s);
        } else {
          mbar_arrive(full + s);
        }
      }
    }
  } else {
    constexpr int NCH = kLaneCols / VEC;
    double cd[kLaneCols], vd[kLaneCols];  // vd: Hv only
    float acc[kLaneCols];
    lane_vector<T, VEC>(coef, d, lane, cd);
    if constexpr (HV && !SV) lane_vector<T, VEC>(v, d, lane, vd);
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[c] = 0.0f;
    const double vsh = HV ? (double)*vshift : 0.0;
    double s0 = 0.0, s1 = 0.0;  // the same in every lane

    for (int k = warp;; k += W) {
      const int64_t t = blockIdx.x + (int64_t)k * gridDim.x;
      if (t >= n_tiles) break;
      const int s = k % stages;
      const int64_t row0 = t * rows_per_tile;
      const int rows = (int)(n - row0 < rows_per_tile ? n - row0 : rows_per_tile);
      // lane i fetches the label, offset and weight of the tile's row i
      float py = 0.0f, po = 0.0f, pw = 0.0f;
      if (lane < rows) {
        py = __ldg(y + row0 + lane);
        po = __ldg(off + row0 + lane);
        pw = __ldg(wt + row0 + lane);
      }
      T* xs = reinterpret_cast<T*>(smem + (size_t)s * stride);
      if constexpr (TMA) {
        mbar_wait(full + s, (uint32_t)((k / stages) & 1));
      } else {
        const T* src = x + row0 * (int64_t)d;
        const int count = rows * d;
        for (int i = lane; i < count; i += 32) xs[i] = src[i];
        __syncwarp();
      }
      for (int b0 = 0; b0 < rows; b0 += B) {
        const int nb = rows - b0 < B ? rows - b0 : B;
        // margins of the batch's rows, in double (the rows' chains interleave)
        double za[B], ua[B];
#pragma unroll
        for (int q = 0; q < B; ++q) za[q] = ua[q] = 0.0;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
#pragma unroll
          for (int q = 0; q < B; ++q) {
            if (q < nb) {
              float xv[VEC];
              lane_chunk<T, VEC>(xs + (int64_t)(b0 + q) * d, d, lane, i, xv);
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                const double xd = (double)xv[e];
                za[q] = fma(cd[i * VEC + e], xd, za[q]);
                if constexpr (HV) ua[q] = fma(SV ? vs[(i * VEC + e) * 32 + lane] : vd[i * VEC + e], xd, ua[q]);
              }
            }
          }
        }
        double zq = 0.0, uq = 0.0;  // lane's row: q = lane mod B
#pragma unroll
        for (int q = 0; q < B; ++q) {
          const double zs = warp_sum(za[q]);
          if ((lane & (B - 1)) == q) zq = zs;
          if constexpr (HV) {
            const double us = warp_sum(ua[q]);
            if ((lane & (B - 1)) == q) uq = us;
          }
        }
        // the losses of the batch's rows at once, row q on lanes q mod B
        const int src = b0 + (lane & (B - 1));
        const double yr = (double)__shfl_sync(0xffffffffu, py, src);
        const double w = (double)__shfl_sync(0xffffffffu, pw, src);
        zq += (double)__shfl_sync(0xffffffffu, po, src);
        double rw, c0, c1 = 0.0;
        if constexpr (HV) {
          rw = w * d2z(loss, zq, yr) * (uq + vsh);
          c0 = rw;
        } else {
          double l, dz;
          loss_and_dz(loss, zq, yr, l, dz);
          rw = w * dz;
          c0 = w * l;
          c1 = rw;
        }
        const float rwf = round_to<T>(rw);
        // the rows in order: their scalar sums, then weight*x into the columns
        for (int q = 0; q < nb; ++q) {
          s0 += __shfl_sync(0xffffffffu, c0, q);
          if constexpr (!HV) s1 += __shfl_sync(0xffffffffu, c1, q);
          const float wq = __shfl_sync(0xffffffffu, rwf, q);
          const T* xr = xs + (int64_t)(b0 + q) * d;
#pragma unroll
          for (int i = 0; i < NCH; ++i) {
            float xv[VEC];
            lane_chunk<T, VEC>(xr, d, lane, i, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i * VEC + e] = fmaf(wq, xv[e], acc[i * VEC + e]);
          }
        }
      }
      __syncwarp();
      if (TMA && lane == 0) mbar_arrive(empty + s);
    }
    if (lane == 0) {
      red[warp][0] = s0;
      red[warp][1] = s1;
    }
    // every tile of the block consumed (each waited on its full barrier, so
    // no copy is in flight): the warp partials take the ring's place
    asm volatile("bar.sync 1, %0;" ::"n"(W * 32) : "memory");
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      const int j = ((c / VEC) * 32 + lane) * VEC + c % VEC;
      if (j < d) wpart[(size_t)warp * d + j] = acc[c];
    }
  }
  __syncthreads();

  float* out = part + (int64_t)blockIdx.x * out_width(MODE, d);
  for (int j = tid; j < d; j += RingShape<T, MODE>::kThreads) {
    double a = 0.0;
    for (int q = 0; q < W; ++q) a += (double)wpart[(size_t)q * d + j];
    out[j] = (float)a;
  }
  if (tid == 0) {
    double a0 = 0.0, a1 = 0.0;
    for (int q = 0; q < W; ++q) {
      a0 += red[q][0];
      a1 += red[q][1];
    }
    out[d] = (float)a0;
    if (MODE == kVG) out[d + 1] = (float)a1;
  }
}

template <typename T>
const void* staged_kernel_of(int mode) {
  switch (mode) {
    case kVG: return (const void*)fused_glm_kernel<T, kVG>;
    case kHV: return (const void*)fused_glm_kernel<T, kHV>;
    case kHD: return (const void*)fused_glm_kernel<T, kHD>;
    default: return (const void*)fused_glm_kernel<T, kHDShifts>;
  }
}

template <typename T, int VEC>
const void* ring_kernel_of(int mode) {
  return mode == kVG ? (const void*)fused_glm_ring_kernel<T, kVG, VEC>
                     : (const void*)fused_glm_ring_kernel<T, kHV, VEC>;
}

// Bodies and finalizes; keep in step with photon_ml_tpu_torch/ops/fused_glm.py.
enum Body : int { kStaged = 0, kRing = 1 };
enum Finalize : int { kFinalizeSerial = 0, kFinalizeTree = 1 };
// launch steps (a bit mask): the main kernel, the finalize
constexpr int kStepMain = 1, kStepFinalize = 2;

struct RingPlan {
  int warps, threads, tile_bytes;
  bool shared_v;
};

template <typename T, int MODE>
RingPlan ring_shape_of() {
  using S = RingShape<T, MODE>;
  return {S::kWarps, S::kThreads, S::kTileBytes, S::kSharedV};
}

// The ring's shape for a mode (kVG or kHV) and X type, on the host.
RingPlan ring_shape(int mode, int bf16) {
  if (bf16) return mode == kVG ? ring_shape_of<__nv_bfloat16, kVG>() : ring_shape_of<__nv_bfloat16, kHV>();
  return mode == kVG ? ring_shape_of<float, kVG>() : ring_shape_of<float, kHV>();
}

const void* kernel_for(int mode, int bf16, int body, int vec16) {
  if (body == kStaged) return bf16 ? staged_kernel_of<__nv_bfloat16>(mode) : staged_kernel_of<float>(mode);
  if (bf16) return vec16 ? ring_kernel_of<__nv_bfloat16, 8>(mode) : ring_kernel_of<__nv_bfloat16, 1>(mode);
  return vec16 ? ring_kernel_of<float, 4>(mode) : ring_kernel_of<float, 1>(mode);
}

struct Args {
  const void *x, *coef, *v;
  const float *y, *off, *wt, *vshift;
  long long n;
  int d, loss, rows_per_tile, stages, vec16;
  float* part;
};

template <typename T, int MODE>
void launch_staged(int grid, long long smem, cudaStream_t s, const Args& a) {
  fused_glm_kernel<T, MODE><<<grid, kThreads, (size_t)smem, s>>>(
      (const T*)a.x, (const T*)a.coef, (const T*)a.v, a.y, a.off, a.wt, a.vshift, a.n, a.d,
      a.rows_per_tile, a.loss, a.vec16, a.part);
}

template <typename T, int MODE, int VEC>
void launch_ring(int grid, long long smem, cudaStream_t s, const Args& a) {
  fused_glm_ring_kernel<T, MODE, VEC><<<grid, RingShape<T, MODE>::kThreads, (size_t)smem, s>>>(
      (const T*)a.x, (const T*)a.coef, (const T*)a.v, a.y, a.off, a.wt, a.vshift, a.n, a.d,
      a.rows_per_tile, a.stages, a.loss, a.part);
}

template <typename T, int VEC>
void launch_ring_mode(int mode, int grid, long long smem, cudaStream_t s, const Args& a) {
  if (mode == kVG) {
    launch_ring<T, kVG, VEC>(grid, smem, s, a);
  } else {
    launch_ring<T, kHV, VEC>(grid, smem, s, a);
  }
}

template <typename T>
void launch_typed(int mode, int body, int grid, long long smem, cudaStream_t s, const Args& a) {
  if (body == kRing) {
    constexpr int kVec = 16 / (int)sizeof(T);
    if (a.vec16) {
      launch_ring_mode<T, kVec>(mode, grid, smem, s, a);
    } else {
      launch_ring_mode<T, 1>(mode, grid, smem, s, a);
    }
    return;
  }
  switch (mode) {
    case kVG: launch_staged<T, kVG>(grid, smem, s, a); break;
    case kHV: launch_staged<T, kHV>(grid, smem, s, a); break;
    case kHD: launch_staged<T, kHD>(grid, smem, s, a); break;
    default: launch_staged<T, kHDShifts>(grid, smem, s, a);
  }
}

}  // namespace

extern "C" {

// Launch geometry for an (n, d) sweep of a mode (0 value+grad, 1 Hv, 2
// Hessian stats, 3 Hessian stats with shifts) through a body (0 staged, 1
// ring; the ring takes modes 0 and 1 with d <= 1,024 only): rows per tile,
// ring stages (1 for the staged body), dynamic shared bytes, and the grid
// (every block resident at once, capped by the tile count). vec16: X's rows
// are 16-byte aligned (the ring's bulk-copy kernel; plain loads otherwise).
// Returns a cudaError_t; cudaErrorInvalidValue for an unknown mode or body,
// a mode or width the body does not take, or when d is too wide for one
// staged row plus its [d] vectors in shared memory.
int fused_glm_plan(int mode, int bf16, long long n, int d, int body, int vec16, int* grid,
                   int* rows_per_tile, int* stages, long long* smem) {
  if (d <= 0 || n < 0 || mode < kVG || mode > kHDShifts) return (int)cudaErrorInvalidValue;
  if (body != kStaged && body != kRing) return (int)cudaErrorInvalidValue;
  if (body == kRing && (mode > kHV || d > kRingMaxD)) return (int)cudaErrorInvalidValue;
  const int elem = bf16 ? 2 : 4;
  int rows, nstages, threads;
  size_t bytes;
  if (body == kRing) {
    const RingPlan r = ring_shape(mode, bf16);
    rows = r.tile_bytes / (d * elem);
    rows = rows < 1 ? 1 : (rows > kRingMaxTileRows ? kRingMaxTileRows : rows);
    nstages = r.warps * kRingStagesPerWarp;
    threads = r.threads;
    bytes = ring_smem_bytes(rows, nstages, d, elem, r.shared_v);
  } else {
    rows = kTileBytes / (d * elem);
    rows = rows < 1 ? 1 : (rows > kMaxTileRows ? kMaxTileRows : rows);
    nstages = 1;
    threads = kThreads;
    bytes = smem_bytes(rows, d, elem, mode);
  }
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* k = kernel_for(mode, bf16, body, vec16);
  // the opt-in ceiling, not this plan's bytes: a kernel serves plans of many
  // widths, and a cached plan must stay launchable after another is made
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + rows - 1) / rows;
  long long g = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (tiles < g) g = tiles;
  *grid = (int)(g < 1 ? 1 : g);
  *rows_per_tile = rows;
  *stages = nstages;
  *smem = (long long)bytes;
  return (int)cudaSuccess;
}

// Blocks per SM that the occupancy calculator allows a planned sweep (for
// the record: the plan caps the grid at this times the SM count).
int fused_glm_blocks_per_sm(int mode, int bf16, int body, int vec16, long long smem, int* per_sm) {
  if (mode < kVG || mode > kHDShifts || (body == kRing && mode > kHV)) return (int)cudaErrorInvalidValue;
  const int threads = body == kRing ? ring_shape(mode, bf16).threads : kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel_for(mode, bf16, body, vec16), threads, (size_t)smem);
}

// One sweep as planned: the main kernel writes part[grid, width] (steps bit
// 1), the finalize (0 serial, 1 tree) reduces it into out[width] as f32 or,
// where slot is not null, into slot[width] as the f32 values widened to
// double (steps bit 2). Both go on `stream`; nothing synchronises. Returns
// cudaGetLastError() after each launch.
int fused_glm_launch(int mode, int bf16, int body, int finalize, int steps, const void* x,
                     const void* coef, const void* v, const float* y, const float* off,
                     const float* wt, const float* vshift, long long n, int d, int loss, int grid,
                     int rows_per_tile, int stages, long long smem, int vec16, float* part,
                     float* out, double* slot, void* stream) {
  if (mode < kVG || mode > kHDShifts || (body != kStaged && body != kRing) ||
      (body == kRing && mode > kHV) || (finalize != kFinalizeSerial && finalize != kFinalizeTree))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (steps & kStepMain) {
    const Args a{x, coef, v, y, off, wt, vshift, n, d, loss, rows_per_tile, stages, vec16, part};
    if (bf16) {
      launch_typed<__nv_bfloat16>(mode, body, grid, smem, s, a);
    } else {
      launch_typed<float>(mode, body, grid, smem, s, a);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (steps & kStepFinalize) {
    const int width = out_width(mode, d);
    if (finalize == kFinalizeTree) {
      finalize_tree_kernel<<<(width + 31) / 32, kFinalizeWarps * 32, 0, s>>>(part, grid, width, out, slot);
    } else {
      finalize_serial_kernel<<<(width + 255) / 256, 256, 0, s>>>(part, grid, width, out, slot);
    }
  }
  return (int)cudaGetLastError();
}

// B4's rank-order sum of slots[world, width] (float64) into the f32
// out[width]. On `stream`; nothing synchronises. Returns
// cudaErrorInvalidValue for world < 1 or width < 1, else cudaGetLastError()
// after the launch.
int rank_order_sum_launch(const double* slots, int world, int width, float* out, void* stream) {
  if (world < 1 || width < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  rank_order_sum_kernel<<<(width + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      slots, world, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
