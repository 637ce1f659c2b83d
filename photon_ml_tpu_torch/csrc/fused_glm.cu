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
//
// What the design does about it: X is read from device memory exactly once.
// Each block walks a strided set of row tiles. A tile (a few contiguous rows,
// at most kTileBytes) is staged in shared memory with 16-byte loads; one warp
// per row computes the row's margin(s) from the staged copy and applies the
// loss; then one thread per column accumulates weight*x[r, j] over the
// tile's rows, still from shared memory. Every column of the block's [d]
// partial is owned by one thread, and a second small kernel sums the
// per-block partials in a fixed order (in double), so the result is the same
// on every run: no float atomics anywhere.
//
// Numerics. The margins z (and u), the loss and its derivatives, and the
// scalar sums are computed in double, per row: the row dot's products of f32
// or bf16 values are exact in double, so z is the float64 margin up to
// rounding, and where the function is discontinuous (smoothed hinge's l'' at
// m = 0 and m = 1) or rounds (the bf16 per-row weight) the kernel decides as
// the float64 reference does. That costs one double FMA per element of X,
// hidden under the bytes. The column accumulation, the bulk of the flops,
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

// log(1 + exp(x)) as jnp.logaddexp(x, 0) computes it
__device__ __forceinline__ double log1pexp_d(double x) {
  return fmax(x, 0.0) + log1p(exp(-fabs(x)));
}

__device__ __forceinline__ void loss_and_dz(int loss, double z, double y, double& l, double& dz) {
  switch (loss) {
    case 0: {  // logistic
      const bool pos = y > 0.5;
      l = log1pexp_d(pos ? -z : z);
      dz = pos ? -sigmoid_d(-z) : sigmoid_d(z);
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

// Sum the per-block partials column by column, blocks in order, in double.
__global__ void finalize_kernel(const float* __restrict__ part, int grid, int width,
                                float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  double a = 0.0;
  for (int b = 0; b < grid; ++b) a += (double)part[(int64_t)b * width + j];
  out[j] = (float)a;
}

template <typename T>
const void* kernel_of(int mode) {
  switch (mode) {
    case kVG: return (const void*)fused_glm_kernel<T, kVG>;
    case kHV: return (const void*)fused_glm_kernel<T, kHV>;
    case kHD: return (const void*)fused_glm_kernel<T, kHD>;
    default: return (const void*)fused_glm_kernel<T, kHDShifts>;
  }
}

const void* kernel_for(int mode, int bf16) {
  return bf16 ? kernel_of<__nv_bfloat16>(mode) : kernel_of<float>(mode);
}

template <typename T, int MODE>
void launch_mode(int grid, long long smem, cudaStream_t s, const void* x, const void* coef,
                 const void* v, const float* y, const float* off, const float* wt,
                 const float* vshift, long long n, int d, int rows_per_tile, int loss,
                 int vec16, float* part) {
  fused_glm_kernel<T, MODE><<<grid, kThreads, (size_t)smem, s>>>(
      (const T*)x, (const T*)coef, (const T*)v, y, off, wt, vshift, n, d, rows_per_tile, loss,
      vec16, part);
}

template <typename T>
void launch_typed(int mode, int grid, long long smem, cudaStream_t s, const void* x,
                  const void* coef, const void* v, const float* y, const float* off,
                  const float* wt, const float* vshift, long long n, int d, int rows_per_tile,
                  int loss, int vec16, float* part) {
  switch (mode) {
    case kVG:
      launch_mode<T, kVG>(grid, smem, s, x, coef, v, y, off, wt, vshift, n, d, rows_per_tile,
                          loss, vec16, part);
      break;
    case kHV:
      launch_mode<T, kHV>(grid, smem, s, x, coef, v, y, off, wt, vshift, n, d, rows_per_tile,
                          loss, vec16, part);
      break;
    case kHD:
      launch_mode<T, kHD>(grid, smem, s, x, coef, v, y, off, wt, vshift, n, d, rows_per_tile,
                          loss, vec16, part);
      break;
    default:
      launch_mode<T, kHDShifts>(grid, smem, s, x, coef, v, y, off, wt, vshift, n, d,
                                rows_per_tile, loss, vec16, part);
  }
}

}  // namespace

extern "C" {

// Launch geometry for an (n, d) sweep of a mode (0 value+grad, 1 Hv, 2
// Hessian stats, 3 Hessian stats with shifts): rows per tile, dynamic shared
// bytes, and the grid (every block resident at once, capped by the tile
// count). Returns a cudaError_t; cudaErrorInvalidValue for an unknown mode
// or when d is too wide for one staged row plus its [d] vectors in shared
// memory.
int fused_glm_plan(int mode, int bf16, long long n, int d, int* grid, int* rows_per_tile,
                   long long* smem) {
  if (d <= 0 || n < 0 || mode < kVG || mode > kHDShifts) return (int)cudaErrorInvalidValue;
  const int elem = bf16 ? 2 : 4;
  int rows = kTileBytes / (d * elem);
  rows = rows < 1 ? 1 : (rows > kMaxTileRows ? kMaxTileRows : rows);
  const size_t bytes = smem_bytes(rows, d, elem, mode);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* k = kernel_for(mode, bf16);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, bytes);
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
  *smem = (long long)bytes;
  return (int)cudaSuccess;
}

// One sweep: the main kernel writes part[grid, width], the finalize kernel
// reduces it into out[width]. Both go on `stream`; nothing synchronises.
// Returns cudaGetLastError() after each launch.
int fused_glm_launch(int mode, int bf16, const void* x, const void* coef, const void* v,
                     const float* y, const float* off, const float* wt, const float* vshift,
                     long long n, int d, int loss, int grid, int rows_per_tile,
                     long long smem, int vec16, float* part, float* out, void* stream) {
  if (mode < kVG || mode > kHDShifts) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    launch_typed<__nv_bfloat16>(mode, grid, smem, s, x, coef, v, y, off, wt, vshift, n, d,
                                rows_per_tile, loss, vec16, part);
  } else {
    launch_typed<float>(mode, grid, smem, s, x, coef, v, y, off, wt, vshift, n, d,
                        rows_per_tile, loss, vec16, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = out_width(mode, d);
  finalize_kernel<<<(width + 255) / 256, 256, 0, s>>>(part, grid, width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
