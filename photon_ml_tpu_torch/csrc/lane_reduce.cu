// V1: a lane reduction whose order of adds depends on the reduced length
// alone, for the vmapped random-effect solve (game/coordinate.py
// _train_blocks) and the entity-leading lanes of the solvers
// (optimize/common.py LEADING).
//
//     out[o, i] = sum_r a[o, r, i] * b[o, r, i]      (b absent: 1)
//
// with o = (o1, o2) over a [O1, O2] grid and every operand addressed by its
// own strides, so a broadcast operand (stride 0) is read in place.
//
// PyTorch's CUDA sums pick their thread layout from the number of outputs
// as well as from the reduced length, so an entity solved in a small stack
// summed its rows in another order than within a large one. Here:
//
// - last axis (I = 1): one warp per output; lane l adds r = l, l + 32,
//   l + 64, ... in that order, then a fixed xor butterfly (16, 8, 4, 2, 1)
//   joins the 32 partials (every lane ends with the same bits);
// - middle axis (I > 1): one thread per (o, i) adds r = 0, 1, ..., R - 1.
//
// Products and sums are in the output type (float for float32 or bfloat16
// features, double for double), as torch.sum of the product computes them.
// Each output is written once; no atomics.
//
// Built by ops/cuda_lib.py (nvcc, sm_90a) and called through ctypes from
// ops/lane_reduce.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;

struct Strides {
  long long s1, s2, sr, si;
};

// an operand element in the output type (bfloat16 widens to float exactly)
template <typename TA, typename TO>
__device__ __forceinline__ TO load(const TA* p) {
  if constexpr (sizeof(TA) == sizeof(TO)) {
    return static_cast<TO>(*p);
  } else {
    return static_cast<TO>(__bfloat162float(*p));
  }
}

template <typename TA, typename TB, typename TO, bool HAS_B>
__global__ void __launch_bounds__(kBlock) lane_reduce_last_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b, TO* __restrict__ out, long long O1, long long O2,
    long long R, Strides sa, Strides sb) {
  const long long o = (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (o >= O1 * O2) return;  // whole warps leave together
  const long long o1 = o / O2, o2 = o % O2;
  const TA* pa = a + o1 * sa.s1 + o2 * sa.s2;
  const TB* pb = HAS_B ? b + o1 * sb.s1 + o2 * sb.s2 : nullptr;
  TO acc = TO(0);
  for (long long r = lane; r < R; r += kWarp) {
    TO x = load<TA, TO>(pa + r * sa.sr);
    if constexpr (HAS_B) x = x * load<TB, TO>(pb + r * sb.sr);
    acc += x;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[o] = acc;
}

template <typename TA, typename TB, typename TO, bool HAS_B>
__global__ void __launch_bounds__(kBlock) lane_reduce_middle_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b, TO* __restrict__ out, long long O1, long long O2,
    long long R, long long I, Strides sa, Strides sb) {
  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= O1 * O2 * I) return;
  const long long i = t % I, o = t / I;
  const long long o1 = o / O2, o2 = o % O2;
  const TA* pa = a + o1 * sa.s1 + o2 * sa.s2 + i * sa.si;
  const TB* pb = HAS_B ? b + o1 * sb.s1 + o2 * sb.s2 + i * sb.si : nullptr;
  TO acc = TO(0);
  for (long long r = 0; r < R; ++r) {
    TO x = load<TA, TO>(pa + r * sa.sr);
    if constexpr (HAS_B) x = x * load<TB, TO>(pb + r * sb.sr);
    acc += x;
  }
  out[t] = acc;
}

template <typename TA, typename TB, typename TO>
int launch(int has_b, int middle, const void* a, const void* b, void* out, long long O1, long long O2, long long R,
           long long I, Strides sa, Strides sb, cudaStream_t stream) {
  const long long threads = middle ? O1 * O2 * I : O1 * O2 * kWarp;
  if (threads == 0) return 0;
  const unsigned grid = static_cast<unsigned>((threads + kBlock - 1) / kBlock);
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  TO* po = static_cast<TO*>(out);
  if (middle) {
    if (has_b)
      lane_reduce_middle_kernel<TA, TB, TO, true><<<grid, kBlock, 0, stream>>>(pa, pb, po, O1, O2, R, I, sa, sb);
    else
      lane_reduce_middle_kernel<TA, TB, TO, false><<<grid, kBlock, 0, stream>>>(pa, pb, po, O1, O2, R, I, sa, sb);
  } else {
    if (has_b)
      lane_reduce_last_kernel<TA, TB, TO, true><<<grid, kBlock, 0, stream>>>(pa, pb, po, O1, O2, R, sa, sb);
    else
      lane_reduce_last_kernel<TA, TB, TO, false><<<grid, kBlock, 0, stream>>>(pa, pb, po, O1, O2, R, sa, sb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kinds: 0 float a, float b, float out; 1 double, double, double;
// 2 bfloat16 a, float b, float out. Returns the CUDA error code (0: ok),
// -1 for an unknown kind.
int lane_reduce_launch(int kind, int has_b, int middle, const void* a, const void* b, void* out, long long O1,
                       long long O2, long long R, long long I, long long as1, long long as2, long long asr,
                       long long asi, long long bs1, long long bs2, long long bsr, long long bsi, void* stream) {
  const Strides sa{as1, as2, asr, asi}, sb{bs1, bs2, bsr, bsi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float, float, float>(has_b, middle, a, b, out, O1, O2, R, I, sa, sb, s);
    case 1:
      return launch<double, double, double>(has_b, middle, a, b, out, O1, O2, R, I, sa, sb, s);
    case 2:
      return launch<__nv_bfloat16, float, float>(has_b, middle, a, b, out, O1, O2, R, I, sa, sb, s);
    default:
      return -1;
  }
}

}  // extern "C"
