// The frame's scale pass on Hopper (sm_90a): kernel C's scale, made on the
// device with no host sync.
//
// It replaces the scale that the JAX package computes in XLA
// before the Pallas kernel (shared_tensor_tpu/ops/codec.py: compute_scale,
// called at codec_pallas.py's quantize). It takes the port's rule for
// scales from partials (ops/codec_np.compute_scales_np, the finish kernel
// in cascade_round.cu): max |r| in f32, sum r^2 and sum |r| in double over
// the WHOLE padded buffer (garbage past n, such as inf, gives scale 0, as
// in the JAX kernel; the squares of f32 values are exact in double and the
// sums cannot overflow, so there is no normalising pass), then POW2_RMS and
// RMS take sqrt(ss / n) in double, rounded to f32, POW2_RMS floored to a
// power of two, ABS_MEAN sabs / n; 0 where max |r| is 0 or the scale is not
// finite. The divisor n is the live count.
// Bound: memory, 4 B an element read once (2^30: 1.28 ms at 3.35 TB/s).
// Design: two launches, no atomics, a fixed order, so every run gives the
// same bits and the plain twin (ops/codec_cuda.frame_scale_plain) repeats
// them:
// 1. partials: a grid of min(ceil(units / 512), kScaleBlocks) blocks of
//    512 threads over the buffer's float4 units; thread g of T takes units
//    g, g + T, g + 2T, ... in turn (kScaleUnroll loads in flight at once) and
//    adds each unit's x, y, z, w in order; a warp's shuffle tree, then warp
//    0's tree over the block's 16 warps; block b writes slot b of
//    partials[3][slots] (max |r|, sum r^2, sum |r|, double).
// 2. finish: one warp; lane i sums slots i, i + 32, ... in turn, then its
//    shuffle tree, and lane 0 writes the scale.
// Indices and the live count are 64-bit. Built without fast-math and
// without FTZ: subnormals are kept, double division and sqrt are IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScaleThreads = 512;
constexpr int kScaleWarps = kScaleThreads / 32;
// the partials' grid at most: two blocks of 512 threads on each of the
// H100 SXM's 132 SMs, one wave. A constant, so the bits do not depend on
// the card.
constexpr int kScaleBlocks = 264;
constexpr int kScaleUnroll = 4;
enum { kPow2Rms = 0, kRms = 1, kAbsMean = 2 };

__device__ __forceinline__ void add_unit(float4 v, double& am, double& ss, double& sa) {
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const double d = (double)x[c];
    const double a = fabs(d);
    if (a > am) am = a;  // a NaN never wins
    ss += d * d;         // exact in double: fused or not, one rounding
    sa += a;
  }
}

__device__ __forceinline__ void warp_tree(double& am, double& ss, double& sa) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double a = __shfl_down_sync(0xffffffffu, am, off);
    if (a > am) am = a;
    ss += __shfl_down_sync(0xffffffffu, ss, off);
    sa += __shfl_down_sync(0xffffffffu, sa, off);
  }
}

__global__ void __launch_bounds__(kScaleThreads, 2)
scale_partials_kernel(const float4* __restrict__ r, long long units, double* __restrict__ partials,
                      int slots) {
  const long long stride = (long long)slots * kScaleThreads;
  double am = 0.0, ss = 0.0, sa = 0.0;
  for (long long u = (long long)blockIdx.x * kScaleThreads + threadIdx.x; u < units;
       u += kScaleUnroll * stride) {
    float4 v[kScaleUnroll];
#pragma unroll
    for (int j = 0; j < kScaleUnroll; ++j) {
      const long long uj = u + j * stride;
      v[j] = uj < units ? r[uj] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // 0 adds nothing
    }
#pragma unroll
    for (int j = 0; j < kScaleUnroll; ++j) add_unit(v[j], am, ss, sa);
  }
  __shared__ double s_part[3][kScaleWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_tree(am, ss, sa);
  if (lane == 0) {
    s_part[0][warp] = am;
    s_part[1][warp] = ss;
    s_part[2][warp] = sa;
  }
  __syncthreads();
  if (warp == 0) {
    am = lane < kScaleWarps ? s_part[0][lane] : 0.0;
    ss = lane < kScaleWarps ? s_part[1][lane] : 0.0;
    sa = lane < kScaleWarps ? s_part[2][lane] : 0.0;
    warp_tree(am, ss, sa);
    if (lane == 0) {
      partials[blockIdx.x] = am;
      partials[slots + blockIdx.x] = ss;
      partials[2 * slots + blockIdx.x] = sa;
    }
  }
}

// the partials' slots for n_pad elements: one a block, at most kScaleBlocks
int scale_slots(long long n_pad) {
  const long long blocks = (n_pad / 4 + kScaleThreads - 1) / kScaleThreads;
  return (int)(blocks < kScaleBlocks ? blocks : kScaleBlocks);
}

__global__ void __launch_bounds__(32)
scale_finish_kernel(const double* __restrict__ partials, int slots, double n, int policy,
                    float* __restrict__ scale) {
  const int lane = threadIdx.x;
  double am = 0.0, ss = 0.0, sa = 0.0;
  for (int i = lane; i < slots; i += 32) {
    const double a = partials[i];
    if (a > am) am = a;
    ss += partials[slots + i];
    sa += partials[2 * slots + i];
  }
  warp_tree(am, ss, sa);
  if (lane == 0) {
    float s = (float)(policy == kAbsMean ? sa / n : sqrt(ss / n));
    if (policy == kPow2Rms) s = __uint_as_float(__float_as_uint(s) & 0x7F800000u);
    if (!(am > 0.0) || !isfinite(s)) s = 0.0f;
    *scale = s;
  }
}

}  // namespace

// resid 16-byte aligned, n_pad a multiple of 128; partials f64[3][slots]
// with slots = scale_slots(n_pad) (ops/codec_cuda.scale_slots); policy 0
// POW2_RMS, 1 RMS, 2 ABS_MEAN; the scale (f32) written on the device.
extern "C" int st_frame_scale(const float* resid, long long n_pad, long long n_live, int policy,
                              double* partials, int slots, float* scale, void* stream) {
  if (n_pad <= 0 || n_pad % 128 || slots != scale_slots(n_pad) || policy < 0 || policy > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  scale_partials_kernel<<<slots, kScaleThreads, 0, s>>>(reinterpret_cast<const float4*>(resid), n_pad / 4,
                                                        partials, slots);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  scale_finish_kernel<<<1, 32, 0, s>>>(partials, slots, (double)n_live, policy, scale);
  return (int)cudaGetLastError();
}
