// Kernel D: the scalar codec's fused receive pass on Hopper (sm_90a).
//
// Replaces shared_tensor_tpu/ops/codec_pallas.py: apply_frame_many /
// apply_frame / _apply_kernel. One frame (an f32 scale s, read on the
// device through a pointer, and LSB-first packed sign words) is unpacked
// once and applied to K target arrays, in place. Per element e:
//   delta = bit_e ? -s : s                  (== s * (1 - 2*bit_e), bit-equal)
//   for each of K arrays a:  a = e < n ? clip(a + delta, -SAT, SAT) : 0
// Padding lanes become 0, as in the Pallas kernel (the golden
// codec.apply_frame_many leaves them as they were). The clip keeps NaN as
// NaN, like jnp.clip, rather than fminf/fmaxf, which would drop it.
//
// Bound: memory. Per element: 1/8 B of words and 8K B of read+write over
// the K arrays; K = 1 costs 8.125 B/element, as kernel C. One launch serves
// every target array (replica + other links' residuals) through a device
// array of K pointers, as kernel B does. One thread per element; the 32
// lanes of a warp read the same word (a broadcast) and consecutive 4 B of
// each array (coalesced). Indices and the live count are 64-bit. Built
// without fast-math: subnormals are kept.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSat = 3.0e38f;

__device__ __forceinline__ float clip_sat(float v) {
  if (v != v) return v;  // NaN propagates, as in jnp.clip
  return v < -kSat ? -kSat : (v > kSat ? kSat : v);
}

__global__ void __launch_bounds__(kThreads)
apply_frame_kernel(const float* __restrict__ scale,
                   const uint32_t* __restrict__ words,
                   float* const* __restrict__ arrays,
                   int n_arrays, long long n_live, long long n_pad) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_pad) return;
  const float s = *scale;
  const uint32_t w = words[e >> 5];
  const float delta = ((w >> (e & 31)) & 1u) ? -s : s;
  const bool live = e < n_live;
  for (int i = 0; i < n_arrays; ++i) {
    float* a = arrays[i];
    a[e] = live ? clip_sat(a[e] + delta) : 0.0f;
  }
}

}  // namespace

extern "C" int st_apply_frame_many(const float* scale, const uint32_t* words,
                                   float* const* arrays, int n_arrays,
                                   long long n_live, long long n_pad,
                                   void* stream) {
  if (n_pad <= 0 || n_arrays <= 0) return 0;
  const long long blocks = (n_pad + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  apply_frame_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      scale, words, arrays, n_arrays, n_live, n_pad);
  return (int)cudaGetLastError();
}
