// Kernel B: the table codec's fused receive pass on Hopper (sm_90a).
//
// Replaces shared_tensor_tpu/ops/codec_pallas.py: apply_rows_batch /
// _apply_rows_kernel. K frames arrive frame-major: s_rows f32[K, rows] (the
// frame's leaf scale broadcast to its rows; 0 where it contributes nothing)
// and words u32[K, rows*4]. Per element of the (rows, 128) view:
//   delta = sum over k = 0..K-1, in that order, from 0.0f, of
//           bit_k ? -s_k : s_k              (== s_k * (1 - 2*bit_k))
//   for each of N arrays a:  a = live ? clip(a + delta, -SAT, SAT) : 0
// in place. The fixed k order keeps the sum bit-equal to the golden even
// when the scales are not powers of two (RMS policy). The clip keeps NaN as
// NaN, like jnp.clip, rather than fminf/fmaxf, which would drop it.
//
// Bound: memory. Per element: K/8 B of words, K*4/128 B of row scales and
// 8N B of read+write over the N arrays (plus 4/128 B of row counts). One
// launch serves every target array (replica + other links' residuals),
// through a device array of N pointers, so the frames are unpacked once.
// One thread per element; the 32 lanes of a warp read the same word
// (a broadcast) and consecutive 4 B of each array (coalesced). Built
// without fast-math: subnormals are kept.

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
apply_rows_kernel(const float* __restrict__ s_rows,
                  const int* __restrict__ rowcount,
                  const uint32_t* __restrict__ words,
                  float* const* __restrict__ arrays,
                  int n_arrays, int k_frames, long long rows) {
  const long long n = rows * 128;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long row = e >> 7;
  const int lane = (int)(e & 127);
  const int bit = lane & 31;
  const long long wi = row * 4 + (lane >> 5);
  const long long words_per_frame = rows * 4;
  float delta = 0.0f;
  for (int k = 0; k < k_frames; ++k) {
    const uint32_t w = words[(long long)k * words_per_frame + wi];
    const float s = s_rows[(long long)k * rows + row];
    delta = delta + (((w >> bit) & 1u) ? -s : s);
  }
  const bool live = lane < rowcount[row];
  for (int i = 0; i < n_arrays; ++i) {
    float* a = arrays[i];
    a[e] = live ? clip_sat(a[e] + delta) : 0.0f;
  }
}

}  // namespace

extern "C" int st_apply_rows_batch(const float* s_rows, const int* rowcount,
                                   const uint32_t* words,
                                   float* const* arrays, int n_arrays,
                                   int k_frames, long long rows,
                                   void* stream) {
  const long long n = rows * 128;
  if (n <= 0 || n_arrays <= 0 || k_frames <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  apply_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      s_rows, rowcount, words, arrays, n_arrays, k_frames, rows);
  return (int)cudaGetLastError();
}
