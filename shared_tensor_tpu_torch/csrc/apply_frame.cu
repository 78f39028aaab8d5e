// Kernel D: the scalar codec's fused receive pass on Hopper (sm_90a).
//
// Replaces shared_tensor_tpu/ops/codec_pallas.py: apply_frame_many /
// apply_frame / _apply_kernel. One frame (an f32 scale s, read on the
// device through a pointer, and LSB-first packed sign words) is unpacked
// once and applied to N target arrays, in place. Per element e:
//   delta = bit_e ? -s : s                  (== s * (1 - 2*bit_e), bit-equal)
//   for each of N arrays a:  a = e < n ? clip(a + delta, -SAT, SAT) : 0
// Padding lanes become 0, as in the Pallas kernel (the golden
// codec.apply_frame_many leaves them as they were).
//
// Bound: memory. Per element: 1/8 B of words and 8N B of read+write over
// the N arrays; N = 1 costs 8.125 B/element, as kernel C. The design is
// apply_common.cuh's: targets by value, up to 8 a launch; a warp for every
// 128-element row, in 16-byte lanes; every load before any store. At 2^30
// elements it streams as fast as a device-to-device copy of the same bytes
// on the H100 (PERF.md). Indices and the live count are 64-bit.

#include <climits>

#include "apply_common.cuh"

namespace {

using namespace st_apply;

template <int N>
__global__ void __launch_bounds__(kThreads)
apply_frame_kernel(const float* __restrict__ scale, const uint32_t* __restrict__ words,
                   Targets t, long long n_live, long long rows) {
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long e = row * 128 + lane * 4;
  const float s = *scale;
  const uint32_t b = words[row * 4 + (lane >> 3)] >> ((lane & 7) * 4);
  float4 v[N];
  load_targets<N>(t, e, v);
  const float4 d = make_float4((b & 1u) ? -s : s, (b & 2u) ? -s : s,
                               (b & 4u) ? -s : s, (b & 8u) ? -s : s);
  const long long left = n_live - e;
  store_targets<N>(t, e, v, d, left <= 0 ? 0 : (left >= 4 ? 4 : (int)left));
}

}  // namespace

// arrays: a HOST array of n_arrays (1..8) device pointers, each 16-byte
// aligned, as are the words; n_pad is a multiple of 128.
extern "C" int st_apply_frame_many(const float* scale, const uint32_t* words,
                                   float* const* arrays, int n_arrays,
                                   long long n_live, long long n_pad,
                                   void* stream) {
  if (n_pad <= 0) return 0;
  Targets t;
  if (!make_targets(arrays, n_arrays, &t) || n_pad % 128) return (int)cudaErrorInvalidValue;
  const long long rows = n_pad / 128;
  const long long blocks = row_blocks(rows);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_targets(n_arrays, [&](auto n) {
    apply_frame_kernel<decltype(n)::value><<<(unsigned)blocks, kThreads, 0, s>>>(scale, words, t, n_live, rows);
    return (int)cudaGetLastError();
  });
}
