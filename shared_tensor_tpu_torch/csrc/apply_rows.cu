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
// when the scales are not powers of two (RMS policy).
//
// Bound: memory. Per element: K/8 B of words, K*4/128 B of row scales and
// 8N B of read+write over the N arrays (plus 4/128 B of row counts). One
// launch serves up to 8 target arrays (replica + other links' residuals),
// so the frames are unpacked once; the caller splits more targets into
// launches of at most 8, each recomputing the same delta in the same order.
// The design is apply_common.cuh's: targets by value; a warp for every
// 128-element row, in 16-byte lanes; every load before any store. The
// loads of the first kPre frames (lane k < kPre loads frame k's row scale,
// which the warp broadcasts by shuffle; every lane its word of each) and of
// the row count are issued before the targets', so a row costs one memory
// round trip where a loop over K would wait for each scale in turn: at the
// ResNet-18 table this took K=1 N=1 from 0.043 to 0.032 ms on the H100
// (PERF.md). Frames past kPre are loaded in the summing loop.

#include <climits>

#include "apply_common.cuh"

namespace {

using namespace st_apply;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPre = 4;  // the flood's batch size: K <= 4 on the main path

__device__ __forceinline__ void add_frame(float4& d, float s, uint32_t b) {
  d.x = d.x + ((b & 1u) ? -s : s);
  d.y = d.y + ((b & 2u) ? -s : s);
  d.z = d.z + ((b & 4u) ? -s : s);
  d.w = d.w + ((b & 8u) ? -s : s);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
apply_rows_kernel(const float* __restrict__ s_rows, const int* __restrict__ rowcount,
                  const uint32_t* __restrict__ words, Targets t, int k_frames, long long rows) {
  // row is warp-uniform: whole warps return, and the shuffles see whole warps
  const long long row = warp_row();
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int c = lane * 4;
  const int shift = (lane & 7) * 4;
  const long long e = row * 128 + c;
  const long long words_per_frame = rows * 4;
  const uint32_t* w = words + row * 4 + (lane >> 3);
  const float s_lane = lane < kPre && lane < k_frames ? s_rows[(long long)lane * rows + row] : 0.0f;
  uint32_t b[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) b[k] = k < k_frames ? w[k * words_per_frame] : 0u;
  const int count = rowcount[row];
  float4 v[N];
  load_targets<N>(t, e, v);
  float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < kPre; ++k)
    if (k < k_frames) add_frame(d, __shfl_sync(kFull, s_lane, k), b[k] >> shift);
  for (int k = kPre; k < k_frames; ++k)
    add_frame(d, s_rows[(long long)k * rows + row], w[k * words_per_frame] >> shift);
  const int left = count - c;
  store_targets<N>(t, e, v, d, left <= 0 ? 0 : (left >= 4 ? 4 : left));
}

}  // namespace

// arrays: a HOST array of n_arrays (1..8) device pointers, each 16-byte
// aligned, as are the words.
extern "C" int st_apply_rows_batch(const float* s_rows, const int* rowcount,
                                   const uint32_t* words,
                                   float* const* arrays, int n_arrays,
                                   int k_frames, long long rows,
                                   void* stream) {
  if (rows <= 0 || k_frames <= 0) return 0;
  Targets t;
  if (!make_targets(arrays, n_arrays, &t)) return (int)cudaErrorInvalidValue;
  const long long blocks = row_blocks(rows);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_targets(n_arrays, [&](auto n) {
    apply_rows_kernel<decltype(n)::value><<<(unsigned)blocks, kThreads, 0, s>>>(
        s_rows, rowcount, words, t, k_frames, rows);
    return (int)cudaGetLastError();
  });
}
