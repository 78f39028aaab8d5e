// Kernel C: the scalar codec's sender on Hopper (sm_90a). Its scale comes
// from the scale pass (frame_scale.cu) or the caller.
//
// Kernel C replaces shared_tensor_tpu/ops/codec_pallas.py: quantize /
// _quantize_kernel. One f32 scale s for the whole flat residual (read on
// the device through a pointer, never handed to the host) and a flat live
// count n. Per element e of the padded residual:
//   live = e < n;  neg = r <= 0 (zero counts as negative)
//   bit  = live && neg, packed LSB-first: flat bit e -> word e/32, bit e%32
//   r'   = live ? (s > 0 ? r - (neg ? -s : s) : r) : 0      (in place)
// Padding lanes become 0 even at s = 0, as in the Pallas kernel (the golden
// codec.quantize returns the residual untouched at s = 0).
// Bound: memory. Per element it reads 4 B and writes 4 B of residual and
// writes 1/8 B of words: 8.125 B/element, so 2^20 elements take ~2.5 us and
// 2^30 ~2.6 ms at 3.35 TB/s.
// Design: kernel D's (apply_common.cuh): a warp for every two 128-element
// rows (on the H100 two rows a warp beat one and four, PERF.md), lane l
// takes elements 4l..4l+3 of each row as one float4, every load made
// before any store. The row's four words come from four ballots, one per
// float4 component: bit l of ballot c is element 4l + c, so word w
// interleaves bits 8w..8w+7 of the four ballots (spread4), and lanes 0-3
// write the row's 16 bytes. The residual must be 16-byte aligned (the
// wrapper checks it). Indices and the live count are 64-bit: at 2^30
// elements byte offsets pass 2^31.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;  // rows a warp

// bit m of the low byte of x to bit 4m
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x &= 0xffu;
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  x = (x | (x << 3)) & 0x11111111u;
  return x;
}

__device__ __forceinline__ float sent(float r, float s, bool live) {
  if (!live) return 0.0f;
  const bool neg = r <= 0.0f;
  return (s > 0.0f) ? r - (neg ? -s : s) : r;
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ scale, float* __restrict__ resid,
                uint32_t* __restrict__ words, long long n_live, long long rows) {
  const long long row0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 >= rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  float4 v[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (row0 + j < rows) v[j] = *reinterpret_cast<const float4*>(resid + (row0 + j) * 128 + lane * 4);
  const float s = *scale;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long row = row0 + j;
    if (row >= rows) break;  // uniform across the warp: every lane reaches the ballots
    const long long e = row * 128 + lane * 4;
    const long long left = n_live - e;
    const int live = left <= 0 ? 0 : (left >= 4 ? 4 : (int)left);
    const uint32_t bx = __ballot_sync(0xffffffffu, 0 < live && v[j].x <= 0.0f);
    const uint32_t by = __ballot_sync(0xffffffffu, 1 < live && v[j].y <= 0.0f);
    const uint32_t bz = __ballot_sync(0xffffffffu, 2 < live && v[j].z <= 0.0f);
    const uint32_t bw = __ballot_sync(0xffffffffu, 3 < live && v[j].w <= 0.0f);
    float4 o;
    o.x = sent(v[j].x, s, 0 < live);
    o.y = sent(v[j].y, s, 1 < live);
    o.z = sent(v[j].z, s, 2 < live);
    o.w = sent(v[j].w, s, 3 < live);
    *reinterpret_cast<float4*>(resid + e) = o;
    if (lane < 4) {
      const int sh = 8 * lane;
      words[row * 4 + lane] = spread4(bx >> sh) | (spread4(by >> sh) << 1) |
                              (spread4(bz >> sh) << 2) | (spread4(bw >> sh) << 3);
    }
  }
}

}  // namespace

// resid 16-byte aligned; n_pad a multiple of 128.
extern "C" int st_quantize(const float* scale, float* resid, uint32_t* words,
                           long long n_live, long long n_pad, void* stream) {
  if (n_pad <= 0) return 0;
  if (n_pad % 128) return (int)cudaErrorInvalidValue;
  const long long rows = n_pad / 128;
  const long long per_block = (long long)kWarps * kRows;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(scale, resid, words, n_live, rows);
  return (int)cudaGetLastError();
}
