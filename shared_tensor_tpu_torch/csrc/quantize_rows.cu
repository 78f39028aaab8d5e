// Kernel A: the table codec's fused sender pass on Hopper (sm_90a).
//
// Replaces shared_tensor_tpu/ops/codec_pallas.py: quantize_rows /
// _quantize_rows_kernel. Per element of a flat f32 residual viewed as
// (rows, 128), with a per-row scale s and a per-row live-lane count c:
//   live = lane < c;  neg = r <= 0 (zero counts as negative)
//   bit  = live && neg, packed LSB-first: flat bit i -> word i/32, bit i%32
//   r'   = live ? (s > 0 ? r - (neg ? -s : s) : r) : 0      (in place)
//
// Bound: memory. Per element it reads 4 B and writes 4 B of residual and
// writes 1/8 B of words, plus 8 B per row of scale and count: about
// 8.19 B/element, so at 3.35 TB/s an 11.2 M-element table costs ~27 us.
// Design: one thread per element, so a warp covers 32 consecutive lanes of
// one row and __ballot_sync of their predicates IS the wire word, written
// by lane 0. (The Pallas kernel packs with two MXU dots only because Mosaic
// cannot split lanes; a ballot needs no arithmetic at all.) Loads and
// stores are coalesced 4 B per thread. Built without fast-math: subnormal
// residuals are kept, as in the golden.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ s_row,
                     const int* __restrict__ rowcount,
                     float* __restrict__ resid,
                     uint32_t* __restrict__ words,
                     long long n) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  // n is a multiple of 128, so a warp is either wholly in range or wholly
  // out: every lane that reaches the ballot below has all 32 lanes with it.
  if (e >= n) return;
  const long long row = e >> 7;
  const int lane = (int)(e & 127);
  const float r = resid[e];
  const float s = s_row[row];
  const bool live = lane < rowcount[row];
  const bool neg = r <= 0.0f;
  const unsigned word = __ballot_sync(0xffffffffu, live && neg);
  if ((lane & 31) == 0) words[e >> 5] = word;
  float out = 0.0f;
  if (live) out = (s > 0.0f) ? r - (neg ? -s : s) : r;
  resid[e] = out;
}

}  // namespace

extern "C" int st_quantize_rows(const float* s_row, const int* rowcount,
                                float* resid, uint32_t* words,
                                long long rows, void* stream) {
  const long long n = rows * 128;
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  quantize_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      s_row, rowcount, resid, words, n);
  return (int)cudaGetLastError();
}
