// Kernel C: the scalar codec's fused sender pass on Hopper (sm_90a).
//
// Replaces shared_tensor_tpu/ops/codec_pallas.py: quantize /
// _quantize_kernel. One f32 scale s for the whole flat residual (computed
// beforehand by ops/codec.compute_scale, on the device; the kernel reads it
// through a pointer and never hands it to the host) and a flat live count n.
// Per element e of the padded residual:
//   live = e < n;  neg = r <= 0 (zero counts as negative)
//   bit  = live && neg, packed LSB-first: flat bit e -> word e/32, bit e%32
//   r'   = live ? (s > 0 ? r - (neg ? -s : s) : r) : 0      (in place)
// Padding lanes become 0 even at s = 0, as in the Pallas kernel (the golden
// codec.quantize returns the residual untouched at s = 0).
//
// Bound: memory. Per element it reads 4 B and writes 4 B of residual and
// writes 1/8 B of words: 8.125 B/element, so 2^20 elements take ~2.5 us and
// 2^30 ~2.6 ms at 3.35 TB/s.
// Design: one thread per element, so a warp covers 32 consecutive elements
// and __ballot_sync of their predicates IS the wire word, written by lane 0
// (as in kernel A, csrc/quantize_rows.cu). Loads and stores are coalesced
// 4 B per thread. Indices and the live count are 64-bit: at 2^30 elements
// byte offsets pass 2^31. Built without fast-math: subnormal residuals are
// kept, as in the golden.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ scale,
                float* __restrict__ resid,
                uint32_t* __restrict__ words,
                long long n_live, long long n_pad) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  // n_pad is a multiple of 128, so a warp is either wholly in range or
  // wholly out: every lane that reaches the ballot has all 32 lanes with it.
  if (e >= n_pad) return;
  const float s = *scale;
  const float r = resid[e];
  const bool live = e < n_live;
  const bool neg = r <= 0.0f;
  const unsigned word = __ballot_sync(0xffffffffu, live && neg);
  if ((threadIdx.x & 31) == 0) words[e >> 5] = word;
  float out = 0.0f;
  if (live) out = (s > 0.0f) ? r - (neg ? -s : s) : r;
  resid[e] = out;
}

}  // namespace

extern "C" int st_quantize(const float* scale, float* resid, uint32_t* words,
                           long long n_live, long long n_pad, void* stream) {
  if (n_pad <= 0) return 0;
  const long long blocks = (n_pad + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      scale, resid, words, n_live, n_pad);
  return (int)cudaGetLastError();
}
