// Kernel A-cascade: the native engine's cascade quantize pass on Hopper
// (sm_90a).
//
// Ports native/stcodec.c: stc_quantize_ef_cascade / quantize_cascade_range
// (no TPU kernel: the engine's C pass) for the device tier's K-frame burst.
// One call quantizes frames [j0, j0 + kc) of one residual viewed as
// (rows, 128), in ONE pass: each element stays in a register across the kc
// levels. Frame j0 + j's scale for leaf i is the ladder top top[i] halved
// j times (s_{j+1} = s_j * 0.5f, in f32, as the engine builds its rows).
// Per level, per element:
//   live = lane < rowcount[row];  neg = v <= 0 (zero counts as negative)
//   bit  = live && neg, packed LSB-first into frame j0 + j's words
//   v    = (live && s > 0) ? v - (neg ? -s : s) : v
// and at the end r' = live ? v : 0 (padding zeroed), in place. A level
// whose scale is 0 records its bits and leaves the element as it is. The
// thread at lane 0 of each leaf's first row writes that leaf's kc scales.
//
// j0 and kc are read from device memory (state[0], state[1]), so a CUDA
// graph can replay the call with a depth chosen on the device; kc <= 0
// returns at once (kc is clipped to the K - j0 frames left and to 64).
//
// Bound: memory. Per element it reads 4 B and writes 4 B of residual and
// writes kc/8 B of words. Design: kernel A's (csrc/quantize_rows.cu): one
// thread per element, so a warp covers 32 consecutive lanes of one row and
// __ballot_sync of their predicates IS the word of each level, written by
// lane 0. Built without fast-math: subnormal residuals and scales are
// kept, as in the C pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 64;  // stc_quantize_ef_cascade's cap

__global__ void __launch_bounds__(kThreads)
quantize_rows_cascade_kernel(const float* __restrict__ top,
                             const long long* __restrict__ row_leaf,
                             const int* __restrict__ rowcount,
                             const int* __restrict__ state,
                             float* __restrict__ resid,
                             uint32_t* __restrict__ words,
                             float* __restrict__ scales,
                             long long n, long long words_per_frame,
                             int n_leaves, int k_frames) {
  const int j0 = state[0];
  int kc = state[1];
  if (kc > k_frames - j0) kc = k_frames - j0;
  if (kc > kMaxLevels) kc = kMaxLevels;
  // uniform over the grid: every thread leaves here, or none does
  if (kc <= 0 || j0 < 0) return;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  // n is a multiple of 128, so a warp is either wholly in range or wholly
  // out: every lane that reaches a ballot below has all 32 lanes with it.
  if (e >= n) return;
  const long long row = e >> 7;
  const int lane = (int)(e & 127);
  const long long leaf = row_leaf[row];
  const bool live = lane < rowcount[row];
  const bool leaf_head = lane == 0 && (row == 0 || row_leaf[row - 1] != leaf);
  float v = resid[e];
  float s = top[leaf];
  uint32_t* w = words + (long long)j0 * words_per_frame + (e >> 5);
  float* sc = scales + (long long)j0 * n_leaves + leaf;
  for (int j = 0; j < kc; j++) {
    const bool neg = v <= 0.0f;
    const unsigned word = __ballot_sync(0xffffffffu, live && neg);
    if ((lane & 31) == 0) w[(long long)j * words_per_frame] = word;
    if (leaf_head) sc[(long long)j * n_leaves] = s;
    if (live && s > 0.0f) v = v - (neg ? -s : s);
    s = s * 0.5f;
  }
  resid[e] = live ? v : 0.0f;
}

}  // namespace

extern "C" int st_quantize_rows_cascade(const float* top, const long long* row_leaf,
                                        const int* rowcount, const int* state,
                                        float* resid, uint32_t* words, float* scales,
                                        long long rows, int n_leaves, int k_frames,
                                        void* stream) {
  const long long n = rows * 128;
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  quantize_rows_cascade_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      top, row_leaf, rowcount, state, resid, words, scales, n, rows * 4, n_leaves, k_frames);
  return (int)cudaGetLastError();
}
