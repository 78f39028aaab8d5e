// Kernel A-cascade: the native engine's cascade quantize pass on Hopper
// (sm_90a), with the partials of the residual it leaves.
//
// Ports native/stcodec.c: stc_quantize_ef_cascade / quantize_cascade_range
// (no TPU kernel: the engine's C pass) for the device tier's K-frame burst.
// One call quantizes frames [j0, j0 + kc) of one residual viewed as
// (rows, 128), in ONE pass, then writes the partials of the final live
// residual that the next round's scales are made from (csrc/cascade_round.cu),
// as the C pass writes out_amax, out_ss and out_sabs. Frame j0 + j's scale
// for leaf i is the ladder top top[i] halved j times (s_{j+1} = s_j * 0.5f,
// in f32, as the engine builds its rows). Per level, per element:
//   live = lane < rowcount[row];  neg = v <= 0 (zero counts as negative)
//   bit  = live && neg, packed LSB-first into frame j0 + j's words
//   v    = (live && s > 0) ? v - (neg ? -s : s) : v
// and at the end r' = live ? v : 0 (padding zeroed), in place. A level
// whose scale is 0 records its bits and leaves the element as it is. The
// thread of each leaf's first word writes that leaf's kc scales.
//
// j0 and kc are read from device memory (state[0], state[1]), so a CUDA
// graph can replay the call with a depth chosen on the device; kc <= 0
// returns at once (kc is clipped to the K - j0 frames left and to 64).
// With `begin` the call quantizes nothing and ignores the state: it zeroes
// all K frames' words and scales and writes the partials of the residual
// as it finds it (its live lanes), which is how a burst starts.
//
// Layout contract: rows is a multiple of 8 and row_leaf is constant on
// every aligned 8-row tile (1024 elements, 32 words): a table's leaves are
// padded to whole tiles (ops/packing.TILE).
//
// Bound: memory (4 B read and 4 B written of residual, kc/8 B of words an
// element), once the levels are cheap. PR 17's design (a thread an element,
// a ballot and a predicated store a level) was bound by instructions. Here
// one thread owns one 32-lane word and a warp one tile of 32 words: the
// thread keeps its 32 values in registers across the levels and builds
// each level's word in a register, then stores it once (a warp's 32
// words: one 128-byte store). A value's level is four instructions, two of
// them on the integer pipe (64 lanes a clock an SM, half the f32 adds'
// rate), which bounds the levels: t = v - 2^-149 carries neg as its sign,
// a funnel shift moves that sign into the word, one bitwise op gives the
// step +-s the sign of t, and v -= step. The block's tiles are loaded
// and stored through shared memory by 16-byte cp.async copies in address
// order; each word's eight 16-byte chunks sit XOR-swizzled by the word's
// index, so the per-thread 16-byte reads and writes have no bank
// conflicts. Row constants are read once a word, a word's live lanes are
// one mask a level (a dead lane's value moves too and is zeroed at the
// end), and a level at scale 0 is a branch uniform over the warp. Built
// without fast-math: subnormal residuals and scales are kept, as in the C
// pass.
//
// Partials: one slot a tile, partials[0][t] = max |r|, [1][t] = sum r^2,
// [2][t] = sum |r|, all double, summed in a fixed order (each word's 32
// values in lane order, then a shuffle tree over the tile's 32 words), so
// every run gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // a block: 4 tiles
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLevels = 64;  // stc_quantize_ef_cascade's cap
constexpr int kChunks = 8;  // 16-byte chunks a word (32 floats)
// the least subnormal, 2^-149: v - kTiny is negative iff v <= 0, zeros of
// either sign included (exact: subnormals are kept); a NaN gives the GPU's
// canonical NaN, whose sign bit is clear, as v <= 0 is false
constexpr float kTiny = 1.40129846e-45f;

// the shared-memory slot of chunk c of word t of a block
__device__ __forceinline__ int slot(int t, int c) { return t * kChunks + (c ^ (t & 7)); }

__device__ __forceinline__ void cp_async16(float4* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kThreads)
quantize_rows_cascade_kernel(const float* __restrict__ top,
                             const long long* __restrict__ row_leaf,
                             const int* __restrict__ rowcount,
                             const int* __restrict__ state,
                             float* __restrict__ resid,
                             uint32_t* __restrict__ words,
                             float* __restrict__ scales,
                             double* __restrict__ partials,
                             long long n_words, int n_leaves, int k_frames, int begin) {
  __shared__ __align__(16) float4 tile[kThreads * kChunks];
  int j0 = 0, kc = 0;
  if (!begin) {
    j0 = state[0];
    kc = state[1];
    if (kc > k_frames - j0) kc = k_frames - j0;
    if (kc > kMaxLevels) kc = kMaxLevels;
    // uniform over the grid: every thread leaves here, or none does
    if (kc <= 0 || j0 < 0) return;
  }
  const int lane = threadIdx.x & 31;
  const long long w0 = (long long)blockIdx.x * kThreads;  // the block's first word
  const long long w = w0 + threadIdx.x;  // this thread's word
  // whole tiles only (n_words is a multiple of 32): a warp past the end
  // still meets the block's barriers
  const bool active = w - lane < n_words;
  const int nw = n_words - w0 < kThreads ? (int)(n_words - w0) : kThreads;
  float* base = resid + w0 * 32;
  for (int g = threadIdx.x; g < nw * kChunks; g += kThreads)  // chunk g: word g / 8, its chunk g % 8
    cp_async16(&tile[slot(g >> 3, g & 7)], base + 4 * g);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float v[32];
  // live lanes of this word, of any sign or size: lane b is live iff b < rem
  int rem = 0;
  if (active) {
#pragma unroll
    for (int c = 0; c < kChunks; c++) {
      const float4 x = tile[slot(threadIdx.x, c)];
      v[4 * c] = x.x;
      v[4 * c + 1] = x.y;
      v[4 * c + 2] = x.z;
      v[4 * c + 3] = x.w;
    }
    const long long row = w >> 2;
    const long long leaf = row_leaf[row];
    rem = rowcount[row] - 32 * (int)(w & 3);
    const bool head = lane == 0 && (w == 0 || row_leaf[row - 1] != leaf);
    if (begin) {
      for (int j = 0; j < k_frames; j++) words[(long long)j * n_words + w] = 0u;
      if (head)
        for (int j = 0; j < k_frames; j++) scales[(long long)j * n_leaves + leaf] = 0.0f;
    } else {
      // the live lanes' bits (bmsk clamps its count at 32)
      uint32_t mask;
      asm("bmsk.clamp.b32 %0, %1, %2;" : "=r"(mask) : "r"(0), "r"(rem > 0 ? rem : 0));
      float s = top[leaf];
      uint32_t* wp = words + (long long)j0 * n_words + w;
      float* sp = scales + (long long)j0 * n_leaves + leaf;
      for (int j = 0; j < kc; j++) {
        uint32_t bits = 0;
        if (s > 0.0f) {
#pragma unroll
          for (int b = 31; b >= 0; b--) {  // value b lands at bit b
            const float t = v[b] - kTiny;  // sign set iff v <= 0
            bits = __funnelshift_l(__float_as_uint(t), bits, 1);
            v[b] = v[b] - __uint_as_float((__float_as_uint(t) & 0x80000000u) | __float_as_uint(s));
          }
        } else {
#pragma unroll
          for (int b = 31; b >= 0; b--) bits = (bits << 1) | (uint32_t)(v[b] <= 0.0f);
        }
        wp[(long long)j * n_words] = bits & mask;
        if (head) sp[(long long)j * n_leaves] = s;
        s = s * 0.5f;
      }
    }
    if (rem < 32) {
#pragma unroll
      for (int b = 0; b < 32; b++)
        if (b >= rem) v[b] = 0.0f;
    }
  }
  if (!begin) {
    if (active) {
#pragma unroll
      for (int c = 0; c < kChunks; c++)
        tile[slot(threadIdx.x, c)] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    }
    __syncthreads();
    for (int g = threadIdx.x; g < nw * kChunks; g += kThreads)
      *reinterpret_cast<float4*>(base + 4 * g) = tile[slot(g >> 3, g & 7)];
  }
  if (!active) return;
  // the partials of the live residual left (padding lanes are 0 here)
  float amax = 0.0f;
  double ss = 0.0, sabs = 0.0;
#pragma unroll
  for (int b = 0; b < 32; b++) {
    const float a = fabsf(v[b]);
    if (a > amax) amax = a;
    const double d = (double)v[b];
    ss += d * d;
    sabs += (double)a;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_down_sync(0xffffffffu, ss, off);
    sabs += __shfl_down_sync(0xffffffffu, sabs, off);
    amax = fmaxf(amax, __shfl_down_sync(0xffffffffu, amax, off));
  }
  if (lane == 0) {
    const long long n_tiles = n_words >> 5, t = w >> 5;
    partials[t] = (double)amax;
    partials[n_tiles + t] = ss;
    partials[2 * n_tiles + t] = sabs;
  }
}

}  // namespace

extern "C" int st_quantize_rows_cascade(const float* top, const long long* row_leaf,
                                        const int* rowcount, const int* state,
                                        float* resid, uint32_t* words, float* scales,
                                        double* partials, long long rows, int n_leaves,
                                        int k_frames, int begin, void* stream) {
  const long long n_words = rows * 4;
  if (n_words <= 0) return 0;
  const long long blocks = (n_words + kThreads - 1) / kThreads;
  quantize_rows_cascade_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      top, row_leaf, rowcount, state, resid, words, scales, partials, n_words, n_leaves, k_frames,
      begin);
  return (int)cudaGetLastError();
}
